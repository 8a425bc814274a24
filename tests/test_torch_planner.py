"""The port's capacity planner (repro_torch.core.planner) against JAX's
(repro.core.planner) on the CPU, mirroring tests/test_planner.py without
its mesh case (sharded frames come with ROADMAP queue 1 slice 12).

JAX runs with its default kernels (interpret mode), the port its plain
versions. Both get the same bounds. Tolerance: exact. Plans (buckets,
estimates, frame plans, workload band) are equal field for field, every
``PlanReport`` field but the wall time equals JAX's (dispatches, retries,
retried frames, drops, leaves, region counts, per-frame P and its source,
ring rows), each dispatch's ``ASKStats`` too, and the canvases are equal
pixel for pixel; the port's lie on the problem's device, JAX's in host
numpy. Sizes are small: n <= 256, max_dwell <= 64 for every run; the
BENCH_7.json configuration is only planned, not run.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core.feedback import OccupancyEstimator as JEstimator
from repro.launch.render_service import zoom_bounds
from repro.testing.hypothesis_compat import given, settings, strategies as st
from repro.workloads import EngineOptions as JEngineOptions
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import solve_batch as j_solve_batch
from repro_torch.core import ask
from repro_torch.core import planner as tplanner
from repro_torch.core.feedback import OccupancyEstimator
from repro_torch.workloads import EngineOptions, FrameProblem, solve_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n=128, g=4, r=2, B=16, max_dwell=32)
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")
REPORT_FIELDS = ("frames", "dispatches", "retries", "retried_frames",
                 "overflow_dropped", "leaf_count", "region_counts",
                 "frame_leaf_counts", "frame_p_subdiv", "frame_p_source",
                 "ring_rows", "ring_bytes")


def _window(cx, cy, w):
    return (cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2)


def _both(**kw):
    """(JAX's problem, the port's problem on the CPU)."""
    base = dict(SMALL, **kw)
    return JFrameProblem(**base), FrameProblem(**base, device="cpu")


def _same_plan(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.frames, t.ring_rows, t.ring_bytes) == \
        (j.frames, j.ring_rows, j.ring_bytes)


def _same_run(got, want):
    """(canvases, PlanReport) of the port against JAX's."""
    canvas, rep = got
    want_canvas, want_rep = want
    assert canvas.dtype == torch.int32 and canvas.device.type == "cpu"
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    _same_plan(rep.plan, want_rep.plan)
    for f in REPORT_FIELDS:
        assert getattr(rep, f) == getattr(want_rep, f), f
    assert len(rep.bucket_stats) == len(want_rep.bucket_stats)
    for a, b in zip(rep.bucket_stats, want_rep.bucket_stats):
        for f in STAT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    assert rep.overflow_dropped == 0


_SPARSE = [_window(-0.5, 0.0, w) for w in (16.0, 12.0, 10.0, 8.0, 6.0)]
_DENSE = [_window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k) for k in (2, 4)]
_BLEND_BOUNDS = [_window(-0.5, 0.0, w) for w in (16.0, 8.0, 4.0, 2.0, 1.0)]


# -- the occupancy model and bucketing ------------------------------------------

def test_occupancy_model_matches_jax():
    for d in (-1e9, -8.0, -4.0, -1.0, -0.3, 0.0, 2.0, 10.0):
        for band in ({}, dict(p_deep=0.9, slope=0.3, p_min=0.2)):
            assert tplanner.effective_p_subdiv(d, **band) == \
                jplanner.effective_p_subdiv(d, **band)
    for w, ref, r in ((1.0, 2.0, 2), (8.0, 2.0, 2), (0.3, 3.0, 3)):
        assert tplanner.zoom_depth(w, ref_width=ref, r=r) == \
            jplanner.zoom_depth(w, ref_width=ref, r=r)
    for mod in (tplanner, jplanner):
        with pytest.raises(ValueError):
            mod.zoom_depth(0.0, ref_width=2.0, r=2)
        with pytest.raises(ValueError):
            mod.effective_p_subdiv(0.0, slope=-1.0)
    assert tplanner.effective_p_subdiv(0.0) == 0.97
    assert (tplanner.ROW_BYTES, tplanner.P_DEEP_DEFAULT, tplanner.SLOPE_DEFAULT,
            tplanner.P_MIN_DEFAULT) == (jplanner.ROW_BYTES,
                                        jplanner.P_DEEP_DEFAULT,
                                        jplanner.SLOPE_DEFAULT,
                                        jplanner.P_MIN_DEFAULT)


@pytest.mark.parametrize("workload", ["mandelbrot", "julia", "burning_ship",
                                      "multibrot"])
def test_estimates_and_bands_match_jax(workload):
    jp, tp = _both(workload=workload)
    assert tplanner.prior_band_for(tp) == jplanner.prior_band_for(jp)
    assert tplanner.workload_name(tp) == jplanner.workload_name(jp)
    for kw in ({}, dict(ref_width=8.0), dict(p_deep=0.9, slope=0.25)):
        t = tplanner.estimate_frames(tp, [2.0, 8.0, 0.5, 3.3], **kw)
        j = jplanner.estimate_frames(jp, [2.0, 8.0, 0.5, 3.3], **kw)
        assert [dataclasses.asdict(e) for e in t] == \
            [dataclasses.asdict(e) for e in j]
    assert tplanner.worst_case_capacities(tp) == \
        jplanner.worst_case_capacities(jp)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 17])
@pytest.mark.parametrize("case", ["single", "identical", "spread", "mixed"])
def test_plan_capacities_matches_jax(case, k):
    """Bucketing, the DP over ring rows and the merge of equal buckets."""
    bounds = {"single": [_window(-0.5, 0.0, 3.0)],
              "identical": [_window(-0.5, 0.0, 3.0)] * 6,
              "spread": [_window(-0.5, 0.0, w) for w in (16.0, 4.0, 1.0)],
              "mixed": ([_window(-0.5, 0.0, w) for w in (16.0, 12.0, 8.0, 6.0)]
                        + [_window(-0.7436, 0.1318, 3.0 / 2 ** e)
                           for e in (4, 8, 12)])}[case]
    jp, tp = _both(n=256, max_dwell=64)
    for sf in (1.25, 2.0):
        t = tplanner.plan_capacities(tp, bounds, num_buckets=k,
                                     safety_factor=sf)
        _same_plan(t, jplanner.plan_capacities(jp, bounds, num_buckets=k,
                                               safety_factor=sf))
        assert sorted(i for b in t.buckets for i in b.frames) == \
            list(range(len(bounds)))
        assert [t.bucket_of(i) for i in range(len(bounds))] == \
            [jplanner.plan_capacities(jp, bounds, num_buckets=k,
                                      safety_factor=sf).bucket_of(i)
             for i in range(len(bounds))]


def test_plan_validation_matches_jax():
    jp, tp = _both()
    for mod, prob in ((tplanner, tp), (jplanner, jp)):
        with pytest.raises(ValueError):
            mod.plan_from_p(prob, [], num_buckets=2)
        with pytest.raises(ValueError):
            mod.plan_from_p(prob, [0.5], num_buckets=0)
        with pytest.raises(ValueError):
            mod.plan_capacities(prob, np.zeros((2, 3)))
        with pytest.raises(KeyError):
            mod.plan_capacities(prob, [_window(0, 0, 1)]).bucket_of(5)
    worst = tplanner.worst_case_capacities(tp)
    caps = tuple(max(1, w // 3) for w in worst)
    assert tplanner.escalate_capacities(caps, worst, [0]) == \
        jplanner.escalate_capacities(caps, worst, [0])
    with pytest.raises(RuntimeError, match="worst-case"):
        tplanner.escalate_capacities(worst, worst, [1, 0])


def test_bench7_config_plans_its_ring_rows():
    """BENCH_7.json's batch (n=512, 12 sparse + 4 deep frames), planned
    only: the per-frame plan (K=4) and the pooled plan give JAX's buckets
    and the file's ring rows, 17636 and 17038 (neither retries there)."""
    cfg = json.loads((ROOT / "BENCH_7.json").read_text())
    row = cfg["workloads"]["mixed_mandelbrot"]
    c = cfg["config"]
    kw = dict(n=c["n"], g=c["g"], r=c["r"], B=c["B"], max_dwell=c["max_dwell"])
    sparse = [_window(-0.5, 0.0, float(w))
              for w in np.geomspace(16.0, 4.0, c["n_sparse"])]
    dense = [_window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k)
             for k in np.linspace(4, 12, c["n_dense"])]
    b = np.asarray(sparse + dense, np.float32)
    jp, tp = _both(**kw)
    t = tplanner.plan_frames(tp, b, num_buckets=4)
    _same_plan(t, jplanner.plan_frames(jp, b, num_buckets=4))
    pooled = tplanner.plan_pooled(tp, b)
    _same_plan(pooled, jplanner.plan_pooled(jp, b))
    assert (t.ring_rows, pooled.ring_rows) == \
        (row["planned_ring_rows"], row["ring_rows"]) == (17636, 17038)


# -- planned execution and the retry -------------------------------------------

_PLANNED = {
    "single": (dict(), [_window(-0.5, 0.0, 2.0)], dict(plan=4)),
    "identical": (dict(), [_window(-0.5, 0.0, 2.0)] * 5, dict(plan=3)),
    "heterogeneous": (dict(n=256, max_dwell=64), _SPARSE + _DENSE,
                      dict(plan=3)),
    "plan_true": (dict(n=256, max_dwell=64), _SPARSE[:3] + _DENSE,
                  dict(plan=True)),
    "ref_width": (dict(), [_window(-0.5, 0.0, 2.0)] * 2,
                  dict(plan=2, ref_width=8.0)),
    "options": (dict(), _BLEND_BOUNDS, dict(options="plan2")),
    "pooled": (dict(n=256, max_dwell=64), _SPARSE[:3] + _DENSE,
               dict(options="pooled")),
}


def _options(kw, pkg):
    """The EngineOptions of a _PLANNED case in either package."""
    opts = {"plan2": dict(plan=2, safety_factor=1.5),
            "pooled": dict(engine="ask_pooled", plan=True)}[kw["options"]]
    return dict(options=(EngineOptions if pkg == "t" else JEngineOptions)(**opts))


@pytest.mark.parametrize("case", _PLANNED)
def test_solve_batch_planned_matches_jax(case):
    pkw, bounds, kw = _PLANNED[case]
    jp, tp = _both(**pkw)
    tkw = _options(kw, "t") if "options" in kw else kw
    jkw = _options(kw, "j") if "options" in kw else kw
    got = solve_batch(tp, bounds, **tkw)
    _same_run(got, j_solve_batch(jp, bounds, **jkw))
    if case == "identical":
        assert got[1].dispatches == 1 and got[1].retries == 0
    if case == "heterogeneous":
        uniform = ask.scan_capacities(256, 4, 2, 16, safety_factor=2.0)
        assert got[1].ring_rows < len(bounds) * 2 * max(uniform)


def _hand_plan(mod, prob, promote: bool):
    """A plan whose first bucket is too small for every frame; with
    ``promote`` an empty worst-case bucket follows it."""
    levels = len(ask.scan_capacities(128, 4, 2, 16)) - 1
    buckets = [mod.BucketPlan(frames=(0, 1) if promote else tuple(range(5)),
                              p_subdiv=0.1, capacities=(16,) + (8,) * levels)]
    if promote:
        buckets.append(mod.BucketPlan(frames=(), p_subdiv=1.0,
                                      capacities=mod.worst_case_capacities(prob)))
    return mod.CapacityPlan(buckets=tuple(buckets), estimates=(),
                            safety_factor=1.0)


@pytest.mark.parametrize("promote", [False, True], ids=["escalate", "promote"])
def test_forced_overflow_retry_matches_jax(promote):
    """Undersized hand-made plans: the escalation toward the worst case,
    and the promotion into the next bucket, converge as JAX's do, with the
    same dispatches, retried frames, per-frame P and canvases."""
    jp, tp = _both()
    F = 2 if promote else 5
    b = np.asarray([(-1.6 + 0.03 * i, -1.1, 0.55, 1.05) for i in range(F)],
                   np.float32)
    got = tplanner.solve_planned(tp, b, plan=_hand_plan(tplanner, tp, promote))
    _same_run(got, jplanner.solve_planned(jp, b,
                                          plan=_hand_plan(jplanner, jp, promote)))
    rep = got[1]
    assert rep.retries > 0 and rep.dispatches > 1
    if promote:
        assert rep.retried_frames == (0, 1) and rep.dispatches == 2
        assert rep.frame_p_subdiv == (1.0, 1.0)
        assert rep.frame_p_source == ("prior", "prior")
    exact, _ = ask.run_ask_scan_batch(tp, b, safety_factor=1e9)
    assert torch.equal(got[0], exact)


def test_plan_report_accounting_matches_jax():
    """report.ring_rows sums frames x 2 x max caps over the dispatches."""
    jp, tp = _both(n=256, max_dwell=64)
    b = np.asarray([_window(-0.5, 0.0, 16.0)] * 3
                   + [_window(-0.7436447860, 0.1318252536, 0.01)] * 2,
                   np.float32)
    tplan = tplanner.plan_capacities(tp, b, num_buckets=2)
    got = tplanner.solve_planned(tp, b, plan=tplan)
    _same_run(got, jplanner.solve_planned(
        jp, b, plan=jplanner.plan_capacities(jp, b, num_buckets=2)))
    rep = got[1]
    assert rep.ring_rows == sum(len(b_.frames) * 2 * max(st_.olt_caps)
                                for b_, st_ in zip(tplan.buckets,
                                                   rep.bucket_stats)) \
        or rep.retries
    assert rep.ring_bytes == rep.ring_rows * 8 and len(rep.region_counts) == 5


def test_frame_overflow_stats_plumbing():
    """The per-frame overflow breakdown the retry keys on sums to the
    total and is zero where nothing dropped, as JAX's."""
    from repro.core.ask import run_ask_scan_batch as j_scan_batch
    jp, tp = _both(g=2, B=8)
    levels = len(ask.scan_capacities(128, 2, 2, 8)) - 1
    caps = (4,) + (12,) * levels
    b = np.stack([[-1.6 + 0.03 * i, -1.1, 0.55, 1.05]
                  for i in range(3)]).astype(np.float32)
    _, st_ = ask.run_ask_scan_batch(tp, b, capacities=caps)
    _, jst = j_scan_batch(jp, b, capacities=caps)
    assert st_.frame_overflow == jst.frame_overflow
    assert sum(st_.frame_overflow) == st_.overflow_dropped > 0
    assert sum(st_.frame_leaf_counts) == st_.leaf_count


def test_planned_path_errors_match_jax():
    jp, tp = _both()
    b = np.asarray([_window(-0.5, 0.0, 2.0)] * 2, np.float32)
    for mod, prob, solve in ((tplanner, tp, solve_batch),
                             (jplanner, jp, j_solve_batch)):
        prebuilt = mod.plan_capacities(prob, b, num_buckets=2)
        with pytest.raises(ValueError, match="ignored"):
            solve(prob, b, plan=prebuilt, ref_width=8.0)
        with pytest.raises(ValueError, match="covers"):
            mod.solve_planned(prob, b[:1], plan=prebuilt)
        with pytest.raises(ValueError, match="pooled plan"):
            mod.solve_pooled(prob, b, plan=prebuilt)
        tiny = mod.CapacityPlan(
            buckets=(mod.BucketPlan(frames=(0, 1), p_subdiv=0.1,
                                    capacities=(1, 1)),),
            estimates=(), safety_factor=1.0)
        with pytest.raises(RuntimeError, match="max_dispatches"):
            mod.solve_planned(prob, b, plan=tiny, max_dispatches=1)
    with pytest.raises(NotImplementedError, match="slice 12"):
        tplanner.solve_planned(tp, b, mesh=object())
    with pytest.raises(NotImplementedError, match="slice 12"):
        tplanner.solve_pooled(tp, b, mesh=object())


# -- measured occupancy (observed=) --------------------------------------------

def _estimators(observations, **cfg):
    """A port estimator and a JAX one fed the same (depth, p) values."""
    t, j = OccupancyEstimator(**cfg), JEstimator(**cfg)
    for d, p in observations:
        t.observe_value(d, p, workload="mandelbrot")
        j.observe_value(d, p, workload="mandelbrot")
    return t, j


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("obs", [(), ((1.0, 0.5),), ((0.0, 0.512), (-2.0, 0.43)),
                                 ((0.0, 0.9), (-3.0, 0.2), (-1.0, 0.6))],
                         ids=["cold", "deep", "two", "three"])
def test_plan_frames_observed_matches_jax(obs, quantize):
    """Provenance, the blend, the p_quantum grid and the pooled plan."""
    jp, tp = _both()
    t_est, j_est = _estimators(obs, p_quantum=0.1, max_extrapolate=0.75)
    for k in (1, 3):
        _same_plan(tplanner.plan_frames(tp, _BLEND_BOUNDS, observed=t_est,
                                        num_buckets=k, quantize=quantize),
                   jplanner.plan_frames(jp, _BLEND_BOUNDS, observed=j_est,
                                        num_buckets=k, quantize=quantize))
    _same_plan(tplanner.plan_pooled(tp, _BLEND_BOUNDS, observed=t_est,
                                    quantize=quantize),
               jplanner.plan_pooled(jp, _BLEND_BOUNDS, observed=j_est,
                                    quantize=quantize))
    assert tplanner.observed_frame_ps(tp, _BLEND_BOUNDS, t_est,
                                      quantize=quantize) == \
        jplanner.observed_frame_ps(jp, _BLEND_BOUNDS, j_est, quantize=quantize)
    plan = tplanner.plan_frames(tp, _BLEND_BOUNDS, observed=t_est)
    assert [fp.source for fp in plan.frame_plans].count("measured") == \
        sum(1 for fp in plan.frame_plans if fp.p_measured is not None)
    if not obs:  # the cold-start contract
        base = tplanner.plan_capacities(tp, _BLEND_BOUNDS, num_buckets=4)
        assert [b.capacities for b in plan.buckets] == \
            [b.capacities for b in base.buckets]


def test_plan_frames_conflicts_match_jax():
    jp, tp = _both()
    t_est, j_est = _estimators(((1.0, 0.5),))
    for mod, prob, est in ((tplanner, tp, t_est), (jplanner, jp, j_est)):
        with pytest.raises(ValueError, match="estimator's own band"):
            mod.plan_frames(prob, _BLEND_BOUNDS, observed=est, p_deep=0.9)
        with pytest.raises(ValueError, match="quantize"):
            mod.plan_frames(prob, _BLEND_BOUNDS, quantize=True)
        with pytest.raises(ValueError, match="tenant"):
            mod.plan_frames(prob, _BLEND_BOUNDS, tenant="a")
    t = tplanner.plan_frames(tp, _BLEND_BOUNDS, observed=t_est, tenant="a")
    _same_plan(t, jplanner.plan_frames(jp, _BLEND_BOUNDS, observed=j_est,
                                       tenant="a"))
    assert all(fp.tenant == "a" for fp in t.frame_plans)


@settings(max_examples=10, deadline=None)
@given(data=st.data())
def test_observed_blend_ring_monotone_and_equal_to_jax(data):
    """More measured density never gives fewer ring rows (the property of
    tests/test_planner.py), and every plan equals JAX's."""
    jp, tp = _both()
    depths = [tplanner.zoom_depth(w, ref_width=2.0, r=2)
              for w in (16.0, 8.0, 4.0, 2.0, 1.0)]
    lo_obs, hi_obs = [], []
    for d in depths:
        lo = data.draw(st.floats(0.05, 1.0))
        hi = min(1.0, lo + data.draw(st.floats(0.0, 0.5)))
        lo_obs.append((d, lo))
        hi_obs.append((d, hi))
    k = data.draw(st.integers(1, 4))
    plans = []
    for obs in (lo_obs, hi_obs):
        t_est, j_est = _estimators(obs)
        t = tplanner.plan_frames(tp, _BLEND_BOUNDS, observed=t_est,
                                 num_buckets=k)
        _same_plan(t, jplanner.plan_frames(jp, _BLEND_BOUNDS, observed=j_est,
                                           num_buckets=k))
        plans.append(t)
    assert plans[1].ring_rows >= plans[0].ring_rows


def test_report_frame_p_with_observed_matches_jax():
    jp, tp = _both()
    t_est, j_est = _estimators(((0.0, 0.9),))
    got = solve_batch(tp, _BLEND_BOUNDS, plan=3, observed=t_est)
    _same_run(got, j_solve_batch(jp, _BLEND_BOUNDS, plan=3, observed=j_est))
    rep = got[1]
    assert set(rep.frame_p_source) <= {"prior", "measured"}
    if not rep.retries:
        for fi, p in enumerate(rep.frame_p_subdiv):
            assert p == rep.plan.buckets[rep.plan.bucket_of(fi)].p_subdiv


def test_solve_pooled_prebuilt_plan_and_quantize_match_jax():
    """solve_pooled with plan= (a prebuilt pooled plan), and with
    observed= plus quantize=True; an undersized pooled plan retries."""
    jp, tp = _both(n=256, max_dwell=64)
    b = np.asarray(_SPARSE[:3] + _DENSE, np.float32)
    t_est, j_est = _estimators(((0.0, 0.6), (-2.0, 0.4)))
    tplan, jplan = (tplanner.plan_pooled(tp, b, observed=t_est),
                    jplanner.plan_pooled(jp, b, observed=j_est))
    _same_run(tplanner.solve_pooled(tp, b, plan=tplan),
              jplanner.solve_pooled(jp, b, plan=jplan))
    _same_run(tplanner.solve_pooled(tp, b, observed=t_est, quantize=True),
              jplanner.solve_pooled(jp, b, observed=j_est, quantize=True))
    small = [dataclasses.replace(p, buckets=(dataclasses.replace(
        p.buckets[0], capacities=tuple(max(1, c // 6)
                                       for c in p.buckets[0].capacities)),))
        for p in (tplan, jplan)]
    got = tplanner.solve_pooled(tp, b, plan=small[0])
    _same_run(got, jplanner.solve_pooled(jp, b, plan=small[1]))
    assert got[1].retries > 0


# -- the estimator threaded through solve_batch (tests/test_planner.py's
# TestBatchObservedThreading) ---------------------------------------------------

def _scenario():
    kw = dict(n=256, g=4, r=2, B=16, max_dwell=64)
    bounds = np.asarray(list(zoom_bounds(4, center=(-0.2, 0.0),
                                         width0=3.0 / 2 ** 6,
                                         zoom_per_frame=1.3)), np.float64)
    return JFrameProblem(**kw), FrameProblem(**kw, device="cpu"), bounds


def _warm(prob, bounds, est_cls, planner_mod, run):
    _, st_ = run(prob, bounds, p_subdiv=1.0)
    widths, ref_w = planner_mod._frame_widths(prob, bounds, None)
    depths = [planner_mod.zoom_depth(w, ref_width=ref_w, r=prob.r)
              for w in widths]
    est = est_cls()
    est.observe_stats(depths, st_, g=prob.g, r=prob.r, workload=prob.workload)
    return est


@pytest.mark.parametrize("case", ["planned_pooled_warm", "unplanned",
                                  "engine_kwargs"])
def test_observed_threading_matches_jax(case):
    from repro.core.ask import run_ask_scan_batch as j_scan_batch
    jp, tp, bounds = _scenario()
    t_est = _warm(tp, bounds, OccupancyEstimator, tplanner,
                  ask.run_ask_scan_batch)
    j_est = _warm(jp, bounds, JEstimator, jplanner, j_scan_batch)
    assert t_est.snapshot() == j_est.snapshot()
    if case == "planned_pooled_warm":
        cold = solve_batch(tp, bounds, options=EngineOptions(
            engine="ask_pooled", plan=True))
        warm = solve_batch(tp, bounds, options=EngineOptions(
            engine="ask_pooled", plan=True, observed=t_est))
        _same_run(warm, j_solve_batch(jp, bounds, options=JEngineOptions(
            engine="ask_pooled", plan=True, observed=j_est)))
        assert warm[1].ring_rows < cold[1].ring_rows
        assert warm[1].dispatches == 1 and torch.equal(warm[0], cold[0])
    elif case == "unplanned":
        ref, _ = ask.run_ask_scan_batch(tp, bounds, p_subdiv=1.0)
        for engine in ("ask_pooled", "ask_scan"):
            got = solve_batch(tp, bounds, options=EngineOptions(
                engine=engine, observed=t_est))
            want = j_solve_batch(jp, bounds, options=JEngineOptions(
                engine=engine, observed=j_est))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            assert got[1].olt_caps == want[1].olt_caps
            assert torch.equal(got[0], ref) and got[1].overflow_dropped == 0
    else:
        for engine in ("ask_scan", "ask_pooled"):
            got = solve_batch(tp, bounds, options=EngineOptions(
                engine=engine, plan=True, block_until_ready=True))
            _same_run(got, j_solve_batch(jp, bounds, options=JEngineOptions(
                engine=engine, plan=True, block_until_ready=True)))
