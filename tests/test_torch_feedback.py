"""The port's measured-occupancy feedback (repro_torch.core.feedback)
against JAX's (repro.core.feedback) on the CPU, mirroring
tests/test_feedback.py, whose hypothesis properties run here through
``repro.testing.hypothesis_compat`` as there.

Every case applies the same observations to a port estimator and a JAX
one. Tolerance: exact. Their ``snapshot()`` must be JSON-equal (the same
``json.dumps`` text) and every ``predict``, ``predict_quantized``,
``measured`` and ``prior`` equal, also after a ``restore`` of the same
(possibly poisoned) state. The engine-fed cases render at n=128,
max_dwell=32.
"""

import json
import math

import numpy as np
import pytest

from repro.core import feedback as jfb
from repro.core import planner as jplanner
from repro.core.ask import run_ask_scan_batch as j_scan_batch
from repro.testing.hypothesis_compat import given, settings, strategies as st
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import solve_batch as j_solve_batch
from repro_torch.core import ask
from repro_torch.core import feedback as tfb
from repro_torch.core import planner as tplanner
from repro_torch.workloads import FrameProblem, solve_batch

SMALL = dict(n=128, g=4, r=2, B=16, max_dwell=32)
DEPTHS = (-8.0, -4.0, -2.3, -1.0, 0.0, 0.7, 1.0, 3.0, 6.0)
NAMESPACES = ((None, None), ("mandelbrot", None), ("julia", None),
              ("burning_ship", None), ("mandelbrot", "alice"),
              ("julia", "newcomer"))


def _chain_from_p(p, *, g, r, levels):
    """The (region_counts, leaf_count) chain of a constant P."""
    chain = [round(g * g * (r * r * p) ** lv) for lv in range(levels + 1)]
    return tuple(chain[:-1]), chain[-1]


def _pair(**cfg):
    return tfb.OccupancyEstimator(**cfg), jfb.OccupancyEstimator(**cfg)


def _wire(est) -> str:
    return json.dumps(est.snapshot(), sort_keys=True)


def _assert_same(t, j):
    """JSON-equal snapshots, equal counters and equal predictions in
    every namespace."""
    assert _wire(t) == _wire(j)
    assert t.is_cold == j.is_cold
    assert t.workloads_observed() == j.workloads_observed()
    for wl, tenant in NAMESPACES:
        assert t.buckets(wl, tenant) == j.buckets(wl, tenant)
        for d in DEPTHS:
            kw = dict(workload=wl, tenant=tenant)
            assert t.predict(d, **kw) == j.predict(d, **kw)
            assert t.predict_quantized(d, **kw) == j.predict_quantized(d, **kw)
            assert t.measured(d, **kw) == j.measured(d, **kw)
            assert t.prior(d, workload=wl) == j.prior(d, workload=wl)


def _both(fn, t, j):
    fn(t)
    fn(j)


# -- measured_p_subdiv, level_subdivision_rates, ewma ----------------------------

@settings(max_examples=40, deadline=None)
@given(p=st.floats(0.1, 1.0), g=st.sampled_from([2, 4, 8]),
       r=st.sampled_from([2, 4]), levels=st.integers(1, 5))
def test_known_p_is_recovered_as_in_jax(p, g, r, levels):
    counts, leaf = _chain_from_p(p, g=g, r=r, levels=levels)
    got = tfb.measured_p_subdiv(counts, leaf, g=g, r=r)
    assert got == jfb.measured_p_subdiv(counts, leaf, g=g, r=r)
    assert tfb.level_subdivision_rates(counts, leaf, r=r) == \
        jfb.level_subdivision_rates(counts, leaf, r=r)
    if min(counts + (leaf,)) >= 1:
        tol = max(0.5 / min(counts + (leaf,)), 1e-9)
        assert got == pytest.approx(p, rel=tol + 1e-6)


def test_envelope_and_no_signal_match_jax():
    for counts, leaf in (((16, 56), 90), ((4, 16, 63), 176), ((), 4),
                         ((16,), 0), ((16, 0, 5), 3)):
        assert tfb.measured_p_subdiv(counts, leaf, g=4, r=2) == \
            jfb.measured_p_subdiv(counts, leaf, g=4, r=2)
        assert tfb.level_subdivision_rates(counts, leaf, r=2) == \
            jfb.level_subdivision_rates(counts, leaf, r=2)
    assert tfb.measured_p_subdiv((16, 56), 90, g=4, r=2) == \
        pytest.approx(56 / 16 / 4)
    assert tfb.measured_p_subdiv((), 4, g=2, r=2) is None
    for mod in (tfb, jfb):
        with pytest.raises(ValueError):
            mod.measured_p_subdiv((4,), 4, g=2, r=1)
        with pytest.raises(ValueError):
            mod.level_subdivision_rates((4,), 4, r=1)
        for bad in (0.0, -0.1, 1.5):
            with pytest.raises(ValueError):
                mod.ewma(0.5, 0.5, bad)


@settings(max_examples=50, deadline=None)
@given(old=st.floats(0.0, 1.0), new=st.floats(0.0, 1.0),
       alpha=st.floats(0.05, 1.0))
def test_ewma_is_the_same_contraction(old, new, alpha):
    out = tfb.ewma(old, new, alpha)
    assert out == jfb.ewma(old, new, alpha)
    assert abs(out - new) == pytest.approx((1 - alpha) * abs(old - new))
    assert tfb.ewma(None, new, alpha) == new


# -- the estimator ---------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(depths=st.lists(st.floats(-6.0, 6.0), min_size=0, max_size=8),
       ps=st.lists(st.floats(-0.5, 1.5), min_size=8, max_size=8),
       query=st.floats(-8.0, 8.0))
def test_estimator_in_band_and_equal_to_jax(depths, ps, query):
    t, j = _pair()
    for d, p in zip(depths, ps):
        assert t.observe_value(d, p) == j.observe_value(d, p)
    assert _wire(t) == _wire(j)
    for value in (t.predict(query), t.predict_quantized(query)):
        assert t.p_min - 1e-12 <= value <= t.p_deep + 1e-12
    assert (t.predict(query), t.predict_quantized(query), t.measured(query)) \
        == (j.predict(query), j.predict_quantized(query), j.measured(query))


@settings(max_examples=25, deadline=None)
@given(p=st.floats(0.35, 0.95))
def test_repeated_observation_converges_as_in_jax(p):
    t, j = _pair()
    for _ in range(12):
        _both(lambda e: e.observe_frames(
            [0.0], [_chain_from_p(p, g=4, r=2, levels=3)], g=4, r=2), t, j)
    _assert_same(t, j)
    assert t.measured(0.0) == pytest.approx(p, abs=0.03)


def _chunk_max(e):
    e.observe_frames([0.0, 0.1, -3.0],
                     [_chain_from_p(0.5, g=4, r=2, levels=3),
                      _chain_from_p(0.8, g=4, r=2, levels=3),
                      ((), 16)], g=4, r=2)


SCRIPTS = {
    "cold": lambda e: None,
    "values": lambda e: [e.observe_value(d, p) for d, p in
                         ((-2.3, 0.41), (0.7, 0.88), (0.7, 0.7), (5.0, 0.2))],
    "chunk_max": _chunk_max,
    "workloads": lambda e: [
        e.observe_value(1.0, 0.66, workload="julia"),
        e.observe_frames([0.0], [_chain_from_p(0.8, g=4, r=2, levels=3)],
                         g=4, r=2, workload="burning_ship"),
        e.observe_value(-1.0, 0.5, workload="mandelbrot")],
    "tenants": lambda e: [
        e.observe_value(0.0, 0.45, workload="mandelbrot"),
        e.observe_value(0.0, 0.9, workload="mandelbrot", tenant="alice"),
        e.observe_value(4.0, 0.6, workload="mandelbrot"),
        e.observe_value(0.0, 0.5, workload="mandelbrot", tenant="a@corp")],
    "tenant_band": lambda e: [
        e._bands.__setitem__("hotwl", (0.95, 0.0, 0.5)),
        e.observe_value(0.0, 0.01, workload="hotwl", tenant="t")],
}


@pytest.mark.parametrize("cfg", [{}, dict(alpha=0.25, depth_quantum=0.4,
                                          p_quantum=0.1, slope=0.2,
                                          max_extrapolate=0.75)],
                         ids=["default", "tuned"])
@pytest.mark.parametrize("script", SCRIPTS)
def test_estimator_snapshot_and_restore_match_jax(script, cfg):
    """The same observations give JSON-equal snapshots; each package
    restores the other's snapshot to an estimator equal to both, whose
    later observations go on alike."""
    t, j = _pair(**cfg)
    _both(SCRIPTS[script], t, j)
    _assert_same(t, j)
    wire = _wire(t)
    tb = tfb.OccupancyEstimator.restore(json.loads(_wire(j)))
    jb = jfb.OccupancyEstimator.restore(json.loads(wire))
    _assert_same(tb, jb)
    _assert_same(tb, t)
    for e in (t, j, tb, jb):
        e.observe_value(0.7, 0.5, workload="mandelbrot")
    _assert_same(tb, jb)
    _assert_same(t, tb)


def _poisoned(kind: str) -> dict:
    snap = tfb.OccupancyEstimator().snapshot()
    if kind == "ewma":
        snap["ewma"] = [["", 0, float("nan")], ["", 1, float("inf")],
                        ["", 2, -0.5], ["", 3, 1.5], ["", 4, 0.0],
                        ["", "x", 0.5], ["", 5], "junk", ["", 6, 0.5],
                        ["ghost_workload", 0, 0.7]]
    elif kind == "bands":
        snap["bands"] = {"short": [0.9, 0.1], "nan": [float("nan"), 0.1, 0.2],
                         "neg_slope": [0.9, -0.1, 0.2],
                         "inverted": [0.3, 0.1, 0.5],
                         "zero_floor": [0.9, 0.1, 0.0],
                         "words": ["a", "b", "c"], "good": [0.9, 0.12, 0.25]}
    else:
        snap["frames_observed"], snap["chunks_observed"] = -3, None
    return snap


@pytest.mark.parametrize("kind", ["ewma", "bands", "counters"])
def test_restore_sanitizes_as_jax_does(kind):
    t = tfb.OccupancyEstimator.restore(_poisoned(kind))
    j = jfb.OccupancyEstimator.restore(_poisoned(kind))
    _assert_same(t, j)
    assert t._bands == j._bands
    for d in (-3.0, 0.0, 2.0, 3.0):
        for wl in (None, "nan", "good", "ghost_workload"):
            p = t.predict(d, workload=wl)
            assert math.isfinite(p) and 0.0 < p <= 1.0
            assert p == j.predict(d, workload=wl)


def test_bad_states_raise_as_in_jax():
    for mod in (tfb, jfb):
        est = mod.OccupancyEstimator()
        for bad in (None, 0, 2, "1", 99):
            with pytest.raises(ValueError, match="version"):
                mod.OccupancyEstimator.restore(dict(est.snapshot(),
                                                    version=bad))
        for cfg in (dict(alpha=0.0), dict(alpha=1.5), dict(depth_quantum=0.0),
                    dict(p_quantum=-1.0), dict(p_min=0.9, p_deep=0.5),
                    dict(p_deep=1.2)):
            with pytest.raises(ValueError):
                mod.OccupancyEstimator(**cfg)
        with pytest.raises(ValueError, match="@"):
            est.observe_value(0.0, 0.5, workload="bad@name")
        with pytest.raises(ValueError):
            est.observe_frames([0.0], [], g=4, r=2)


def test_cold_estimator_predicts_the_ports_prior():
    t = tfb.OccupancyEstimator()
    for d in DEPTHS:
        assert t.predict(d) == tplanner.effective_p_subdiv(d)
        assert t.measured(d) is None


# -- fed by the engines ------------------------------------------------------------

def test_observe_stats_from_batched_runs_matches_jax():
    """Both packages render the same batch, and their estimators, fed the
    per-frame chains, are JSON-equal."""
    jp, tp = JFrameProblem(**SMALL), FrameProblem(**SMALL, device="cpu")
    b = np.asarray([(-1.5, -1.0, 0.5, 1.0), (-8.0, -8.0, 8.0, 8.0),
                    (-0.8, 0.0, -0.6, 0.2)], np.float32)
    _, tst = ask.run_ask_scan_batch(tp, b, safety_factor=1e9)
    _, jst = j_scan_batch(jp, b, safety_factor=1e9)
    assert tst.frame_chains() == jst.frame_chains()
    ref_w = tp.bounds[2] - tp.bounds[0]
    depths = [tplanner.zoom_depth(float(x[2] - x[0]), ref_width=ref_w, r=2)
              for x in b]
    t, j = _pair()
    t.observe_stats(depths, tst, g=4, r=2, workload=tp.workload)
    j.observe_stats(depths, jst, g=4, r=2, workload=jp.workload)
    _assert_same(t, j)
    _, one = ask.run_ask_scan(tp, safety_factor=1e9)
    assert one.frame_chains() == ((one.region_counts, one.leaf_count),)


def test_observe_report_closes_the_loop_as_in_jax():
    """A planned run's report warms the estimator; the next plan over the
    same windows is measured in both packages; a hand-made plan's report
    (no estimates) is refused."""
    jp, tp = JFrameProblem(**SMALL), FrameProblem(**SMALL, device="cpu")
    bounds = [(-1.5, -1.0, 0.5, 1.0), (-5.0, -4.0, 3.0, 4.0)]
    t, j = _pair()
    _, trep = solve_batch(tp, bounds, plan=2, observed=t)
    _, jrep = j_solve_batch(jp, bounds, plan=2, observed=j)
    t.observe_report(trep, g=4, r=2)
    j.observe_report(jrep, g=4, r=2)
    _assert_same(t, j)
    assert t.workloads_observed() == ("mandelbrot",)
    _, trep2 = solve_batch(tp, bounds, plan=2, observed=t)
    _, jrep2 = j_solve_batch(jp, bounds, plan=2, observed=j)
    assert trep2.frame_p_source == jrep2.frame_p_source == \
        ("measured", "measured")
    assert trep2.frame_p_subdiv == jrep2.frame_p_subdiv
    for mod, prob, est in ((tplanner, tp, t), (jplanner, jp, j)):
        handmade = mod.CapacityPlan(
            buckets=(mod.BucketPlan(frames=(0, 1), p_subdiv=0.9,
                                    capacities=mod.worst_case_capacities(prob)),),
            estimates=(), safety_factor=1.0)
        _, rep3 = mod.solve_planned(prob, np.asarray(bounds, np.float32),
                                    plan=handmade)
        with pytest.raises(ValueError, match="estimates"):
            est.observe_report(rep3, g=4, r=2)
