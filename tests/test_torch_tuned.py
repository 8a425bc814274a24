"""The port's tuned engine (``ask_tuned``) against the JAX package's, on
the CPU: one frame, batches, the planner and serving.

Both packages route every kernel through their tuned tier. On the CPU
JAX's heuristics pick its jnp lowering and the port's its plain versions
(a tuned cache of the port's, written by its own ``tune_problem``, is
read too); the tier changes a schedule, never a result. The configs are
BENCH_6.json's (n=256, g=4, r=2, B=16, max_dwell=64, the five registry
workloads) and BENCH_10.json's (its 6-frame zoom ladders of mandelbrot and
julia). Tolerance: exact. Canvases are equal pixel for pixel and every
``ASKStats`` / ``PlanReport`` / ``RenderStats`` field equals JAX's. JAX's
sharded path is held on a 1-device mesh built with Auto axes (R1).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_planner import _same_run  # noqa: E402

from repro.kernels import autotune as jat  # noqa: E402
from repro.launch import render_service as jrs  # noqa: E402
from repro.workloads import EngineOptions as JEngineOptions  # noqa: E402
from repro.workloads import FrameProblem as JFrameProblem  # noqa: E402
from repro.workloads import dispatch_batch as j_dispatch_batch  # noqa: E402
from repro.workloads import solve as j_solve  # noqa: E402
from repro.workloads import solve_batch as j_solve_batch  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.policy import (TUNED_POLICY, Backend,  # noqa: E402
                                        KernelPolicy)
from repro_torch.launch import render_service as trs  # noqa: E402
from repro_torch.launch.mesh import make_frames_mesh  # noqa: E402
from repro_torch.workloads import (EngineOptions, FrameProblem,  # noqa: E402
                                   dispatch_batch, solve, solve_batch)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BENCH6 = json.loads((ROOT / "BENCH_6.json").read_text())
BENCH10 = json.loads((ROOT / "BENCH_10.json").read_text())
CONFIG = {k: BENCH6["config"][k] for k in ("n", "g", "r", "B", "max_dwell")}
WORKLOADS = tuple(BENCH6["workloads"])  # the five registry workloads
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")
SIZING = {"worst": dict(safety_factor=1e9), "default": {}}


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.clear_memo()
    jat.clear_memo()
    yield
    autotune.clear_memo()
    jat.clear_memo()


def _both(workload, **kw):
    """(JAX's problem, the port's problem on the CPU) at BENCH_6's config."""
    return (JFrameProblem(**CONFIG, workload=workload, backend="jnp", **kw),
            FrameProblem(**CONFIG, workload=workload, device="cpu"))


def _same(got, want):
    canvas, stats = got
    want_canvas, want_stats = want
    assert canvas.dtype == torch.int32 and canvas.device.type == "cpu"
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(want_stats, f), f


def _ladder(problem, frames):
    """BENCH_10's zoom ladder: ``frames`` windows about the problem's
    centre, each 1.35x narrower (benchmarks/bench_ask_scan.py)."""
    b = np.asarray(problem.bounds, np.float64)
    c = (b[:2] + b[2:]) / 2.0
    w0 = b[2] - b[0]
    return [(c[0] - w / 2, c[1] - w / 2, c[0] + w / 2, c[1] + w / 2)
            for w in (w0 / 1.35 ** k for k in range(frames))]


# ---------------------------------------------------------------------------
# one frame


@pytest.mark.parametrize("sizing", list(SIZING))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_ask_tuned_matches_jax(workload, sizing):
    """BENCH_6.json's acceptance bar, on the CPU: ``ask_tuned`` equals
    JAX's ``ask_tuned`` (canvas and every ASKStats field) and the port's
    ``ask_scan``, one dispatch, at worst-case and default sizing."""
    jp, tp = _both(workload)
    kw = SIZING[sizing]
    got = solve(tp, "ask_tuned", **kw)
    _same(got, j_solve(jp, "ask_tuned", **kw))
    scan = solve(tp, "ask_scan", **kw)
    assert torch.equal(got[0], scan[0]) and got[1].kernel_launches == 1
    assert got[1].region_counts == scan[1].region_counts
    if sizing == "worst":
        row = BENCH6["workloads"][workload]
        assert (got[1].kernel_launches, got[1].ring_rows, 1) == (
            row["dispatches"], row["ring_rows"], row["identical"])


def test_ask_tuned_reads_a_port_cache(tmp_path):
    """A cache written by the port's ``tune_problem`` routes ``ask_tuned``
    (its entries are read, not the heuristics), and the canvas is JAX's."""
    jp, tp = _both("mandelbrot")
    cache = autotune.tune_problem(tp, reps=1, tiny=True)
    path = tmp_path / "tc.json"
    cache.save(str(path))
    pol = KernelPolicy(tuning_cache=str(path))
    tuned = dataclasses.replace(tp, policy=pol)
    got = solve(tuned, "ask_tuned", safety_factor=1e9)
    _same(got, j_solve(jp, "ask_tuned", safety_factor=1e9))
    key = autotune.cache_key("region_dwell", workload=tp.workload,
                             device="cpu", side=16, n=256, max_dwell=64)
    assert (str(path.resolve()), key) in autotune._MEMO
    assert autotune._MEMO[(str(path.resolve()), key)].source == "cache"


def test_ask_tuned_problem_keys_its_own_graph():
    """The tuned problem's graph key differs from the scan's (the policy is
    part of it), so a card never replays the default's graph for it."""
    _, tp = _both("mandelbrot")
    tuned = dataclasses.replace(tp, policy=tp.policy.with_backend("tuned"))
    assert tuned.policy.backend is Backend.TUNED and tuned.backend == "tuned"
    assert tuned.graph_key() != tp.graph_key()
    cached = dataclasses.replace(tuned, policy=KernelPolicy(
        backend="tuned", tuning_cache="tc.json"))
    assert len({tp.graph_key(), tuned.graph_key(), cached.graph_key()}) == 3


# ---------------------------------------------------------------------------
# batches and the planner


@pytest.mark.parametrize("sizing", ["default", "worst", "overflow"])
@pytest.mark.parametrize("workload", tuple(BENCH10["workloads"]))
def test_solve_batch_ask_tuned_matches_jax(workload, sizing):
    """``solve_batch(engine="ask_tuned")`` on BENCH_10.json's zoom ladder
    equals JAX's, ring rows and overflow included (a uniform 8 rows a
    level makes frames drop)."""
    jp, tp = _both(workload)
    bounds = np.asarray(_ladder(tp, BENCH10["config"]["frames"]), np.float32)
    kw = {"default": {}, "worst": dict(safety_factor=1e9),
          "overflow": dict(capacities=(8, 8, 8))}[sizing]
    got = solve_batch(tp, bounds, options=EngineOptions(engine="ask_tuned", **kw))
    _same(got, j_solve_batch(jp, bounds, options=JEngineOptions(
        engine="ask_tuned", **kw)))
    want = solve_batch(tp, bounds, **kw)
    assert torch.equal(got[0], want[0])
    if sizing == "overflow":
        assert got[1].overflow_dropped > 0


@pytest.mark.parametrize("workload", tuple(BENCH10["workloads"]))
def test_bench10_pooled_tuned_matches_jax_and_the_file(workload):
    """BENCH_10.json's own recipe: the pooled engine planned under the
    tuned policy equals JAX's (canvases and every PlanReport field), equals
    the default policy's, and gives the file's dispatches, ring rows and
    overflow."""
    jp, tp = _both(workload)
    bounds = _ladder(tp, BENCH10["config"]["frames"])
    opts = dict(engine="ask_pooled", plan=True, policy="tuned")
    got = solve_batch(tp, bounds, options=EngineOptions(**opts))
    _same_run(got, j_solve_batch(jp, bounds, options=JEngineOptions(**opts)))
    base, _ = solve_batch(tp, bounds, options=EngineOptions(
        engine="ask_pooled", plan=True))
    assert torch.equal(got[0], base)
    row = BENCH10["workloads"][workload]
    rep = got[1]
    assert (rep.dispatches, rep.ring_rows, rep.overflow_dropped, 1) == (
        row["dispatches"], row["ring_rows"], row["overflow"], row["identical"])


@pytest.mark.parametrize("plan", [True, 2])
def test_planned_ask_tuned_matches_jax(plan):
    """``plan=`` with ``engine="ask_tuned"``: a tuned-tier problem plans,
    dispatches and retries as JAX's does."""
    jp, tp = _both("mandelbrot")
    bounds = _ladder(tp, 6)[::-1] + [(-2.5, -2.5, 2.5, 2.5)]
    got = solve_batch(tp, bounds, options=EngineOptions(engine="ask_tuned",
                                                        plan=plan))
    _same_run(got, j_solve_batch(jp, bounds, options=JEngineOptions(
        engine="ask_tuned", plan=plan)))


def test_engine_options_apply_to_switches_policy():
    _, tp = _both("mandelbrot")
    tuned = EngineOptions(engine="ask_tuned").apply_to(tp)
    assert tuned.policy.backend is Backend.TUNED
    assert EngineOptions().apply_to(tp) is tp  # no-op pass-through
    pol = KernelPolicy(backend="torch")
    assert EngineOptions(policy=pol).apply_to(tp).policy == pol
    assert EngineOptions(engine="ask_tuned", policy=pol).apply_to(
        tp).policy == pol.with_backend("tuned")
    assert EngineOptions(policy="tuned").policy == TUNED_POLICY
    opts = EngineOptions.from_kwargs({"policy": "tuned", "plan": 2})
    assert opts.policy == TUNED_POLICY and opts.engine_kwargs() == {}
    with pytest.raises(ValueError, match="backend"):
        EngineOptions(policy="pallas")


def test_engine_options_legacy_equivalence_with_policy():
    """``options=`` carries the routing; as in JAX, the legacy flat path
    takes no ``policy=`` (the engine refuses the keyword)."""
    jp, tp = _both("julia")
    bb = np.array([list(tp.bounds), [-0.8, -0.8, 0.8, 0.8]], np.float32)
    base, _ = solve_batch(tp, bb)
    tuned, _ = solve_batch(tp, bb, options=EngineOptions(engine="ask_tuned"))
    routed, _ = solve_batch(tp, bb, options=EngineOptions(policy="tuned"))
    assert torch.equal(base, tuned) and torch.equal(base, routed)
    with pytest.raises(TypeError, match="policy"):
        solve_batch(tp, bb, policy="tuned")
    with pytest.raises(TypeError, match="policy"):
        j_solve_batch(jp, bb, policy="tuned")


# ---------------------------------------------------------------------------
# sharded frames and serving


@pytest.fixture(scope="module")
def meshes():
    """(JAX's 1-device Auto-axis frames mesh, the port's 1-shard CPU mesh)."""
    jm = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    return jm, make_frames_mesh(device="cpu")


@pytest.mark.parametrize("engine", ["ask_tuned", "ask_pooled"])
def test_sharded_tuned_matches_jax(meshes, engine):
    """The sharded batch and ``dispatch_batch`` under the tuned tier equal
    JAX's sharded functions (their handles' ``finalize``)."""
    jm, tm = meshes
    jp, tp = _both("julia")
    bounds = np.asarray(_ladder(tp, 3), np.float32)
    pol = {} if engine == "ask_tuned" else dict(policy="tuned")
    got = solve_batch(tp, bounds, options=EngineOptions(engine=engine, mesh=tm,
                                                        **pol))
    want = j_solve_batch(jp, bounds, options=JEngineOptions(
        engine=engine, mesh=jm, **pol))
    _same(got, want)
    handle = dispatch_batch(tp, bounds, options=EngineOptions(
        engine=engine, mesh=tm, **pol))
    _same(handle.finalize(), j_dispatch_batch(jp, bounds, options=JEngineOptions(
        engine=engine, mesh=jm, **pol)).finalize())


@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_render_service_tuned_matches_jax(meshes, engine):
    """``RenderService(policy=TUNED_POLICY)`` gives JAX's frames and
    RenderStats with the same policy, and the untuned service's frames."""
    jm, tm = meshes
    jp, tp = _both("mandelbrot")
    bounds = list(jrs.zoom_bounds(6))
    kw = dict(chunk_frames=2, pipeline_depth=2, engine=engine,
              safety_factor=1e9)
    ts = trs.RenderService(tp, mesh=tm, policy=TUNED_POLICY, **kw)
    js = jrs.RenderService(jp, mesh=jm, policy="tuned", **kw)
    assert ts.problem.policy == TUNED_POLICY
    assert js.problem.policy.backend.value == "tuned"
    (gc, grs), (wc, wrs) = ts.render(bounds), js.render(bounds)
    np.testing.assert_array_equal(gc, wc)
    for f in ("frames", "chunks", "dispatches", "leaf_count",
              "overflow_dropped", "pipeline_depth", "retries", "ring_rows",
              "plan_signatures"):
        assert getattr(grs, f) == getattr(wrs, f), f
    base, _ = trs.RenderService(tp, mesh=tm, **kw).render(bounds)
    np.testing.assert_array_equal(gc, base)


def test_render_service_feedback_tuned_matches_jax(meshes):
    """The feedback path (the planner inside the service) under the tuned
    policy: JAX's chunks, retries and ring rows."""
    jm, tm = meshes
    jp, tp = _both("mandelbrot")
    bounds = list(jrs.zoom_bounds(8, center=(-0.7436447860, 0.1318252536),
                                  width0=6.0, zoom_per_frame=1.05))
    kw = dict(chunk_frames=4, feedback=True, safety_factor=1.1, policy="tuned")
    (gc, grs) = trs.RenderService(tp, mesh=tm, **kw).render(bounds)
    (wc, wrs) = jrs.RenderService(jp, mesh=jm, **kw).render(bounds)
    np.testing.assert_array_equal(gc, wc)
    for f in ("chunks", "dispatches", "retries", "ring_rows",
              "overflow_dropped", "plan_signatures"):
        assert getattr(grs, f) == getattr(wrs, f), f
