"""The port's batched scan -- ``run_ask_scan_batch``, ``solve_batch``'s
default ``ask_scan`` engine, ``pad_frames`` and ``dispatch_batch`` --
against the JAX package on the CPU, mirroring tests/test_ask_scan.py.

JAX runs with its default kernels (``backend="pallas"``, interpret mode):
its batched frames take Q and A in ``jnp`` (traced bounds) and T through
the vmapped ``region_fill``. The port runs its plain versions (the tensors
lie on the CPU). Both get the same f32 bounds, in the traced spelling.

Tolerance: exact for every output. Canvases are equal pixel for pixel and
every ``ASKStats`` field equals JAX's (``levels``, ``kernel_launches``,
``region_counts``, ``leaf_count``, ``overflow_dropped``, ``frame_overflow``,
``frame_leaf_counts``, ``olt_caps``, ``ring_rows``), at the default sizing,
at worst-case capacities and at capacities small enough that frames
overflow, where the order of each frame's ring decides what drops. Sizes
are small: n <= 256, max_dwell <= 64.
"""

import numpy as np
import pytest
import torch

from repro.core.ask import pad_frames as j_pad_frames
from repro.core.ask import run_ask_scan_batch as j_scan_batch
from repro.core.feedback import OccupancyEstimator as JEstimator
from repro.workloads import EngineOptions as JEngineOptions
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import solve_batch as j_solve_batch
from repro_torch.core import ask, pooled
from repro_torch.core.feedback import OccupancyEstimator
from repro_torch.workloads import (EngineOptions, FrameProblem,
                                   dispatch_batch, solve_batch)

torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=256, g=4, r=2, B=16, max_dwell=64)
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")
# the default sizing, worst case, a uniform 8 rows a level (every frame
# drops roots and children), and per-level capacities that drop children
SIZING = {"default": {}, "worst": dict(safety_factor=1e9),
          "uniform8": dict(capacities=8), "levels": dict(capacities=(16, 30, 70))}


def _both(kw, workload="mandelbrot"):
    """(JAX's problem, the port's problem on the CPU)."""
    return (JFrameProblem(**kw, workload=workload),
            FrameProblem(**kw, workload=workload, device="cpu"))


def _frames(workload):
    """Four frames of one workload: its default window, two zooms into it,
    and a window far outside the set, which empties after level 0."""
    re0, im0, re1, im1 = FrameProblem(n=64, g=4, B=16, workload=workload,
                                      device="cpu").bounds
    cx, cy, w = (re0 + re1) / 2, (im0 + im1) / 2, re1 - re0
    return np.asarray([(re0, im0, re1, im1),
                       (cx - w / 8, cy - w / 8, cx + w / 8, cy + w / 8),
                       (re0 + w / 4, cy, re0 + w / 2, cy + w / 4),
                       (40.0, 40.0, 41.0, 41.0)], np.float32)


def _assert_same(got, want):
    canvas, stats = got
    want_canvas, want_stats = want
    assert canvas.dtype == torch.int32 and canvas.device.type == "cpu"
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(want_stats, f), f
    assert stats.frame_chains() == want_stats.frame_chains()


@pytest.mark.parametrize("sizing", SIZING)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_scan_batch_matches_jax(workload, sizing):
    jp, tp = _both(SMALL, workload)
    b = _frames(workload)
    kw = SIZING[sizing]
    got = ask.run_ask_scan_batch(tp, b, **kw)
    _assert_same(got, j_scan_batch(jp, b, **kw))
    st = got[1]
    assert st.kernel_launches == 1 and got[0].shape == (4, 256, 256)
    # the far frame empties at level 0
    assert st.region_counts[3] == (min(16, st.olt_caps[0]),)
    if sizing == "worst":
        assert st.overflow_dropped == 0
    if sizing in ("uniform8", "levels"):
        assert sum(1 for d in st.frame_overflow if d) >= 2


@pytest.mark.parametrize("spelling", ["legacy", "options", "name"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_solve_batch_default_engine_matches_jax(workload, spelling):
    """No engine named (the legacy flat kwargs), EngineOptions and the
    engine's name all run the batched scan: JAX's run_ask_scan_batch."""
    jp, tp = _both(SMALL, workload)
    b = _frames(workload)
    want = j_scan_batch(jp, b)
    if spelling == "legacy":
        got = solve_batch(tp, b, block_until_ready=True)
    elif spelling == "options":
        got = solve_batch(tp, b, options=EngineOptions(engine="ask_scan"))
    else:
        got = solve_batch(tp, b, options="ask_scan")
    _assert_same(got, want)


def test_hot_window_overflow_matches_jax():
    """The hot window of tests/test_ask_scan.py at test size (g=2 on the
    default window: the constant-P sizing runs hot): frame 0 overflows at
    the default sizing exactly as in JAX, and worst-case capacities drop
    nothing."""
    kw = dict(n=256, g=2, r=2, B=16, max_dwell=64)
    b = np.asarray([(-2.0, -1.5, 1.0, 1.5), (-0.8, -0.2, -0.4, 0.2)],
                   np.float32)
    jp, tp = _both(kw)
    got = ask.run_ask_scan_batch(tp, b)
    _assert_same(got, j_scan_batch(jp, b))
    assert got[1].frame_overflow[0] > 0 and got[1].frame_overflow[1] == 0
    worst = ask.run_ask_scan_batch(tp, b, safety_factor=1e9)
    _assert_same(worst, j_scan_batch(jp, b, safety_factor=1e9))
    assert worst[1].overflow_dropped == 0
    assert torch.equal(worst[0][1], got[0][1])  # the frame with no drop


@pytest.mark.parametrize("kw", [dict(n=64, g=2, r=2, B=64, max_dwell=16),
                                dict(n=64, g=4, r=2, B=16, max_dwell=16)],
                         ids=["zero-levels", "roots-are-leaves"])
def test_levels_zero_chain_matches_jax(kw):
    """n/g <= B: no exploration level; the roots are the leaves of every
    frame (test_levels_zero_chain), also at a uniform capacity below g^2."""
    b = np.asarray([(-2.0, -1.5, 1.0, 1.5), (-1.0, -0.5, 0.0, 0.5)], np.float32)
    jp, tp = _both(kw)
    for sizing in ({}, dict(capacities=3)):
        got = ask.run_ask_scan_batch(tp, b, **sizing)
        _assert_same(got, j_scan_batch(jp, b, **sizing))
        assert got[1].region_counts == ((), ()) and got[1].levels == 0


def test_scan_batch_equals_pooled_batch_at_worst_case():
    """With nothing dropped both batched engines render each frame alike:
    the same canvases, counts and leaves (the rings differ)."""
    kw = dict(n=192, g=3, r=2, B=12, max_dwell=48)
    tp = FrameProblem(**kw, device="cpu")
    b = _frames("mandelbrot")
    scan, st = ask.run_ask_scan_batch(tp, b, safety_factor=1e9)
    pool, pst = pooled.run_ask_pooled_batch(tp, b, safety_factor=1e9)
    assert torch.equal(scan, pool)
    assert st.region_counts == pst.region_counts
    assert st.frame_leaf_counts == pst.frame_leaf_counts
    assert st.overflow_dropped == pst.overflow_dropped == 0


def test_scan_batch_accepts_tensor_and_list_bounds():
    tp = FrameProblem(**SMALL, device="cpu")
    b = _frames("mandelbrot")[:2]
    want, _ = ask.run_ask_scan_batch(tp, b)
    for spelled in (torch.from_numpy(b), b.tolist()):
        got, _ = ask.run_ask_scan_batch(tp, spelled)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"\[F, 4\]"):
        ask.run_ask_scan_batch(tp, np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="capacities"):
        ask.run_ask_scan_batch(tp, b, capacities=(4, 4))


def test_pad_frames_matches_jax():
    """Frame 0 repeats up to the multiple, as JAX's pad_frames does, for a
    numpy array and a tensor."""
    b = np.arange(12, dtype=np.float32).reshape(3, 4)
    for multiple in (1, 3, 4, 8):
        want, wf = j_pad_frames(b, multiple)
        got, f = ask.pad_frames(b, multiple)
        assert f == wf == 3
        np.testing.assert_array_equal(got, np.asarray(want))
        got_t, _ = ask.pad_frames(torch.from_numpy(b), multiple)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))
    same, _ = ask.pad_frames(b, 3)
    assert same is b
    for fn in (ask.pad_frames, j_pad_frames):
        with pytest.raises(ValueError):
            fn(b, 0)
    with pytest.raises(ValueError, match="frame axis"):
        ask.pad_frames(np.float32(1.0), 2)


def test_observed_without_plan_matches_jax():
    """observed= alone sizes the scan from the hottest frame's measured P
    and the pooled ring from each frame's, as JAX threads it."""
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=32)
    jp, tp = _both(kw)
    b = _frames("mandelbrot")
    jest, est = JEstimator(), OccupancyEstimator()
    for e, wl in ((jest, jp.workload), (est, tp.workload)):
        e.observe_value(0.0, 0.45, workload=wl)
        e.observe_value(-1.0, 0.35, workload=wl)
    for engine in ("ask_scan", "ask_pooled"):
        for quantize in (None, True):
            got = solve_batch(tp, b, options=EngineOptions(
                engine=engine, observed=est, quantize=quantize))
            want = j_solve_batch(jp, b, options=JEngineOptions(
                engine=engine, observed=jest, quantize=quantize))
            _assert_same(got, want)
    got = solve_batch(tp, b, observed=est, ref_width=1.0)
    _assert_same(got, j_solve_batch(jp, b, observed=jest, ref_width=1.0))


def test_kwarg_conflicts_raise_as_in_jax():
    tp = FrameProblem(**SMALL, device="cpu")
    jp = JFrameProblem(**SMALL)
    b = _frames("mandelbrot")[:2]
    cases = [
        (dict(options="ask_scan", safety_factor=2.0), "not both"),
        (dict(options=EngineOptions(), plan=True), "not both"),
        (dict(quantize=True), "quantize"),
        (dict(observed="EST", capacities=8), "conflict with observed"),
        (dict(observed="EST", p_subdiv=0.5), "conflict with observed"),
        (dict(plan=2, p_subdiv=0.8), "uniform path"),
        (dict(plan=2, capacities=(4, 4)), "uniform path"),
        (dict(options=EngineOptions(engine="ask_pooled", plan=3)),
         "does not apply"),
        (dict(options=EngineOptions(engine="ask_pooled", plan=True,
                                    num_buckets=2)), "do not apply"),
    ]
    for kw, match in cases:
        for fn, prob, est in ((solve_batch, tp, OccupancyEstimator()),
                              (j_solve_batch, jp, JEstimator())):
            kw_ = {k: (est if v == "EST" else v) for k, v in kw.items()}
            if isinstance(kw_.get("options"), EngineOptions) and \
                    fn is j_solve_batch:
                o = kw_["options"]
                kw_["options"] = JEngineOptions(engine=o.engine, plan=o.plan,
                                                num_buckets=o.num_buckets)
            with pytest.raises(ValueError, match=match):
                fn(prob, b, **kw_)
    with pytest.raises(ValueError, match=r"\[F, 4\]"):
        solve_batch(tp, np.zeros((2, 3), np.float32))


def test_what_later_slices_bring_raises_naming_them():
    """The tuned tier (slice 11) raises naming its slice; the sharded
    frames (slice 12) are ported: a mesh runs every engine and the
    planner, equal to the unsharded batch (tests/test_torch_sharded.py
    holds them against JAX)."""
    from repro_torch.launch.mesh import make_frames_mesh
    tp = FrameProblem(n=64, g=4, B=16, max_dwell=16, device="cpu")
    b = np.asarray([tp.bounds], np.float32)
    with pytest.raises(NotImplementedError, match="slice 11"):
        solve_batch(tp, b, options="ask_tuned")
    mesh = make_frames_mesh(device="cpu")
    for engine in ("ask_scan", "ask_pooled"):
        got, st = solve_batch(tp, b, options=EngineOptions(engine=engine,
                                                           mesh=mesh))
        want, wst = solve_batch(tp, b, options=engine)
        assert torch.equal(got, want) and st.region_counts == wst.region_counts
    got, rep = solve_batch(tp, b, mesh=mesh, plan=True)
    assert torch.equal(got, solve_batch(tp, b, plan=True)[0])
    for fn in (ask.run_ask_scan_sharded,
               lambda *a, **k: ask.dispatch_ask_scan_sharded(*a, **k)
               .finalize()):
        assert torch.equal(fn(tp, b, mesh=mesh)[0],
                           ask.run_ask_scan_batch(tp, b)[0])


def test_dispatch_batch_needs_a_mesh_as_in_jax():
    """Without a mesh, JAX's ValueError; with one, an in-flight sharded
    batch whose ``finalize()`` is solve_batch's result."""
    from repro_torch.core import pooled as tpooled
    from repro_torch.launch.mesh import make_frames_mesh
    from repro.workloads import dispatch_batch as j_dispatch_batch
    tp = FrameProblem(n=64, g=4, B=16, max_dwell=16, device="cpu")
    jp = JFrameProblem(n=64, g=4, B=16, max_dwell=16)
    b = np.asarray([tp.bounds], np.float32)
    for fn, prob in ((dispatch_batch, tp), (j_dispatch_batch, jp)):
        with pytest.raises(ValueError, match="needs a mesh"):
            fn(prob, b)
        with pytest.raises(ValueError, match="needs a mesh"):
            fn(prob, b, options="ask_pooled")
        with pytest.raises(ValueError, match="not both"):
            fn(prob, b, options="ask_scan", safety_factor=2.0)
    mesh = make_frames_mesh(device="cpu")
    d = dispatch_batch(tp, b, mesh=mesh)
    assert isinstance(d, ask.ShardedDispatch)
    assert torch.equal(d.finalize()[0], solve_batch(tp, b)[0])
    d = dispatch_batch(tp, b, options=EngineOptions(engine="ask_pooled",
                                                     mesh=mesh))
    assert isinstance(d, tpooled.PooledDispatch)
    assert torch.equal(d.finalize()[0], solve_batch(tp, b,
                                                    options="ask_pooled")[0])


@pytest.mark.parametrize("module", ["", ".exhaustive", ".mariani_silver"])
def test_mandelbrot_shims_export_what_jax_exports(module):
    import importlib

    j = importlib.import_module("repro.mandelbrot" + module)
    t = importlib.import_module("repro_torch.mandelbrot" + module)
    assert sorted(t.__all__) == sorted(j.__all__)
    from repro_torch.workloads import frame_problem
    for name in t.__all__:
        assert getattr(t, name) is getattr(frame_problem, name)


def test_core_and_package_export_the_batched_slice():
    import repro.core as jcore
    import repro_torch
    import repro_torch.core as tcore
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in ("run_ask_scan_batch", "plan_capacities", "solve_planned",
                 "OccupancyEstimator", "CapacityPlan", "PlanReport",
                 "dispatch_batch", "solve_batch"):
        assert name in repro_torch.__all__ and hasattr(repro_torch, name)
