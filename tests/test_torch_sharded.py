"""The port's sharded frames -- ``launch.mesh.make_frames_mesh``,
``run_ask_scan_sharded`` / ``dispatch_ask_scan_sharded``,
``run_ask_pooled_sharded`` / ``dispatch_ask_pooled_sharded``,
``solve_batch(mesh=)``, ``dispatch_batch`` and the planners' mesh arms --
against JAX's on the CPU.

JAX's mesh is built here with ``jax.make_mesh(..., axis_types=(AxisType.
Auto,))``, never through ``repro.launch.mesh.make_frames_mesh``: on jax
0.9 that one's axes default to Explicit, under which JAX's own
``ShardedDispatch.finalize`` raises on its ``x[:F]`` (ROADMAP R1). With
Auto axes JAX's sharded functions run and are the reference. In this
process JAX sees one CPU device, so the in-process tests hold a 1-shard
port mesh (``make_frames_mesh(device="cpu")``) against a 1-device JAX
mesh; one subprocess test forces 4 host devices for JAX and holds a
4-shard CPU mesh of the port against them.

JAX's problems use ``backend="jnp"`` (its batched frames take Q and A in
jnp anyway; T in jnp keeps the compiles short), the port its plain
versions. Tolerance: exact. Canvases are equal pixel for pixel and every
``ASKStats`` / ``PlanReport`` field equals JAX's, undersized rings
included. Sizes: n=128, g=4, r=2, B=16, max_dwell=32.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import ask as jask
from repro.core import pooled as jpooled
from repro.workloads import EngineOptions as JEngineOptions
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import dispatch_batch as j_dispatch_batch
from repro.workloads import solve_batch as j_solve_batch
from repro_torch.core import ask, pooled
from repro_torch.launch.mesh import FramesMesh, make_frames_mesh
from repro_torch.workloads import (EngineOptions, FrameProblem,
                                   dispatch_batch, solve_batch)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=128, g=4, r=2, B=16, max_dwell=32)
FRAMES = (1, 3, 4, 7)
PADS = (None, 8)
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")
REPORT_FIELDS = ("frames", "dispatches", "retries", "retried_frames",
                 "overflow_dropped", "leaf_count", "region_counts",
                 "frame_leaf_counts", "frame_p_subdiv", "frame_p_source",
                 "ring_rows", "ring_bytes")
# the scan's rings: the default sizing, and one that drops children
SCAN_SIZING = ({}, dict(capacities=(16, 24)))


@pytest.fixture(scope="module")
def meshes():
    """(JAX's 1-device Auto-axis frames mesh, the port's 1-shard CPU mesh).
    Not repro.launch.mesh.make_frames_mesh: its Explicit axes fail (R1)."""
    jm = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    return jm, make_frames_mesh(device="cpu")


def _both(workload):
    return (JFrameProblem(**SMALL, workload=workload, backend="jnp"),
            FrameProblem(**SMALL, workload=workload, device="cpu"))


def _frames(workload, F):
    """F distinct windows of one workload: its default window, zooms into
    it, quarters of it and a window far outside the set."""
    re0, im0, re1, im1 = FrameProblem(n=64, g=4, B=16, workload=workload,
                                      device="cpu").bounds
    cx, cy, w = (re0 + re1) / 2, (im0 + im1) / 2, re1 - re0
    z = [(re0, im0, re1, im1),
         (cx - w / 8, cy - w / 8, cx + w / 8, cy + w / 8),
         (re0 + w / 4, cy, re0 + w / 2, cy + w / 4),
         (40.0, 40.0, 41.0, 41.0),
         (cx + w / 10, cy - w / 16, cx + w / 10 + w / 8, cy + w / 16),
         (re0, im0, cx, cy),
         (cx, cy, re1, im1),
         (cx - w / 32, cy + w / 20, cx + w / 32, cy + w / 20 + w / 16)]
    return np.asarray(z[:F], np.float32)


def _same(got, want):
    """(canvases, ASKStats) of the port against JAX's."""
    canvas, stats = got
    want_canvas, want_stats = want
    assert canvas.dtype == torch.int32 and canvas.device.type == "cpu"
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(want_stats, f), f


def _same_report(got, want):
    """(canvases, PlanReport) of the port against JAX's."""
    canvas, rep = got
    want_canvas, want_rep = want
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    assert dataclasses.asdict(rep.plan) == dataclasses.asdict(want_rep.plan)
    for f in REPORT_FIELDS:
        assert getattr(rep, f) == getattr(want_rep, f), f
    assert len(rep.bucket_stats) == len(want_rep.bucket_stats)
    for a, b in zip(rep.bucket_stats, want_rep.bucket_stats):
        for f in STAT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f


# -- the frames mesh --------------------------------------------------------------

def test_make_frames_mesh(monkeypatch):
    """CPU shards for the tests; on the card every visible device; and no
    quiet CPU mesh when the card is missing."""
    m = make_frames_mesh(device="cpu")
    assert m.size == 1 and m.axis_names == ("frames",)
    m = make_frames_mesh(3, axis_name="f", device="cpu")
    assert m.devices == (torch.device("cpu"),) * 3 and m.axis_names == ("f",)
    with pytest.raises(ValueError):
        make_frames_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_frames_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        make_frames_mesh(1, device="cuda")


# -- the engines on one shard -------------------------------------------------------

@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_scan_sharded_matches_jax(meshes, workload, F):
    """run_ask_scan_sharded and dispatch_ask_scan_sharded(...).finalize()
    with and without pad_to, at the default sizing and at rings that drop
    children."""
    jm, tm = meshes
    jp, tp = _both(workload)
    b = _frames(workload, F)
    for pad in PADS:
        for kw in SCAN_SIZING:
            want = jask.run_ask_scan_sharded(jp, b, mesh=jm, pad_to=pad, **kw)
            got = ask.run_ask_scan_sharded(tp, b, mesh=tm, pad_to=pad, **kw)
            _same(got, want)
            d = ask.dispatch_ask_scan_sharded(tp, b, mesh=tm, pad_to=pad, **kw)
            assert isinstance(d, ask.ShardedDispatch)
            # one shard, padded to the multiple pad_to asks for
            assert len(d.shards) == 1
            assert d.shards[0][0].shape[0] == F + (-F) % (pad or 1)
            _same(d.finalize(), jask.dispatch_ask_scan_sharded(
                jp, b, mesh=jm, pad_to=pad, **kw).finalize())
            # and the unsharded batch, the same field for field
            _same(got, ask.run_ask_scan_batch(tp, b, **kw))
    # a ring that drops somewhere, for the overflow path
    assert any(ask.run_ask_scan_sharded(tp, b, mesh=tm, capacities=(16, 24))
               [1].frame_overflow) or F == 1


@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_solve_batch_and_dispatch_batch_with_mesh_match_jax(meshes, workload,
                                                            F):
    """solve_batch(mesh=) and dispatch_batch, each in the legacy and the
    EngineOptions spelling, for both engines."""
    jm, tm = meshes
    jp, tp = _both(workload)
    b = _frames(workload, F)
    for engine in ("ask_scan", "ask_pooled"):
        want = j_solve_batch(jp, b, options=JEngineOptions(
            engine=engine, mesh=jm, pad_to=8))
        _same(solve_batch(tp, b, options=EngineOptions(
            engine=engine, mesh=tm, pad_to=8)), want)
        _same(dispatch_batch(tp, b, options=EngineOptions(
            engine=engine, mesh=tm, pad_to=8)).finalize(), want)
    want = j_solve_batch(jp, b, mesh=jm, safety_factor=1e9)
    _same(solve_batch(tp, b, mesh=tm, safety_factor=1e9), want)
    _same(dispatch_batch(tp, b, mesh=tm, safety_factor=1e9).finalize(),
          j_dispatch_batch(jp, b, mesh=jm, safety_factor=1e9).finalize())
    assert want[1].overflow_dropped == 0


def test_sharded_errors_match_jax(meshes):
    """pad_to that is not a multiple of the mesh's size, and a mesh with
    two axes, raise JAX's ValueError with JAX's words."""
    jm, tm = meshes
    jp, tp = _both("mandelbrot")
    b = _frames("mandelbrot", 3)
    two = make_frames_mesh(2, device="cpu")
    for fn in (ask.run_ask_scan_sharded, pooled.run_ask_pooled_sharded,
               ask.dispatch_ask_scan_sharded,
               pooled.dispatch_ask_pooled_sharded):
        with pytest.raises(ValueError, match="pad_to=3 must be a multiple "
                           "of the mesh device count 2"):
            fn(tp, b, mesh=two, pad_to=3)
    with pytest.raises(ValueError, match="pad_to=3 must be a multiple"):
        dispatch_batch(tp, b, mesh=two, pad_to=3)
    j2 = jax.make_mesh((1, 1), ("a", "b"),
                       axis_types=(AxisType.Auto, AxisType.Auto))
    t2 = FramesMesh(tm.devices, ("a", "b"))
    for fn, prob, mesh in ((ask.run_ask_scan_sharded, tp, t2),
                           (jask.run_ask_scan_sharded, jp, j2),
                           (pooled.run_ask_pooled_sharded, tp, t2),
                           (jpooled.run_ask_pooled_sharded, jp, j2)):
        with pytest.raises(ValueError, match="1-D frames mesh"):
            fn(prob, b, mesh=mesh)
    with pytest.raises(ValueError, match="frame_ps covers"):
        pooled.run_ask_pooled_sharded(tp, b, mesh=tm, frame_ps=[0.5])
    with pytest.raises(ValueError, match="needs a mesh"):
        dispatch_batch(tp, b)
    with pytest.raises(NotImplementedError, match="slice 11"):
        dispatch_batch(tp, b, options=EngineOptions(engine="ask_tuned",
                                                    mesh=tm))


def test_shards_in_order_and_padding_masked():
    """On a 3-shard CPU mesh, shard d renders frames d*S .. (d+1)*S - 1 and
    the padded (dead) frames leave no trace: equal to the unsharded batch
    at every F, for both engines."""
    tp = FrameProblem(**SMALL, device="cpu")
    m3 = make_frames_mesh(3, device="cpu")
    for F in (1, 4, 7):
        b = _frames("mandelbrot", F)
        d = ask.dispatch_ask_scan_sharded(tp, b, mesh=m3, safety_factor=1e9)
        assert len(d.shards) == 3
        assert all(s[0].shape[0] == -(-F // 3) for s in d.shards)
        _same(d.finalize(), ask.run_ask_scan_batch(tp, b, safety_factor=1e9))
        got, st = pooled.run_ask_pooled_sharded(tp, b, mesh=m3,
                                                safety_factor=1e9)
        want, wst = pooled.run_ask_pooled_batch(tp, b, safety_factor=1e9)
        assert torch.equal(got, want)
        assert st.region_counts == wst.region_counts
        assert st.frame_leaf_counts == wst.frame_leaf_counts


def test_one_shard_canvas_is_not_copied():
    """On one device the canvas handed back is the shard's own, cut to F."""
    tp = FrameProblem(**SMALL, device="cpu")
    tm = make_frames_mesh(device="cpu")
    b = _frames("mandelbrot", 3)
    d = ask.dispatch_ask_scan_sharded(tp, b, mesh=tm, pad_to=4)
    shard = d.shards[0][0]
    got, _ = d.finalize()
    assert got.shape[0] == 3 and got.data_ptr() == shard.data_ptr()


def test_core_exports_the_sharded_slice():
    import repro.core as jcore
    import repro_torch.core as tcore
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert tcore.ShardedDispatch is ask.ShardedDispatch
    for name in ("PooledDispatch", "run_ask_pooled_sharded",
                 "dispatch_ask_pooled_sharded"):
        assert name in pooled.__all__ and name in jpooled.__all__


# -- four shards: one subprocess with four JAX host devices -----------------------

_K4 = """
import numpy as np, jax, torch
from jax.sharding import AxisType
from repro.core import ask as jask, planner as jplanner, pooled as jpooled
from repro.workloads import FrameProblem as JP
from repro_torch.core import ask, planner, pooled
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import FrameProblem as TP
torch.set_num_threads(1)
F_ = ("levels", "kernel_launches", "region_counts", "leaf_count",
      "overflow_dropped", "frame_overflow", "frame_leaf_counts", "olt_caps",
      "ring_rows")
R_ = ("dispatches", "retries", "retried_frames", "leaf_count",
      "region_counts", "frame_leaf_counts", "frame_p_subdiv", "ring_rows")

def same(got, want, fields=F_):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for f in fields:
        assert getattr(got[1], f) == getattr(want[1], f), (
            f, getattr(got[1], f), getattr(want[1], f))

assert len(jax.devices()) == 4
jm = jax.make_mesh((4,), ("frames",), axis_types=(AxisType.Auto,))
tm = make_frames_mesh(4, device="cpu")
kw = dict(n=128, g=4, r=2, B=16, max_dwell=32)
jp, tp = JP(**kw, backend="jnp"), TP(**kw, device="cpu")
allb = np.asarray([[-1.6 + 0.02 * i, -1.1, 0.55, 1.05] for i in range(8)],
                  np.float32)
allb[2] = (-0.8, 0.0, -0.6, 0.2)
allb[5] = (-0.77, 0.08, -0.71, 0.14)
for F in (1, 3, 4, 8):
    b = allb[:F]
    for sz in ({}, dict(capacities=(16, 24))):
        same(ask.run_ask_scan_sharded(tp, b, mesh=tm, **sz),
             jask.run_ask_scan_sharded(jp, b, mesh=jm, **sz))
    same(ask.dispatch_ask_scan_sharded(tp, b, mesh=tm, pad_to=8).finalize(),
         jask.dispatch_ask_scan_sharded(jp, b, mesh=jm, pad_to=8).finalize())
    ps = [0.95 if i in (2, 5) else 0.3 for i in range(F)]
    for sz in ({}, dict(frame_ps=ps), dict(capacities=(16, 40))):
        same(pooled.run_ask_pooled_sharded(tp, b, mesh=tm, **sz),
             jpooled.run_ask_pooled_sharded(jp, b, mesh=jm, **sz))
# the max over shards of each shard's own pooled caps
b = allb[:8]
ps = [0.95, 0.3, 0.3, 0.3, 0.3, 0.3, 0.95, 0.95]
got = pooled.run_ask_pooled_sharded(tp, b, mesh=tm, frame_ps=ps)
shard_caps = [pooled.pooled_capacities(tp, ps[2 * d:2 * d + 2])
              for d in range(4)]
assert got[1].olt_caps == tuple(max(c) for c in zip(*shard_caps))
assert got[1].olt_caps != shard_caps[1]  # a cool shard alone sizes less
# the planners' padded ring rows: 5 frames pad to 8 on 4 shards
b5 = allb[:5]
for t_fn, j_fn in ((planner.solve_planned, jplanner.solve_planned),
                   (planner.solve_pooled, jplanner.solve_pooled)):
    one = t_fn(tp, b5)
    four = t_fn(tp, b5, mesh=tm)
    same(four, j_fn(jp, b5, mesh=jm), R_)
    assert torch.equal(four[0], one[0])
    print("ring_rows", t_fn.__name__, one[1].ring_rows, four[1].ring_rows)
for fn in (ask.run_ask_scan_sharded, jask.run_ask_scan_sharded):
    try:
        fn(tp if fn is ask.run_ask_scan_sharded else jp, allb[:3],
           mesh=tm if fn is ask.run_ask_scan_sharded else jm, pad_to=6)
    except ValueError as e:
        assert "pad_to=6 must be a multiple of the mesh device count 4" in str(e)
    else:
        raise AssertionError("pad_to=6 on 4 devices did not raise")
print("OK")
"""


def test_four_shards_match_jax_on_four_host_devices():
    """One interpreter with XLA_FLAGS forcing 4 host devices: JAX's sharded
    engines on a 4-device Auto-axis mesh against the port's 4-shard CPU
    mesh, F in {1, 3, 4, 8}; the pooled caps are the max over shards of
    each shard's own with per-frame P; the planners' ring rows count the
    padded frames (5 frames: 640 unsharded, 1024 on 4 shards)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_K4)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "OK" in r.stdout
    rows = [line.split() for line in r.stdout.splitlines()
            if line.startswith("ring_rows")]
    assert [(a[1], int(a[2]), int(a[3])) for a in rows] == [
        ("solve_planned", 640, 1024), ("solve_pooled", 640, 1024)]
