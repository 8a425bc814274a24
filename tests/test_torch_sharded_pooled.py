"""The port's sharded pool (``run_ask_pooled_sharded`` /
``dispatch_ask_pooled_sharded``) and the planners' mesh arms
(``solve_planned`` / ``solve_pooled`` with a mesh) against JAX's on the
CPU, on a 1-shard CPU mesh against a 1-device JAX mesh built with Auto
axes; the conventions (and why not ``repro.launch.mesh.
make_frames_mesh``, ROADMAP R1) are tests/test_torch_sharded.py's, whose
helpers this file shares. Tolerance: exact, every ``ASKStats`` and
``PlanReport`` field. Sizes: n=128, g=4, r=2, B=16, max_dwell=32.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import planner as jplanner
from repro.core import pooled as jpooled
from repro.workloads import EngineOptions as JEngineOptions
from repro.workloads import solve_batch as j_solve_batch
from repro_torch.core import planner, pooled
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import EngineOptions, solve_batch
from test_torch_sharded import (FRAMES, PADS, WORKLOADS, _both, _frames,
                                _same, _same_report)

torch.set_num_threads(1)

# the pool's: default, uniform P, explicit (undersized) and per frame;
# with pad_to those that size from the shard's frames
POOL_SIZING = ({}, dict(p_subdiv=0.9), dict(capacities=(16, 40)), "frame_ps")
POOL_PADDED = ({}, "frame_ps")


@pytest.fixture(scope="module")
def meshes():
    """(JAX's 1-device Auto-axis frames mesh, the port's 1-shard CPU mesh)."""
    jm = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    return jm, make_frames_mesh(device="cpu")


def _pool_kw(sizing, F):
    if sizing == "frame_ps":  # a hot frame among cool ones
        return dict(frame_ps=[0.95 if i % 3 == 1 else 0.35 for i in range(F)])
    return sizing


@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_pooled_sharded_matches_jax(meshes, workload, F):
    """run_ask_pooled_sharded (and its dispatch) with default, uniform,
    explicit and per-frame (frame_ps) sizing; with pad_to the two that
    size from the shard's frames (a full shard, its live frames). The
    padded frames are dead rows."""
    jm, tm = meshes
    jp, tp = _both(workload)
    b = _frames(workload, F)
    for pad in PADS:
        for sizing in POOL_SIZING if pad is None else POOL_PADDED:
            kw = _pool_kw(sizing, F)
            want = jpooled.run_ask_pooled_sharded(jp, b, mesh=jm, pad_to=pad,
                                                  **kw)
            got = pooled.run_ask_pooled_sharded(tp, b, mesh=tm, pad_to=pad,
                                                **kw)
            _same(got, want)
            d = pooled.dispatch_ask_pooled_sharded(tp, b, mesh=tm,
                                                   pad_to=pad, **kw)
            assert isinstance(d, pooled.PooledDispatch) and len(d.shards) == 1
            _same(d.finalize(), want)


@pytest.mark.parametrize("F", FRAMES)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planners_with_mesh_match_jax(meshes, workload, F):
    """solve_planned and solve_pooled under a mesh (directly and through
    solve_batch), PlanReport field for field, ring rows included."""
    jm, tm = meshes
    jp, tp = _both(workload)
    b = _frames(workload, F)
    _same_report(planner.solve_planned(tp, b, mesh=tm, num_buckets=2),
                 jplanner.solve_planned(jp, b, mesh=jm, num_buckets=2))
    _same_report(planner.solve_pooled(tp, b, mesh=tm),
                 jplanner.solve_pooled(jp, b, mesh=jm))
    if F == 7:  # the solve_batch spellings, once a workload
        _same_report(solve_batch(tp, b, mesh=tm, plan=True),
                     j_solve_batch(jp, b, mesh=jm, plan=True))
        _same_report(
            solve_batch(tp, b, options=EngineOptions(
                engine="ask_pooled", plan=True, mesh=tm)),
            j_solve_batch(jp, b, options=JEngineOptions(
                engine="ask_pooled", plan=True, mesh=jm)))


def test_planners_retry_under_a_mesh_as_jax():
    """Frames that overflow their first dispatch retry under the mesh as
    in JAX: a tight safety factor on a sparse and dense mix."""
    jm = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    tm = make_frames_mesh(device="cpu")
    jp, tp = _both("mandelbrot")

    def window(cx, cy, w):
        return (cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2)

    b = np.asarray([window(-0.5, 0.0, w) for w in (16.0, 8.0, 4.0)]
                   + [window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k)
                      for k in (2, 4)], np.float32)
    for kw in (dict(num_buckets=2, safety_factor=0.3),
               dict(num_buckets=1, safety_factor=0.5)):
        got = planner.solve_planned(tp, b, mesh=tm, **kw)
        _same_report(got, jplanner.solve_planned(jp, b, mesh=jm, **kw))
    assert got[1].retries > 0
    for sf in (0.3, 0.6):
        got = planner.solve_pooled(tp, b, mesh=tm, safety_factor=sf)
        _same_report(got, jplanner.solve_pooled(jp, b, mesh=jm,
                                                safety_factor=sf))
    assert got[1].retries > 0
