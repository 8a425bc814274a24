"""The port's render service (``repro_torch.launch.render_service``)
against JAX's (``repro.launch.render_service``) on the CPU.

Both services stream the same trajectories: JAX's on a 1-device mesh built
with Auto axes (``jax.make_mesh(..., axis_types=(AxisType.Auto,))``; ROADMAP
R1), its problems on ``backend="jnp"``; the port's on
``make_frames_mesh(device="cpu")``, its problems on ``device="cpu"``. The
tolerance is exact: canvases equal pixel for pixel, and every
``RenderStats``, ``ChunkStats`` (its timings aside) and per-chunk
``ASKStats`` field equals JAX's, the feedback path's plans, retries and
ring rows included. ``program_traces`` is held equal to JAX's jit-cache
count where the problem is traced by that test alone (a ``max_dwell``
of its own, which no other test file uses); tests that share a problem
share JAX's compiled programs. The pipeline's schedule is held on the virtual-clock
harness of ``tests/fakes.py``, whose ``FakeEngine`` drives both services
unchanged. One subprocess holds a 4-shard CPU mesh against JAX on 4 host
devices. Sizes: n=128, g=4, r=2, B=16.
"""

import dataclasses
import json
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

from fakes import FakeEngine
from repro.launch import render_service as jrs
from repro.workloads import FrameProblem as JFrameProblem
from repro_torch.core.feedback import OccupancyEstimator
from repro_torch.launch import render_service as trs
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import FrameProblem, solve_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CHUNK_FIELDS = ("index", "frames", "in_flight", "p_subdiv", "p_source",
                "retries", "ring_rows", "workload", "tenants", "cache_hits",
                "cache_misses", "cache_bytes")
RENDER_FIELDS = ("frames", "chunks", "dispatches", "leaf_count",
                 "overflow_dropped", "pipeline_depth", "program_traces",
                 "retries", "ring_rows", "plan_signatures")
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps")
SKIM_CENTER = (-0.7436447860, 0.1318252536)


def _jmesh():
    return jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))


def _problems(dwell: int, workload: str = "mandelbrot", n: int = 128):
    kw = dict(n=n, g=4, r=2, B=16, max_dwell=dwell, workload=workload)
    return (JFrameProblem(**kw, backend="jnp"),
            FrameProblem(**kw, device="cpu"))


def _services(dwell: int, *, problems=None, **kw):
    """(JAX's service, the port's) over the same problem(s) and options."""
    jp, tp = _problems(dwell) if problems is None else problems
    kw.setdefault("chunk_frames", 4)
    kw.setdefault("safety_factor", 1e9)
    return (jrs.RenderService(jp, mesh=_jmesh(), **kw),
            trs.RenderService(tp, mesh=make_frames_mesh(device="cpu"), **kw))


def _fb_kw(**kw):
    kw.setdefault("feedback", True)
    kw.setdefault("safety_factor", 1.1)
    return kw


def _skim(frames=32):
    return list(jrs.zoom_bounds(frames, center=SKIM_CENTER, width0=6.0,
                                zoom_per_frame=1.02))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_chunk(got, want):
    for f in CHUNK_FIELDS:
        assert getattr(got, f) == getattr(want, f), (f, got, want)


def _same_stats(got, want):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (f, got, want)


def _same_render(got, want, *, traces: bool = True):
    """Two renders: canvases, RenderStats and ChunkStats. ``traces=False``
    leaves out ``program_traces``, which JAX counts over every service
    that traced the problem in this process, the port over this one."""
    (gc, grs), (wc, wrs) = got, want
    np.testing.assert_array_equal(gc, wc)
    for f in RENDER_FIELDS:
        if f != "program_traces" or traces:
            assert getattr(grs, f) == getattr(wrs, f), (f, grs, wrs)
    assert len(grs.chunk_stats) == len(wrs.chunk_stats)
    for g, w in zip(grs.chunk_stats, wrs.chunk_stats):
        _same_chunk(g, w)


def _same_stream(got, want):
    """Two ``stream_chunks`` lists: canvases, ASKStats and ChunkStats."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_host(g.canvases), _host(w.canvases))
        _same_stats(g.stats, w.stats)
        _same_chunk(g.chunk, w.chunk)


# ---------------------------------------------------------------------------
# the uniform stream
# ---------------------------------------------------------------------------

def test_defaults_and_constructor_errors():
    assert trs.DEFAULT_PIPELINE_DEPTH == jrs.DEFAULT_PIPELINE_DEPTH == 2
    assert trs.DEFAULT_FRAMES_PER_DEVICE == jrs.DEFAULT_FRAMES_PER_DEVICE
    _, tp = _problems(32)
    mesh = make_frames_mesh(device="cpu")
    svc = trs.RenderService(tp, mesh=mesh)
    assert svc.pipeline_depth == 2
    assert svc.chunk_frames == trs.DEFAULT_FRAMES_PER_DEVICE
    assert trs.RenderService(tp, mesh=make_frames_mesh(3, device="cpu"),
                             chunk_frames=4).chunk_frames == 6
    for kw, err, match in (
            (dict(pipeline_depth=0), ValueError, "pipeline_depth"),
            (dict(pad_to=8), ValueError, "pad_to"),
            (dict(engine="ask_tuned"), ValueError, "engine"),
            (dict(policy="warp"), ValueError, "backend"),
            (dict(adapt=False), ValueError, "feedback"),
            (dict(feedback=True, capacities=(8, 8, 8)), ValueError,
             "feedback"),
            (dict(feedback=True, p_subdiv=0.8), ValueError, "feedback")):
        with pytest.raises(err, match=match):
            trs.RenderService(tp, mesh=mesh, **kw)
    # policy= (slice 11) replaces the problem's kernel routing
    tuned = trs.RenderService(tp, mesh=mesh, policy="tuned")
    assert tuned.problem.policy.backend.value == "tuned"
    with pytest.raises(ValueError, match="feedback"):
        trs.RenderService({"a": tp}, mesh=mesh)  # mixed needs feedback
    with pytest.raises(ValueError, match="canvas size"):
        trs.RenderService({"a": tp, "b": dataclasses.replace(tp, n=64)},
                          mesh=mesh, feedback=True)


def test_no_mesh_means_the_card():
    """``RenderService(problem)`` with no mesh builds ``make_frames_mesh()``
    over the visible cards, which raises without one: nothing falls back
    to the CPU. So does the CLI."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh holds it")
    _, tp = _problems(32)
    with pytest.raises(RuntimeError, match="is_available"):
        trs.RenderService(tp)
    with pytest.raises(RuntimeError, match="is_available"):
        trs.main(["--frames", "4", "--n", "64"])


def test_stream_equals_jax():
    """19 frames, chunk 4: every chunk's canvases, ASKStats and ChunkStats
    equal JAX's at depth 3, frame order and in-flight counts included; the
    synchronous render (depth 1) equals JAX's and one unsharded batch of
    all frames (``solve_batch``)."""
    js, ts = _services(101, pipeline_depth=3)
    bounds = list(jrs.zoom_bounds(19))
    got = list(ts.stream_chunks(bounds))
    _same_stream(got, list(js.stream_chunks(bounds)))
    assert [c.chunk.frames for c in got] == [4, 4, 4, 4, 3]
    assert [c.chunk.in_flight for c in got] == [3, 3, 3, 2, 1]
    assert all(c.stats.kernel_launches == 1 for c in got)
    assert all(isinstance(c.canvases, torch.Tensor) for c in got)
    js, ts = _services(101, pipeline_depth=1)
    got = ts.render(bounds)
    _same_render(got, js.render(bounds))
    ref, _ = solve_batch(ts.problem, np.asarray(bounds, np.float32),
                         safety_factor=1e9)
    np.testing.assert_array_equal(got[0], ref.numpy())
    # one signature, ragged tail included, equal to JAX's jit-cache count
    assert ts.program_traces() == js.program_traces() == 1


def test_in_flight_queue_is_bounded():
    """The stream never holds more than pipeline_depth chunks in flight,
    reaches the bound, and records the same in-flight counts as JAX."""
    for depth in (1, 2, 3):
        js, ts = _services(101, pipeline_depth=depth)
        got = [c.chunk for c in ts.stream_chunks(jrs.zoom_bounds(12))]
        want = [c.chunk for c in js.stream_chunks(jrs.zoom_bounds(12))]
        inflight = [c.in_flight for c in got]
        assert inflight == [c.in_flight for c in want]
        assert max(inflight) == min(depth, len(got))
        assert [c.index for c in got] == list(range(len(got)))


def test_chunk_stats_timing_and_sink():
    """Per-chunk timings sum to the render's; the sink sees each chunk's
    host canvases (numpy, as JAX's sink does) and stats once, in order."""
    _, ts = _services(101)
    seen = []

    def sink(canvases, stats):
        assert isinstance(canvases, np.ndarray)
        seen.append((canvases.shape, stats.kernel_launches))

    canv, rs = ts.render(jrs.zoom_bounds(10), sink=sink)
    assert canv.shape == (10, 128, 128) and canv.dtype == np.int32
    assert seen == [((4, 128, 128), 1), ((4, 128, 128), 1),
                    ((2, 128, 128), 1)]
    assert len(rs.chunk_stats) == rs.chunks == 3
    for c in rs.chunk_stats:
        assert c.dispatch_s >= 0 and c.fetch_s >= 0
        assert c.busy_s == pytest.approx(c.dispatch_s + c.fetch_s)
    assert rs.dispatch_s == pytest.approx(
        sum(c.dispatch_s for c in rs.chunk_stats))
    assert rs.fetch_s == pytest.approx(sum(c.fetch_s for c in rs.chunk_stats))
    assert rs.host_copy_s >= 0 and rs.busy_s <= rs.wall_s + 0.05
    empty, rs0 = ts.render([])
    assert empty.shape == (0, 128, 128) and rs0.chunks == 0


def test_pipeline_law_on_fake_engine():
    """The pipeline law on the deterministic harness, for the port's
    service and JAX's under the same FakeEngine: with per-chunk compute
    1.0 and sink I/O 0.5 (virtual seconds), sync busy == 8 x 1.5, the
    pipelined run saves exactly (chunks - 1) x min(compute, io), every
    pipelined chunk after the first is enqueued before the previous one
    is consumed, and both services' schedules are the same."""
    compute_s, sink_s = 1.0, 0.5
    runs = {}
    for name, svc_of in (("torch", lambda d: _services(102,
                                                       pipeline_depth=d)[1]),
                         ("jax", lambda d: _services(102,
                                                     pipeline_depth=d)[0])):
        for depth in (1, 2):
            svc = svc_of(depth)
            eng = FakeEngine.attach(svc, compute_s=compute_s)

            def sink(canvases, stats, _eng=eng):
                _eng.clock.advance(sink_s)

            canv, rs = svc.render(jrs.zoom_bounds(32), sink=sink)
            runs[(name, depth)] = (canv, rs, eng.records)
    sync_canv, sync_rs, _ = runs[("torch", 1)]
    pipe_canv, pipe_rs, recs = runs[("torch", 2)]
    np.testing.assert_array_equal(pipe_canv, sync_canv)
    assert sync_rs.chunks == pipe_rs.chunks == 8
    assert sync_rs.busy_s == pytest.approx(sync_rs.wall_s)
    assert sync_rs.wall_s == pytest.approx(8 * (compute_s + sink_s))
    assert sync_rs.busy_s - pipe_rs.wall_s == pytest.approx(
        (sync_rs.chunks - 1) * min(compute_s, sink_s))
    assert len(recs) == 8
    for prev, cur in zip(recs, recs[1:]):
        assert cur.enqueued_at < prev.finalized_at
        assert cur.ready_at == prev.ready_at + compute_s
    for depth in (1, 2):
        t, j = runs[("torch", depth)], runs[("jax", depth)]
        np.testing.assert_array_equal(t[0], j[0])
        assert (t[1].wall_s, t[1].busy_s, t[1].fetch_s, t[1].host_copy_s) \
            == (j[1].wall_s, j[1].busy_s, j[1].fetch_s, j[1].host_copy_s)
        assert [dataclasses.astuple(r) for r in t[2]] == \
            [dataclasses.astuple(r) for r in j[2]]


# ---------------------------------------------------------------------------
# closed-loop occupancy feedback
# ---------------------------------------------------------------------------

def test_feedback_acceptance_equals_jax():
    """JAX's acceptance property on the boundary-skimming zoom, on the
    port: the feedback plan reaches zero drops with fewer retries, ring
    rows and dispatches than the prior-only plan, chunk 0 planned from
    the prior on both; and both runs equal JAX's field for field,
    canvases and the prior-only run's signatures included."""
    runs = {}
    for adapt in (False, True):
        js, ts = _services(103, **_fb_kw(adapt=adapt))
        got = ts.render(_skim())
        # the second service's programs were partly traced by the first
        _same_render(got, js.render(_skim()), traces=not adapt)
        assert got[1].overflow_dropped == 0 and got[1].frames == 32
        runs[adapt] = got[1]
    prior, fb = runs[False], runs[True]
    # JAX's own test holds JAX's canvases equal to its uniform worst case
    assert fb.retries < prior.retries
    assert fb.ring_rows < prior.ring_rows
    assert fb.dispatches < prior.dispatches
    assert fb.chunk_stats[0].p_subdiv == prior.chunk_stats[0].p_subdiv
    assert fb.chunk_stats[0].p_source == "prior"
    assert any(c.p_source == "measured" for c in fb.chunk_stats)
    assert all(c.p_source == "prior" for c in prior.chunk_stats)


@pytest.mark.parametrize("engine,depth,dwell", [("ask_scan", 1, 103),
                                                ("ask_scan", 3, 103),
                                                ("ask_pooled", 2, 106)])
def test_feedback_stream_equals_jax(engine, depth, dwell):
    """The closed loop chunk by chunk, pipelined or not, both engines:
    canvases, ASKStats (retries merged) and ChunkStats equal JAX's, the
    queue stays within the depth, and later chunks plan from measurement.
    """
    js, ts = _services(dwell, **_fb_kw(pipeline_depth=depth, engine=engine))
    got = list(ts.stream_chunks(_skim(24)))
    _same_stream(got, list(js.stream_chunks(_skim(24))))
    assert max(c.chunk.in_flight for c in got) <= depth
    assert sum(c.chunk.frames for c in got) == 24
    assert any(c.chunk.p_source == "measured" for c in got)
    assert all(c.stats.overflow_dropped == 0 for c in got)
    assert ts.program_traces() == len(ts._used_sigs)
    if engine == "ask_pooled":  # a problem only this test traces
        assert ts.program_traces() == js.program_traces()


def test_feedback_splits_chunk_on_capacity_class_jump():
    """A density jump mid-chunk cuts it: [wide x3], [deep x4], [deep x1],
    power-of-two widths, as many signatures as JAX traces, and canvases
    equal to the uniform worst-case service."""
    wide = (-0.5 - 8.0, 0.0 - 8.0, -0.5 + 8.0, 0.0 + 8.0)
    deep = (SKIM_CENTER[0] - 0.005, SKIM_CENTER[1] - 0.005,
            SKIM_CENTER[0] + 0.005, SKIM_CENTER[1] + 0.005)
    bounds = [wide] * 3 + [deep] * 5
    js, ts = _services(107, **_fb_kw(adapt=False))
    got = list(ts.stream_chunks(bounds))
    _same_stream(got, list(js.stream_chunks(bounds)))
    assert [c.chunk.frames for c in got] == [3, 4, 1]
    ps = [c.chunk.p_subdiv for c in got]
    assert ps[0] < ps[1] and ps[1] == ps[2]
    assert {ts._pad_width(c.chunk.frames) for c in got} <= {1, 2, 4}
    assert ts.program_traces() == len(ts._used_sigs) == js.program_traces()
    ref = _services(107)[1].render(bounds)[0]
    np.testing.assert_array_equal(
        np.concatenate([_host(c.canvases) for c in got]), ref)


@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_feedback_retry_converges_with_zero_drops(engine):
    """A hostile safety factor: chunks overflow, the retries escalate
    until every frame fits (patched into the chunk's canvas), the merged
    stats report zero drops -- all equal to JAX's -- and the canvases
    equal the uniform worst-case service's."""
    dwell = 108 if engine == "ask_scan" else 109
    js, ts = _services(dwell, **_fb_kw(safety_factor=0.4, engine=engine))
    got = list(ts.stream_chunks(_skim(4)))
    _same_stream(got, list(js.stream_chunks(_skim(4))))
    assert sum(c.chunk.retries for c in got) > 0
    assert sum(c.stats.kernel_launches for c in got) > len(got)
    ref = _services(dwell)[1].render(_skim(4))[0]
    np.testing.assert_array_equal(
        np.concatenate([_host(c.canvases) for c in got]), ref)


def test_feedback_estimator_state_carries_across_renders():
    """The estimator is service state: a second trajectory plans chunk 0
    from measurement, as JAX's does, with the same plans."""
    js, ts = _services(103, **_fb_kw())
    renders = []
    for _ in range(2):
        got = ts.render(_skim(8))
        _same_render(got, js.render(_skim(8)), traces=False)
        renders.append(got[1])
    assert renders[0].chunk_stats[0].p_source == "prior"
    assert renders[1].chunk_stats[0].p_source == "measured"
    assert ts.estimator.chunks_observed == js.estimator.chunks_observed == \
        renders[0].chunks + renders[1].chunks


def test_feedback_state_round_trips_between_the_packages(tmp_path):
    """``feedback_state``: a restarted port service restored from its
    file reproduces the warm service's plans; the file one package writes
    restores in the other to the same snapshot and the same predictions;
    conflicting construction fails."""
    jp, tp = _problems(103)
    path = tmp_path / "estimator.json"
    mesh = make_frames_mesh(device="cpu")
    svc1 = trs.RenderService(tp, mesh=mesh, chunk_frames=4,
                             feedback_state=path, safety_factor=1.1)
    rs1 = svc1.render(_skim(8))[1]
    assert rs1.chunk_stats[0].p_source == "prior" and path.exists()
    saved = path.read_bytes()
    canv_warm, rs_warm = svc1.render(_skim(8))
    path.write_bytes(saved)
    svc2 = trs.RenderService(tp, mesh=mesh, chunk_frames=4,
                             feedback_state=path, safety_factor=1.1)
    canv2, rs2 = svc2.render(_skim(8))
    assert rs2.chunk_stats[0].p_source == "measured"
    assert [c.p_subdiv for c in rs2.chunk_stats] == \
        [c.p_subdiv for c in rs_warm.chunk_stats]
    assert rs2.retries == rs_warm.retries and rs2.overflow_dropped == 0
    np.testing.assert_array_equal(canv2, canv_warm)
    # across the packages: JAX's service restores the port's file
    path.write_bytes(saved)
    jsvc = jrs.RenderService(jp, mesh=_jmesh(), chunk_frames=4,
                             feedback_state=path, safety_factor=1.1)
    assert jsvc.estimator.snapshot() == json.loads(saved)
    _same_render(svc2.render(_skim(8)), jsvc.render(_skim(8)), traces=False)
    jpath = jsvc.save_feedback_state(tmp_path / "jax.json")
    back = trs.RenderService(tp, mesh=mesh, feedback_state=jpath)
    assert back.estimator.snapshot() == jsvc.estimator.snapshot()
    for d in np.linspace(-2.0, 6.0, 17):
        assert back.estimator.predict_quantized(d, workload=tp.workload) == \
            jsvc.estimator.predict_quantized(d, workload=jp.workload)
    with pytest.raises(ValueError, match="not both"):
        trs.RenderService(tp, mesh=mesh, feedback=OccupancyEstimator(),
                          feedback_state=path)
    with pytest.raises(ValueError, match="estimator"):
        _services(103)[1].save_feedback_state(tmp_path / "x.json")


def test_mixed_workloads_observe_their_own_chunks_when_pipelined():
    """A mandelbrot / julia stream switching every frame at depth 2: each
    finalised chunk is observed under its own workload before the queue
    refills; chunks equal JAX's."""
    pm = _problems(112, "mandelbrot")
    pj = _problems(112, "julia")
    items = [("m", pm[1].bounds), ("j", pj[1].bounds)] * 3
    est = OccupancyEstimator()
    observed = []
    orig = est.observe_stats

    def spy(depths, stats, **kw):
        observed.append(kw["workload"].name)
        return orig(depths, stats, **kw)

    est.observe_stats = spy
    ts = trs.RenderService({"m": pm[1], "j": pj[1]},
                           mesh=make_frames_mesh(device="cpu"),
                           chunk_frames=4, pipeline_depth=2, feedback=est,
                           safety_factor=2.0)
    js = jrs.RenderService({"m": pm[0], "j": pj[0]}, mesh=_jmesh(),
                           chunk_frames=4, pipeline_depth=2, feedback=True,
                           safety_factor=2.0)
    got = list(ts.stream_chunks(items))
    _same_stream(got, list(js.stream_chunks(items)))
    assert max(c.chunk.in_flight for c in got) == 2
    assert observed == [ts.problem_for(c.chunk.workload).workload.name
                        for c in got] == ["mandelbrot", "julia"] * 3
    assert {"mandelbrot", "julia"} <= set(est.workloads_observed())
    assert ts.workload_keys() == ("j", "m") and ts.n == 128
    with pytest.raises(KeyError):
        list(ts.stream_chunks([("x", pm[1].bounds)]))


@pytest.mark.parametrize("feedback", [False, True])
def test_dispatch_planned_equals_jax(feedback):
    """The front doors' seam: one coalesced batch with tenants, uniform
    or planned (its capacities from the hottest member), finalised once;
    its result and ChunkStats equal JAX's; bad batches raise."""
    kw = _fb_kw() if feedback else {}
    js, ts = _services(113 if feedback else 114, **kw)
    bounds = _skim(3)
    tenants = ("a", "b", "a")
    results = []
    for svc in (ts, js):
        h = svc.dispatch_planned(bounds, tenants=tenants,
                                 tenant_feedback=feedback)
        assert (h.frames, h.workload, h.tenants) == (3, "", tenants)
        r = h.finalize()
        with pytest.raises(RuntimeError, match="one-shot"):
            h.finalize()
        results.append(r)
    _same_stream(results[:1], results[1:])
    assert results[0].chunk.tenant_frames() == {"a": 2, "b": 1}
    if feedback:
        assert "a@mandelbrot" in ts.estimator.workloads_observed()
    for bad, err in ((dict(bounds=_skim(5)), ValueError),
                     (dict(bounds=[]), ValueError),
                     (dict(bounds=bounds, key="x"), KeyError),
                     (dict(bounds=bounds, tenants=("a",)), ValueError)):
        with pytest.raises(err):
            ts.dispatch_planned(**bad)


# ---------------------------------------------------------------------------
# four shards
# ---------------------------------------------------------------------------

_K4 = """
import jax, numpy as np, torch
from jax.sharding import AxisType
from repro.launch import render_service as jrs
from repro.workloads import FrameProblem as JP
from repro_torch.launch import render_service as trs
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import FrameProblem as TP

torch.set_num_threads(1)
assert len(jax.devices()) == 4
jmesh = jax.make_mesh((4,), ("frames",), axis_types=(AxisType.Auto,))
tmesh = make_frames_mesh(4, device="cpu")
kw = dict(n=128, g=4, r=2, B=16, max_dwell=70)
skim = list(jrs.zoom_bounds(14, center=(-0.7436447860, 0.1318252536),
                            width0=6.0, zoom_per_frame=1.02))
STATS = ("levels", "kernel_launches", "region_counts", "leaf_count",
         "overflow_dropped", "frame_overflow", "frame_leaf_counts", "olt_caps")
CHUNK = ("index", "frames", "in_flight", "p_subdiv", "p_source", "retries",
         "ring_rows", "workload")
for name, skw in (("uniform", dict(safety_factor=1e9)),
                  ("feedback", dict(feedback=True, safety_factor=0.6)),
                  ("pooled", dict(feedback=True, safety_factor=0.6,
                                  engine="ask_pooled"))):
    js = jrs.RenderService(JP(**kw, backend="jnp"), mesh=jmesh,
                           chunk_frames=6, **skw)
    ts = trs.RenderService(TP(**kw, device="cpu"), mesh=tmesh,
                           chunk_frames=6, **skw)
    assert ts.chunk_frames == js.chunk_frames == 8
    got, want = list(ts.stream_chunks(skim)), list(js.stream_chunks(skim))
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert np.array_equal(g.canvases.numpy(), np.asarray(w.canvases)), name
        for f in STATS:
            assert getattr(g.stats, f) == getattr(w.stats, f), (name, f)
        for f in CHUNK:
            assert getattr(g.chunk, f) == getattr(w.chunk, f), (name, f)
    print(name, len(got), sum(c.chunk.retries for c in got),
          sum(c.chunk.ring_rows for c in got))
print("OK")
"""


def test_four_shards_match_jax_on_four_host_devices():
    """One interpreter with 4 forced host devices: the port's service on
    a 4-shard CPU mesh against JAX's on a 4-device Auto-axis mesh, chunk
    6 rounded up to 8 (2 frames a shard): the uniform stream, the
    feedback stream with retries, and the pooled feedback stream (one
    ring a shard) equal JAX's chunk by chunk."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_K4)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.splitlines()[-1] == "OK"
    rows = {line.split()[0]: line.split()[1:]
            for line in r.stdout.splitlines()[:-1]}
    assert set(rows) == {"uniform", "feedback", "pooled"}
    assert int(rows["feedback"][1]) > 0  # the retries really ran sharded
