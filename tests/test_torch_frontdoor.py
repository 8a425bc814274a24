"""The port's multi-tenant front door (``repro_torch.launch.frontdoor``)
against JAX's (``repro.launch.frontdoor``) on the CPU.

Every scenario runs twice, once through each package's ``FrontDoor``, each
over its own scripted ``FakeService`` of ``tests/fakes.py`` (a virtual
clock and a serial fake device): the schedules must be the same -- every
batch's key, tenants, bounds and enqueue/ready/finalize times -- and so
must every ``FrontDoorStats`` counter and every served frame. On top of
that the port's results are held to the properties JAX's tests hold:
validation before admission, backpressure, deficit-round-robin fairness,
deadline-aware widths and shedding, the in-flight window, fault isolation,
disconnects, and the hypothesis properties (exactly-once, no reordering
within a tenant, the DRR service-gap bound). The acceptance scenario
runs both front doors over their real render services (n=128, g=4, r=2,
B=16): equal stats, frames and estimator snapshots, and the port's
consolidation against its tenants rendered alone. Tolerance: exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from fakes import FakeService, VirtualClock
from repro.launch import frontdoor as jfd
from repro.launch import render_service as jrs
from repro.testing.hypothesis_compat import given, settings
from repro.testing.hypothesis_compat import strategies as st
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import FrontDoorOptions as JFrontDoorOptions
from repro_torch.launch import frontdoor as tfd
from repro_torch.launch import render_service as trs
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import FrameProblem, FrontDoorOptions

torch.set_num_threads(1)

DWELL = 77  # no other test file renders at this max_dwell
STATS = ("admitted", "served", "shed_queue_full", "shed_deadline",
         "rejected_invalid", "cancelled", "failed", "batches", "dispatches",
         "frames_dispatched", "overflow_dropped", "retries",
         "deadline_misses", "tile_hits", "tile_misses", "tile_bytes")
PACKAGES = {"torch": (tfd, FrontDoorOptions), "jax": (jfd, JFrontDoorOptions)}


def _bounds(i: int):
    """Identity-carrying bounds: frame i's canvas reads back i."""
    return (float(i), 0.0, float(i) + 1.0, 1.0)


def _both(scenario):
    """Run ``scenario(fd_module, options_class)`` -> (door, service, out)
    through both packages; the schedules, stats and ``out`` must agree.
    Returns the port's (door, service, out)."""
    runs = {name: scenario(*pkg) for name, pkg in PACKAGES.items()}
    (td, tsvc, tout), (jd, jsvc, jout) = runs["torch"], runs["jax"]
    assert [dataclasses.astuple(b) for b in tsvc.batches] == \
        [dataclasses.astuple(b) for b in jsvc.batches]
    for f in STATS:
        assert getattr(td.stats, f) == getattr(jd.stats, f), f
    assert [vars(c) for c in td.stats.batch_stats] == \
        [vars(c) for c in jd.stats.batch_stats]
    assert tout == jout
    return td, tsvc, tout


def _outcome(ticket):
    """A settled ticket as comparable data: the served frame's identity,
    or the error's class name."""
    err = ticket.exception()
    if err is not None:
        return type(err).__name__
    f = ticket.result()
    return (float(f.canvas[0, 0]), f.tenant, f.workload, f.tseq,
            f.batch_index, f.deadline, f.completed_at, f.met_deadline)


def _door(fd, opts, service=None, **opt):
    if service is None:
        service = FakeService(chunk_frames=8)
    return fd.FrontDoor(service, options=opts(**opt)), service


def _served_sequence(service):
    return [t for rec in service.batches for t in rec.tenants]


# ---------------------------------------------------------------------------
# admission + validation
# ---------------------------------------------------------------------------

def test_poisoned_requests_rejected_before_admission():
    def scenario(fd, opts):
        door, svc = _door(fd, opts, FakeService(keys=("julia",),
                                                chunk_frames=4))
        for key, b in (("mandelbrot", _bounds(0)), ("julia", (0.0, 0.0, 1.0)),
                       ("julia", (0.0, 0.0, float("nan"), 1.0)),
                       ("julia", (1.0, 0.0, 1.0, 1.0)),
                       ("julia", "not-bounds")):
            with pytest.raises(fd.InvalidRequest):
                door.submit("a", key, b)
        assert door.stats.admitted == 0 and door.queued == 0
        return door, svc, _outcome(door.submit("b", "julia", _bounds(7)))

    door, svc, out = _both(scenario)
    assert door.stats.rejected_invalid == 5 and out[0] == 7.0
    assert door.stats.served == 1 and len(svc.batches) == 1


@pytest.mark.parametrize("on_full", ["shed", "block"])
def test_backpressure(on_full):
    """shed: past max_queue a typed AdmissionRejected, nothing enqueued;
    block: a submit into a full queue serves until space frees."""
    def scenario(fd, opts):
        door, svc = _door(fd, opts, max_queue=2, on_full=on_full)
        tickets = []
        for i in range(2 if on_full == "shed" else 6):
            tickets.append(door.submit("a", "", _bounds(i)))
        if on_full == "shed":
            with pytest.raises(fd.AdmissionRejected):
                door.submit("a", "", _bounds(2))
            assert door.queued == 2
        else:
            assert sum(t.done for t in tickets) >= 2
        door.drain()
        return door, svc, [_outcome(t) for t in tickets]

    door, _, out = _both(scenario)
    assert [o[0] for o in out] == [float(i) for i in range(len(out))]
    assert door.stats.shed_queue_full == (on_full == "shed")


# ---------------------------------------------------------------------------
# fair coalescing (deficit round robin)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,per_tenant,want", [
    (6, 6, [("a", "a", "b", "b", "c", "c")] * 3),
    # width 4 cuts the 2-2-2 rotation mid-"c": c's grant carries over
    (4, 4, [("a", "a", "b", "b"), ("c", "c", "a", "a"),
            ("b", "b", "c", "c")])])
def test_drr_schedule(width, per_tenant, want):
    def scenario(fd, opts):
        door, svc = _door(fd, opts, FakeService(chunk_frames=width),
                          quantum=2)
        for t in ("a", "b", "c"):
            for i in range(per_tenant):
                door.submit(t, "", _bounds(i))
        door.drain()
        return door, svc, None

    door, svc, _ = _both(scenario)
    assert [rec.tenants for rec in svc.batches] == want
    assert door.stats.served == 3 * per_tenant


@pytest.mark.parametrize("scenario", ["mismatched_head", "no_deadlines"])
def test_head_of_queue_rules(scenario):
    """A tenant whose head is another workload is skipped without losing
    its turn and served by that workload's batch; with no deadlines the
    batch runs at full width (nothing to shrink by)."""
    def run(fd, opts):
        if scenario == "mismatched_head":
            door, svc = _door(fd, opts, FakeService(keys=("m", "j"),
                                                    chunk_frames=8),
                              quantum=2)
            for i in range(2):
                door.submit("a", "m", _bounds(i))
                door.submit("b", "j", _bounds(10 + i))
        else:
            svc = FakeService(chunk_frames=8, clock=VirtualClock(),
                              per_frame_s=1.0)
            door = fd.FrontDoor(svc, options=opts(per_frame_s=1.0, quantum=8))
            for i in range(8):
                door.submit("a", "", _bounds(i))
        door.drain()
        return door, svc, None

    _, svc, _ = _both(run)
    want = ([("m", ("a", "a"), 2), ("j", ("b", "b"), 2)]
            if scenario == "mismatched_head" else [("", ("a",) * 8, 8)])
    assert [(r.key, r.tenants, r.frames) for r in svc.batches] == want


def test_batches_cut_at_workload_switches_keep_tenant_order():
    def scenario(fd, opts):
        door, svc = _door(fd, opts, FakeService(keys=("m", "j"),
                                                chunk_frames=4), quantum=1)
        sess = door.session("a")
        tickets = [sess.submit(k, _bounds(i)) for i, k in
                   enumerate(["m", "m", "j", "m", "j", "j", "m"])]
        door.drain()
        return door, svc, [_outcome(t) for t in tickets]

    door, svc, out = _both(scenario)
    assert [o[0] for o in out] == [float(i) for i in range(7)]
    assert [rec.key for rec in svc.batches] == ["m", "j", "m", "j", "m"]


# ---------------------------------------------------------------------------
# deadline-aware batching
# ---------------------------------------------------------------------------

def test_deadline_shrinks_batch_width():
    """Slack 2.5 at 1 s/frame: the urgent pair rides a 2-frame batch."""
    def scenario(fd, opts):
        clock = VirtualClock()
        svc = FakeService(chunk_frames=8, clock=clock, per_frame_s=1.0)
        door = fd.FrontDoor(svc, options=opts(per_frame_s=1.0, quantum=8))
        sess = door.session("a")
        tickets = [sess.submit("", _bounds(i), deadline=clock.now() + 2.5)
                   for i in range(2)]
        tickets += [sess.submit("", _bounds(2 + i)) for i in range(6)]
        door.drain()
        return door, svc, [_outcome(t) for t in tickets]

    door, svc, out = _both(scenario)
    assert [rec.frames for rec in svc.batches] == [2, 6]
    assert all(o[-1] for o in out[:2])
    assert door.stats.deadline_misses == 0 and door.stats.served == 8


def test_expired_requests_shed_and_latency_model_learns():
    def scenario(fd, opts):
        clock = VirtualClock()
        svc = FakeService(chunk_frames=8, clock=clock, per_frame_s=2.0)
        door = fd.FrontDoor(svc, options=opts(latency_alpha=1.0))
        late = door.submit("a", "", _bounds(0), deadline=clock.now() + 1.0)
        ok = [door.submit("b", "", _bounds(1 + i)) for i in range(4)]
        clock.advance(5.0)
        door.drain()
        with pytest.raises(fd.DeadlineExceeded):
            late.result()
        return door, svc, ([_outcome(t) for t in ok], door._per_frame_s)

    door, svc, (out, per_frame) = _both(scenario)
    assert door.stats.shed_deadline == 1 and door.stats.served == 4
    assert svc.batches[0].tenants == ("b",) * 4
    assert per_frame == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# the in-flight window, faults, disconnects
# ---------------------------------------------------------------------------

def test_in_flight_window_overlaps_batches():
    def scenario(fd, opts):
        clock = VirtualClock()
        svc = FakeService(chunk_frames=4, clock=clock, per_frame_s=1.0)
        door = fd.FrontDoor(svc, options=opts(max_in_flight=2, quantum=4))
        for i in range(12):
            door.submit("a", "", _bounds(i))
        assert door.in_flight <= 2
        door.drain()
        return door, svc, None

    _, svc, _ = _both(scenario)
    recs = svc.batches
    assert len(recs) == 3 and recs[1].enqueued_at < recs[0].ready_at
    assert recs[2].ready_at == recs[1].ready_at + 4.0 == recs[0].ready_at + 8


def test_dispatch_failure_fails_only_that_batch():
    def scenario(fd, opts):
        svc = FakeService(chunk_frames=2, fail={1})
        door = fd.FrontDoor(svc, options=opts(quantum=2, max_in_flight=1))
        tickets = [door.submit(t, "", _bounds(10 * k + i))
                   for k, t in enumerate("abc") for i in range(2)]
        door.drain()
        for t in tickets[2:4]:
            with pytest.raises(fd.DispatchFailed) as e:
                t.result()
            assert isinstance(e.value.__cause__, RuntimeError)
        return door, svc, [_outcome(t) for t in tickets]

    door, _, out = _both(scenario)
    assert [o if isinstance(o, str) else o[0] for o in out] == [
        0.0, 1.0, "DispatchFailed", "DispatchFailed", 20.0, 21.0]
    assert door.stats.failed == 2 and door.stats.served == 4


def test_disconnect_cancels_queued_and_in_flight_requests():
    def scenario(fd, opts):
        clock = VirtualClock()
        svc = FakeService(chunk_frames=4, clock=clock)
        door = fd.FrontDoor(svc, options=opts(max_in_flight=2, quantum=2))
        sa, sb = door.session("a"), door.session("b")
        a = [sa.submit("", _bounds(i)) for i in range(4)]
        b = [sb.submit("", _bounds(10 + i)) for i in range(4)]
        while door.in_flight < 2 and door._dispatch_next():
            pass
        assert door.in_flight == 2
        sa.close()
        door.drain()
        with pytest.raises(fd.SessionClosed):
            sa.submit("", _bounds(99))
        with pytest.raises(fd.SessionClosed):
            door.session("a")
        return door, svc, [_outcome(t) for t in a + b]

    door, _, out = _both(scenario)
    assert out[:4] == ["SessionClosed"] * 4
    assert [o[0] for o in out[4:]] == [10.0, 11.0, 12.0, 13.0]
    assert door.stats.cancelled == 4 and door.stats.served == 4


def test_results_iterator_survives_typed_errors():
    def scenario(fd, opts):
        svc = FakeService(chunk_frames=2, fail={0})
        door = fd.FrontDoor(svc, options=opts(max_in_flight=1))
        sess = door.session("a")
        for i in range(3):
            sess.submit("", _bounds(i))
        door.drain()
        it = sess.results()
        got = []
        for _ in range(3):
            try:
                got.append(next(it).canvas[0, 0])
            except fd.DispatchFailed:
                got.append("DispatchFailed")
        with pytest.raises(StopIteration):
            next(it)
        return door, svc, got

    _, _, got = _both(scenario)
    assert got == ["DispatchFailed", "DispatchFailed", 2.0]


def test_options_match_jax():
    """FrontDoorOptions: same fields, defaults and errors as JAX's."""
    assert [(f.name, f.default) for f in dataclasses.fields(FrontDoorOptions)] \
        == [(f.name, f.default) for f in dataclasses.fields(JFrontDoorOptions)]
    for bad in (dict(max_queue=0), dict(max_in_flight=0),
                dict(max_batch_frames=0), dict(quantum=0),
                dict(on_full="drop"), dict(overhead_s=-1.0),
                dict(latency_alpha=0.0), dict(latency_alpha=1.5)):
        with pytest.raises(ValueError) as want:
            JFrontDoorOptions(**bad)
        with pytest.raises(ValueError) as got:
            FrontDoorOptions(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        tfd.FrontDoor(FakeService(), options=JFrontDoorOptions())
    stats = tfd.FrontDoorStats()
    stats.observe_tiles(3, 1, 4096)
    assert (stats.tile_hit_rate, stats.tile_bytes) == (0.75, 4096)


# ---------------------------------------------------------------------------
# property tests (hypothesis when installed; seeded fallback otherwise)
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.data())
def test_property_order_exactly_once_and_same_as_jax(data):
    """Arbitrary interleavings, widths, quanta and injected failures: both
    front doors serve the same schedule; every tenant's stream keeps its
    submission order; every admitted request settles exactly once and is
    dispatched in exactly one batch."""
    n_tenants = data.draw(st.integers(2, 5))
    width = data.draw(st.integers(1, 6))
    quantum = data.draw(st.integers(1, 4))
    fail_every = data.draw(st.integers(0, 3))
    plan = data.draw(st.lists(
        st.tuples(st.integers(0, n_tenants - 1), st.integers(0, 1)),
        min_size=1, max_size=24))

    def scenario(fd, opts):
        svc = FakeService(
            keys=("m", "j"), chunk_frames=width,
            fail=(lambda i, *a: RuntimeError("boom")
                  if fail_every and i % (fail_every + 1) == fail_every
                  else None))
        door = fd.FrontDoor(svc, options=opts(quantum=quantum))
        tickets = [door.submit(f"t{ti}", ("m", "j")[ki], _bounds(seq))
                   for seq, (ti, ki) in enumerate(plan)]
        door.drain()
        return door, svc, [_outcome(t) for t in tickets]

    door, svc, out = _both(scenario)
    s = door.stats
    assert s.admitted == len(plan) == s.served + s.failed
    served = [(plan[int(o[0])][0], o[0]) for o in out if not isinstance(o, str)]
    for ti in range(n_tenants):
        mine = [x for t, x in served if t == ti]
        assert mine == sorted(mine)
    dispatched = [b[0] for rec in svc.batches for b in rec.bounds]
    assert sorted(dispatched) == [float(i) for i in range(len(plan))]


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_property_drr_service_gap_bound(data):
    """While a tenant stays backlogged, at most quantum x tenants frames of
    others are served between two of its frames, as in JAX's."""
    n_tenants = data.draw(st.integers(2, 5))
    quantum = data.draw(st.integers(1, 3))
    width = data.draw(st.integers(1, 8))
    per_tenant = [data.draw(st.integers(1, 8)) for _ in range(n_tenants)]

    def scenario(fd, opts):
        door, svc = _door(fd, opts, FakeService(chunk_frames=width),
                          quantum=quantum)
        for ti, count in enumerate(per_tenant):
            for i in range(count):
                door.submit(f"t{ti}", "", _bounds(ti * 100 + i))
        door.drain()
        return door, svc, None

    _, svc, _ = _both(scenario)
    seq = _served_sequence(svc)
    bound = quantum * n_tenants
    for ti in range(n_tenants):
        pos = [p for p, who in enumerate(seq) if who == f"t{ti}"]
        assert len(pos) == per_tenant[ti] and pos[0] <= bound
        for p1, p2 in zip(pos, pos[1:]):
            assert p2 - p1 - 1 <= bound


# ---------------------------------------------------------------------------
# acceptance: the real services end to end
# ---------------------------------------------------------------------------

def _real_services(n=128, **kw):
    """(JAX's mixed mandelbrot/julia service, the port's), feedback on."""
    probs = {}
    for wl in ("mandelbrot", "julia"):
        pk = dict(n=n, g=4, r=2, B=16, max_dwell=DWELL, workload=wl)
        probs[wl] = (JFrameProblem(**pk, backend="jnp"),
                     FrameProblem(**pk, device="cpu"))
    kw.setdefault("feedback", True)
    kw.setdefault("chunk_frames", 8)
    jmesh = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    return (jrs.RenderService({k: p[0] for k, p in probs.items()},
                              mesh=jmesh, safety_factor=1.1, **kw),
            trs.RenderService({k: p[1] for k, p in probs.items()},
                              mesh=make_frames_mesh(device="cpu"),
                              safety_factor=1.1, **kw))


def _tenant_plan():
    """8 tenants x 3 frames, mixed workloads, distinct trajectories."""
    plan = {}
    for i in range(8):
        wl = ("mandelbrot", "julia")[i % 2]
        center = ((-0.74364 + 0.01 * i, 0.13182) if wl == "mandelbrot"
                  else (0.02 * i - 0.05, 0.01 * i))
        plan[f"tenant{i}"] = (wl, list(jrs.zoom_bounds(
            3, center=center, width0=3.0 - 0.1 * i)))
    return plan


def test_acceptance_eight_tenants_equal_jax_and_their_solo_runs():
    """8 tenants, mixed workloads, staggered deadlines, shared planned
    batches with tenant feedback: the port's front door equals JAX's
    (stats, per-batch ChunkStats, every served frame, the estimator's
    snapshot, per-tenant namespaces included), drops nothing, coalesces
    across tenants, and serves each tenant exactly what that tenant
    rendered alone through a port service gets, in fewer dispatches."""
    jsvc, tsvc = _real_services()
    plan = _tenant_plan()
    doors = {}
    for name, (fd, opts), svc in (("torch", PACKAGES["torch"], tsvc),
                                  ("jax", PACKAGES["jax"], jsvc)):
        door = fd.FrontDoor(svc, options=opts(
            quantum=2, max_in_flight=2, tenant_feedback=True))
        now = svc._clock.now()
        for i, (tenant, (wl, bounds)) in enumerate(plan.items()):
            for j, b in enumerate(bounds):
                door.session(tenant).submit(
                    wl, b, deadline=now + 300.0 + 10.0 * i + j)
        door.drain()
        doors[name] = door
    td, jd = doors["torch"], doors["jax"]
    for f in STATS:
        assert getattr(td.stats, f) == getattr(jd.stats, f), f
    strip = ("dispatch_s", "fetch_s")
    assert [{k: v for k, v in vars(c).items() if k not in strip}
            for c in td.stats.batch_stats] == \
        [{k: v for k, v in vars(c).items() if k not in strip}
         for c in jd.stats.batch_stats]
    assert tsvc.estimator.snapshot() == jsvc.estimator.snapshot()
    assert "tenant0@mandelbrot" in tsvc.estimator.workloads_observed()

    st_ = td.stats
    assert st_.admitted == st_.served == 24 and st_.overflow_dropped == 0
    assert st_.shed_queue_full == st_.shed_deadline == st_.failed == 0
    assert st_.batches < 24
    assert any(len(set(c.tenants)) > 1 for c in st_.batch_stats)
    solo_dispatches = 0
    for tenant, (wl, bounds) in plan.items():
        got = [f for f in td.session(tenant).results()]
        want = [f for f in jd.session(tenant).results()]
        assert [f.tseq for f in got] == [0, 1, 2]
        assert all(f.workload == wl for f in got)
        assert all(isinstance(f.canvas, np.ndarray) for f in got)
        np.testing.assert_array_equal(np.stack([f.canvas for f in got]),
                                      np.stack([f.canvas for f in want]))
        solo = _real_services()[1]
        solo_canv, solo_rs = solo.render([(wl, b) for b in bounds])
        assert solo_rs.overflow_dropped == 0
        solo_dispatches += solo_rs.dispatches
        np.testing.assert_array_equal(np.stack([f.canvas for f in got]),
                                      solo_canv)
    assert st_.dispatches < solo_dispatches
