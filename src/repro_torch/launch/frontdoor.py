"""Multi-tenant front door: admission queue, fair coalescing,
deadline-aware batching in front of ``RenderService``.

Counterpart of ``repro/launch/frontdoor.py``, a port of it: the same
classes, schedule and errors. It differs only where a finalised batch's
canvases come to the host (``core.readback.to_host``: a copy stream waits
on that batch's own event, so batches still in flight behind it keep
computing) and in its clock, which is the render service's
(``launch.render_service``).

The paper's thesis is that finite GPU resources should be focused where
the parallelism is, via a *planned* subdivision process. The stack
below this module already does that for one client: the planner sizes
per-level rings from expected occupancy, the feedback loop refines the
estimate, the pooled tier shares one ring across a whole heterogeneous
batch. What none of that answers is the serving question the
DP-consolidation line of work poses (Wu et al. 2016): MANY independent
clients, each submitting a trickle of small launches, waste the machine
unless somebody aggregates them into shared launches. The front door is
that somebody:

* **Admission.** Sessions submit ``(tenant, workload, bounds,
  deadline)`` requests into one bounded queue. A full queue either
  blocks the submitter until serving drains it (``on_full="block"``) or
  sheds the request with a typed :class:`AdmissionRejected`
  (``on_full="shed"``) -- backpressure is explicit, never an unbounded
  buffer.
* **Fair coalescing.** A deficit-round-robin coalescer drains the
  per-tenant FIFOs into shared batches: each rotation grants every
  backlogged tenant up to ``quantum`` frames, so one tenant with a
  million-frame deep zoom cannot starve the tenant with three frames.
  Batches are cut at workload switches (the pooled chunker's rule:
  every dispatch is single-workload, so it runs one problem),
  and never reorder requests *within* a tenant.
* **Deadline-aware batching.** The batch width shrinks when the most
  urgent member's deadline tightens -- a smaller batch finalises sooner
  -- using an online EWMA latency model (``overhead_s + width *
  per_frame_s``). Requests whose deadline already passed are shed with
  a typed :class:`DeadlineExceeded` instead of burning shared capacity.
* **Overlap.** Up to ``max_in_flight`` batches are in flight at once
  (enqueued on the card with no host sync: the pipeline-DP shape, batch
  k+1's device compute runs behind batch k's admission, demux, and host
  I/O).
* **Demux.** Each finalised batch's canvases fan back out to the
  submitting sessions' tickets, in per-tenant submission order, with
  per-tenant attribution stamped on the shared ``ChunkStats``. A
  dispatch failure fails exactly the tickets riding that batch; a
  disconnected session's frames are dropped at demux without touching
  its batch-mates.

The front door owns WHO gets served WHEN; the ``RenderService`` seam it
drives (``dispatch_planned``) owns planning, padding, retry-to-zero-
drops, and the occupancy estimator -- including per-tenant estimator
namespaces when ``FrontDoorOptions(tenant_feedback=True)``.

Determinism contract: the front door never sleeps and never reads wall
time directly -- all timing goes through an injectable clock, and all
blocking happens inside ``handle.finalize()``. The deterministic test
harness (``tests/fakes.py``) swaps in a virtual clock plus scripted
dispatches and replays exact schedules; production swaps in nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.readback import to_host
from repro_torch.workloads.options import FrontDoorOptions

__all__ = [
    "FrontDoor",
    "FrontDoorOptions",
    "FrontDoorStats",
    "TenantSession",
    "Ticket",
    "RenderedFrame",
    "FrontDoorError",
    "AdmissionRejected",
    "DeadlineExceeded",
    "InvalidRequest",
    "DispatchFailed",
    "SessionClosed",
]


# ---------------------------------------------------------------------------
# typed rejections
# ---------------------------------------------------------------------------

class FrontDoorError(Exception):
    """Base of every typed front-door rejection/failure."""


class AdmissionRejected(FrontDoorError):
    """Shed at admission: the bounded queue was full (``on_full="shed"``)."""


class DeadlineExceeded(FrontDoorError):
    """Shed by the coalescer: the deadline passed before dispatch."""


class InvalidRequest(FrontDoorError):
    """Poisoned request (unknown workload / malformed bounds): rejected
    at submit, before admission -- it can never reach a shared batch."""


class DispatchFailed(FrontDoorError):
    """The shared batch this request rode failed to dispatch/finalise.
    Only the tickets of that batch carry it; the front door keeps
    serving subsequent batches."""


class SessionClosed(FrontDoorError):
    """The submitting session disconnected before this request was
    served (or a submit was attempted on a closed session)."""


# ---------------------------------------------------------------------------
# requests / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted frame request."""

    tenant: str
    key: str  # workload (problem) key on the service
    bounds: Tuple[float, float, float, float]
    deadline: Optional[float]  # absolute clock time; None = no deadline
    seq: int  # global admission sequence (front-door-wide)
    tseq: int  # per-tenant submission sequence

    def deadline_key(self) -> float:
        return math.inf if self.deadline is None else float(self.deadline)


@dataclasses.dataclass(frozen=True)
class RenderedFrame:
    """One served request: the frame canvas plus shared-batch context."""

    canvas: Any  # np [n, n]
    tenant: str
    workload: str
    tseq: int  # per-tenant submission sequence (stream order)
    batch_index: int  # which shared batch served it
    chunk: Any  # ChunkStats of the shared batch (tenants attribution incl.)
    deadline: Optional[float]
    completed_at: float

    @property
    def met_deadline(self) -> bool:
        return self.deadline is None or self.completed_at <= self.deadline


class Ticket:
    """Future of one submitted request. Resolved exactly once -- with a
    :class:`RenderedFrame` or a typed :class:`FrontDoorError`."""

    def __init__(self, door: "FrontDoor", request: Request):
        self._door = door
        self.request = request
        self._value: Optional[RenderedFrame] = None
        self._error: Optional[BaseException] = None
        self._resolved = False

    @property
    def done(self) -> bool:
        return self._resolved

    def _resolve(self, value: RenderedFrame) -> None:
        if self._resolved:
            raise RuntimeError(f"ticket {self.request} resolved twice")
        self._value, self._resolved = value, True

    def _fail(self, error: BaseException) -> None:
        if self._resolved:
            raise RuntimeError(f"ticket {self.request} resolved twice")
        self._error, self._resolved = error, True

    def exception(self) -> Optional[BaseException]:
        """The ticket's typed error, driving the front door until this
        request settles; None when it was served."""
        while not self._resolved:
            self._door._require_progress()
        return self._error

    def result(self) -> RenderedFrame:
        """Block (driving the front door) until this request is served;
        raises the ticket's typed error if it was shed/failed/cancelled
        instead."""
        err = self.exception()
        if err is not None:
            raise err
        return self._value


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrontDoorStats:
    """Aggregate front-door accounting (monotone counters)."""

    admitted: int = 0
    served: int = 0
    shed_queue_full: int = 0  # AdmissionRejected (on_full="shed")
    shed_deadline: int = 0  # DeadlineExceeded before dispatch
    rejected_invalid: int = 0  # InvalidRequest at submit
    cancelled: int = 0  # SessionClosed before being served
    failed: int = 0  # DispatchFailed delivered to tickets
    batches: int = 0  # shared dispatches issued
    dispatches: int = 0  # engine dispatches (kernel_launches, retries incl.)
    frames_dispatched: int = 0
    overflow_dropped: int = 0
    retries: int = 0
    deadline_misses: int = 0  # served, but after the deadline
    batch_stats: List[Any] = dataclasses.field(default_factory=list)
    # tile serving (launch.tiles): a TileService sitting in front of the
    # door folds its cache accounting here via ``observe_tiles`` so one
    # stats object describes the whole admission surface. Hits are
    # requests that never became front-door traffic.
    tile_hits: int = 0
    tile_misses: int = 0
    tile_bytes: int = 0  # bytes resident in the tile cache (gauge)

    @property
    def frames_per_batch(self) -> float:
        return self.frames_dispatched / self.batches if self.batches else 0.0

    @property
    def tile_hit_rate(self) -> float:
        lookups = self.tile_hits + self.tile_misses
        return self.tile_hits / lookups if lookups else 0.0

    def observe_tiles(self, hits: int, misses: int, resident_bytes: int):
        """Fold one tile-service response's cache accounting in
        (``launch.tiles.TileService(stats_sink=...)`` calls this)."""
        self.tile_hits += int(hits)
        self.tile_misses += int(misses)
        self.tile_bytes = int(resident_bytes)


@dataclasses.dataclass
class _Batch:
    """One dispatched-but-not-finalised shared batch."""

    index: int
    key: str
    tickets: List[Ticket]
    handle: Any  # PlannedDispatch (or a fake with the same surface)
    dispatched_at: float


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

class TenantSession:
    """One tenant's handle on the front door: submit requests, stream
    results back in submission order, disconnect."""

    def __init__(self, door: "FrontDoor", tenant: str):
        self._door = door
        self.tenant = tenant
        self._tickets: collections.deque = collections.deque()
        self.closed = False

    def submit(self, key: str, bounds, *, deadline=None) -> Ticket:
        """Submit one frame request (see :meth:`FrontDoor.submit`)."""
        return self._door.submit(self.tenant, key, bounds, deadline=deadline)

    def results(self) -> "_ResultStream":
        """Iterate this session's served frames in submission order,
        driving the front door as needed. A shed/failed/cancelled
        request raises its typed error from ``next()`` -- and the
        stream SURVIVES the raise: the next ``next()`` moves on to the
        following request (a generator would die on the first error)."""
        return _ResultStream(self._tickets)

    def pending(self) -> int:
        return len(self._tickets)

    def close(self) -> None:
        """Disconnect: unserved requests (queued or riding an in-flight
        batch) are cancelled with :class:`SessionClosed`; batch-mates
        from other tenants are unaffected -- the demux simply drops
        this tenant's canvases."""
        self._door._close_session(self.tenant)


class _ResultStream:
    """Per-tenant result iterator that outlives per-request errors:
    each ``next()`` settles exactly one request (shared deque with the
    session, so interleaved ``results()`` calls stay in stream order)."""

    def __init__(self, tickets: collections.deque):
        self._tickets = tickets

    def __iter__(self) -> "_ResultStream":
        return self

    def __next__(self) -> RenderedFrame:
        if not self._tickets:
            raise StopIteration
        return self._tickets.popleft().result()


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

class FrontDoor:
    """Multi-tenant admission + coalescing layer over a render service.

    ``service`` is a ``launch.render_service.RenderService`` (or any
    object with the same ``workload_keys() / chunk_frames /
    dispatch_planned(bounds, key=, tenants=, tenant_feedback=)``
    surface, e.g. the scripted fake in ``tests/fakes.py``). ``options``
    is a :class:`repro_torch.workloads.FrontDoorOptions`; ``clock`` defaults
    to the service's own clock so deadlines and service timing share a
    timebase.

    The front door is single-threaded and event-driven: every public
    entry point (``submit`` under backpressure, ``Ticket.result``,
    ``drain``) makes progress by running :meth:`step`, which fills the
    in-flight window (coalesce + dispatch) and then finalises the
    oldest batch. Device compute therefore always runs behind
    admission/demux work up to ``max_in_flight`` batches deep, and the
    whole schedule is a deterministic function of the submit/step call
    sequence -- no timers, no threads, no races.
    """

    def __init__(self, service, *, options: FrontDoorOptions | None = None,
                 clock=None):
        self.service = service
        self.options = options if options is not None else FrontDoorOptions()
        if not isinstance(self.options, FrontDoorOptions):
            raise TypeError(
                f"options must be FrontDoorOptions, got {type(self.options)}")
        if clock is None:
            clock = getattr(service, "_clock", None)
        if clock is None:  # service without a clock (bare fakes)
            import time as _time

            class _Wall:
                @staticmethod
                def now():
                    return _time.perf_counter()

            clock = _Wall()
        self._clock = clock
        self._keys = tuple(str(k) for k in service.workload_keys())
        chunk = int(service.chunk_frames)
        want = self.options.max_batch_frames
        self._max_width = chunk if want is None else min(int(want), chunk)
        self.stats = FrontDoorStats()
        self._sessions: Dict[str, TenantSession] = {}
        self._closed: set = set()
        self._tenant_order: List[str] = []  # DRR ring, first-seen order
        self._queues: Dict[str, collections.deque] = {}
        self._queued_total = 0
        self._in_flight: collections.deque = collections.deque()
        self._seq = 0
        self._tseq: Dict[str, int] = {}
        self._batch_index = 0
        # DRR resume state: the tenant (and its remaining grant) the next
        # batch's fill continues at, so batch truncation is invisible to
        # the fairness sequence
        self._rr_tenant: Optional[str] = None
        self._rr_left = 0
        # online latency model (deadline-aware width): seeds from options
        self._overhead_s = float(self.options.overhead_s)
        self._per_frame_s = float(self.options.per_frame_s)

    def now(self) -> float:
        """The front door's clock (deadlines are absolute times on it)."""
        return self._clock.now()

    # -- sessions -----------------------------------------------------------

    def session(self, tenant: str) -> TenantSession:
        """The tenant's session (created on first use; one per tenant).
        Reopening a closed tenant raises :class:`SessionClosed`."""
        tenant = str(tenant)
        if tenant in self._closed:
            raise SessionClosed(f"session {tenant!r} is closed")
        s = self._sessions.get(tenant)
        if s is None:
            s = self._sessions[tenant] = TenantSession(self, tenant)
        return s

    def _close_session(self, tenant: str) -> None:
        if tenant in self._closed:
            return
        self._closed.add(tenant)
        s = self._sessions.get(tenant)
        if s is not None:
            s.closed = True
        q = self._queues.pop(tenant, None)
        if q:
            self._queued_total -= len(q)
            for tk in q:
                tk._fail(SessionClosed(
                    f"session {tenant!r} disconnected before this request "
                    "was served"))
                self.stats.cancelled += 1
        # requests already riding an in-flight batch: cancel the tickets
        # now; the demux skips resolved tickets (their canvases drop)
        for batch in self._in_flight:
            for tk in batch.tickets:
                if tk.request.tenant == tenant and not tk.done:
                    tk._fail(SessionClosed(
                        f"session {tenant!r} disconnected before this "
                        "request was served"))
                    self.stats.cancelled += 1

    # -- admission ----------------------------------------------------------

    def _validate(self, tenant: str, key: str, bounds) -> Tuple[float, ...]:
        if tenant in self._closed:
            raise SessionClosed(f"session {tenant!r} is closed")
        if key not in self._keys:
            self.stats.rejected_invalid += 1
            raise InvalidRequest(
                f"unknown workload {key!r}; serving {sorted(self._keys)}")
        try:
            b = tuple(float(x) for x in bounds)
        except (TypeError, ValueError):
            self.stats.rejected_invalid += 1
            raise InvalidRequest(f"bounds must be 4 numbers, got {bounds!r}")
        if len(b) != 4 or not all(math.isfinite(x) for x in b):
            self.stats.rejected_invalid += 1
            raise InvalidRequest(
                f"bounds must be 4 finite numbers, got {bounds!r}")
        if not (b[2] > b[0] and b[3] > b[1]):
            self.stats.rejected_invalid += 1
            raise InvalidRequest(
                f"bounds window must have positive extent, got {b}")
        return b

    def submit(self, tenant: str, key: str, bounds, *,
               deadline=None) -> Ticket:
        """Admit one frame request into the bounded queue.

        ``deadline`` is an absolute clock time (the front door's clock;
        None = no deadline). Poisoned requests -- unknown workload,
        malformed bounds -- raise :class:`InvalidRequest` here, BEFORE
        admission, so they can never poison a shared batch. When the
        queue is full, ``on_full="shed"`` raises
        :class:`AdmissionRejected`; ``on_full="block"`` serves queued
        work (dispatch + finalize) until space frees, then admits.
        """
        tenant = str(tenant)
        key = str(key)
        b = self._validate(tenant, key, bounds)
        if deadline is not None:
            deadline = float(deadline)
        while self._queued_total >= self.options.max_queue:
            if self.options.on_full == "shed":
                self.stats.shed_queue_full += 1
                raise AdmissionRejected(
                    f"admission queue full ({self.options.max_queue} "
                    f"requests); retry later or widen FrontDoorOptions."
                    "max_queue")
            self._require_progress()  # block: drain by serving
        sess = self.session(tenant)  # ensure the session exists
        if tenant not in self._queues:
            self._queues[tenant] = collections.deque()
            if tenant not in self._tenant_order:
                self._tenant_order.append(tenant)
        tseq = self._tseq.get(tenant, 0)
        self._tseq[tenant] = tseq + 1
        req = Request(tenant=tenant, key=key, bounds=b, deadline=deadline,
                      seq=self._seq, tseq=tseq)
        self._seq += 1
        tk = Ticket(self, req)
        self._queues[tenant].append(tk)
        self._queued_total += 1
        sess._tickets.append(tk)
        self.stats.admitted += 1
        return tk

    # -- coalescing ---------------------------------------------------------

    def _shed_expired(self, now: float) -> None:
        if not self.options.shed_expired:
            return
        for tenant, q in self._queues.items():
            kept = collections.deque()
            for tk in q:
                d = tk.request.deadline
                if d is not None and d < now:
                    tk._fail(DeadlineExceeded(
                        f"deadline {d:.6f} passed before dispatch "
                        f"(now {now:.6f})"))
                    self.stats.shed_deadline += 1
                    self._queued_total -= 1
                else:
                    kept.append(tk)
            self._queues[tenant] = kept

    def _pick_workload(self, now: float) -> Optional[str]:
        """The next batch's workload: the head request with the most
        urgent deadline (ties: oldest admission). Heads only -- serving
        anything else first would reorder within a tenant."""
        best = None
        for q in self._queues.values():
            if not q:
                continue
            r = q[0].request
            k = (r.deadline_key(), r.seq)
            if best is None or k < best[0]:
                best = (k, r.key)
        return None if best is None else best[1]

    def _width_for(self, key: str, now: float) -> int:
        """Deadline-aware batch width: full width when nothing is
        urgent, shrunk so the latency model ``overhead + W*per_frame``
        fits inside the tightest queued deadline of this workload. The
        model is the EWMA of measured batch latency (seeded from
        options); with no per-frame estimate yet the width stays full
        (there is nothing to shrink by)."""
        W = self._max_width
        if self._per_frame_s <= 0.0:
            return W
        tightest = math.inf
        for q in self._queues.values():
            for tk in q:
                r = tk.request
                if r.key == key and r.deadline is not None:
                    tightest = min(tightest, r.deadline)
        if not math.isfinite(tightest):
            return W
        slack = tightest - now - self._overhead_s
        if slack <= self._per_frame_s:
            return 1  # already late / barely in time: minimal batch, ASAP
        return max(1, min(W, int(slack // self._per_frame_s)))

    def _ring_from(self) -> List[str]:
        ring = [t for t in self._tenant_order if self._queues.get(t)]
        return ring

    def _fill(self, key: str, width: int) -> List[Ticket]:
        """Deficit-round-robin fill: rotate over backlogged tenants in
        first-seen order, granting each up to ``quantum`` head-of-queue
        requests of ``key`` per visit. The rotation position and any
        grant remainder persist across batches, so the served-frame
        sequence is one continuous DRR schedule no matter where batch
        boundaries fall."""
        ring = self._ring_from()
        if not ring:
            return []
        quantum = self.options.quantum
        # resume at the persisted tenant when it is still backlogged,
        # else at the next backlogged tenant after it in ring order
        if self._rr_tenant in ring:
            i = ring.index(self._rr_tenant)
            left = self._rr_left if self._rr_left > 0 else quantum
        else:
            i = 0
            if self._rr_tenant is not None:
                order = self._tenant_order
                if self._rr_tenant in order:
                    j = order.index(self._rr_tenant)
                    after = order[j + 1:] + order[:j + 1]
                    for t in after:
                        if t in ring:
                            i = ring.index(t)
                            break
            left = quantum
        batch: List[Ticket] = []
        idle_visits = 0
        while len(batch) < width and idle_visits < len(ring):
            t = ring[i]
            q = self._queues.get(t)
            took = 0
            while (q and left >= 1 and len(batch) < width
                   and q[0].request.key == key):
                batch.append(q.popleft())
                self._queued_total -= 1
                left -= 1
                took += 1
            if (len(batch) == width and left >= 1 and q
                    and q[0].request.key == key):
                # truncated mid-grant: resume HERE next batch
                self._rr_tenant, self._rr_left = t, left
                return batch
            i = (i + 1) % len(ring)
            left = quantum
            idle_visits = 0 if took else idle_visits + 1
        self._rr_tenant, self._rr_left = ring[i], 0
        return batch

    def _dispatch_next(self) -> bool:
        """Coalesce one shared batch and enqueue it on the devices.
        Returns False when nothing is queued (after shedding)."""
        now = self._clock.now()
        self._shed_expired(now)
        key = self._pick_workload(now)
        if key is None:
            return False
        width = self._width_for(key, now)
        tickets = self._fill(key, width)
        if not tickets:  # can't happen while _pick_workload found a head
            return False
        handle = self.service.dispatch_planned(
            [tk.request.bounds for tk in tickets], key=key,
            tenants=[tk.request.tenant for tk in tickets],
            tenant_feedback=self.options.tenant_feedback)
        self._in_flight.append(_Batch(
            index=self._batch_index, key=key, tickets=tickets,
            handle=handle, dispatched_at=now))
        self._batch_index += 1
        self.stats.batches += 1
        self.stats.frames_dispatched += len(tickets)
        return True

    # -- finalisation / demux -----------------------------------------------

    def _observe_latency(self, frames: int, elapsed: float) -> None:
        if frames < 1 or elapsed < 0:
            return
        alpha = self.options.latency_alpha
        per = max(0.0, elapsed - self._overhead_s) / frames
        if self._per_frame_s <= 0.0:
            self._per_frame_s = per
        else:
            self._per_frame_s += alpha * (per - self._per_frame_s)

    def _finalize_oldest(self) -> None:
        batch = self._in_flight.popleft()
        try:
            res = batch.handle.finalize()
        except Exception as e:
            err = DispatchFailed(
                f"shared batch {batch.index} ({batch.key!r}, "
                f"{len(batch.tickets)} frames) failed: {e!r}")
            err.__cause__ = e
            for tk in batch.tickets:
                if not tk.done:  # disconnected tenants already cancelled
                    tk._fail(err)
                    self.stats.failed += 1
            return
        now = self._clock.now()
        self._observe_latency(len(batch.tickets), now - batch.dispatched_at)
        canv = to_host(res.canvases, getattr(res, "ready", None))
        for j, tk in enumerate(batch.tickets):
            if tk.done:  # session closed while in flight: drop the canvas
                continue
            r = tk.request
            frame = RenderedFrame(
                canvas=canv[j], tenant=r.tenant, workload=batch.key,
                tseq=r.tseq, batch_index=batch.index, chunk=res.chunk,
                deadline=r.deadline, completed_at=now)
            tk._resolve(frame)
            self.stats.served += 1
            if not frame.met_deadline:
                self.stats.deadline_misses += 1
        self.stats.dispatches += int(res.stats.kernel_launches)
        self.stats.overflow_dropped += int(res.stats.overflow_dropped)
        self.stats.retries += int(res.chunk.retries)
        self.stats.batch_stats.append(res.chunk)

    # -- the drive loop -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        return len(self._in_flight)

    @property
    def queued(self) -> int:
        return self._queued_total

    def step(self) -> bool:
        """One scheduling step: fill the in-flight window (coalesce +
        dispatch, up to ``max_in_flight`` deep), then finalise and
        demux the oldest batch. Returns False when there was nothing to
        do. Every blocking entry point is a loop over this method, so
        driving it directly (as the deterministic tests do) replays
        exactly the production schedule."""
        progressed = False
        while (len(self._in_flight) < self.options.max_in_flight
               and self._dispatch_next()):
            progressed = True
        if self._in_flight:
            self._finalize_oldest()
            progressed = True
        return progressed

    def _require_progress(self) -> None:
        if not self.step():
            raise RuntimeError(
                "front door cannot make progress: nothing queued or in "
                "flight (is a ticket being awaited that was never "
                "admitted?)")

    def drain(self) -> None:
        """Serve until every admitted request has settled."""
        while self.step():
            pass

    def close(self) -> None:
        """Drain, then close every session."""
        self.drain()
        for t in list(self._sessions):
            self._close_session(t)
