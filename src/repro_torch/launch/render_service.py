"""Chunked frame-rendering service: stream arbitrarily long zoom sequences
through the sharded batch engines, with the host I/O of chunk k
overlapped against the card's work on chunk k+1.

Counterpart of ``repro/launch/render_service.py``, every public name
included (``RenderService``, ``RenderStats``, ``ChunkStats``,
``ChunkResult``, ``PlannedDispatch``, ``zoom_bounds``, the two defaults
and the CLI). A zoom trajectory can be millions of frames -- far more
than one batch should hold -- so the service chunks the stream into
fixed-size, device-divisible batches and enqueues each through
``workloads.dispatch_batch`` over a frames mesh (``launch.mesh``):

  * chunk size is a multiple of the mesh's size, so every device owns
    ``chunk/devices`` frames;
  * the ragged tail chunk is padded back up to the SAME chunk width
    (``pad_to=chunk_frames``) with dead frames, which are masked out of
    canvases and stats, so the streamed output equals rendering each frame
    alone;
  * with ``pipeline_depth >= 2`` (the default is 2: double buffering) up
    to ``pipeline_depth`` chunks are in flight at once. JAX gets that from
    async dispatch; here a dispatch returns once its level loop is
    enqueued on the device's stream (no host sync), and its read-back
    waits only for its own events (``core.readback``): ``finalize()`` on
    the stats' pinned copy, the host copy of the canvases
    (``readback.to_host``, in ``render()`` and the front doors) on a copy
    stream behind the chunk's event. So while the host blocks on chunk k
    -- and while the consumer converts, encodes or writes it -- the card
    is already computing chunks k+1..k+depth-1. ``ChunkStats`` records
    per-chunk enqueue/fetch times; a pipelined run's ``wall_s`` against a
    synchronous run's ``busy_s`` measures the overlap.
    ``pipeline_depth=1`` is the synchronous service (dispatch, block,
    yield, repeat);

  * with ``feedback=`` set, the service closes the occupancy loop
    (planner-aware chunking): each chunk's ring capacities are re-planned
    from a ``core.feedback.OccupancyEstimator`` BEFORE dispatch -- the
    zoom-depth prior on the cold-start chunk, the EWMA of the previous
    chunks' measured ``region_counts`` afterwards -- and a boundary-aware
    chunker cuts a chunk early when the predicted capacity class jumps.
    Predictions are quantized onto the estimator's ``p_quantum`` grid and
    dispatch widths are power-of-two bucketed (``_pad_width``), so the
    (chunk width, capacity signature) pairs stay few for the life of the
    service. Frames that still overflow are retried at doubled capacities
    (clamped at the worst case) and patched into the chunk's canvas on the
    device before the chunk is yielded: ``overflow_dropped == 0`` holds
    chunk by chunk, and the measured counts that come back -- retries
    included -- are what the estimator folds in.

``python -m repro_torch.launch.render_service --frames 64 --n 256`` runs
a self-timed trajectory end to end on the card and prints the pipelined
wall time (``--feedback`` switches on the closed loop).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import os
import time
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping, Tuple, Union

import numpy as np

import torch

from repro_torch.core import readback
from repro_torch.core.feedback import OccupancyEstimator
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch.mesh import make_frames_mesh

# frames each device renders per dispatch when the caller doesn't pin a
# chunk size; bigger amortises dispatch overhead, smaller bounds latency
DEFAULT_FRAMES_PER_DEVICE = 4

# dispatched-but-not-finalised chunks the pipelined stream keeps in
# flight: 2 == classic double buffering (compute k+1 behind fetch of k)
DEFAULT_PIPELINE_DEPTH = 2

__all__ = ["RenderService", "RenderStats", "ChunkStats", "ChunkResult",
           "PlannedDispatch", "zoom_bounds", "DEFAULT_FRAMES_PER_DEVICE",
           "DEFAULT_PIPELINE_DEPTH"]


class _WallClock:
    """Default timing source: monotonic wall time. The service reads
    time ONLY through its clock, so the deterministic test harness
    (``tests/fakes.py``) can substitute a virtual clock and assert on
    exact schedules instead of sleeping."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()


_WALL = _WallClock()


def _ready(handle):
    """A dispatch handle's ``ready`` event, once it is finalized (None on
    the CPU, and for the scripted engines of the tests, whose canvases
    are numpy)."""
    return getattr(handle, "ready", None)


def _after(canvases, ready):
    """An event after everything enqueued so far on the stream that writes
    ``canvases`` (the retries' patches), or ``ready`` off the card."""
    if isinstance(canvases, torch.Tensor) and canvases.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(canvases.device))
        return event
    return ready


@dataclasses.dataclass
class ChunkStats:
    """Per-chunk timing of the streamed pipeline.

    ``dispatch_s`` is the time to *enqueue* the chunk's level loop (the
    dispatch returns before the card finishes); ``fetch_s`` is the
    time the host then spent blocked in ``finalize()`` materialising the
    chunk. In the synchronous path ``fetch_s`` absorbs the chunk's whole
    device compute; in the pipelined path chunk k+1's compute runs
    behind the fetch/host processing of chunk k, so its own ``fetch_s``
    shrinks by the hidden amount -- comparing a pipelined run's
    ``RenderStats.wall_s`` against a synchronous run's ``busy_s`` (the
    sum of per-chunk compute + host-copy costs) measures the overlap.
    """

    index: int
    frames: int
    dispatch_s: float
    fetch_s: float
    in_flight: int  # chunks already enqueued when this one was finalised
    # feedback (planner-aware) serving only:
    p_subdiv: float | None = None  # quantized planning P that sized the chunk
    p_source: str = ""  # "prior" | "measured" | "mixed" (cold start = prior)
    retries: int = 0  # frame re-dispatches after overflow
    ring_rows: int = 0  # OLT-ring rows allocated, retry dispatches included
    workload: str = ""  # mixed-workload serving: problem key of this chunk
    # multi-tenant front-door batches (launch.frontdoor): the tenant id
    # of each frame of this chunk, in frame order; () for single-tenant
    # streams. ``tenant_frames()`` aggregates the attribution.
    tenants: tuple = ()
    # tile serving (launch.tiles): how the viewport that produced this
    # chunk split between the dwell cache and fresh rendering. The
    # chunk's frames are the MISSES; hits never reach a dispatch.
    cache_hits: int = 0
    cache_misses: int = 0
    cache_bytes: int = 0  # bytes resident in the tile cache afterwards

    @property
    def busy_s(self) -> float:
        return self.dispatch_s + self.fetch_s

    def tenant_frames(self) -> dict:
        """Per-tenant frame attribution of this chunk ({tenant: frame
        count}; empty for single-tenant streams)."""
        out: dict = {}
        for t in self.tenants:
            out[t] = out.get(t, 0) + 1
        return out


@dataclasses.dataclass
class ChunkResult:
    """One finalised chunk: canvases [f, n, n] (a tensor on the mesh's
    first device; numpy from the front doors), engine stats, timing, and
    ``ready``: the CUDA event after which the canvases are written, which
    their host copy waits on (``readback.to_host``; None on the CPU)."""

    canvases: Any
    stats: Any  # core.ask.ASKStats for this chunk's dispatch
    chunk: ChunkStats
    ready: Any = None


class PlannedDispatch:
    """Handle of one in-flight ``RenderService.dispatch_planned`` batch.

    The batch-ingestion seam of the multi-tenant front door
    (``launch.frontdoor``): the batch is already enqueued on the
    devices when this handle exists; ``finalize()`` blocks, runs the
    service's overflow-retry loop to zero drops (feedback path), feeds
    the estimator, and returns the same ``ChunkResult`` the streaming
    path yields -- with ``ChunkStats.tenants`` carrying the per-frame
    tenant attribution. ``finalize()`` is one-shot.
    """

    def __init__(self, service, item, tenants, tenant_feedback):
        self._service = service
        self._item = item  # (i, key, bounds, depths, p, caps, src, d, disp_s)
        self._tenants = tuple(tenants)
        self._tenant_feedback = bool(tenant_feedback)
        self._done = False

    @property
    def frames(self) -> int:
        return len(self._item[2])

    @property
    def workload(self) -> str:
        return self._item[1]

    @property
    def tenants(self) -> tuple:
        return self._tenants

    def finalize(self) -> ChunkResult:
        """Block until the batch is materialised (overflow retried to
        zero drops on the feedback path) and demuxable."""
        if self._done:
            raise RuntimeError("PlannedDispatch.finalize() is one-shot")
        self._done = True
        svc = self._service
        if svc.estimator is not None:
            return svc._finalize_feedback(
                self._item, in_flight=1, tenants=self._tenants,
                tenant_feedback=self._tenant_feedback)
        i, key, bounds, depths, p, caps, src, d, disp_s = self._item
        t0 = svc._clock.now()
        canvases, st = d.finalize()
        fetch_s = svc._clock.now() - t0
        return ChunkResult(canvases, st, ChunkStats(
            index=i, frames=len(bounds), dispatch_s=disp_s, fetch_s=fetch_s,
            in_flight=1, workload=key, tenants=self._tenants), _ready(d))


@dataclasses.dataclass
class RenderStats:
    """Aggregate accounting across a streamed trajectory."""

    frames: int = 0
    chunks: int = 0
    dispatches: int = 0  # engine dispatches issued (target: one per chunk)
    leaf_count: int = 0
    overflow_dropped: int = 0
    wall_s: float = 0.0
    pipeline_depth: int = 1
    dispatch_s: float = 0.0  # total time spent enqueueing chunks
    fetch_s: float = 0.0  # total time blocked materialising chunks
    host_copy_s: float = 0.0  # render() only: device->numpy conversion
    chunk_stats: tuple = ()  # ChunkStats per chunk, stream order
    # chunk-program signatures AFTER the stream (``program_traces()``).
    # Uniform serving: 1 == every chunk, ragged tail included, ran at ONE
    # (width, capacities); 2+ means the pad_to plumbing regressed.
    # Feedback serving: one per capacity signature, whose regression
    # target is ``plan_signatures``.
    program_traces: int | None = None
    # feedback serving only: frame re-dispatches after overflow, total
    # OLT-ring rows allocated (retries included), and how many distinct
    # capacity signatures (chunk programs) the stream requested
    retries: int = 0
    ring_rows: int = 0
    plan_signatures: int | None = None

    @property
    def dispatches_per_chunk(self) -> float:
        return self.dispatches / self.chunks if self.chunks else 0.0

    @property
    def busy_s(self) -> float:
        """Sum of per-chunk (enqueue + fetch + host copy/sink) costs. For
        a synchronous run (pipeline_depth=1) this is the serial cost of
        the trajectory -- the baseline a pipelined run's ``wall_s`` is
        measured against: wall(pipelined) < busy(sync) is the overlap."""
        return self.dispatch_s + self.fetch_s + self.host_copy_s


def zoom_bounds(
    frames: int,
    *,
    center: Tuple[float, float] = (-0.7436447860, 0.1318252536),
    width0: float = 3.0,
    zoom_per_frame: float = 1.05,
) -> Iterator[Tuple[float, float, float, float]]:
    """Exponential zoom trajectory: yields (re0, im0, re1, im1) per frame,
    shrinking the window by ``zoom_per_frame`` each step around ``center``
    (default: a classic seahorse-valley deep-zoom target)."""
    cr, ci = center
    half = width0 / 2.0
    for _ in range(frames):
        yield (cr - half, ci - half, cr + half, ci + half)
        half /= zoom_per_frame


class RenderService:
    """Chunked sharded serving of a workload frame stream.

    ``problem`` is a ``workloads.FrameProblem`` (any registered
    workload), or -- mixed-workload serving -- a mapping {key:
    FrameProblem} whose problems share one canvas size; stream items
    are then ``(key, bounds)`` pairs instead of bare bounds tuples.
    ``mesh`` defaults to a 1-D mesh over every visible card
    (``launch.mesh.make_frames_mesh()``, which raises without one: pass
    ``make_frames_mesh(device="cpu")`` for CPU shards); ``chunk_frames``
    is rounded up to a multiple of the mesh's size; ``pipeline_depth``
    bounds how many chunks may be in flight at once (1 = synchronous, 2 = double
    buffering, the default). Engine kwargs (``capacities``,
    ``safety_factor``, ...) pass through to the scan engine unchanged.

    ``feedback`` (True or a ``core.feedback.OccupancyEstimator``) turns
    on closed-loop planner-aware chunking: every chunk's ring
    capacities come from the estimator's (quantized) prediction at the
    chunk's zoom depths -- the WORKLOAD's zoom-depth prior while the
    estimator is cold, the previous chunks' measured occupancy
    afterwards -- the chunker splits a chunk early when the predicted
    capacity class (or the workload) jumps, overflowing frames are
    retried at doubled capacities before the chunk is yielded, and the
    finished chunk's measured ``region_counts`` are folded back into
    the estimator under the chunk's workload namespace (so a mixed
    mandelbrot+julia stream never plans one workload from the other's
    measurements). Mixed-workload serving requires the feedback path
    (it IS the planner-aware chunker). ``adapt=False`` keeps the same
    chunking/retry machinery but never feeds measurements back -- the
    prior-only baseline the feedback benchmark rows compare against.
    With ``pipeline_depth >= 2`` the feedback lags by the chunks in
    flight: chunk k is planned from the chunks finalised before it was
    enqueued, which is what keeps the re-plan loop compatible with the
    async overlap.

    ``feedback_state`` (a JSON path) persists the estimator across
    service restarts: an existing file is loaded at construction (so
    the first chunk plans from the previous process's measurements
    instead of the cold prior), and ``render()`` saves back on
    completion (``save_feedback_state()`` for streaming callers).

    ``engine="ask_pooled"`` serves every chunk through the cross-frame
    pooled worklists (``core.pooled``): each device shard pools ITS
    frames into ONE shared ring sized from their summed per-frame
    occupancies. On the feedback path the chunker then cuts only on
    workload switches (heterogeneous frames are the point of pooling --
    a capacity-class jump stays inside the chunk, see
    ``_pooled_chunks``), the retry loop escalates the shared pool
    (``pooled.escalate_pooled_capacities``), and ``ChunkStats.
    ring_rows`` counts ``n_dev x 2 x max(caps)`` per dispatch -- the
    pooled allocation the feedback benchmark compares against the
    per-frame path's ``pad x 2 x max(caps)``.

    ``policy=`` (a ``KernelPolicy`` or a backend name) replaces every
    problem's kernel routing: one policy for every tenant, as the service
    owns ``pad_to`` and chunking. ``clock`` (an object with ``now()``)
    replaces wall time for every timing the service takes.
    """

    def __init__(self, problem, *, mesh=None, chunk_frames: int | None = None,
                 pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
                 feedback: OccupancyEstimator | bool | None = None,
                 adapt: bool = True,
                 feedback_state: Union[str, Path, None] = None,
                 policy=None,
                 engine: str = "ask_scan",
                 clock=None,
                 **engine_kw):
        if engine not in ("ask_scan", "ask_pooled"):
            raise ValueError(
                f"service engine must be 'ask_scan' or 'ask_pooled', got "
                f"{engine!r} (the tuned tier is a policy= concern)")
        self.engine = engine
        if "pad_to" in engine_kw:
            raise ValueError(
                "pad_to is owned by the service (pinned to chunk_frames so "
                "every chunk runs at one program signature); set "
                "chunk_frames instead")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if isinstance(problem, Mapping):
            if not problem:
                raise ValueError("problem mapping must not be empty")
            self._problems = {str(k): p for k, p in problem.items()}
            self._mixed = True
            self.problem = None  # no single canonical problem in mixed mode
        else:
            self._problems = {"": problem}
            self._mixed = False
            self.problem = problem
        if policy is not None:
            pol = KernelPolicy.coerce(policy)
            self._problems = {k: dataclasses.replace(p, policy=pol)
                              for k, p in self._problems.items()}
            if not self._mixed:
                self.problem = self._problems[""]
        sizes = {p.n for p in self._problems.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"mixed-workload problems must share one canvas size n, "
                f"got {sorted(sizes)}")
        self._n = sizes.pop()
        dtypes = {np.dtype(getattr(getattr(p, "workload", None), "dtype",
                                   np.int32))
                  for p in self._problems.values()}
        if len(dtypes) != 1:
            raise ValueError(
                "mixed-workload problems must share one canvas dtype "
                f"(render() stacks chunks into one array), got "
                f"{sorted(d.name for d in dtypes)}")
        self._dtype = dtypes.pop()
        self.mesh = make_frames_mesh() if mesh is None else mesh
        n_dev = self.mesh.size
        want = (n_dev * DEFAULT_FRAMES_PER_DEVICE if chunk_frames is None
                else int(chunk_frames))
        if want < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {want}")
        self.chunk_frames = -(-want // n_dev) * n_dev  # round up to multiple
        self.pipeline_depth = int(pipeline_depth)
        self._state_path = (None if feedback_state is None
                            else Path(feedback_state))
        if self._state_path is not None and not feedback:
            feedback = True  # a state path IS a request for the closed loop
        if feedback:
            clash = {"capacities", "p_subdiv"} & engine_kw.keys()
            if clash:
                raise ValueError(
                    f"{sorted(clash)} conflict with feedback=: the service "
                    "re-plans each chunk's capacities from the estimator; "
                    "tune safety_factor / the OccupancyEstimator instead")
            if (self._state_path is not None
                    and isinstance(feedback, OccupancyEstimator)):
                raise ValueError(
                    "pass feedback_state= OR a prebuilt OccupancyEstimator, "
                    "not both -- restoring the file would discard the "
                    "estimator you handed in")
            if self._state_path is not None and self._state_path.exists():
                self.estimator = OccupancyEstimator.restore(
                    json.loads(self._state_path.read_text()))
            else:
                self.estimator = (feedback
                                  if isinstance(feedback, OccupancyEstimator)
                                  else OccupancyEstimator())
            self._ref_widths = {}
            for key, prob in self._problems.items():
                bounds = getattr(prob, "bounds", None)
                if bounds is None:
                    raise ValueError(
                        "feedback= needs problem.bounds to anchor zoom depth")
                self._ref_widths[key] = float(bounds[2]) - float(bounds[0])
        else:
            if self._mixed:
                raise ValueError(
                    "mixed-workload serving needs feedback= (the planner-"
                    "aware chunker is what routes each frame to its "
                    "workload's program and prior)")
            if not adapt:
                raise ValueError(
                    "adapt=False is the prior-only FEEDBACK baseline (same "
                    "chunking/retry machinery, no estimator updates) -- it "
                    "needs feedback= set; without it the service runs the "
                    "uniform path and the flag would be silently ignored")
            self.estimator = None
            self._ref_widths = None
        self.adapt = bool(adapt)
        self.engine_kw = engine_kw
        # all service timing goes through the clock so the deterministic
        # harness (tests/fakes.py VirtualClock) can replace wall time
        self._clock = _WALL if clock is None else clock
        self._caps_cache: dict = {}  # (problem key, quantized P) -> capacities
        # (problem key, pad width, caps) dispatched; caps None: uniform
        self._used_sigs: set = set()
        self._planned_index = 0  # ChunkStats.index of dispatch_planned batches

    # -- dispatch plumbing --------------------------------------------------

    def _dispatch(self, chunk, caps=None, key: str = ""):
        """Enqueue one chunk; returns (ShardedDispatch, enqueue seconds).

        ``caps`` (feedback path) overrides the engine kwargs' sizing with
        a per-chunk capacity vector and pads to the pow2-bucketed width
        (``_pad_width``); the uniform path keeps the width pinned to
        ``chunk_frames``. ``key`` selects the problem in mixed-workload
        mode. Either way a chunk runs at a (problem, chunk width, capacity
        signature) that ``program_traces()`` counts. The enqueue makes no
        host sync: the level loop, the stats' pinned copy and its event go
        onto the device's stream and the call returns.
        """
        from repro_torch.workloads import dispatch_batch
        from repro_torch.workloads.options import EngineOptions

        kw = dict(self.engine_kw)
        pad = self.chunk_frames
        if caps is not None:
            kw["capacities"] = caps
            pad = self._pad_width(len(chunk))
        self._used_sigs.add((key, pad, None if caps is None else tuple(caps)))
        t0 = self._clock.now()
        if self.engine == "ask_pooled":
            # the pooled engine is selected through EngineOptions (the
            # legacy flat-kwargs path predates engines); capacities are
            # then PER-SHARD shared pool caps, which is exactly what
            # _pooled_caps_for / the pooled escalation produce
            opts = EngineOptions.from_kwargs(
                {**kw, "mesh": self.mesh, "pad_to": pad},
                engine="ask_pooled")
            d = dispatch_batch(self._problems[key], chunk, options=opts)
        else:
            d = dispatch_batch(self._problems[key], chunk, mesh=self.mesh,
                               pad_to=pad, **kw)
        return d, self._clock.now() - t0

    def _pad_width(self, f: int) -> int:
        """Padding width of a feedback-path dispatch: the next power-of-
        two multiple of the device count, capped at ``chunk_frames``.

        Early-split chunks and small retry batches would waste most of a
        full-width dispatch's ring (padding frames cost real compute),
        but letting every length be its own width would make a program
        signature per length; power-of-two bucketing bounds the widths at
        O(log(chunk_frames / devices)) -- so the signatures (chunk width,
        capacity signature) stay few, the discipline the uniform path pins
        with its single width.
        """
        n_dev = self.mesh.size
        w = n_dev
        while w < f:
            w *= 2
        return min(w, self.chunk_frames)

    # -- feedback (planner-aware) serving -----------------------------------

    def _split_item(self, item) -> Tuple[str, Any]:
        """One stream item -> (problem key, bounds). Single-problem
        streams carry bare bounds tuples; mixed-workload streams carry
        (key, bounds) pairs."""
        if not self._mixed:
            return "", item
        key, bounds = item
        key = str(key)
        if key not in self._problems:
            raise KeyError(
                f"stream item names unknown problem {key!r}; serving "
                f"{sorted(self._problems)}")
        return key, bounds

    def _depth(self, key: str, bounds) -> float:
        from repro_torch.core.planner import zoom_depth

        return zoom_depth(float(bounds[2]) - float(bounds[0]),
                          ref_width=self._ref_widths[key],
                          r=self._problems[key].r)

    def _caps_for(self, key: str, p: float):
        """Capacity vector for one (problem, quantized planning P)
        (memoised: the p_quantum grid keeps this cache -- and the
        program signature set -- small for the life of the
        service)."""
        ck = (key, round(float(p), 6))
        caps = self._caps_cache.get(ck)
        if caps is None:
            from repro_torch.core.ask import scan_capacities

            prob = self._problems[key]
            caps = scan_capacities(
                prob.n, prob.g, prob.r, prob.B, p_subdiv=ck[1],
                safety_factor=self.engine_kw.get("safety_factor", 2.0))
            self._caps_cache[ck] = caps
        return caps

    def _adaptive_chunks(self, it: Iterator):
        """Boundary-aware chunker: yields (key, bounds, depths, p, caps,
        source) with every frame of a chunk in ONE problem and ONE
        predicted capacity class. A class jump -- or a workload switch
        in a mixed stream -- cuts the chunk early: deep-tail frames get
        their own (hotter) program instead of inflating the whole
        chunk's ring, and every dispatch stays single-workload. Lazy:
        predictions are made as frames are pulled, so re-planning
        naturally picks up whatever the estimator has observed by then.
        """
        est = self.estimator
        buf: list = []
        depths: list = []
        sources: list = []
        cls = None  # (problem key, quantized P, capacities) of the open chunk

        def flush():
            src = (sources[0] if len(set(sources)) == 1 else "mixed")
            return cls[0], list(buf), list(depths), cls[1], cls[2], src

        for item in it:
            key, b = self._split_item(item)
            wl = self._problems[key].workload
            d = self._depth(key, b)
            p = est.predict_quantized(d, workload=wl)
            caps = self._caps_for(key, p)
            if buf and (key, p, caps) != cls:
                yield flush()
                buf, depths, sources = [], [], []
                # the estimator may have observed the flushed chunk while
                # this generator was suspended in that yield: re-predict
                # the held-over frame so the new chunk's class and
                # provenance both reflect the post-observation state
                p = est.predict_quantized(d, workload=wl)
                caps = self._caps_for(key, p)
            cls = (key, p, caps)
            buf.append(b)
            depths.append(d)
            sources.append("measured"
                           if est.measured(d, workload=wl) is not None
                           else "prior")
            if len(buf) == self.chunk_frames:
                yield flush()
                buf, depths, sources, cls = [], [], [], None
        if buf:
            yield flush()

    def _pooled_caps_for(self, key: str, ps):
        """Shared per-shard ring capacities for one pooled chunk: the
        members' expected occupancies are summed per shard (frame-major
        assignment, live frames only; ``core.pooled.pooled_capacities``),
        maxed across shards so every shard runs the one program, then
        rounded up to powers of two (clamped at the shard worst case) --
        so the capacity-signature set stays bounded even though every
        chunk carries its own P mix."""
        from repro_torch.core.olt import next_pow2
        from repro_torch.core.planner import worst_case_capacities
        from repro_torch.core.pooled import pooled_capacities

        prob = self._problems[key]
        n_dev = self.mesh.size
        S = self._pad_width(len(ps)) // n_dev
        sf = self.engine_kw.get("safety_factor", 2.0)
        caps = None
        for d in range(n_dev):
            shard = ps[d * S:(d + 1) * S]
            if not shard:
                continue
            c = pooled_capacities(prob, shard, safety_factor=sf)
            caps = c if caps is None else tuple(
                max(a, b) for a, b in zip(caps, c))
        worst = worst_case_capacities(prob)
        return tuple(min(next_pow2(c), S * w) for c, w in zip(caps, worst))

    def _pooled_chunks(self, it: Iterator):
        """Pooled chunker: yields the same (key, bounds, depths, p, caps,
        source) tuples as ``_adaptive_chunks``, but a chunk is cut ONLY
        on a workload switch or when full. Heterogeneous frames are the
        POINT of pooling -- one shared ring sized from their summed
        occupancies -- so a predicted capacity-class jump stays inside
        the chunk instead of splitting it into per-class dispatches.
        ``caps`` is the per-shard pooled vector (``_pooled_caps_for``);
        ``p`` reports the hottest member's prediction."""
        est = self.estimator
        buf: list = []
        depths: list = []
        ps: list = []
        sources: list = []
        key_open: str | None = None

        def flush():
            src = (sources[0] if len(set(sources)) == 1 else "mixed")
            return (key_open, list(buf), list(depths), max(ps),
                    self._pooled_caps_for(key_open, ps), src)

        for item in it:
            key, b = self._split_item(item)
            if buf and key != key_open:
                yield flush()
                buf, depths, ps, sources = [], [], [], []
            key_open = key
            wl = self._problems[key].workload
            d = self._depth(key, b)
            # predicted AFTER any flush above resumes, so the pool's
            # sizing reflects whatever the estimator observed by then
            ps.append(est.predict_quantized(d, workload=wl))
            sources.append("measured"
                           if est.measured(d, workload=wl) is not None
                           else "prior")
            buf.append(b)
            depths.append(d)
            if len(buf) == self.chunk_frames:
                yield flush()
                buf, depths, ps, sources = [], [], [], []
                key_open = None
        if buf:
            yield flush()

    def _resolve_overflow(self, key, bounds, caps, canvases, st, ready):
        """Retry overflowing frames at doubled capacities until every
        frame fits, then merge canvases/stats. Returns (canvases, merged
        ASKStats, frame re-dispatch count, retry ring rows, ready).

        The retried frames are patched into the chunk's canvas where it
        lies (on the device), row by row behind each retry on the same
        stream; ``ready`` then becomes an event after the last patch. The
        merged stats' ``olt_caps`` are the LARGEST capacities any of the
        chunk's frames ran at (the escalated vector when retries
        happened), so ``ASKStats.ring_rows`` never under-reports the
        per-frame residency of a hot chunk; the per-dispatch total incl.
        padding lives in ``ChunkStats.ring_rows``."""
        from repro_torch.core.ask import ASKStats
        from repro_torch.core.planner import (escalate_capacities,
                                              worst_case_capacities)

        f = len(bounds)
        chains = list(st.frame_chains())
        launches = st.kernel_launches
        wall = st.wall_s
        retries = 0
        retry_rows = 0
        cur = tuple(caps)
        pending = [j for j, o in enumerate(st.frame_overflow) if o]
        n_dev = self.mesh.size
        if pending:
            worst = worst_case_capacities(self._problems[key])
        ran = self._pad_width(f) // n_dev  # pool width of the last dispatch
        first = True
        while pending:
            if self.engine == "ask_pooled":
                from repro_torch.core.pooled import (
                    escalate_pooled_capacities, failed_pool_capacities)

                nxt = self._pad_width(len(pending)) // n_dev
                if first and self.estimator is not None:
                    # First retry: size the ring from ONLY the pending
                    # frames' measured chains + their own estimated P,
                    # not a doubling of the whole chunk's shared pool.
                    prob = self._problems[key]
                    ps = [float(self.estimator.predict_quantized(
                              self._depth(key, bounds[j]),
                              workload=prob.workload))
                          for j in pending]
                    cur = failed_pool_capacities(
                        prob, [chains[j][0] for j in pending],
                        leaf_counts=[chains[j][1] for j in pending],
                        frames_per_shard=nxt, frame_ps=ps,
                        caps_prev=cur, dispatched_per_shard=ran)
                else:
                    cur = escalate_pooled_capacities(
                        cur, worst, nxt, pending, dispatched_per_shard=ran)
                ran = nxt
            else:
                cur = escalate_capacities(cur, worst, pending)
            first = False
            d, _ = self._dispatch([bounds[j] for j in pending], caps=cur,
                                  key=key)
            rc, rst = d.finalize()
            if self.engine == "ask_pooled":
                # shared pool: one ring of 2*max(cur) rows PER DEVICE
                retry_rows += n_dev * 2 * max(cur)
            else:
                retry_rows += self._pad_width(len(pending)) * 2 * max(cur)
            retries += len(pending)
            launches += rst.kernel_launches
            wall += rst.wall_s
            still = []
            for k, j in enumerate(pending):
                if rst.frame_overflow[k] == 0:
                    canvases[j] = rc[k]
                    chains[j] = (rst.region_counts[k],
                                 rst.frame_leaf_counts[k])
                else:
                    still.append(j)
            pending = still
            ready = _after(canvases, ready)
        merged = ASKStats(
            levels=max((len(c) for c, _ in chains), default=0),
            kernel_launches=launches,
            region_counts=tuple(c for c, _ in chains),
            leaf_count=sum(leaf for _, leaf in chains),
            overflow_dropped=0,  # the loop only exits once every frame fits
            wall_s=wall,
            olt_caps=cur,  # == caps when nothing retried
            frame_overflow=(0,) * f,
            frame_leaf_counts=tuple(leaf for _, leaf in chains),
        )
        return canvases, merged, retries, retry_rows, ready

    def _finalize_feedback(self, item, in_flight: int, tenants=(),
                           tenant_feedback: bool = False) -> ChunkResult:
        """Block on one in-flight feedback chunk: finalize, retry any
        overflow, fold the measured counts into the estimator (under
        the chunk's workload namespace -- and, for multi-tenant batches
        with ``tenant_feedback``, additionally under each frame's
        tenant namespace so per-tenant plans refine independently)."""
        i, key, bounds, depths, p, caps, src, d, disp_s = item
        t0 = self._clock.now()
        canvases, st = d.finalize()
        canv, merged, retries, retry_rows, ready = self._resolve_overflow(
            key, bounds, caps, canvases, st, _ready(d))
        fetch_s = self._clock.now() - t0  # retry dispatches included
        prob = self._problems[key]
        if self.adapt:
            self.estimator.observe_stats(depths, merged, g=prob.g, r=prob.r,
                                         workload=prob.workload)
            if tenant_feedback and tenants:
                chains = merged.frame_chains()
                by_tenant: dict = {}
                for j, t in enumerate(tenants):
                    by_tenant.setdefault(t, []).append(j)
                for t, idxs in by_tenant.items():
                    self.estimator.observe_frames(
                        [depths[j] for j in idxs],
                        [chains[j] for j in idxs],
                        g=prob.g, r=prob.r, workload=prob.workload,
                        tenant=t)
        if self.engine == "ask_pooled":
            # ONE shared ring per device shard, not one per frame
            ring = self.mesh.size * 2 * max(caps) + retry_rows
        else:
            ring = self._pad_width(len(bounds)) * 2 * max(caps) + retry_rows
        return ChunkResult(canv, merged, ChunkStats(
            index=i, frames=len(bounds), dispatch_s=disp_s,
            fetch_s=fetch_s, in_flight=in_flight, p_subdiv=p,
            p_source=src, retries=retries,
            ring_rows=ring, workload=key, tenants=tuple(tenants)), ready)

    # -- multi-tenant front-door seam ---------------------------------------

    def workload_keys(self) -> Tuple[str, ...]:
        """The problem keys this service can dispatch ("" for a single-
        problem service). The front door validates request workloads
        against this set at admission time."""
        return tuple(sorted(self._problems))

    @property
    def n(self) -> int:
        """Shared canvas size of every problem this service serves."""
        return self._n

    def problem_for(self, key: str = ""):
        """The ``FrameProblem`` serving ``key`` ("" for a single-problem
        service). The tile service's progressive path (``launch.tiles``)
        dispatches split scans (``core.progressive``) against it
        directly, bypassing the uniform chunker."""
        key = str(key)
        if key not in self._problems:
            raise KeyError(
                f"unknown problem {key!r}; serving {sorted(self._problems)}")
        return self._problems[key]

    def dispatch_planned(self, bounds, *, key: str = "", tenants=(),
                         tenant_feedback: bool = False) -> PlannedDispatch:
        """Batch-ingestion seam: enqueue ONE explicitly coalesced batch.

        This is how the multi-tenant front door (``launch.frontdoor``)
        feeds shared batches through the service's planning, dispatch,
        retry, and feedback machinery without going through the
        streaming chunker: ``bounds`` is a list of frame bounds (all in
        problem ``key``, at most ``chunk_frames`` of them -- the front
        door owns coalescing, the service owns planning and padding),
        ``tenants`` optionally attributes each frame to a tenant id
        (same length as ``bounds``; lands in ``ChunkStats.tenants``).

        On the feedback path the batch's ring capacities come from the
        estimator exactly as the streaming chunker's would -- sized for
        the HOTTEST member, since a coalesced batch deliberately mixes
        tenants' capacity classes -- and ``finalize()`` retries overflow
        to zero drops and folds the measured counts back in (per-tenant
        namespaces too when ``tenant_feedback`` is set). Without
        feedback the batch runs the uniform path (engine kwargs sizing,
        no retry), mirroring the uniform stream. Returns immediately
        with a ``PlannedDispatch`` (no host sync): the caller overlaps its
        own admission/demux work with the card's compute and calls
        ``finalize()`` when it needs the frames.
        """
        key = str(key)
        if key not in self._problems:
            raise KeyError(
                f"dispatch_planned names unknown problem {key!r}; serving "
                f"{sorted(self._problems)}")
        bounds = [tuple(float(x) for x in b) for b in bounds]
        if not bounds:
            raise ValueError("dispatch_planned needs at least one frame")
        if len(bounds) > self.chunk_frames:
            raise ValueError(
                f"batch of {len(bounds)} frames exceeds chunk_frames="
                f"{self.chunk_frames}; the front door must cut batches at "
                "the service's chunk width")
        tenants = tuple(str(t) for t in tenants)
        if tenants and len(tenants) != len(bounds):
            raise ValueError(
                f"got {len(tenants)} tenants for {len(bounds)} frames")
        index = self._planned_index
        self._planned_index += 1
        if self.estimator is None:
            if self._mixed:
                raise ValueError(
                    "mixed-workload dispatch_planned needs feedback= "
                    "(same contract as the streaming chunker)")
            d, secs = self._dispatch(bounds, key=key)
            item = (index, key, bounds, None, None, None, "", d, secs)
            return PlannedDispatch(self, item, tenants, tenant_feedback)
        est = self.estimator
        wl = self._problems[key].workload
        depths = [self._depth(key, b) for b in bounds]
        t_of = (lambda j: tenants[j]) if (tenant_feedback and tenants) \
            else (lambda j: None)
        ps = [est.predict_quantized(d, workload=wl, tenant=t_of(j))
              for j, d in enumerate(depths)]
        sources = {"measured"
                   if est.measured(d, workload=wl, tenant=t_of(j)) is not None
                   else "prior"
                   for j, d in enumerate(depths)}
        src = sources.pop() if len(sources) == 1 else "mixed"
        if self.engine == "ask_pooled":
            caps = self._pooled_caps_for(key, ps)
        else:
            caps = self._caps_for(key, max(ps))
        d, secs = self._dispatch(bounds, caps=caps, key=key)
        item = (index, key, bounds, depths, max(ps), caps, src, d, secs)
        return PlannedDispatch(self, item, tenants, tenant_feedback)

    def _stream_feedback(self, bounds_iter: Iterable) -> Iterator[ChunkResult]:
        """The closed loop: re-plan, dispatch, retry, observe, refill."""
        chunker = (self._pooled_chunks if self.engine == "ask_pooled"
                   else self._adaptive_chunks)
        chunks = chunker(iter(bounds_iter))
        pending: collections.deque = collections.deque()
        index = 0

        def enqueue() -> bool:
            nonlocal index
            item = next(chunks, None)
            if item is None:
                return False
            key, bounds, depths, p, caps, src = item
            d, secs = self._dispatch(bounds, caps=caps, key=key)
            pending.append((index, key, bounds, depths, p, caps, src, d, secs))
            index += 1
            return True

        if self.pipeline_depth == 1:  # synchronous: at most one in flight,
            # and the next chunk is planned AND dispatched only after the
            # consumer returns (the uniform path's depth-1 contract) --
            # which also means it always plans from the freshest state
            while enqueue():
                yield self._finalize_feedback(pending.popleft(), in_flight=1)
            return

        while len(pending) < self.pipeline_depth and enqueue():
            pass
        while pending:
            in_flight = len(pending)
            item = pending.popleft()
            result = self._finalize_feedback(item, in_flight)
            # refill AFTER observing (inside _finalize_feedback) and
            # BEFORE yielding: the next chunk is planned from the
            # freshest finalised state while the devices stay busy
            # behind the consumer
            enqueue()
            yield result

    def stream_chunks(self, bounds_iter: Iterable) -> Iterator[ChunkResult]:
        """Yield ``ChunkResult`` per chunk, f <= chunk_frames frames each,
        its canvases a tensor on the mesh's first device (JAX yields
        device arrays); ``readback.to_host(r.canvases, r.ready)`` copies
        one to the host without waiting for the chunks behind it.

        Lazy: pulls ``chunk_frames`` bounds at a time, so the input can be
        an unbounded generator (a million-frame trajectory never
        materialises host-side). With ``pipeline_depth >= 2`` up to that
        many chunks are enqueued ahead of the one being finalised, and
        the queue is refilled BEFORE each yield -- so the devices compute
        chunk k+1 while the consumer of the stream is still busy with
        chunk k. Chunk order (and therefore frame order) is preserved.

        With ``feedback=`` set the stream re-plans each chunk's
        capacities from the estimator state before dispatch (see
        ``_stream_feedback``); chunks may then be SHORTER than
        ``chunk_frames`` where the predicted capacity class jumps.
        """
        for r, _ in self._stream(bounds_iter):
            yield r

    def _stream(self, bounds_iter: Iterable, prefetch: bool = False):
        """``stream_chunks`` as (ChunkResult, host copy) pairs. With
        ``prefetch`` the uniform path starts each chunk's host copy
        (``ShardedDispatch.host_copy``) as soon as the chunk is enqueued,
        on the copy stream behind the chunk's event, so the copy of chunk
        k+1 runs while the consumer still works on chunk k; otherwise,
        and on the feedback path (whose retries patch the canvases after
        the finalize), the copy is None."""
        if self.estimator is not None:
            for r in self._stream_feedback(bounds_iter):
                yield r, None
            return
        it = iter(bounds_iter)
        pending: collections.deque = collections.deque()
        index = 0

        def enqueue() -> bool:
            nonlocal index
            chunk = list(itertools.islice(it, self.chunk_frames))
            if not chunk:
                return False
            d, secs = self._dispatch(chunk)
            start = getattr(d, "host_copy", None) if prefetch else None
            pending.append((index, len(chunk), d, secs,
                            None if start is None else start()))
            index += 1
            return True

        if self.pipeline_depth == 1:  # synchronous: at most one in flight
            while enqueue():
                i, f, d, disp_s, copy = pending.popleft()
                t0 = self._clock.now()
                canvases, st = d.finalize()
                fetch_s = self._clock.now() - t0
                yield ChunkResult(canvases, st, ChunkStats(
                    index=i, frames=f, dispatch_s=disp_s, fetch_s=fetch_s,
                    in_flight=1), _ready(d)), copy
            return

        while len(pending) < self.pipeline_depth and enqueue():
            pass
        while pending:
            in_flight = len(pending)
            i, f, d, disp_s, copy = pending.popleft()
            t0 = self._clock.now()
            canvases, st = d.finalize()  # younger chunks compute behind this
            fetch_s = self._clock.now() - t0
            enqueue()  # refill BEFORE yielding: devices stay busy while the
            #            consumer processes this chunk
            yield ChunkResult(canvases, st, ChunkStats(
                index=i, frames=f, dispatch_s=disp_s, fetch_s=fetch_s,
                in_flight=in_flight), _ready(d)), copy

    def stream(self, bounds_iter: Iterable):
        """Yield (canvases [f, n, n], ASKStats) per chunk (the PR-2
        interface; ``stream_chunks`` adds per-chunk pipeline timing)."""
        for r in self.stream_chunks(bounds_iter):
            yield r.canvases, r.stats

    def program_traces(self) -> int:
        """Chunk-program signatures this service has dispatched so far.

        JAX reads this off the jit cache of the chunk program: one trace
        per (problem, padded width, capacities). The port's chunks run
        eagerly and compile nothing, so it counts the distinct (problem
        key, padded width, capacities) signatures its ``_dispatch`` ran,
        retries included -- what JAX traces on problems no other service
        has traced. Pinning ``pad_to`` to the chunk width must keep this
        at 1 on the uniform path no matter how ragged the trajectory tail
        is; on the feedback path its regression target is
        ``RenderStats.plan_signatures``.
        """
        return len(self._used_sigs)

    def render(self, bounds_seq: Iterable, *, sink=None):
        """Render a whole (finite) trajectory.

        Returns (canvases np [F, n, n], RenderStats). For streams too big
        to stack host-side, iterate ``stream_chunks`` directly. The
        device->numpy conversion of chunk k (``readback.HostCopy``: a copy
        stream waits on chunk k's event only) happens while chunk k+1 is
        in flight (``pipeline_depth >= 2``), which is exactly the host-I/O
        / device-compute overlap the pipelined service exists for; on the
        uniform path that copy is started when the chunk is enqueued, so
        with ``pipeline_depth >= 2`` it runs behind the consumer's work on
        the chunk before.

        ``sink(canvases_np, stats)``, if given, is called once per chunk
        -- the place for the serving-side host I/O (encode frames, write
        to disk/network). Its cost is counted in ``host_copy_s`` and,
        like the numpy conversion, overlaps the next chunk's device
        compute whenever it releases the GIL (compression, file/socket
        writes, and numpy copies largely do).
        """
        out = []
        rs = RenderStats(pipeline_depth=self.pipeline_depth)
        chunk_stats = []
        t0 = self._clock.now()
        for r, copy in self._stream(bounds_seq, prefetch=True):
            tc = self._clock.now()
            host = (readback.to_host(r.canvases, r.ready) if copy is None
                    else copy.result())
            out.append(host)
            if sink is not None:
                sink(host, r.stats)
            rs.host_copy_s += self._clock.now() - tc
            rs.frames += int(r.canvases.shape[0])
            rs.chunks += 1
            rs.dispatches += r.stats.kernel_launches
            rs.leaf_count += r.stats.leaf_count
            rs.overflow_dropped += r.stats.overflow_dropped
            rs.dispatch_s += r.chunk.dispatch_s
            rs.fetch_s += r.chunk.fetch_s
            rs.retries += r.chunk.retries
            rs.ring_rows += r.chunk.ring_rows
            chunk_stats.append(r.chunk)
        rs.wall_s = self._clock.now() - t0
        rs.chunk_stats = tuple(chunk_stats)
        rs.program_traces = self.program_traces()
        if self.estimator is not None:
            rs.plan_signatures = len(self._used_sigs)
        if self._state_path is not None:
            self.save_feedback_state()
        n = self._n
        stacked = (np.concatenate(out, axis=0) if out
                   else np.zeros((0, n, n), self._dtype))
        return stacked, rs

    def save_feedback_state(self, path: Union[str, Path, None] = None) -> Path:
        """Write the estimator snapshot as JSON (``feedback_state`` path
        unless overridden). ``render()`` calls this automatically when
        the service was constructed with ``feedback_state=``; streaming
        callers (``stream_chunks``) invoke it at their own cadence."""
        if self.estimator is None:
            raise ValueError("no estimator to save -- service runs the "
                             "uniform path (feedback= not set)")
        target = self._state_path if path is None else Path(path)
        if target is None:
            raise ValueError("no feedback_state path configured; pass path=")
        target.parent.mkdir(parents=True, exist_ok=True)
        # atomic replace: a crash mid-save (the exact restart scenario
        # feedback_state exists for) must never leave truncated JSON
        # behind for the next construction to choke on
        tmp = target.with_name(target.name + ".tmp")
        tmp.write_text(json.dumps(self.estimator.snapshot()))
        os.replace(tmp, target)
        return target


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all visible cards)")
    ap.add_argument("--max-dwell", type=int, default=128)
    ap.add_argument("--zoom", type=float, default=1.05)
    ap.add_argument("--safety-factor", type=float, default=2.0)
    ap.add_argument("--pipeline-depth", type=int,
                    default=DEFAULT_PIPELINE_DEPTH,
                    help="chunks in flight at once (1 = synchronous)")
    ap.add_argument("--feedback", action="store_true",
                    help="closed-loop occupancy feedback: re-plan each "
                         "chunk's ring from measured region_counts")
    ap.add_argument("--engine", choices=("ask_scan", "ask_pooled"),
                    default="ask_scan",
                    help="ask_pooled: ONE shared cross-frame ring per "
                         "device shard (core.pooled)")
    args = ap.parse_args(argv)

    from repro_torch.workloads import MandelbrotProblem

    # the card: make_frames_mesh raises when there is none
    mesh = make_frames_mesh(args.devices)
    prob = MandelbrotProblem(n=args.n, g=4, r=2, B=16,
                             max_dwell=args.max_dwell,
                             device=mesh.devices[0])
    svc = RenderService(prob, mesh=mesh, chunk_frames=args.chunk,
                        pipeline_depth=args.pipeline_depth,
                        feedback=args.feedback, engine=args.engine,
                        safety_factor=args.safety_factor)
    bounds = zoom_bounds(args.frames, zoom_per_frame=args.zoom)

    # warm the kernel libraries and the pinned buffers, then stream the
    # trajectory
    next(svc.stream(zoom_bounds(svc.chunk_frames)))
    _, rs = svc.render(bounds)
    print(f"devices={mesh.size} chunk={svc.chunk_frames} "
          f"depth={svc.pipeline_depth} frames={rs.frames} chunks={rs.chunks} "
          f"dispatches_per_chunk={rs.dispatches_per_chunk:.1f} "
          f"program_traces={rs.program_traces}")
    print(f"wall={rs.wall_s * 1e3:.1f} ms  "
          f"{rs.wall_s * 1e3 / max(rs.frames, 1):.2f} ms/frame  "
          f"busy={rs.busy_s * 1e3:.1f} ms  "
          f"fetch={rs.fetch_s * 1e3:.1f} ms  "
          f"overflow_dropped={rs.overflow_dropped}")
    if args.feedback:
        print(f"feedback: retries={rs.retries} ring_rows={rs.ring_rows} "
              f"plan_signatures={rs.plan_signatures} "
              f"sources={[c.p_source for c in rs.chunk_stats]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
