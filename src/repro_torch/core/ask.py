"""Adaptive Serial Kernels (ASK) -- paper Sec. 5, and its one-dispatch modes.

Counterpart of ``repro/core/ask.py`` (``ASKProblem``, ``ASKStats``,
``run_ask``, ``run_ask_fused``, ``scan_capacities``, ``run_ask_scan``,
``run_ask_scan_batch``, ``pad_frames`` and the sharded engine).
ASK replaces Dynamic Parallelism's recursive kernel tree with a serial
sequence of flat launches, one per subdivision level; the live regions
travel between levels in a compact OLT (``core/olt.py``).

``run_ask``       -- the paper-faithful mode. The live count is padded to
                     the next power of two, as in the JAX package, so the
                     per-level OLT sizes (``olt_caps``) are the same. After
                     each level the host reads the child count with
                     ``.item()``: that sync is the serial-kernel boundary
                     of the paper, where the next level's grid size is
                     learnt.
``run_ask_fused`` -- the whole level loop at static worst-case capacities
                     (scaled by ``capacity_factor``), drops counted.
``run_ask_scan``  -- the same loop over a double-buffered OLT ring whose
                     per-level slices are sized from the cost model's
                     expected occupancy (``scan_capacities``); regions
                     beyond capacity are dropped and counted in
                     ``ASKStats.overflow_dropped``, and leave their pixels
                     at the init value (0).
``run_ask_scan_batch`` -- a batch of frames, each with its own ring at
                     those capacities, run together as one worklist of
                     frame-tagged rows (``pooled.pooled_pipeline`` with
                     ``per_frame=True``), eagerly: JAX vmaps the scan.
``run_ask_scan_sharded`` -- the batch over a frames mesh
                     (``launch.mesh.make_frames_mesh``): padded to a
                     multiple of the mesh's size with dead frames, one
                     worklist a shard, each enqueued on its device's
                     current stream with no host sync
                     (``dispatch_ask_scan_sharded`` returns a
                     ``ShardedDispatch``; ``finalize()`` reads it back).

The two one-dispatch modes keep every count on the device: JAX compiles
each into one XLA program per problem and capacities; on the card each is
one replay of a CUDA graph of its level loop (``core.graphs``), cached per
the problem's ``graph_key`` (all but its window) and capacities, with the
window copied into the graph's static plane at each call, so one capture
serves a zoom sequence. The first call of a key runs the loop once as a
warm-up and once under capture. The stats are read back once after the
replay. On the CPU the same loop runs eagerly, kernel by kernel
(``_fused_pipeline``, ``_scan_pipeline``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Protocol, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core import olt as olt_lib
from repro_torch.core.cost_model import expected_level_counts, num_levels
from repro_torch.kernels import ops

__all__ = ["ASKProblem", "ASKStats", "ShardedDispatch", "run_ask",
           "run_ask_fused", "scan_capacities", "run_ask_scan",
           "run_ask_scan_batch", "pad_frames", "run_ask_scan_sharded",
           "dispatch_ask_scan_sharded"]


class ASKProblem(Protocol):
    """Adapter for an SSD workload driven by subdivision.

    Regions at level ``l`` live on a ``(g * r**l)``-per-side grid and are
    identified by int32 coords (cy, cx) -- see ``core/olt.py``.
    """

    n: int
    g: int
    r: int
    B: int
    device: torch.device

    def init_state(self) -> Any:
        """Initial output state (e.g. the n x n canvas)."""

    def root_coords(self) -> torch.Tensor:
        """[g*g, 2] level-0 region coordinates."""

    def level_step(self, state: Any, coords: torch.Tensor,
                   valid: torch.Tensor, *, level: int) -> Tuple[Any, torch.Tensor]:
        """Query Q on each valid region, terminal work T on the homogeneous
        ones; returns (new_state, subdivide_flags[bool])."""

    def leaf_step(self, state: Any, coords: torch.Tensor, valid: torch.Tensor,
                  *, level: int) -> Any:
        """Last-level application work A on each remaining region."""

    def region_side(self, level: int) -> int:
        """Pixel side of a level-``level`` region: n // (g * r**level)."""

    def graph_key(self) -> Any:
        """What a CUDA graph of the level loop holds fixed (hashable)."""

    def window(self) -> torch.Tensor:
        """The tensor the card's kernels read the frame's window from."""

    def reading(self, window: torch.Tensor) -> "ASKProblem":
        """This problem with its kernels reading the window from
        ``window``."""


@dataclasses.dataclass
class ASKStats:
    """Per-run accounting (feeds the cost-model validation benchmarks)."""

    levels: int = 0
    kernel_launches: int = 0  # host dispatches (ASK: one per level)
    region_counts: tuple = ()  # live regions entering each level
    leaf_count: int = 0
    wall_s: float = 0.0
    overflow_dropped: int = 0  # pooled engine: regions beyond capacity
    olt_caps: tuple = ()  # OLT rows allocated per level (incl. leaf level)
    # batched engines only: per-frame breakdowns of the two sums above, in
    # input frame order (region_counts then holds one tuple per frame)
    frame_overflow: tuple = ()
    frame_leaf_counts: tuple = ()

    @property
    def ring_rows(self) -> int:
        """Live OLT rows in the scan engines' double-buffered ring: two
        buffers of the widest level slice (the whole batch's, pooled)."""
        return 2 * max(self.olt_caps) if self.olt_caps else 0

    def frame_chains(self) -> tuple:
        """Per-frame ``(region_counts, leaf_count)`` observation chains (the
        raw material of the measured-occupancy feedback loop): one per
        frame of a batch, in input order, or one for a single frame."""
        if self.frame_leaf_counts:
            return tuple(zip(self.region_counts, self.frame_leaf_counts))
        return ((self.region_counts, self.leaf_count),)


def _explore(problem: ASKProblem, state, coords: torch.Tensor,
             valid: torch.Tensor, level: int, *, capacity: int):
    """One exploration level: Q and T on the valid rows of ``coords``
    (``level_step``), then the write-OLT (Sec. 5.3.2): every flagged valid
    region inserts its r*r children, compacted through the scan kernel
    into ``capacity`` rows. Returns (state, children, child_count), the
    count uncapped, on the device."""
    state, flags = problem.level_step(state, coords, valid, level=level)
    flags = flags & valid
    children, child_count = olt_lib.subdivide_olt(
        coords, flags, r=problem.r, capacity=capacity,
        ranks_count=ops.compact_ranks(flags))
    return state, children, child_count


def synchronize(device: torch.device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_ask(problem: ASKProblem) -> Tuple[Any, ASKStats]:
    """Paper-faithful ASK: serial launches, power-of-two OLT buckets.
    Returns (canvas, ASKStats); the canvas is the problem's ``init_state``
    updated in place, and ``wall_s`` ends after the device finished."""
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    t0 = time.perf_counter()
    state = problem.init_state()
    coords = problem.root_coords()
    count = g * g
    stats = ASKStats()
    counts = []
    caps_used = []

    for level in range(num_levels(n, g, r, B)):
        if count == 0:
            break
        cap = olt_lib.next_pow2(count)
        coords_p, valid = olt_lib.pad_olt(coords, count, cap)
        counts.append(count)
        caps_used.append(cap)
        state, coords, child_count = _explore(
            problem, state, coords_p, valid, level,
            capacity=olt_lib.next_pow2(cap * r * r))
        stats.kernel_launches += 1
        count = int(child_count.item())  # host sync: the level boundary
        stats.levels += 1

    if count > 0:
        cap = olt_lib.next_pow2(count)
        coords_p, valid = olt_lib.pad_olt(coords, count, cap)
        state = problem.leaf_step(state, coords_p, valid, level=stats.levels)
        stats.kernel_launches += 1
        stats.leaf_count = count
        caps_used.append(cap)

    synchronize(problem.device)
    stats.region_counts = tuple(counts)
    stats.olt_caps = tuple(caps_used)
    stats.wall_s = time.perf_counter() - t0
    return state, stats


def _one_dispatch(problem: ASKProblem, key,
                  pipeline: Callable[[ASKProblem], tuple]) -> Tuple[Any, list]:
    """Run ``pipeline(problem)`` -> (canvas, *tensors) as one dispatch: on
    the card one replay of its CUDA graph, cached under ``key`` and the
    problem's ``graph_key``, with the problem's window as the graph's
    static input; the canvas is cloned out of the graph's pool. On the CPU
    eagerly. Returns (canvas, [tensors])."""
    if problem.device.type != "cuda":
        state, *rest = pipeline(problem)
        return state, rest
    state, *rest = graphs.replay(
        (key, problem.graph_key()),
        lambda window: pipeline(problem.reading(window)), problem.window(),
        device=problem.device)
    return state.clone(), rest


def _read_back(tensors) -> list:
    """The values of int32 device tensors, in one transfer."""
    return torch.cat([x.reshape(-1) for x in tensors]).tolist()


def _fused_capacities(problem: ASKProblem,
                      capacity_factor: float) -> Tuple[int, ...]:
    """The fused engine's per-level OLT rows: the worst case at level l,
    the full region grid (g*r**l)^2, times ``capacity_factor``, rounded up
    to a power of two; levels 0..tau."""
    g, r = problem.g, problem.r
    levels = num_levels(problem.n, g, r, problem.B)
    return tuple(
        max(1, olt_lib.next_pow2(int((g * r ** lv) ** 2 * capacity_factor)))
        for lv in range(levels + 1))


def _fused_pipeline(problem: ASKProblem, caps: Sequence[int]) -> tuple:
    """The fused engine's level loop, with no host sync. Returns (canvas,
    leaf_count, dropped), the last two int32 on the device."""
    g, dev = problem.g, problem.device
    levels = len(caps) - 1
    state = problem.init_state()
    coords = problem.root_coords()
    count = torch.full((), g * g, dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for level in range(levels):
        cap, child_cap = caps[level], caps[level + 1]
        coords_p, _ = olt_lib.pad_olt(coords, 0, cap)  # shape only
        valid = torch.arange(cap, device=dev) < count
        state, coords, child_count = _explore(
            problem, state, coords_p, valid, level, capacity=child_cap)
        dropped = dropped + (child_count - child_cap).clamp(min=0)
        count = child_count.clamp(max=child_cap)
    valid = torch.arange(caps[levels], device=dev) < count
    state = problem.leaf_step(state, coords, valid, level=levels)
    return state, count, dropped


def run_ask_fused(problem: ASKProblem, *,
                  capacity_factor: float = 1.0) -> Tuple[Any, ASKStats]:
    """Fused ASK: the whole level loop as one dispatch
    (``_fused_pipeline``).

    Per-level OLT capacities are static worst cases scaled by
    ``capacity_factor`` (``_fused_capacities``). Regions beyond capacity
    are dropped and counted: with the default factor nothing can drop.
    Returns (canvas, ASKStats); ``region_counts`` stays empty, as in JAX.
    """
    caps = _fused_capacities(problem, capacity_factor)
    levels = len(caps) - 1
    t0 = time.perf_counter()
    state, rest = _one_dispatch(problem, ("ask_fused", caps),
                                lambda q: _fused_pipeline(q, caps))
    leaf_count, dropped = _read_back(rest)
    return state, ASKStats(
        levels=levels,
        kernel_launches=1,  # the whole pipeline is one dispatch
        leaf_count=leaf_count,
        overflow_dropped=dropped,
        wall_s=time.perf_counter() - t0,
        olt_caps=caps,
    )


def scan_capacities(n: int, g: int, r: int, B: int, *, p_subdiv: float = 0.7,
                    safety_factor: float = 2.0) -> Tuple[int, ...]:
    """Per-level ring-slice capacities for ``run_ask_scan``: the cost
    model's expected occupancy E_l = g^2 (r^2 p)^l
    (``cost_model.expected_level_counts``) times ``safety_factor``, clamped
    to the worst case (g r^l)^2 and at least 1; one capacity per level
    0..tau."""
    expected = expected_level_counts(n, g, r, B, P=p_subdiv)
    caps = []
    for lv, e in enumerate(expected):
        worst = (g * r ** lv) ** 2
        caps.append(max(1, min(int(math.ceil(e * safety_factor)), worst)))
    return tuple(caps)


def _resolve_capacities(problem: ASKProblem, capacities, p_subdiv,
                        safety_factor) -> Tuple[int, ...]:
    """The scan's capacities: ``scan_capacities`` when ``capacities`` is
    None, else a uniform int or one per level 0..tau."""
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    levels = num_levels(n, g, r, B)
    if capacities is None:
        return scan_capacities(n, g, r, B, p_subdiv=p_subdiv,
                               safety_factor=safety_factor)
    if isinstance(capacities, int):
        return (max(1, capacities),) * (levels + 1)
    caps = tuple(max(1, int(c)) for c in capacities)
    if len(caps) != levels + 1:
        raise ValueError(
            f"need {levels + 1} capacities (levels 0..{levels}), got {len(caps)}")
    return caps


def _scan_pipeline(problem: ASKProblem, caps: Sequence[int]) -> tuple:
    """The scan engine's level loop, with no host sync: the live OLT in a
    double-buffered ring of ``max(caps)`` rows, ``caps[l]`` of them read at
    level l (``scan_start``, ``scan_levels`` over every level, then
    ``scan_leaf``; the split scan, ``core.progressive``, stops and resumes
    it between levels). Returns (canvas, entering [levels], leaf_count,
    dropped), the last three int32 on the device."""
    levels = len(caps) - 1
    carry, entering = scan_levels(problem, caps, scan_start(problem, caps),
                                  0, levels)
    state, count, dropped = scan_leaf(problem, caps, carry)
    return state, entering, count, dropped


def scan_start(problem: ASKProblem, caps: Sequence[int]) -> tuple:
    """The scan's carry before level 0: ``(state, ring, parity, count,
    dropped)``, the roots in the ring's front buffer (those beyond
    ``caps[0]`` dropped); ``parity`` is a Python int, the rest tensors on
    the problem's device."""
    roots_n = problem.g * problem.g
    dev = problem.device
    ring = olt_lib.ring_init(problem.root_coords(), roots_n, max(caps))
    count = torch.full((), min(roots_n, caps[0]), dtype=torch.int32,
                       device=dev)
    dropped = torch.full((), max(roots_n - caps[0], 0), dtype=torch.int32,
                         device=dev)
    return problem.init_state(), ring, 0, count, dropped


def scan_live(ring: torch.Tensor, parity: int, count: torch.Tensor,
              cap: int) -> tuple:
    """The first ``cap`` rows of the ring's front buffer and which of them
    are live: (coords [cap, 2], valid [cap])."""
    coords = olt_lib.ring_read(ring, parity, cap)
    return coords, torch.arange(cap, device=coords.device) < count


def scan_levels(problem: ASKProblem, caps: Sequence[int], carry: tuple,
                lo: int, hi: int) -> tuple:
    """Levels ``[lo, hi)`` of the scan from ``carry``; the canvas and the
    ring are updated in place. Returns (carry, entering [hi - lo]), the
    live count entering each level."""
    state, ring, parity, count, dropped = carry
    entering = []
    for lv in range(lo, hi):
        cap_out = caps[lv + 1]
        entering.append(count)
        coords, valid = scan_live(ring, parity, count, caps[lv])
        state, children, child_count = _explore(
            problem, state, coords, valid, lv, capacity=cap_out)
        dropped = dropped + (child_count - cap_out).clamp(min=0)
        count = child_count.clamp(max=cap_out)
        ring = olt_lib.ring_write(ring, parity, children)
        parity = 1 - parity
    entering = (torch.stack(entering) if entering else
                torch.zeros((0,), dtype=torch.int32, device=ring.device))
    return (state, ring, parity, count, dropped), entering


def scan_leaf(problem: ASKProblem, caps: Sequence[int], carry: tuple) -> tuple:
    """The leaf pass A on the rows live after the last level. Returns
    (canvas, leaf_count, dropped)."""
    state, ring, parity, count, dropped = carry
    levels = len(caps) - 1
    coords, valid = scan_live(ring, parity, count, caps[levels])
    state = problem.leaf_step(state, coords, valid, level=levels)
    return state, count, dropped


def run_ask_scan(problem: ASKProblem, *,
                 capacities: Union[None, int, Sequence[int]] = None,
                 p_subdiv: float = 0.7,
                 safety_factor: float = 2.0) -> Tuple[Any, ASKStats]:
    """The streaming ASK engine: the level loop as one dispatch over a
    bounded double-buffered ring (``_scan_pipeline``).

    Ring capacities: ``capacities`` (a uniform int, or one per level
    0..tau) > ``scan_capacities(p_subdiv, safety_factor)``. The canvas
    equals ``run_ask``'s whenever ``stats.overflow_dropped == 0``; pass
    ``safety_factor=1e9`` for worst-case capacities, which never drop.
    """
    caps = _resolve_capacities(problem, capacities, p_subdiv, safety_factor)
    levels = len(caps) - 1
    t0 = time.perf_counter()
    state, rest = _one_dispatch(problem, ("ask_scan", caps),
                                lambda q: _scan_pipeline(q, caps))
    host = _read_back(rest)
    counts = []
    for c in host[:levels]:
        if c == 0:
            break
        counts.append(c)
    return state, ASKStats(
        levels=len(counts),
        kernel_launches=1,  # the whole level pipeline is one dispatch
        region_counts=tuple(counts),
        leaf_count=host[levels],
        overflow_dropped=host[levels + 1],
        wall_s=time.perf_counter() - t0,
        olt_caps=caps,
    )


def _per_frame_counts(entering) -> tuple:
    """[F, levels] entering-count matrix -> per-frame ``region_counts``
    tuples, each cut at its first zero level as in the single-frame
    engine."""
    per_frame = []
    for row in entering:
        counts = []
        for c in row.tolist():
            if c == 0:
                break
            counts.append(int(c))
        per_frame.append(tuple(counts))
    return tuple(per_frame)


def run_ask_scan_batch(problem: ASKProblem, extras: Any, *,
                       capacities: Union[None, int, Sequence[int]] = None,
                       p_subdiv: float = 0.7,
                       safety_factor: float = 2.0) -> Tuple[Any, ASKStats]:
    """The scan engine over a batch of frames: ``extras`` is the [F, 4]
    per-frame bounds (re0, im0, re1, im1), computed in the traced f32
    spelling (``ref.pooled_planes``).

    Every frame gets a ring of its own, ``caps[l]`` rows at level l
    (``_resolve_capacities``, as ``run_ask_scan``): roots beyond
    ``caps[0]`` and the children of a frame past ``caps[l + 1]`` are
    dropped and charged to that frame, in the order its own ring holds
    them, as JAX's vmapped scan does. The frames run together as one
    worklist of frame-tagged rows (``pooled.pooled_pipeline`` with
    ``per_frame=True``), launched eagerly with no host sync inside; the
    stats are read back once, after it.

    Returns (states [F, n, n] int32 on the problem's device, ASKStats):
    ``region_counts`` one tuple per frame (cut at its first zero level),
    ``levels`` the most any frame ran, ``leaf_count`` and
    ``overflow_dropped`` summed over the frames, ``frame_overflow`` and
    ``frame_leaf_counts`` per frame, ``olt_caps`` the per-frame ``caps``
    (``ring_rows`` is one frame's ring) and ``kernel_launches`` 1: one
    engine dispatch for the batch.
    """
    from repro_torch.core import pooled

    bounds = pooled.bounds_array(extras)
    caps = _resolve_capacities(problem, capacities, p_subdiv, safety_factor)
    return pooled.run_pool(problem, bounds, caps, per_frame=True)


def _frame_count(extras) -> int:
    """Size of the leading (frame) axis of ``extras``."""
    if getattr(extras, "ndim", 0) < 1:
        raise ValueError("extras must be an array with a leading frame axis")
    return int(extras.shape[0])


def pad_frames(extras, multiple: int):
    """Pad the frame axis of ``extras`` (a tensor or numpy array, such as
    the [F, 4] bounds) up to the next multiple of ``multiple``, repeating
    frame 0. Returns (padded, F), F the frame count before padding;
    callers mask the padded frames out of every sum."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    F = _frame_count(extras)
    pad = (-F) % multiple
    if pad == 0:
        return extras, F
    if isinstance(extras, torch.Tensor):
        fill = extras[:1].expand((pad,) + tuple(extras.shape[1:]))
        return torch.cat([extras, fill], dim=0), F
    fill = np.broadcast_to(extras[:1], (pad,) + tuple(extras.shape[1:]))
    return np.concatenate([extras, fill], axis=0), F


@dataclasses.dataclass
class ShardedDispatch:
    """An in-flight sharded batch: enqueued on the mesh's devices, not yet
    read back.

    ``dispatch_ask_scan_sharded`` returns as soon as every shard's level
    loop is enqueued on its device's current stream, with no host sync;
    each shard ends in a recorded CUDA event. ``finalize()`` waits on the
    events, reads each shard's stats back in one transfer, masks the
    padded frames and returns the ``(states, ASKStats)`` that
    ``run_ask_scan_sharded`` returns. An async caller enqueues the next
    chunk before it finalizes this one, so the host's read-back of one
    overlaps the card's work on the next. ``shards`` holds each shard's
    ``pooled.enqueue_pool`` outputs, frame-major (``pooled.enqueue_shards``,
    which also pads the batch); the sharded pool's handle,
    ``pooled.PooledDispatch``, is this class under JAX's other name."""

    shards: list
    frames: int  # true F before padding
    caps: Tuple[int, ...]
    t0: float  # perf_counter at enqueue (finalize stamps wall_s from it)

    def finalize(self, *, block_until_ready: bool = True
                 ) -> Tuple[torch.Tensor, ASKStats]:
        """``(states [F, n, n], ASKStats)`` equal to the unsharded batch's
        field for field, ``kernel_launches`` 1 (JAX's one GSPMD program;
        here one engine dispatch). On one device the canvas is the
        shard's, cut to F with no copy; on several the shards' canvases
        are concatenated on the mesh's first device.
        ``block_until_ready`` has nothing to do: the read-back waits for
        the canvases too. Call it once."""
        from repro_torch.core.pooled import finish_shards

        return finish_shards(self.shards, self.frames, self.caps, self.t0)


def dispatch_ask_scan_sharded(
    problem: ASKProblem,
    extras: Any,
    *,
    mesh,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    pad_to: Union[int, None] = None,
) -> ShardedDispatch:
    """Enqueue one sharded batch without waiting for it: the non-blocking
    half of ``run_ask_scan_sharded``. Every shard runs the batched scan's
    loop (``pooled.pooled_pipeline(per_frame=True)``) on its device's
    current stream; two shards of one device run one after the other on
    it (the single-pass scans of a stream share one look-back scratch).
    Call ``.finalize()`` for ``(states, ASKStats)``."""
    from repro_torch.core.pooled import (bounds_array, enqueue_shards,
                                         shard_multiple)

    bounds = bounds_array(extras)
    caps = _resolve_capacities(problem, capacities, p_subdiv, safety_factor)
    multiple = shard_multiple(mesh, pad_to)
    t0 = time.perf_counter()
    shards, F = enqueue_shards(problem, bounds, mesh, caps,
                               multiple=multiple, per_frame=True)
    return ShardedDispatch(shards=shards, frames=F, caps=tuple(caps), t0=t0)


def run_ask_scan_sharded(
    problem: ASKProblem,
    extras: Any,
    *,
    mesh,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    pad_to: Union[int, None] = None,
    block_until_ready: bool = True,
) -> Tuple[torch.Tensor, ASKStats]:
    """``run_ask_scan_batch`` with the frame axis sharded over ``mesh``
    (a ``launch.mesh.FramesMesh``): frame-major, S = F_pad / mesh.size
    frames a shard. The batch is padded up to a multiple of the mesh's
    size (``pad_to`` overrides the multiple, as the render service pins
    it to its chunk); the padded frames are dead rows of the pool and are
    masked out of the canvases and the sums, so the result equals the
    unsharded batch at any F. ``dispatch_ask_scan_sharded`` then
    ``ShardedDispatch.finalize``."""
    d = dispatch_ask_scan_sharded(
        problem, extras, mesh=mesh, capacities=capacities,
        p_subdiv=p_subdiv, safety_factor=safety_factor, pad_to=pad_to)
    return d.finalize(block_until_ready=block_until_ready)
