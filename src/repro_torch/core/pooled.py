"""Pooled per-level worklists: one cross-frame OLT ring for a whole batch.

Counterpart of ``repro/core/pooled.py``. Per level, the live regions of all F frames travel in one compacted worklist
of frame-tagged rows ``(frame, cy, cx)`` (``olt.subdivide_olt_tagged``),
and the shared ring is sized from the sum of the per-frame expected
occupancies

    cap_l = ceil(safety * sum_f E_l(P_f)),   E_l(P) = g^2 (r^2 P)^l

clamped at the pooled worst case ``F (g r^l)^2`` (``pooled_capacities``).
Each frame's subsequence of the pooled worklist is the worklist its own
engine would carry (roots are frame-major and every compaction is a
stable scan), each row is computed in its own frame's plane
(``ops.pooled_planes``), and each region lands in its frame's band of a
tall [F*n, n] canvas, so every frame equals the frame rendered alone
whenever nothing overflows. Drops are attributed to the frames that
owned them (``ASKStats.frame_overflow``).

The level loop (``pooled_pipeline``) runs over static capacities: every
count stays on the device, the compactions go through the scan kernel
(``ops.compact_ranks``) and the kernels read their live counts on the
device, so between the roots and the final read-back of the stats it makes
no host sync; on the card its enqueue runs ahead of the device, so the
batch launches it eagerly. (A CUDA graph of it, ``core.graphs.replay``
with the planes and the live mask as static inputs, measured slower at
n=16384, F=8: the copy of the 8 GiB canvas out of the graph's pool costs
more than the enqueue it saves; PERF.md.) With ``per_frame`` the same
loop is the batched scan (``ask.run_ask_scan_batch``): each frame keeps
what a ring of its own would, the frame-local rank of a flagged row being
its pool rank less that of its frame's first row, and the kept children
compacted again through the scan kernel.

The loop is three phases, ``pool_start``, ``pool_levels`` and
``pool_leaf``, so the split scan (``core.progressive``) can stop and
resume it between levels; a run is two halves, ``enqueue_pool`` (no host
sync; the stats' copy to pinned host memory enqueued behind the pipeline,
a CUDA event after it: ``readback.StatsCopy``) and ``read_pool`` (which
waits on that event alone). Under a frames mesh (``launch.mesh``) a batch
is padded to a multiple of the mesh's size with dead frames and cut
frame-major into one pool a shard, each enqueued on its device's current
stream (``shard_multiple``, ``enqueue_shards``: the shard layout lives
here alone); ``run_ask_pooled_sharded`` and the batched scan's
``ask.run_ask_scan_sharded`` read the shards back in ``finish_shards``,
through one handle, ``ask.ShardedDispatch`` (``PooledDispatch`` is JAX's
other name for it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import olt as olt_lib
from repro_torch.core import readback
from repro_torch.core.ask import ASKStats, ShardedDispatch, _per_frame_counts
from repro_torch.core.cost_model import expected_level_counts, num_levels
from repro_torch.kernels import ops

__all__ = ["PooledDispatch", "pooled_capacities",
           "escalate_pooled_capacities", "failed_pool_capacities",
           "pooled_pipeline", "pool_start", "pool_levels", "pool_leaf",
           "enqueue_pool", "pool_stats", "read_pool", "enqueue_shards",
           "finish_shards", "run_ask_pooled", "run_ask_pooled_batch",
           "run_ask_pooled_sharded", "dispatch_ask_pooled_sharded"]


def pooled_capacities(problem, frame_ps: Sequence[float], *,
                      safety_factor: float = 2.0) -> Tuple[int, ...]:
    """Shared per-level ring capacities for a pooled frame batch: per level
    0..tau, ``safety_factor`` times the sum of the frames' expected
    occupancies E_l = g^2 (r^2 P_f)^l (each clamped at its own worst
    case), clamped at the pooled worst case F (g r^l)^2 and at least 1."""
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    levels = num_levels(n, g, r, B)
    F = len(frame_ps)
    totals = [0.0] * (levels + 1)
    for p in frame_ps:
        for lv, e in enumerate(expected_level_counts(n, g, r, B, P=float(p))):
            totals[lv] += e
    caps = []
    for lv in range(levels + 1):
        worst = (g * r ** lv) ** 2
        caps.append(max(1, min(int(math.ceil(totals[lv] * safety_factor)),
                               F * worst)))
    return tuple(caps)


def escalate_pooled_capacities(caps, worst, frames_per_shard: int, frames, *,
                               dispatched_per_shard: int = None,
                               ) -> Tuple[int, ...]:
    """The pooled overflow-escalation step: double each level's capacity,
    clamped at the worst case ``S * worst`` of the ``S =
    frames_per_shard`` frames the retry pool serves. Raises when ``caps``
    already covered the worst case of the pool that ran
    (``dispatched_per_shard`` frames, default S): such a pool cannot
    overflow. ``frames`` only labels the error."""
    ran = frames_per_shard if dispatched_per_shard is None \
        else dispatched_per_shard
    hi_ran = tuple(max(1, int(ran)) * w for w in worst)
    if tuple(min(c, h) for c, h in zip(caps, hi_ran)) == hi_ran:
        raise RuntimeError(
            f"frames {sorted(frames)} overflow at pooled worst-case "
            "capacities")
    hi = tuple(max(1, int(frames_per_shard)) * w for w in worst)
    return tuple(min(2 * c, h) for c, h in zip(caps, hi))


def failed_pool_capacities(problem, entered, *, frames_per_shard: int,
                           leaf_counts=None, frame_ps=None, caps_prev=None,
                           dispatched_per_shard: int = None,
                           safety_factor: float = 2.0) -> Tuple[int, ...]:
    """First-retry ring sizing from only the overflowing frames: per level,
    twice their measured live rows (``entered``: their region_counts;
    ``leaf_counts``: their leaf rows), or their own pooled estimate from
    ``frame_ps`` if larger, clamped at the retry pool's worst case
    ``frames_per_shard * (g r^l)^2``. ``caps_prev`` keeps the impossibility
    check of ``escalate_pooled_capacities``."""
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    levels = num_levels(n, g, r, B)
    S = max(1, int(frames_per_shard))
    worst = tuple((g * r ** lv) ** 2 for lv in range(levels + 1))
    if caps_prev is not None:
        ran = (S if dispatched_per_shard is None
               else max(1, int(dispatched_per_shard)))
        hi_ran = tuple(ran * w for w in worst)
        if tuple(min(c, h) for c, h in zip(caps_prev, hi_ran)) == hi_ran:
            raise RuntimeError(
                "frames overflow at pooled worst-case capacities")
    est = (pooled_capacities(problem, frame_ps, safety_factor=safety_factor)
           if frame_ps else None)
    caps = []
    for lv in range(levels + 1):
        if lv == levels:
            meas = (sum(int(c) for c in leaf_counts)
                    if leaf_counts is not None else 0)
        else:
            meas = sum(int(c[lv]) for c in entered if lv < len(c))
        need = 2 * meas
        if est is not None:
            need = max(need, est[lv])
        caps.append(max(1, min(need, S * worst[lv])))
    return tuple(caps)


def _resolve_pooled_capacities(problem, frames: int, capacities, frame_ps,
                               p_subdiv, safety_factor) -> Tuple[int, ...]:
    levels = num_levels(problem.n, problem.g, problem.r, problem.B)
    if capacities is not None:
        if frame_ps is not None:
            raise ValueError("pass capacities= OR frame_ps=, not both")
        if isinstance(capacities, int):
            return (max(1, capacities),) * (levels + 1)
        caps = tuple(max(1, int(c)) for c in capacities)
        if len(caps) != levels + 1:
            raise ValueError(
                f"need {levels + 1} capacities (levels 0..{levels}), "
                f"got {len(caps)}")
        return caps
    if frame_ps is None:
        ps: Tuple[float, ...] = (float(p_subdiv),) * frames
    else:
        ps = tuple(float(p) for p in frame_ps)
        if len(ps) != frames:
            raise ValueError(
                f"frame_ps covers {len(ps)} frames, batch has {frames}")
    return pooled_capacities(problem, ps, safety_factor=safety_factor)


def pooled_pipeline(problem, caps: Sequence[int], planes: torch.Tensor,
                    live: torch.Tensor, *, per_frame: bool = False):
    """Render the frames of ``planes`` [F, 4] (``ops.pooled_planes``)
    through one OLT ring of frame-tagged rows, with no host sync.

    ``live`` [F] bool masks frames out of the pool. ``caps`` [l] is the
    pool's shared capacity at level l, or with ``per_frame`` each frame's
    own: the batched scan's rule (``ask.run_ask_scan_batch``), where a
    frame keeps the children a ring of ``caps[l]`` rows of its own would
    keep and the pool holds up to ``F * caps[l]`` rows. Returns (states
    [F, n, n], entering [levels, F], leaf_f [F], frame_dropped [F]), all on
    the problem's device. The problem implements ``pooled_level_step`` and
    ``pooled_leaf_step`` (``workloads.FrameProblem`` does). The loop is
    ``pool_start``, ``pool_levels`` over every level, then ``pool_leaf``;
    the split scan (``core.progressive``) stops and resumes it between
    levels.
    """
    levels = len(caps) - 1
    carry = pool_start(problem, caps, live, per_frame=per_frame)
    carry, entering = pool_levels(problem, caps, planes, carry, 0, levels,
                                  per_frame=per_frame)
    states, leaf_f, dropped = pool_leaf(problem, caps, planes, carry,
                                        per_frame=per_frame)
    return states, entering, leaf_f, dropped


def _pool_rows(caps: Sequence[int], F: int, per_frame: bool) -> list:
    """The pool's rows at each level: ``caps``, or F times it per frame."""
    return [F * c for c in caps] if per_frame else list(caps)


def _frame_sum(rows: torch.Tensor, weights: torch.Tensor, F: int):
    """Sum ``weights`` by the rows' frame tags -> [F] int32."""
    return torch.zeros((F,), dtype=torch.int32, device=rows.device).index_add_(
        0, rows[:, 0].long(), weights.to(torch.int32))


def pool_start(problem, caps: Sequence[int], live: torch.Tensor, *,
               per_frame: bool = False) -> tuple:
    """The pool's carry before level 0: ``(state, ring, parity, count,
    frame_dropped)``, the banded [F*n, n] canvas zeroed and the live
    frames' roots in the ring, frame-major (frame f's g^2 roots, in root
    order, before frame f+1's: the order every frame's own worklist would
    have). Roots beyond ``caps[0]`` (the pool's, or each frame's) are
    dropped and charged to their frames."""
    n = problem.n
    dev = live.device
    F = live.shape[0]
    pool = _pool_rows(caps, F, per_frame)
    state = torch.zeros((F * n, n), dtype=torch.int32, device=dev)
    roots = problem.root_coords()  # [g*g, 2]
    gg = roots.shape[0]
    slot0 = torch.arange(F * gg, device=dev)
    rows0 = torch.cat([(slot0 // gg).to(torch.int32)[:, None],
                       roots.repeat(F, 1)], dim=1)
    flags0 = live[rows0[:, 0].long()]
    pol = getattr(problem, "policy", None)
    if per_frame:  # a frame keeps its first caps[0] roots
        keep0 = flags0 & (slot0 % gg < caps[0])
        ranks0, count = ops.compact_ranks(keep0, policy=pol)
    else:  # the pool keeps its first caps[0] roots
        ranks0, count0 = ops.compact_ranks(flags0, policy=pol)
        keep0 = flags0 & (ranks0 < caps[0])
        count = count0.clamp(max=caps[0])
    rows_c, _ = olt_lib.compact_gather(rows0, keep0, pool[0],
                                       ranks_count=(ranks0, count))
    frame_dropped = _frame_sum(rows0, flags0 & ~keep0, F)
    ring = olt_lib.ring_init(rows_c, pool[0], max(pool))
    return state, ring, 0, count, frame_dropped


def pool_levels(problem, caps: Sequence[int], planes: torch.Tensor,
                carry: tuple, lo: int, hi: int, *, per_frame: bool = False):
    """Run levels ``[lo, hi)`` of the pool from ``carry`` (``pool_start``'s
    or an earlier ``pool_levels``'); the canvas and the ring are updated
    in place. Returns (carry, entering [hi - lo, F]): each frame's live
    rows entering each level."""
    state, ring, parity, count, frame_dropped = carry
    r = problem.r
    pol = getattr(problem, "policy", None)
    dev = planes.device
    F = planes.shape[0]
    pool = _pool_rows(caps, F, per_frame)
    slots = torch.arange(ring.shape[1], device=dev)
    R = r * r
    entering = []
    for lv in range(lo, hi):
        cap_in, cap_out = pool[lv], caps[lv + 1]
        # per-frame live counts entering this level, off the front buffer
        entering.append(_frame_sum(ring[parity], slots < count, F))
        rows = olt_lib.ring_read(ring, parity, cap_in)
        valid = slots[:cap_in] < count
        state, flags = problem.pooled_level_step(state, rows, valid, level=lv,
                                                 planes=planes)
        flags = flags & valid
        ranks, kcount = ops.compact_ranks(flags, policy=pol)
        # k: a flagged parent's rank in its capacity's worklist, whose
        # children own slots [k*R, (k+1)*R) there, kept below cap_out
        k = _frame_ranks(rows, valid, ranks, F) if per_frame else ranks
        inserted = (cap_out - k * R).clamp(0, R)
        frame_dropped = frame_dropped + _frame_sum(
            rows, torch.where(flags, R - inserted, 0), F)
        if per_frame:
            children, count = _kept_children(rows, flags, inserted, r,
                                             pool[lv + 1], policy=pol)
        else:
            children, child_count = olt_lib.subdivide_olt_tagged(
                rows, flags, r=r, capacity=cap_out,
                ranks_count=(ranks, kcount))
            count = child_count.clamp(max=cap_out)
        ring = olt_lib.ring_write(ring, parity, children)
        parity = 1 - parity
    entering = (torch.stack(entering) if entering else
                torch.zeros((0, F), dtype=torch.int32, device=dev))
    return (state, ring, parity, count, frame_dropped), entering


def pool_live(caps: Sequence[int], carry: tuple, level: int, F: int, *,
              per_frame: bool = False):
    """The rows live in ``carry`` at ``level``: (rows [pool, 3], valid)."""
    _, ring, parity, count, _ = carry
    rows = olt_lib.ring_read(ring, parity, _pool_rows(caps, F, per_frame)[level])
    valid = torch.arange(rows.shape[0], device=rows.device) < count
    return rows, valid


def pool_leaf(problem, caps: Sequence[int], planes: torch.Tensor,
              carry: tuple, *, per_frame: bool = False):
    """The leaf pass A on the rows live after the last level. Returns
    (states [F, n, n], leaf_f [F], frame_dropped [F])."""
    state, _, _, _, frame_dropped = carry
    levels, F, n = len(caps) - 1, planes.shape[0], problem.n
    rows, valid = pool_live(caps, carry, levels, F, per_frame=per_frame)
    leaf_f = _frame_sum(rows, valid, F)
    state = problem.pooled_leaf_step(state, rows, valid, level=levels,
                                     planes=planes)
    return state.reshape(F, n, n), leaf_f, frame_dropped


def _frame_ranks(rows: torch.Tensor, valid: torch.Tensor, ranks: torch.Tensor,
                 F: int) -> torch.Tensor:
    """Each flagged row's rank among its own frame's flagged rows: its
    pool rank minus the pool rank of its frame's first row. The live rows
    are frame-major, so each frame's first row is a binary search of the
    frame tags (the rows past the live count tagged F). Junk where the
    flag is False."""
    tags = torch.where(valid, rows[:, 0], F).contiguous()
    first = torch.searchsorted(tags, torch.arange(F, dtype=tags.dtype,
                                                  device=tags.device))
    base = ranks[first.clamp_(max=rows.shape[0] - 1)]
    return ranks - base[rows[:, 0].long()]


def _kept_children(rows: torch.Tensor, flags: torch.Tensor,
                   inserted: torch.Tensor, r: int, capacity: int, *,
                   policy=None):
    """The children each flagged row keeps (its first ``inserted``, of
    r*r), compacted in row-then-child order through the scan kernel into
    ``capacity`` rows. Returns (child rows [capacity, 3], count)."""
    R = r * r
    dev = rows.device
    j = torch.arange(R, device=dev)
    keep = (flags[:, None] & (j[None, :] < inserted[:, None])).reshape(-1)
    dy, dx = (j // r).to(rows.dtype), (j % r).to(rows.dtype)
    children = torch.stack([rows[:, None, 0].expand(-1, R),
                            rows[:, None, 1] * r + dy,
                            rows[:, None, 2] * r + dx], dim=-1).reshape(-1, 3)
    ranks, count = ops.compact_ranks(keep, policy=policy)
    out, _ = olt_lib.compact_gather(children, keep, capacity,
                                    ranks_count=(ranks, count))
    return out, count


def _pooled_stats(caps, entering_fl, leaf_f, frame_dropped, wall_s) -> ASKStats:
    """Per-frame ASKStats from the pipeline's outputs (host-side;
    ``entering_fl`` is [F, levels])."""
    per_frame = _per_frame_counts(entering_fl)
    leaf_host = [int(c) for c in leaf_f]
    drop_host = [int(d) for d in frame_dropped]
    return ASKStats(
        levels=max((len(c) for c in per_frame), default=0),
        kernel_launches=1,  # one engine dispatch serves the whole batch
        region_counts=per_frame,
        leaf_count=sum(leaf_host),
        overflow_dropped=sum(drop_host),
        wall_s=wall_s,
        olt_caps=tuple(caps),  # the shared ring: ring_rows is the pool's
        frame_overflow=tuple(drop_host),
        frame_leaf_counts=tuple(leaf_host),
    )


def run_ask_pooled_batch(
    problem,
    extras: Any,
    *,
    capacities: Union[None, int, Sequence[int]] = None,
    frame_ps: Union[Sequence[float], None] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    live=None,
) -> Tuple[torch.Tensor, ASKStats]:
    """Render F frames through one pooled cross-frame worklist.

    ``extras`` is the [F, 4] per-frame bounds (re0, im0, re1, im1). Ring
    sizing: ``capacities`` (explicit shared per-level caps) > ``frame_ps``
    (per-frame subdivision probabilities, summed by
    ``pooled_capacities``) > ``p_subdiv`` for every frame. ``live`` masks
    frames out of the pool: dead frames get zero canvases and zero stats.

    Returns (states [F, n, n] int32 on the problem's device, stats) with
    the per-frame breakdown of the batched engines (``region_counts`` one
    tuple per frame, ``frame_overflow``, ``frame_leaf_counts``);
    ``stats.ring_rows`` is the whole batch's ring. ``kernel_launches`` is
    1, as in JAX: it counts engine dispatches, one for the batch, not the
    CUDA launches inside it. The stats are read back once, after the
    pipeline, which waits for the canvas too.
    """
    bounds = bounds_array(extras)
    F = bounds.shape[0]
    caps = _resolve_pooled_capacities(problem, F, capacities, frame_ps,
                                      p_subdiv, safety_factor)
    return run_pool(problem, bounds, caps, live=live)


def bounds_array(extras) -> np.ndarray:
    """The [F, 4] per-frame bounds of ``extras`` (array-like or tensor) as
    f32 numpy."""
    bounds = np.asarray(extras.cpu() if isinstance(extras, torch.Tensor)
                        else extras, dtype=np.float32)
    if bounds.ndim != 2 or bounds.shape[1] != 4:
        raise ValueError(f"bounds_batch must be [F, 4], got {bounds.shape}")
    return bounds


def enqueue_pool(problem, bounds: np.ndarray, caps: Sequence[int], *,
                 live=None, per_frame: bool = False) -> tuple:
    """The enqueue half of ``run_pool``: ``pooled_pipeline`` on [F, 4] f32
    ``bounds`` at ``caps``, on the problem's device and its current stream,
    with no host sync (the planes go up from pinned memory). ``live`` is
    None (every frame), a host mask, or a [F] bool tensor on the device.
    Returns (states, the stats' host copy): ``pool_stats``, started behind
    the pipeline on the same stream, whose event marks the states as
    written too."""
    F = bounds.shape[0]
    dev = problem.device
    planes = ops.pooled_planes(problem.n, bounds, dev)
    if live is None:
        live = torch.ones((F,), dtype=torch.bool, device=dev)
    elif not isinstance(live, torch.Tensor):
        live = torch.from_numpy(np.asarray(live, bool)).to(dev)
    states, entering, leaf_f, dropped = pooled_pipeline(
        problem, caps, planes, live, per_frame=per_frame)
    return states, pool_stats(entering, leaf_f, dropped)


def pool_stats(entering: torch.Tensor, leaf_f: torch.Tensor,
               dropped: torch.Tensor) -> tuple:
    """Start one pool's stats on their way to the host, in one transfer
    (``readback.StatsCopy``). Returns (the copy, levels, F)."""
    levels, F = entering.shape
    flat = torch.cat([entering.t().reshape(-1), leaf_f, dropped])
    return readback.StatsCopy(flat), levels, F


def read_pool(copy: readback.StatsCopy, levels: int, F: int) -> tuple:
    """The read-back half: wait on the copy's own event, not on what the
    stream ran since. Returns numpy (entering [F, levels], leaf_f [F],
    dropped [F])."""
    host = copy.read()
    return (host[:levels * F].reshape(F, levels),
            host[levels * F:levels * F + F], host[levels * F + F:])


def run_pool(problem, bounds: np.ndarray, caps: Sequence[int], *, live=None,
             per_frame: bool = False) -> Tuple[torch.Tensor, ASKStats]:
    """Run ``pooled_pipeline`` on [F, 4] f32 ``bounds`` at ``caps`` and read
    its stats back, once, after it (``enqueue_pool``, then ``read_pool``).
    Returns (states [F, n, n] on the problem's device, ASKStats)."""
    t0 = time.perf_counter()
    states, stats = enqueue_pool(problem, bounds, caps, live=live,
                                 per_frame=per_frame)
    entering_fl, leaf_f, dropped = read_pool(*stats)
    return states, _pooled_stats(caps, entering_fl, leaf_f, dropped,
                                 time.perf_counter() - t0)


def run_ask_pooled(
    problem,
    *,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
) -> Tuple[torch.Tensor, ASKStats]:
    """The pooled engine for one frame (a pool of F=1) with the flat
    single-frame stats: what ``solve(problem, "ask_pooled")`` runs."""
    states, stats = run_ask_pooled_batch(
        problem, np.asarray([problem.bounds], np.float32),
        capacities=capacities, p_subdiv=p_subdiv, safety_factor=safety_factor)
    stats = dataclasses.replace(stats, region_counts=stats.region_counts[0],
                                frame_overflow=(), frame_leaf_counts=())
    return states[0], stats


# ---------------------------------------------------------------------------
# the sharded pool: one pool per shard of a frames mesh
# ---------------------------------------------------------------------------

def _frames_axis(mesh) -> str:
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "run_ask_scan_sharded needs a 1-D frames mesh "
            f"(e.g. launch.mesh.make_frames_mesh()), got axes {mesh.axis_names}")
    return mesh.axis_names[0]


def shard_multiple(mesh, pad_to: Union[int, None]) -> int:
    """The multiple a sharded batch is padded to: the mesh's size, or
    ``pad_to``, which must be a multiple of it (JAX's checks, in its
    order: a 1-D mesh, then the multiple)."""
    _frames_axis(mesh)
    n_dev = mesh.size
    multiple = n_dev if pad_to is None else int(pad_to)
    if multiple % n_dev:
        raise ValueError(
            f"pad_to={multiple} must be a multiple of the mesh device count {n_dev}")
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    return multiple


def enqueue_shards(problem, bounds: np.ndarray, mesh, caps: Sequence[int], *,
                   multiple: int, per_frame: bool) -> tuple:
    """Pad [F, 4] ``bounds`` to a multiple of ``multiple`` (a multiple of
    the mesh's size, ``shard_multiple``) and enqueue one pool per
    shard: device d gets frames ``d*S .. (d+1)*S - 1``, the padded frames
    dead (``live=False``), on that device's current stream. Returns (the
    shards' ``enqueue_pool`` outputs, F)."""
    from repro_torch.core.ask import pad_frames

    padded, F = pad_frames(bounds, multiple)
    S = padded.shape[0] // mesh.size
    shards = []
    for d, dev in enumerate(mesh.devices):
        if dev.type != problem.device.type:
            raise ValueError(
                f"the mesh's devices are {dev.type}, the problem's "
                f"{problem.device.type}")
        q = problem if dev == problem.device else dataclasses.replace(
            problem, device=dev, plane=None)
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            live = torch.arange(d * S, (d + 1) * S, device=dev) < F
            shards.append(enqueue_pool(q, padded[d * S:(d + 1) * S], caps,
                                       live=live, per_frame=per_frame))
    return shards, F


def finish_shards(shards: list, F: int, caps: Sequence[int],
                  t0: float) -> tuple:
    """The read-back of a sharded dispatch: wait on each shard's own stats
    event, read its stats, mask the padded frames. Returns ``(states [F,
    n, n], ASKStats, ready)``: on one device the shard's canvas cut to F
    (no copy), on several the shards' canvases concatenated on the mesh's
    first device on its copy stream (``readback.gather_on_first``);
    ``ready`` is the CUDA event after which the states are written (None
    on the CPU)."""
    host = [read_pool(*shard[1]) for shard in shards]
    entering = np.concatenate([h[0] for h in host])[:F]
    leaf_f = np.concatenate([h[1] for h in host])[:F]
    dropped = np.concatenate([h[2] for h in host])[:F]
    if len(shards) == 1:
        states, ready = shards[0][0], shards[0][1][0].event
    else:
        states, ready = readback.gather_on_first(
            [shard[0] for shard in shards],
            [shard[1][0].event for shard in shards])
    if states.shape[0] != F:
        states = states[:F]
    return states, _pooled_stats(caps, entering, leaf_f, dropped,
                                 time.perf_counter() - t0), ready


class PooledDispatch(ShardedDispatch):
    """An in-flight sharded pooled batch: one pool per shard of the mesh,
    enqueued on each device's current stream, not yet read back. JAX's
    name for it; the handle is ``core.ask.ShardedDispatch``, whose
    ``caps`` here is the per-shard shared ring sizing."""


def dispatch_ask_pooled_sharded(
    problem,
    extras: Any,
    *,
    mesh,
    capacities: Union[None, int, Sequence[int]] = None,
    frame_ps: Union[Sequence[float], None] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    pad_to: Union[int, None] = None,
) -> PooledDispatch:
    """Enqueue one sharded pooled batch without waiting for it.

    Frames are padded up to a multiple of the mesh's size (``pad_to``
    overrides the multiple) with dead frames, which add no occupancy and
    no rows, then assigned frame-major: shard d pools frames ``d*S ..
    (d+1)*S - 1`` into one shared ring. Every shard gets the same ring
    sizing: per level, the maximum over shards of that shard's pooled
    capacity over its live frames, each frame at its own P with
    ``frame_ps``; uniform ``p_subdiv`` sizes a full shard of S frames;
    explicit ``capacities`` are per-shard shared caps, taken as given.
    Call ``.finalize()`` for ``(states, ASKStats)``.
    """
    bounds = bounds_array(extras)
    F = bounds.shape[0]
    multiple = shard_multiple(mesh, pad_to)
    S = (F + (-F) % multiple) // mesh.size
    if capacities is not None:
        caps = _resolve_pooled_capacities(problem, S, capacities, None,
                                          p_subdiv, safety_factor)
    elif frame_ps is not None:
        ps = [float(p) for p in frame_ps]
        if len(ps) != F:
            raise ValueError(
                f"frame_ps covers {len(ps)} frames, batch has {F}")
        caps = None
        for d in range(mesh.size):
            c = pooled_capacities(problem, ps[d * S:min((d + 1) * S, F)],
                                  safety_factor=safety_factor)
            caps = c if caps is None else tuple(
                max(a, b) for a, b in zip(caps, c))
    else:
        caps = pooled_capacities(problem, (float(p_subdiv),) * S,
                                 safety_factor=safety_factor)
    t0 = time.perf_counter()
    shards, F = enqueue_shards(problem, bounds, mesh, caps,
                               multiple=multiple, per_frame=False)
    return PooledDispatch(shards=shards, frames=F, caps=tuple(caps), t0=t0)


def run_ask_pooled_sharded(
    problem,
    extras: Any,
    *,
    mesh,
    capacities: Union[None, int, Sequence[int]] = None,
    frame_ps: Union[Sequence[float], None] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    pad_to: Union[int, None] = None,
    block_until_ready: bool = True,
) -> Tuple[torch.Tensor, ASKStats]:
    """``dispatch_ask_pooled_sharded`` then ``PooledDispatch.finalize``:
    one pool per shard (the ring across the mesh is ``mesh.size *
    stats.ring_rows`` rows)."""
    d = dispatch_ask_pooled_sharded(
        problem, extras, mesh=mesh, capacities=capacities,
        frame_ps=frame_ps, p_subdiv=p_subdiv, safety_factor=safety_factor,
        pad_to=pad_to)
    return d.finalize(block_until_ready=block_until_ready)
