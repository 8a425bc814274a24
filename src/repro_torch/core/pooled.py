"""Pooled per-level worklists: one cross-frame OLT ring for a whole batch.

Counterpart of ``repro/core/pooled.py`` without its sharded part. Per
level, the live regions of all F frames travel in one compacted worklist
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
more than the enqueue it saves; PERF.md.) The sharded pool
(``run_ask_pooled_sharded``) comes with ROADMAP queue 1 slice 12.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import olt as olt_lib
from repro_torch.core.ask import ASKStats, _per_frame_counts
from repro_torch.core.cost_model import expected_level_counts, num_levels
from repro_torch.kernels import ops

__all__ = ["pooled_capacities", "escalate_pooled_capacities",
           "failed_pool_capacities", "pooled_pipeline",
           "run_ask_pooled", "run_ask_pooled_batch",
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
                    live: torch.Tensor):
    """Render the frames of ``planes`` [F, 4] (``ops.pooled_planes``)
    through one shared OLT ring of frame-tagged rows, with no host sync.

    ``live`` [F] bool masks frames out of the pool. Returns (states
    [F, n, n], entering [levels, F], leaf_f [F], frame_dropped [F]), all on
    the problem's device. The problem implements ``pooled_level_step`` and
    ``pooled_leaf_step`` (``workloads.FrameProblem`` does).
    """
    g, r, n = problem.g, problem.r, problem.n
    dev = planes.device
    levels = len(caps) - 1
    ring_width = max(caps)
    F = planes.shape[0]
    R = r * r

    def frame_sum(rows, weights):
        """Sum ``weights`` by the rows' frame tags -> [F] int32."""
        return torch.zeros((F,), dtype=torch.int32, device=dev).index_add_(
            0, rows[:, 0].long(), weights.to(torch.int32))

    state = torch.zeros((F * n, n), dtype=torch.int32, device=dev)

    # frame-major roots: frame f's g^2 roots, in root order, before frame
    # f+1's -- the order every frame's own worklist would have
    roots = problem.root_coords()  # [g*g, 2]
    gg = roots.shape[0]
    frame_ids = (torch.arange(F * gg, device=dev) // gg).to(torch.int32)
    rows0 = torch.cat([frame_ids[:, None], roots.repeat(F, 1)], dim=1)
    flags0 = live[rows0[:, 0].long()]
    ranks0, count0 = ops.compact_ranks(flags0)
    rows_c, _ = olt_lib.compact_gather(rows0, flags0, caps[0],
                                       ranks_count=(ranks0, count0))
    frame_dropped = frame_sum(rows0, flags0 & (ranks0 >= caps[0]))
    count = count0.clamp(max=caps[0])
    ring = olt_lib.ring_init(rows_c, caps[0], ring_width)
    parity = 0
    slots = torch.arange(ring_width, device=dev)

    entering = []
    for lv in range(levels):
        cap_in, cap_out = caps[lv], caps[lv + 1]
        # per-frame live counts entering this level, off the front buffer
        entering.append(frame_sum(ring[parity], slots < count))
        rows = olt_lib.ring_read(ring, parity, cap_in)
        valid = slots[:cap_in] < count
        state, flags = problem.pooled_level_step(state, rows, valid, level=lv,
                                                 planes=planes)
        flags = flags & valid
        ranks, kcount = ops.compact_ranks(flags)
        children, child_count = olt_lib.subdivide_olt_tagged(
            rows, flags, r=r, capacity=cap_out, ranks_count=(ranks, kcount))
        # the flagged parent of rank k owns slots [k*R, (k+1)*R), so its
        # dropped children are exactly R - clip(cap_out - k*R, 0, R)
        inserted = (cap_out - ranks * R).clamp(0, R)
        frame_dropped += frame_sum(rows, torch.where(flags, R - inserted, 0))
        count = child_count.clamp(max=cap_out)
        ring = olt_lib.ring_write(ring, parity, children)
        parity = 1 - parity
    entering = (torch.stack(entering) if entering else
                torch.zeros((0, F), dtype=torch.int32, device=dev))

    rows = olt_lib.ring_read(ring, parity, caps[levels])
    valid = slots[:caps[levels]] < count
    leaf_f = frame_sum(rows, valid)
    state = problem.pooled_leaf_step(state, rows, valid, level=levels,
                                     planes=planes)
    return state.reshape(F, n, n), entering, leaf_f, frame_dropped


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
    bounds = np.asarray(extras.cpu() if isinstance(extras, torch.Tensor)
                        else extras, dtype=np.float32)
    if bounds.ndim != 2 or bounds.shape[1] != 4:
        raise ValueError(f"pooled extras must be [F, 4] bounds, got {bounds.shape}")
    F = bounds.shape[0]
    caps = _resolve_pooled_capacities(problem, F, capacities, frame_ps,
                                      p_subdiv, safety_factor)
    dev = problem.device
    live_host = np.ones((F,), bool) if live is None else np.asarray(live, bool)

    t0 = time.perf_counter()
    planes = ops.pooled_planes(problem.n, bounds, dev)
    live_t = torch.from_numpy(live_host).to(dev)
    states, entering, leaf_f, dropped = pooled_pipeline(problem, caps, planes,
                                                        live_t)
    levels = entering.shape[0]
    host = torch.cat([entering.reshape(-1), leaf_f, dropped]).cpu().numpy()
    entering_fl = host[:levels * F].reshape(levels, F).T
    stats = _pooled_stats(caps, entering_fl, host[levels * F:levels * F + F],
                          host[levels * F + F:], time.perf_counter() - t0)
    return states, stats


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


def run_ask_pooled_sharded(*args, **kwargs):
    """One pool per device shard: ported with ROADMAP queue 1 slice 12."""
    raise NotImplementedError(
        "the sharded pooled engine is not ported yet: ROADMAP queue 1 "
        "slice 12 (sharded frames)")


def dispatch_ask_pooled_sharded(*args, **kwargs):
    """The non-blocking half of ``run_ask_pooled_sharded``: slice 12."""
    raise NotImplementedError(
        "the sharded pooled engine is not ported yet: ROADMAP queue 1 "
        "slice 12 (sharded frames)")
