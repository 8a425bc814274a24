"""Offset Lookup Tables (OLT) -- paper Sec. 5.2/5.3, the main-path part.

Counterpart of ``repro/core/olt.py`` (``next_pow2``, ``pad_olt``, the
double-buffered ring ``ring_init``/``ring_read``/``ring_write``,
``compact_ranks``, ``batched_compact_ranks``, ``compact_gather``,
``subdivide_olt`` and the pooled engine's ``subdivide_olt_tagged``). The paper
compacts concurrent OLT insertions with an ``atomicAdd``; like the JAX
package, the port takes the alternative the paper names in Sec. 5.3.1, an
exclusive prefix sum over the insert flags, which keeps insertion order
stable. These are torch operations: the JAX package computes them outside
any Pallas kernel too.

A region at level ``l`` is identified by its integer coordinate
``(cy, cx)`` in the level-l region grid; a subdividing region produces the
children ``(cy*r + dy, cx*r + dx)`` for ``dy, dx in [0, r)``.

Rows that JAX drops with ``mode="drop"`` scatter into one extra junk row
here, which is cut off before returning, so nothing waits on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref

__all__ = ["next_pow2", "pad_olt", "ring_init", "ring_read", "ring_write",
           "compact_ranks", "batched_compact_ranks", "compact_gather",
           "subdivide_olt", "subdivide_olt_tagged"]


def next_pow2(x: int) -> int:
    """Bucket size for the serial-kernel relaunch: live counts are rounded
    up to the next power of two, so the OLTs take O(log n) distinct sizes."""
    x = int(x)
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def pad_olt(coords: torch.Tensor, count: int,
            capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad an OLT of ``count`` live entries up to ``capacity`` rows.

    Returns (padded_coords [capacity, k], valid [capacity] bool). Padded
    rows replicate row 0; ``valid`` masks them out.
    """
    if coords.ndim != 2:
        raise ValueError("coords must be [N, k]")
    n = coords.shape[0]
    if capacity < count:
        raise ValueError(f"capacity {capacity} < count {count}")
    if n >= capacity:
        out = coords[:capacity]
    else:
        fill = coords[:1].expand(capacity - n, coords.shape[1])
        out = torch.cat([coords, fill], dim=0)
    valid = torch.arange(capacity, device=coords.device) < count
    return out, valid


# -- the double-buffered OLT ring: one read and one write buffer of equal
# width, swapped by parity each level. The level loop runs on the host, so
# the parity is a Python int.

def ring_init(coords: torch.Tensor, count: int, capacity: int) -> torch.Tensor:
    """A [2, capacity, k] ring with ``coords`` in the front (parity-0)
    buffer, padded as ``pad_olt`` pads; beyond ``capacity`` the tail is cut
    (the caller counts those rows as dropped)."""
    buf0, _ = pad_olt(coords, min(count, capacity), capacity)
    return torch.stack([buf0, torch.zeros_like(buf0)], dim=0)


def ring_read(ring: torch.Tensor, parity: int, cap: int) -> torch.Tensor:
    """The first ``cap`` rows of the front buffer (a view): [cap, k]."""
    return ring[parity, :cap]


def ring_write(ring: torch.Tensor, parity: int, buf: torch.Tensor) -> torch.Tensor:
    """Store ``buf`` (a compact child OLT no wider than the ring) into the
    back buffer ``1 - parity``, zero past its rows; in place, returns
    ``ring``."""
    width = ring.shape[1]
    if buf.shape[0] > width:
        raise ValueError(f"child OLT {buf.shape[0]} exceeds ring width {width}")
    back = ring[1 - parity]
    back[:buf.shape[0]] = buf
    back[buf.shape[0]:] = 0
    return ring


def compact_ranks(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The atomicAdd replacement (paper Sec. 5.3.1).

    ``flags`` [N] bool. Returns ``ranks`` [N] int32, the exclusive prefix
    sum (the slot each inserting entry owns; junk where the flag is False),
    and ``count``, the int32 scalar total, left on the device.
    """
    return ref.compact_ranks_ref(flags)


def batched_compact_ranks(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column compact ranks: ``flags`` [N, E] -> (ranks [N, E], counts
    [E]), int32. Column e is an independent OLT: the MoE token->expert
    dispatch primitive (the paper's atomicAdd-per-expert becomes E parallel
    prefix sums). The torch path; ``kernels.ops.batched_ranks`` runs it as
    a kernel on the card."""
    ranks, counts = ref.batched_ranks(flags[None])
    return ranks[0], counts[0]


def compact_gather(values: torch.Tensor, flags: torch.Tensor, capacity: int,
                   *, ranks_count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact ``values[flags]`` into the first ``count`` rows of a
    [capacity, ...] tensor (write-OLT form), in stable order; the other
    rows are zero. ``ranks_count`` supplies a precomputed ``(ranks,
    count)``, as the pooled engine's scan kernel gives them."""
    ranks, count = compact_ranks(flags) if ranks_count is None else ranks_count
    idx = torch.where(flags, ranks.long(), capacity).clamp_(max=capacity)
    out = torch.zeros((capacity + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:capacity], count


def subdivide_olt(coords: torch.Tensor, flags: torch.Tensor, *, r: int,
                  capacity: int,
                  ranks_count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One read-OLT -> write-OLT step (paper Sec. 5.3.2).

    Every flagged region inserts its r*r children contiguously at
    ``rank * r * r``. Returns (child_coords [capacity, 2], child_count), the
    count an int32 scalar on the device; ``ranks_count`` as in
    ``compact_gather``.
    """
    ranks, count = compact_ranks(flags) if ranks_count is None else ranks_count
    R = r * r
    dev = coords.device
    dy, dx = torch.meshgrid(torch.arange(r, device=dev),
                            torch.arange(r, device=dev), indexing="ij")
    offs = torch.stack([dy.reshape(-1), dx.reshape(-1)], dim=-1).to(coords.dtype)
    children = coords[:, None, :] * r + offs[None, :, :]  # [N, R, 2]
    base = torch.where(flags, ranks.long() * R, capacity)
    idx = (base[:, None] + torch.arange(R, device=dev)[None, :]).clamp_(max=capacity)
    out = torch.zeros((capacity + 1, 2), dtype=coords.dtype, device=dev)
    out[idx.reshape(-1)] = children.reshape(-1, 2)
    return out[:capacity], count * R


def subdivide_olt_tagged(rows: torch.Tensor, flags: torch.Tensor, *, r: int,
                         capacity: int,
                         ranks_count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame-tagged OLT step of the pooled cross-frame worklist.

    ``rows`` [N, 3] int32 = (frame, cy, cx). Only the coordinate columns
    are multiplied by ``r``; the frame tag goes into all r*r children
    unchanged. The layout is ``subdivide_olt``'s (the flagged row of rank
    k owns slots [k*r*r, (k+1)*r*r)), so each frame's children keep the
    order its own worklist would give them. Returns (child_rows
    [capacity, 3], child_count); ``ranks_count`` as in ``compact_gather``.
    """
    ranks, count = compact_ranks(flags) if ranks_count is None else ranks_count
    R = r * r
    dev = rows.device
    dy, dx = torch.meshgrid(torch.arange(r, device=dev),
                            torch.arange(r, device=dev), indexing="ij")
    offs = torch.stack([torch.zeros_like(dy.reshape(-1)), dy.reshape(-1),
                        dx.reshape(-1)], dim=-1).to(rows.dtype)  # [R, 3]
    scale = torch.ones(3, dtype=rows.dtype, device=dev)
    scale[1:] = r  # the frame tag is not scaled
    children = rows[:, None, :] * scale + offs[None, :, :]  # [N, R, 3]
    base = torch.where(flags, ranks.long() * R, capacity)
    idx = (base[:, None] + torch.arange(R, device=dev)[None, :]).clamp_(max=capacity)
    out = torch.zeros((capacity + 1, 3), dtype=rows.dtype, device=dev)
    out[idx.reshape(-1)] = children.reshape(-1, 3)
    return out[:capacity], count * R
