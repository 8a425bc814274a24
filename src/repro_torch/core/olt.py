"""Offset Lookup Tables (OLT) -- paper Sec. 5.2/5.3, the main-path part.

Counterpart of ``repro/core/olt.py`` (``next_pow2``, ``pad_olt``,
``compact_ranks``, ``compact_gather``, ``subdivide_olt``). The paper
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

__all__ = ["next_pow2", "pad_olt", "compact_ranks", "compact_gather",
           "subdivide_olt"]


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


def compact_ranks(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The atomicAdd replacement (paper Sec. 5.3.1).

    ``flags`` [N] bool. Returns ``ranks`` [N] int32, the exclusive prefix
    sum (the slot each inserting entry owns; junk where the flag is False),
    and ``count``, the int32 scalar total, left on the device.
    """
    return ref.compact_ranks_ref(flags)


def compact_gather(values: torch.Tensor, flags: torch.Tensor,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact ``values[flags]`` into the first ``count`` rows of a
    [capacity, ...] tensor (write-OLT form), in stable order; the other
    rows are zero."""
    ranks, count = compact_ranks(flags)
    idx = torch.where(flags, ranks.long(), capacity).clamp_(max=capacity)
    out = torch.zeros((capacity + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:capacity], count


def subdivide_olt(coords: torch.Tensor, flags: torch.Tensor, *, r: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One read-OLT -> write-OLT step (paper Sec. 5.3.2).

    Every flagged region inserts its r*r children contiguously at
    ``rank * r * r``. Returns (child_coords [capacity, 2], child_count), the
    count an int32 scalar on the device.
    """
    ranks, count = compact_ranks(flags)
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
