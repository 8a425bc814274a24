"""The OLT scan: exclusive prefix sum of insert flags plus their total
(``csrc/olt_compact.cu``).

Replaces ``repro/kernels/olt_compact.py``: ``compact_ranks_kernel`` (one
VMEM block, N <= 65536) and ``compact_ranks_blocked`` (a sequential grid
that carries the running total in SMEM). Both compute the same function,
and one CUDA scan covers them for any N: CUDA blocks run in no order, so
the kernel is a two-pass reduce-then-scan (tile sums, one block scanning
them, then each tile's own scan with warp shuffles). What bounds it on the
card is bytes: each flag is read twice and each rank written once. The
plain version is ``torch.cumsum``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["compact_ranks", "compact_ranks_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             *[ctypes.c_void_p] * 4]
TILE = 4096  # flags per block: kTile of csrc/olt_compact.cu


def compact_ranks_plain(flags: torch.Tensor):
    """The plain version: ``ref.compact_ranks_ref`` with the count as [1]."""
    ranks, count = ref.compact_ranks_ref(flags)
    return ranks, count.reshape(1)


def compact_ranks(flags: torch.Tensor):
    """flags [N] bool or int32 (an int32 flag adds its value). Returns
    (ranks [N] int32, the exclusive scan; count [1] int32, the total), both
    left on the device. A CUDA tensor launches the kernel (counted in
    ``compact_ranks.launches``); a CPU one takes the plain version."""
    if not _build.on_card(flags.device):
        return compact_ranks_plain(flags)
    if flags.dtype not in (torch.bool, torch.int32) or flags.ndim != 1 \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous 1-D bool or int32 tensor, "
                         f"got {flags.dtype} {tuple(flags.shape)}")
    N = flags.shape[0]
    ranks = torch.empty((N,), dtype=torch.int32, device=flags.device)
    if N == 0:
        return ranks, torch.zeros((1,), dtype=torch.int32, device=flags.device)
    # the kernel always writes the count
    count = torch.empty((1,), dtype=torch.int32, device=flags.device)
    partials = torch.empty(((N + TILE - 1) // TILE,), dtype=torch.int32,
                           device=flags.device)
    launch = _build.function("olt_compact", "olt_compact_launch", _ARGTYPES)
    launch(_build.ptr(flags), N, int(flags.dtype == torch.bool),
           _build.ptr(ranks), _build.ptr(count), _build.ptr(partials),
           _build.stream(flags))
    compact_ranks.launches += 1
    return ranks, count


compact_ranks.launches = 0
