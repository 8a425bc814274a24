"""Batched OLT ranks, the MoE ``position_in_expert`` (``csrc/moe_dispatch.cu``).

Replaces ``repro/kernels/moe_dispatch.py`` ``batched_ranks_kernel``: for
every column of ``flags`` [N, E], the exclusive rank of each flagged entry
within its column plus the column totals, E independent OLT compactions in
one pass (the paper's atomicAdd-per-expert replacement). The Pallas kernel
holds one [N, E] tile in VMEM, so ``ops.py`` of the JAX package falls back
to ``jnp.cumsum`` above 65536 elements; this kernel takes any N, and a
leading group axis G: ``flags`` [G, N, E], all groups in one launch.

Design: blocks of 32 columns x 32 row lanes walk the rows in chunks of
128, each warp scanning one column with ``__shfl_up_sync``; above
``TILE_ROWS`` rows it is a reduce-then-scan of three launches (tile
totals, their scan, each tile's scan from its offset), since CUDA blocks
run in no order. What bounds it on the card is bytes (each flag read, each
rank written). The plain version is ``ref.batched_ranks``
(``cumsum(dim=1) - flags``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["batched_ranks", "batched_ranks_plain", "TILE_ROWS"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, *[ctypes.c_void_p] * 4]
TILE_ROWS = 512  # kTileRows of csrc/moe_dispatch.cu
_MAX_GRID = 65535  # gridDim.y and gridDim.z


def batched_ranks_plain(flags: torch.Tensor):
    """The plain version: ``ref.batched_ranks``."""
    return ref.batched_ranks(flags)


def batched_ranks(flags: torch.Tensor):
    """flags [G, N, E] bool or int32 (an int32 flag adds its value).
    Returns (ranks [G, N, E] int32, the exclusive scan of each column along
    N; counts [G, E] int32, the column totals), on the device. A CUDA
    tensor launches the kernel (counted in ``batched_ranks.launches``); a
    CPU one takes the plain version."""
    if not _build.on_card(flags.device):
        return batched_ranks_plain(flags)
    if flags.dtype not in (torch.bool, torch.int32) or flags.ndim != 3 \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous 3-D bool or int32 tensor "
                         f"[G, N, E], got {flags.dtype} {tuple(flags.shape)}")
    G, N, E = flags.shape
    tiles = -(-N // TILE_ROWS)
    if G > _MAX_GRID or tiles > _MAX_GRID or E > 1 << 30:
        raise ValueError(f"flags {tuple(flags.shape)}: at most {_MAX_GRID} "
                         f"groups and {_MAX_GRID * TILE_ROWS} rows")
    ranks = torch.empty((G, N, E), dtype=torch.int32, device=flags.device)
    if N == 0 or G == 0 or E == 0:
        return ranks, torch.zeros((G, E), dtype=torch.int32, device=flags.device)
    counts = torch.empty((G, E), dtype=torch.int32, device=flags.device)
    partials = torch.empty((G, tiles, E) if tiles > 1 else (1,),
                           dtype=torch.int32, device=flags.device)
    launch = _build.function("moe_dispatch", "batched_ranks_launch", _ARGTYPES)
    launch(_build.ptr(flags), G, N, E, int(flags.dtype == torch.bool),
           _build.ptr(ranks), _build.ptr(counts), _build.ptr(partials),
           _build.stream(flags))
    batched_ranks.launches += 1
    return ranks, counts


batched_ranks.launches = 0
