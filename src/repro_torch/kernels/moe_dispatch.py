"""Batched OLT ranks, the MoE ``position_in_expert`` (``csrc/moe_dispatch.cu``).

Replaces ``repro/kernels/moe_dispatch.py`` ``batched_ranks_kernel``: for
every column of ``flags`` [N, E], the exclusive rank of each flagged entry
within its column plus the column totals, E independent OLT compactions in
one pass (the paper's atomicAdd-per-expert replacement). The Pallas kernel
holds one [N, E] tile in VMEM, so ``ops.py`` of the JAX package falls back
to ``jnp.cumsum`` above 65536 elements; this kernel takes any N, and a
leading group axis G: ``flags`` [G, N, E], all groups in one launch.

Design: one launch at every shape, each flag read once: a single-pass
scan with decoupled look-back over a flat grid of (group, 32 columns,
tile of rows); the header of the ``.cu`` and ``csrc/lookback.cuh`` say
how. A column longer than
one tile needs look-back state that outlives the call: a scratch per
device and stream, zeroed once when made and kept (``_SCRATCH``), whose
epoch-tagged words need no clearing between calls. It is never made while
a CUDA graph captures: a graph that captures a call of more than one tile
needs one call of that shape or larger on its capture stream first, e.g.
a warm-up under ``torch.cuda.stream(s)`` and then ``torch.cuda.graph(g,
stream=s)``, and is replayed in order with that stream's calls, which share
the scratch. What bounds it on the card is bytes (each flag read, each
rank written). The plain version is ``ref.batched_ranks``
(``cumsum(dim=1) - flags``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["batched_ranks", "batched_ranks_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 3, ctypes.c_longlong,
             ctypes.c_void_p]
_V = 4  # columns a thread (V of the .cu)
_MAX_GRID = (1 << 31) - 1
# (device index, stream) -> the look-back scratch of that stream, and the
# ones a CUDA graph captured (``_build.lookback_scratch``)
_SCRATCH: dict = {}
_CAPTURED: list = []


def batched_ranks_plain(flags: torch.Tensor):
    """The plain version: ``ref.batched_ranks``."""
    return ref.batched_ranks(flags)


def _tile_rows(N: int) -> int:
    """Rows of a tile for columns of N rows: 128 while a column fits one
    (MoE decode, N = 48), else 512 (the prefill, N = 6144)."""
    return 128 if N <= 128 else 512


def batched_ranks(flags: torch.Tensor):
    """flags [G, N, E] bool or int32 (an int32 flag adds its value).
    Returns (ranks [G, N, E] int32, the exclusive scan of each column along
    N; counts [G, E] int32, the column totals), on the device. A CUDA
    tensor launches the kernel once (counted in ``batched_ranks.launches``);
    a CPU one takes the plain version."""
    if not _build.on_card(flags.device):
        return batched_ranks_plain(flags)
    if flags.dtype not in (torch.bool, torch.int32) or flags.ndim != 3 \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous 3-D bool or int32 tensor "
                         f"[G, N, E], got {flags.dtype} {tuple(flags.shape)}")
    G, N, E = flags.shape
    ranks = torch.empty((G, N, E), dtype=torch.int32, device=flags.device)
    if N == 0 or G == 0 or E == 0:
        return ranks, torch.zeros((G, E), dtype=torch.int32, device=flags.device)
    rows = _tile_rows(N)
    tiles = -(-N // rows)
    blocks = G * -(-E // 32) * tiles
    if blocks > _MAX_GRID:
        raise ValueError(f"flags {tuple(flags.shape)}: {blocks} tiles, at most "
                         f"{_MAX_GRID}")
    counts = torch.empty((G, E), dtype=torch.int32, device=flags.device)
    stream = _build.stream(flags)
    scratch, words = None, 0
    if tiles > 1:
        scratch = _build.lookback_scratch(_SCRATCH, _CAPTURED, flags.device,
                                          stream.value, 32 * blocks,
                                          "batched_ranks")
        words = scratch.numel() - _build.LOOKBACK_STATE
    launch = _build.function("moe_dispatch", "batched_ranks_launch", _ARGTYPES)
    width = _V * flags.element_size()  # bytes of one V-flag load
    vec = int(E % _V == 0 and flags.data_ptr() % width == 0
              and ranks.data_ptr() % (4 * _V) == 0)
    launch(_build.ptr(flags), G, N, E, int(flags.dtype == torch.bool), rows,
           vec, _build.ptr(ranks), _build.ptr(counts),
           None if scratch is None else _build.ptr(scratch), words, stream)
    batched_ranks.launches += 1
    return ranks, counts


batched_ranks.launches = 0
