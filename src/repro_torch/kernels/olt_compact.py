"""The OLT scan: exclusive prefix sum of insert flags plus their total
(``csrc/olt_compact.cu``).

Replaces ``repro/kernels/olt_compact.py``: ``compact_ranks_kernel`` (one
VMEM block, N <= 65536) and ``compact_ranks_blocked`` (a sequential grid
that carries the running total in SMEM). Both compute the same function,
and one CUDA kernel covers them for any N in one launch that reads each
flag once: a single block sized to N up to one tile of 4096 flags, and
above it a single-pass scan with decoupled look-back (``csrc/lookback.cuh``,
shared with the batched ranks). A call of more than one tile needs
look-back state that outlives the call: a scratch per device and stream,
zeroed once when made and kept (``_SCRATCH``), whose epoch-tagged words
need no clearing between calls. It is never made while a CUDA graph
captures: warm the call up on the capture stream first
(``torch.cuda.stream(s)``, then ``torch.cuda.graph(g, stream=s)``), as
``core.graphs`` does. What bounds it on the card is bytes (each flag read,
each rank written once); at the engines' sizes that is below a launch's
floor. The plain version is ``torch.cumsum``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["compact_ranks", "compact_ranks_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             *[ctypes.c_void_p] * 3, ctypes.c_longlong, ctypes.c_void_p]
TILE = 4096  # flags a block: kTile of csrc/olt_compact.cu
# (device index, stream) -> the look-back scratch of that stream, and the
# ones a CUDA graph captured (``_build.lookback_scratch``)
_SCRATCH: dict = {}
_CAPTURED: list = []


def compact_ranks_plain(flags: torch.Tensor):
    """The plain version: ``ref.compact_ranks_ref`` with the count as [1]."""
    ranks, count = ref.compact_ranks_ref(flags)
    return ranks, count.reshape(1)


def compact_ranks(flags: torch.Tensor):
    """flags [N] bool or int32 (an int32 flag adds its value). Returns
    (ranks [N] int32, the exclusive scan; count [1] int32, the total), both
    left on the device. A CUDA tensor launches the kernel once (counted in
    ``compact_ranks.launches``; N = 0 launches nothing); a CPU one takes
    the plain version."""
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
    count = torch.empty((1,), dtype=torch.int32, device=flags.device)
    stream = _build.stream(flags)
    tiles = -(-N // TILE)
    scratch, words = None, 0
    if tiles > 1:
        scratch = _build.lookback_scratch(_SCRATCH, _CAPTURED, flags.device,
                                          stream.value, tiles, "compact_ranks")
        words = scratch.numel() - _build.LOOKBACK_STATE
    vec = int(flags.data_ptr() % 16 == 0 and ranks.data_ptr() % 16 == 0)
    launch = _build.function("olt_compact", "olt_compact_launch", _ARGTYPES)
    launch(_build.ptr(flags), N, int(flags.dtype == torch.bool), vec,
           _build.ptr(ranks), _build.ptr(count),
           None if scratch is None else _build.ptr(scratch), words, stream)
    compact_ranks.launches += 1
    return ranks, count


compact_ranks.launches = 0
