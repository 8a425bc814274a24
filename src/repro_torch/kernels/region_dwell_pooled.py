"""A on the banded cross-frame canvas (``csrc/region_dwell_pooled.cu``).

Replaces ``repro/kernels/region_dwell_pooled.py::region_dwell_pooled``.
Each frame-tagged leaf row (f, cy, cx) is computed in its own frame's
plane: the Pallas kernel stages the [F, 4] bounds through scalar prefetch
and computes each window's step itself; here ``planes`` [F, 4] f32 =
(re0, im0, step_re, step_im) is computed once per batch on the host in the
traced spelling (``ref.pooled_planes``) and every row gathers its own by
frame tag. The canvas is updated in place and the kernel reads the live
row count on the device. The unit of work is an item of up to 4096 pixels
of one row (a B=32 leaf is one item of 1024), one warp owns it and
computes it by lane refill (as ``region_dwell``), and the warps of a grid
of a few blocks per SM take items from one counter on the device, zeroed
by the launch on the same stream (``next_item``, 8 bytes of scratch that
the wrapper allocates). What bounds it on the card is the issue rate of
the escape loop under the rounding contract (8 instructions a mandelbrot
step, none fused; ``csrc/escape_time.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.region_fill_pooled import _check_band

__all__ = ["region_dwell_pooled", "region_dwell_pooled_plain"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    *_build.WORKLOAD_ARGTYPES, ctypes.c_int, ctypes.c_void_p]
_THREADS = 256  # kWarps = 8 warps in the .cu


def region_dwell_pooled_plain(canvas: torch.Tensor, rows: torch.Tensor,
                              count: torch.Tensor, planes: torch.Tensor, *,
                              side: int, n: int, max_dwell: int = 512,
                              workload=None) -> torch.Tensor:
    """The plain version: ``ref.region_interior_pooled_ref`` of the first
    ``count`` rows, written with one indexed write."""
    _check_band(canvas, side, n)
    k = int(count.reshape(()))
    tiles = ref.region_interior_pooled_ref(rows[:k], planes, side=side,
                                           max_dwell=max_dwell,
                                           workload=workload)
    ys, xs = ref.pooled_region_index(rows[:k], side, n)
    canvas[ys, xs] = tiles.to(canvas.dtype)
    return canvas


def region_dwell_pooled(canvas: torch.Tensor, rows: torch.Tensor,
                        count: torch.Tensor, planes: torch.Tensor, *,
                        side: int, n: int, max_dwell: int = 512,
                        workload=None, unroll=None) -> torch.Tensor:
    """Write the interior dwell of the first ``count`` frame-tagged leaf
    rows into the banded ``canvas`` in place; returns ``canvas``. Shapes as
    in ``region_fill_pooled``, plus ``planes`` [F, 4] f32. A CUDA canvas
    launches the kernel (counted in ``region_dwell_pooled.launches``), in
    blocks of ``unroll`` steps (None: the default, 16); a CPU one takes the
    plain version."""
    _check_band(canvas, side, n)
    if not _build.on_card(canvas.device):
        return region_dwell_pooled_plain(canvas, rows, count, planes, side=side,
                                         n=n, max_dwell=max_dwell,
                                         workload=workload)
    for name, x, nd in (("canvas", canvas, 2), ("rows", rows, 2),
                        ("count", count, 1)):
        _build.check(x, name, torch.int32, nd)
    _build.check(planes, "planes", torch.float32, 2)
    unroll = _build.unroll_arg(unroll)
    N = rows.shape[0]
    if N == 0:
        return canvas
    rpi = _build.rows_per_item(side)
    items = N * -(-side // rpi)  # one warp each
    grid = _build.grid_for(canvas.device, -(-items // (_THREADS // 32)),
                           _THREADS)
    next_item = torch.empty((1,), dtype=torch.int64, device=canvas.device)
    launch = _build.function("region_dwell_pooled", "region_dwell_pooled_launch",
                             _ARGTYPES)
    launch(_build.ptr(canvas), _build.ptr(rows), _build.ptr(count),
           _build.ptr(planes), _build.ptr(next_item), grid, n, side, rpi,
           *_build.workload_args(max_dwell, workload),
           unroll, _build.stream(canvas))
    region_dwell_pooled.launches += 1
    return canvas


region_dwell_pooled.launches = 0
