"""A: the per-pixel dwell of each leaf region (``csrc/region_dwell.cu``).

Replaces ``repro/kernels/region_dwell.py::region_dwell``. The Pallas kernel
aliases the canvas in and out, and needs a duplicate-padded OLT plus a
``nonempty`` flag. Here the canvas is updated in place, and the kernel
reads the live row count from the device. The unit of work is an item of
up to 4096 pixels, whole rows of one tile of one leaf region (the tile is
the whole region for SBR, ``tile`` x ``tile`` for MBR), one flat index
over (live row, tile, piece), and one warp owns it, by lane refill: each
lane starts on one pixel, and after every block of 16 escape steps the
lanes that finished store their dwell straight into the canvas and take
the item's next pixels. A leaf of B = 32 or 64 is one item, and keeps its
own kernel of the mapping before the cut (warp w of block b, row 4b + w).
What bounds it on the card is the issue rate of the escape loop under the
rounding contract (8 instructions a mandelbrot step, none fused;
``csrc/escape_time.cuh``). Leaves are the regions whose dwell is not
uniform, so a warp that ran one row of pixels to its slowest lane, the
mapping before refill, left about half its lanes idle; with refill a
warp's time is its item's work over 32 lanes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["region_dwell", "region_dwell_plain"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
    *_build.PLANE_ARGTYPES, ctypes.c_void_p]
_WARPS = 4  # kWarps of csrc/region_dwell.cu: one item a warp
_MAX_GRID_X = (1 << 31) - 1


def region_dwell_plain(canvas: torch.Tensor, coords: torch.Tensor,
                       count: torch.Tensor, *, side: int, n: int,
                       bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                       workload=None, plane=None) -> torch.Tensor:
    """The plain version: ``ref.region_interior_ref`` of the first
    ``count`` rows, written with one indexed write. It reads the window
    from ``bounds``; ``plane``, the card's copy of it, is not read."""
    k = int(count.reshape(()))
    tiles = ref.region_interior_ref(coords[:k], side=side, n=n, bounds=bounds,
                                    max_dwell=max_dwell, workload=workload)
    ys, xs = ref.region_index(coords[:k], side)
    canvas[ys, xs] = tiles.to(canvas.dtype)
    return canvas


def region_dwell(canvas: torch.Tensor, coords: torch.Tensor,
                 count: torch.Tensor, *, side: int, n: int,
                 bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                 scheme: str = "sbr", tile: int = 256,
                 workload=None, plane=None) -> torch.Tensor:
    """Write the interior dwell of the first ``count`` leaf regions into
    ``canvas`` in place; returns ``canvas``. Shapes as in ``region_fill``.
    A CUDA canvas launches the kernel (counted in
    ``region_dwell.launches``), which reads the window from ``plane`` as
    ``perimeter_query`` does; a CPU one takes the plain version, on
    ``bounds``."""
    t = _build.tile_of(side, scheme, tile)
    if not _build.on_card(canvas.device):
        return region_dwell_plain(canvas, coords, count, side=side, n=n,
                                  bounds=bounds, max_dwell=max_dwell,
                                  workload=workload)
    for name, x, nd in (("canvas", canvas, 2), ("coords", coords, 2),
                        ("count", count, 1)):
        _build.check(x, name, torch.int32, nd)
    N = coords.shape[0]
    if N == 0:
        return canvas
    rpi = _build.rows_per_item(t)
    blocks = -(-N * (side // t) ** 2 * -(-t // rpi) // _WARPS)
    grid_y = -(-blocks // _MAX_GRID_X)
    launch = _build.function("region_dwell", "region_dwell_launch", _ARGTYPES)
    launch(_build.ptr(canvas), _build.ptr(coords), _build.ptr(count),
           -(-blocks // grid_y), grid_y, n, side, t, rpi,
           *_build.plane_args(n, bounds, plane, max_dwell, workload,
                              canvas.device),
           _build.stream(canvas))
    region_dwell.launches += 1
    return canvas


region_dwell.launches = 0
