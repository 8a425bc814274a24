"""T: fill homogeneous regions with their border's value
(``csrc/region_fill.cu``).

Replaces ``repro/kernels/region_fill.py::region_fill``. The Pallas kernel
aliases the canvas in and out, and needs a duplicate-padded OLT plus a
``nonempty`` flag; those are artifacts of its grid. Here the canvas is
updated in place, and the kernel reads the live row count from the device.
The output is the same. What bounds it on the card is store bandwidth,
4 * side^2 bytes per region. The kernel body is the pooled fill's
(``region_fill_pooled``): items of up to 4096 pixels of one region, a grid
of a few blocks per SM striding over the live items, 16-byte stores where
side and n allow. A fill writes the same pixels whatever the MBR tile, so
the tile is only checked.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["region_fill", "region_fill_plain"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_THREADS = 256  # kThreads of csrc/region_fill.cu


def region_fill_plain(canvas: torch.Tensor, coords: torch.Tensor,
                      values: torch.Tensor, count: torch.Tensor, *, side: int,
                      n: int) -> torch.Tensor:
    """The plain version: one indexed write of the first ``count`` rows."""
    k = int(count.reshape(()))
    ys, xs = ref.region_index(coords[:k], side)
    canvas[ys, xs] = values[:k, None, None].to(canvas.dtype).expand(k, side, side)
    return canvas


def launch_fill(symbol: str, canvas: torch.Tensor, rows: torch.Tensor,
                values: torch.Tensor, count: torch.Tensor, side: int,
                n: int) -> None:
    """Launch one of the fill kernels of ``csrc/region_fill.cu`` on checked
    CUDA tensors: ``region_fill_launch`` (rows [N, 2]) or
    ``region_fill_pooled_launch`` (rows [N, 3])."""
    rpi = _build.rows_per_item(side)
    grid = _build.grid_for(canvas.device, rows.shape[0] * -(-side // rpi),
                           _THREADS)
    vec4 = int(side % 4 == 0 and n % 4 == 0 and canvas.data_ptr() % 16 == 0)
    launch = _build.function("region_fill", symbol, _ARGTYPES)
    launch(_build.ptr(canvas), _build.ptr(rows), _build.ptr(values),
           _build.ptr(count), grid, n, side, rpi, vec4, _build.stream(canvas))


def region_fill(canvas: torch.Tensor, coords: torch.Tensor,
                values: torch.Tensor, count: torch.Tensor, *, side: int, n: int,
                scheme: str = "sbr", tile: int = 256) -> torch.Tensor:
    """Fill ``values[i]`` into the side x side block of ``coords[i]`` for
    the first ``count`` rows, in place; returns ``canvas``.

    canvas [n, n] int32; coords [N, 2] int32; values [N] int32; count [1]
    int32, on the device (JAX's ``nonempty`` plus duplicate padding is the
    same as count = live rows). ``scheme`` and ``tile`` are checked as JAX
    checks them. A CUDA canvas launches the kernel (counted in
    ``region_fill.launches``); a CPU one takes the plain version.
    """
    _build.tile_of(side, scheme, tile)
    if not _build.on_card(canvas.device):
        return region_fill_plain(canvas, coords, values, count, side=side, n=n)
    for name, x, dt, nd in (("canvas", canvas, torch.int32, 2),
                            ("coords", coords, torch.int32, 2),
                            ("values", values, torch.int32, 1),
                            ("count", count, torch.int32, 1)):
        _build.check(x, name, dt, nd)
    if coords.shape[0] == 0:
        return canvas
    launch_fill("region_fill_launch", canvas, coords, values, count, side, n)
    region_fill.launches += 1
    return canvas


region_fill.launches = 0
