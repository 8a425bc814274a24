"""T: fill homogeneous regions with their border's value
(``csrc/region_fill.cu``).

Replaces ``repro/kernels/region_fill.py::region_fill``. The Pallas kernel
aliases the canvas in and out, and needs a duplicate-padded OLT plus a
``nonempty`` flag; those are artifacts of its grid. Here the canvas is
updated in place, and the kernel reads the live row count from the device:
blocks past it return at once. The output is the same. What bounds it on
the card is store bandwidth, 4 * side^2 bytes per region; each thread
stores 16 bytes (int4) along a row.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["region_fill", "region_fill_plain"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def region_fill_plain(canvas: torch.Tensor, coords: torch.Tensor,
                      values: torch.Tensor, count: torch.Tensor, *, side: int,
                      n: int) -> torch.Tensor:
    """The plain version: one indexed write of the first ``count`` rows."""
    k = int(count.reshape(()))
    ys, xs = ref.region_index(coords[:k], side)
    canvas[ys, xs] = values[:k, None, None].to(canvas.dtype).expand(k, side, side)
    return canvas


def region_fill(canvas: torch.Tensor, coords: torch.Tensor,
                values: torch.Tensor, count: torch.Tensor, *, side: int, n: int,
                scheme: str = "sbr", tile: int = 256) -> torch.Tensor:
    """Fill ``values[i]`` into the side x side block of ``coords[i]`` for
    the first ``count`` rows, in place; returns ``canvas``.

    canvas [n, n] int32; coords [N, 2] int32; values [N] int32; count [1]
    int32, on the device (JAX's ``nonempty`` plus duplicate padding is the
    same as count = live rows). A CUDA canvas launches the kernel (counted
    in ``region_fill.launches``); a CPU one takes the plain version.
    """
    t = _build.tile_of(side, scheme, tile)
    if not _build.on_card(canvas.device):
        return region_fill_plain(canvas, coords, values, count, side=side, n=n)
    for name, x, dt, nd in (("canvas", canvas, torch.int32, 2),
                            ("coords", coords, torch.int32, 2),
                            ("values", values, torch.int32, 1),
                            ("count", count, torch.int32, 1)):
        _build.check(x, name, dt, nd)
    N = coords.shape[0]
    if N == 0:
        return canvas
    vec4 = int(t % 4 == 0 and n % 4 == 0 and canvas.data_ptr() % 16 == 0)
    launch = _build.function("region_fill", "region_fill_launch", _ARGTYPES)
    launch(_build.ptr(canvas), _build.ptr(coords), _build.ptr(values),
           _build.ptr(count), N, n, side, t, vec4, _build.stream(canvas))
    region_fill.launches += 1
    return canvas


region_fill.launches = 0
