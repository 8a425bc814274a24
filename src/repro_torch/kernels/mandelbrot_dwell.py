"""Ex: the flat exhaustive dwell kernel (``csrc/mandelbrot_dwell.cu``).

Replaces ``repro/kernels/mandelbrot_dwell.py::mandelbrot_dwell``, a Pallas
grid of 256 x 256 tiles. On the card it is one thread per pixel in 16 x 16
blocks: the paper's basic exhaustive implementation, which ASK's speedups
are quoted against, so the mapping stays. What bounds it there is the issue
rate of the escape loop under the rounding contract of ``ref.py``: no
operation may fuse into an FMA the contract does not place, so a
mandelbrot step is 8 instructions (7 arithmetic, one compare), each one
issue slot per lane, against one 4-byte store per pixel. The loop runs in
blocks of 8 steps with no per-step branch (``csrc/escape_time.cuh``); the
orbit stays in registers, and each pixel is written once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["mandelbrot_dwell", "mandelbrot_dwell_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, *_build.POINT_ARGTYPES,
             ctypes.c_void_p]


def mandelbrot_dwell_plain(n: int, *, bounds=ref.DEFAULT_BOUNDS,
                           max_dwell: int = 512, workload=None,
                           device="cpu") -> torch.Tensor:
    """The plain version: ``ref.mandelbrot_ref`` on ``device``."""
    return ref.mandelbrot_ref(n, bounds, max_dwell, workload=workload,
                              device=device)


def mandelbrot_dwell(n: int, *, bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                     workload=None, device="cuda") -> torch.Tensor:
    """The int32 [n, n] dwell image. On a CUDA device the kernel runs (and
    ``mandelbrot_dwell.launches`` counts it); on the CPU the plain version."""
    if not _build.on_card(device):
        return mandelbrot_dwell_plain(n, bounds=bounds, max_dwell=max_dwell,
                                      workload=workload)
    out = torch.empty((n, n), dtype=torch.int32, device=device)
    launch = _build.function("mandelbrot_dwell", "mandelbrot_dwell_launch",
                             _ARGTYPES)
    launch(_build.ptr(out), n, *_build.point_args(n, bounds, max_dwell, workload),
           _build.stream(out))
    mandelbrot_dwell.launches += 1
    return out


mandelbrot_dwell.launches = 0
