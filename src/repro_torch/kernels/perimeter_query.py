"""Q: the Mariani-Silver border query (``csrc/perimeter_query.cu``).

Replaces ``repro/kernels/perimeter_query.py::perimeter_query``, one Pallas
grid step per region with the coords in scalar prefetch. On the card it
is one block per region; the block loads its own coords, its threads
stride over the 4 * side border points and the block decides with
``__syncthreads_and``. What bounds it there is the issue rate of the
escape loop under the rounding contract (8 instructions a mandelbrot step,
none fused; ``csrc/escape_time.cuh``), since each region reads 8 bytes and
writes 5; each border point runs the loop in blocks of 8 steps. The four
corners are computed twice (4 of the 4 * side points), as in the plain
version's order, and only the two results leave the SM. Given the live
row count on the device, blocks past it write (False, 0) and return, so
the power-of-two padding of an OLT costs no escape loop (where JAX's
kernel computes every padded row again).

``perimeter_query_pooled`` is the same query for the pooled engine's
frame-tagged rows (frame, cy, cx), each in its own frame's plane
(``planes`` [F, 4], ``ref.pooled_planes``). JAX computes it with jnp
(``ref.perimeter_query_dyn`` through ``ops.pooled_bounds``), in no Pallas
kernel; the port's plain version emulates each FMA in f64, which is no
way to run the card's main path, so the query has a kernel here. A grid of
a few blocks per SM strides over the live rows, and the rows past the
count stay (False, 0) with no block launched for them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["perimeter_query", "perimeter_query_plain",
           "perimeter_query_pooled", "perimeter_query_pooled_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             *_build.POINT_ARGTYPES, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def perimeter_query_plain(coords: torch.Tensor, count: torch.Tensor, *,
                          side: int, n: int, bounds=ref.DEFAULT_BOUNDS,
                          max_dwell: int = 512, workload=None):
    """The plain version: ``ref.perimeter_query_ref`` on the first
    ``count`` rows; the rows past it are (False, 0)."""
    N = coords.shape[0]
    k = int(count.reshape(()))
    homog = torch.zeros((N,), dtype=torch.bool, device=coords.device)
    common = torch.zeros((N,), dtype=torch.int32, device=coords.device)
    homog[:k], common[:k] = ref.perimeter_query_ref(
        coords[:k], side=side, n=n, bounds=bounds, max_dwell=max_dwell,
        workload=workload)
    return homog, common


def perimeter_query(coords: torch.Tensor, count: torch.Tensor, *, side: int,
                    n: int, bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                    workload=None):
    """coords: [N, 2] int32 (cy, cx); count: [1] int32 on the device, the
    live rows (JAX's kernel takes no count and answers for every row).
    Returns (homog [N] bool, common [N] int32); the rows past ``count`` are
    (False, 0) and cost no escape loop. A CUDA ``coords`` launches the
    kernel (counted in ``perimeter_query.launches``); a CPU one takes the
    plain version."""
    if not _build.on_card(coords.device):
        return perimeter_query_plain(coords, count, side=side, n=n,
                                     bounds=bounds, max_dwell=max_dwell,
                                     workload=workload)
    _build.check(coords, "coords", torch.int32, 2)
    _build.check(count, "count", torch.int32, 1)
    N = coords.shape[0]
    homog = torch.empty((N,), dtype=torch.bool, device=coords.device)
    common = torch.empty((N,), dtype=torch.int32, device=coords.device)
    if N == 0:
        return homog, common
    launch = _build.function("perimeter_query", "perimeter_query_launch",
                             _ARGTYPES)
    launch(_build.ptr(coords), _build.ptr(count), N, side,
           *_build.point_args(n, bounds, max_dwell, workload),
           _build.ptr(homog), _build.ptr(common), _build.stream(coords))
    perimeter_query.launches += 1
    return homog, common


perimeter_query.launches = 0


_POOLED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
    *_build.WORKLOAD_ARGTYPES, *[ctypes.c_void_p] * 3]


def perimeter_query_pooled_plain(rows: torch.Tensor, count: torch.Tensor,
                                 planes: torch.Tensor, *, side: int,
                                 max_dwell: int = 512, workload=None):
    """The plain version: ``ref.perimeter_query_pooled_ref`` on the first
    ``count`` rows; the rows past it are (False, 0)."""
    N = rows.shape[0]
    k = int(count.reshape(()))
    homog = torch.zeros((N,), dtype=torch.bool, device=rows.device)
    common = torch.zeros((N,), dtype=torch.int32, device=rows.device)
    homog[:k], common[:k] = ref.perimeter_query_pooled_ref(
        rows[:k], planes, side=side, max_dwell=max_dwell, workload=workload)
    return homog, common


def perimeter_query_pooled(rows: torch.Tensor, count: torch.Tensor,
                           planes: torch.Tensor, *, side: int,
                           max_dwell: int = 512, workload=None):
    """rows: [N, 3] int32 (frame, cy, cx); count: [1] int32 on the device;
    planes: [F, 4] f32. Returns (homog [N] bool, common [N] int32), the rows
    past ``count`` (False, 0). A CUDA ``rows`` launches the kernel (counted
    in ``perimeter_query_pooled.launches``); a CPU one takes the plain
    version."""
    if not _build.on_card(rows.device):
        return perimeter_query_pooled_plain(rows, count, planes, side=side,
                                            max_dwell=max_dwell,
                                            workload=workload)
    _build.check(rows, "rows", torch.int32, 2)
    _build.check(count, "count", torch.int32, 1)
    _build.check(planes, "planes", torch.float32, 2)
    N = rows.shape[0]
    homog = torch.zeros((N,), dtype=torch.bool, device=rows.device)
    common = torch.zeros((N,), dtype=torch.int32, device=rows.device)
    if N == 0:
        return homog, common
    threads = min(512, -(-4 * side // 32) * 32)  # as threads_for in the .cu
    launch = _build.function("perimeter_query", "perimeter_query_pooled_launch",
                             _POOLED_ARGTYPES)
    launch(_build.ptr(rows), _build.ptr(count), _build.ptr(planes),
           _build.grid_for(rows.device, N, threads), side,
           *_build.workload_args(max_dwell, workload), _build.ptr(homog),
           _build.ptr(common), _build.stream(rows))
    perimeter_query_pooled.launches += 1
    return homog, common


perimeter_query_pooled.launches = 0
