"""Q: the Mariani-Silver border query (``csrc/perimeter_query.cu``).

Replaces ``repro/kernels/perimeter_query.py::perimeter_query``, one Pallas
grid step per region with the coords in scalar prefetch. For each live row
it answers whether all 4 * side border dwells (the four corners twice, in
the plain version's order) equal f, the dwell of the region's (0, 0)
pixel, and f itself; the rows past the live count (read on the device) are
(False, 0).

What bounds it on the card is the issue rate of the escape loop under the
rounding contract (8 instructions a mandelbrot step, none fused;
``csrc/escape_time.cuh``), and the answer needs far fewer steps than the
whole border: a border that differs needs only f and one witness of the
mismatch. So the kernel spreads border points, not regions, over the card:
one grid of resident 8-warp blocks takes items (runs of one region's
border points: the first 32 to 128, sized on the device from the live
count, then 32 at a time) from 32 queues on the device, each warp runs its
item by the leaf kernels' lane refill (``repro::refill``) in blocks of 16
steps, and each region keeps the smallest finished dwell of its border in
scratch. A warp that can prove a mismatch answers False and flags the
region; then its running points stop and the points not yet handed out
are dropped. Point (0, 0) always runs to its dwell. The launch zeroes the scratch and presets the answers to True
with two ``cudaMemsetAsync`` on the stream: one kernel launch a query, no
host sync. The scratch's size comes from the library
(``perimeter_query_scratch_words``), which lays it out.

``perimeter_query_pooled`` is the same query for the pooled engine's
frame-tagged rows (frame, cy, cx), each in its own frame's plane
(``planes`` [F, 4], ``ref.pooled_planes``). JAX computes it with jnp
(``ref.perimeter_query_dyn`` through ``ops.pooled_bounds``), in no Pallas
kernel; the port's plain version emulates each FMA in f64, which is no
way to run the card's main path, so the query has a kernel here: the same
device code, with each row's plane gathered by its frame tag.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["perimeter_query", "perimeter_query_plain",
           "perimeter_query_pooled", "perimeter_query_pooled_plain"]

# both launch functions end in (scratch, homog, common, stream)
_OUTPUT_ARGTYPES = [ctypes.c_void_p] * 4
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             *_build.PLANE_ARGTYPES, *_OUTPUT_ARGTYPES]
_POOLED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
    *_build.WORKLOAD_ARGTYPES, *_OUTPUT_ARGTYPES]


def _scratch_words(N: int) -> int:
    """Ints of scratch the kernel needs for N rows, as the .cu lays it out
    (``perimeter_query_scratch_words``)."""
    return _build.function("perimeter_query", "perimeter_query_scratch_words",
                           [ctypes.c_int], ctypes.c_longlong)(N)


def _launch(wrapper, rows: torch.Tensor, launch):
    """Allocate the outputs and the kernel's scratch (the launch zeroes it
    on the stream), call ``launch(scratch, homog, common, stream)`` and
    count it on ``wrapper.launches``. No launch for zero rows."""
    N = rows.shape[0]
    homog = torch.empty((N,), dtype=torch.bool, device=rows.device)
    common = torch.empty((N,), dtype=torch.int32, device=rows.device)
    if N == 0:
        return homog, common
    scratch = torch.empty((_scratch_words(N),), dtype=torch.int32,
                          device=rows.device)
    launch(_build.ptr(scratch), _build.ptr(homog), _build.ptr(common),
           _build.stream(rows))
    wrapper.launches += 1
    return homog, common


def perimeter_query_plain(coords: torch.Tensor, count: torch.Tensor, *,
                          side: int, n: int, bounds=ref.DEFAULT_BOUNDS,
                          max_dwell: int = 512, workload=None, plane=None):
    """The plain version: ``ref.perimeter_query_ref`` on the first
    ``count`` rows; the rows past it are (False, 0). It reads the window
    from ``bounds``; ``plane``, the card's copy of it, is not read."""
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
                    workload=None, plane=None):
    """coords: [N, 2] int32 (cy, cx); count: [1] int32 on the device, the
    live rows (JAX's kernel takes no count and answers for every row).
    Returns (homog [N] bool, common [N] int32); the rows past ``count`` are
    (False, 0) and cost no escape loop. A CUDA ``coords`` launches the
    kernel (counted in ``perimeter_query.launches``), which reads the
    window from ``plane``, a [4] f32 tensor on the card holding
    ``ref.plane(n, bounds)`` (by default ``_build.plane_tensor``'s); a CPU
    one takes the plain version, on ``bounds``."""
    if not _build.on_card(coords.device):
        return perimeter_query_plain(coords, count, side=side, n=n,
                                     bounds=bounds, max_dwell=max_dwell,
                                     workload=workload)
    _build.check(coords, "coords", torch.int32, 2)
    _build.check(count, "count", torch.int32, 1)
    launch = _build.function("perimeter_query", "perimeter_query_launch",
                             _ARGTYPES)
    return _launch(perimeter_query, coords, lambda *out: launch(
        _build.ptr(coords), _build.ptr(count), coords.shape[0], side,
        *_build.plane_args(n, bounds, plane, max_dwell, workload,
                           coords.device), *out))


perimeter_query.launches = 0


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
    launch = _build.function("perimeter_query", "perimeter_query_pooled_launch",
                             _POOLED_ARGTYPES)
    return _launch(perimeter_query_pooled, rows, lambda *out: launch(
        _build.ptr(rows), _build.ptr(count), _build.ptr(planes), rows.shape[0],
        side, *_build.workload_args(max_dwell, workload), *out))


perimeter_query_pooled.launches = 0
