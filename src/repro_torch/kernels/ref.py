"""Plain PyTorch versions of every kernel of the port's main path.

Counterpart of ``repro/kernels/ref.py``. These functions are the CPU path
of every wrapper in ``kernels/ops.py`` and the reference that each CUDA
kernel is held against on the card.

Numeric contract (the one every kernel in ``csrc/`` follows too). The JAX
package rounds as XLA:CPU compiles it: LLVM contracts an f32 multiply into
the add or subtract that uses it (one FMA, one rounding) when the product
has exactly one use, and folds the first operand's product when both
operands qualify. Products shared with the escape test (``zr*zr``,
``zi*zi``) therefore round on their own. Spelled out per operation:

* ``map_coords``: ``cr = fma(x, step_re, re0)`` and ``ci = fma(y, step_im,
  im0)``;
* escape test: ``zr*zr + zi*zi < 4``, every operation rounded;
* mandelbrot, julia, burning_ship: the real update ``(zr*zr - zi*zi) + c``
  is rounded operation by operation; the imaginary update is
  ``fma(2*zr, zi, c_im)`` (``2*|zr|``, ``|zi|`` for burning_ship);
* multibrot: XLA merges ``zr*zi`` and ``zi*zr`` into one product ``x``,
  so the first factor is ``(zr*zr - zi*zi, x + x)``; each further factor
  is ``(fma(wr, zr, -(wi*zi)), fma(wr, zi, wi*zr))``; ``+ c`` is rounded
  on its own. Verified for m=3 (the registered default).

On the CPU an FMA is computed exactly (``fma`` below): the f64 product of
two f32 values is exact, the f64 sum is rounded to odd, and the final
rounding to f32 is then correct. The CUDA kernels use ``__fmaf_rn``, so
the two agree bit for bit.

Bounds have two spellings (``plane``): a tuple of Python floats computes
the step in double and rounds it to f32; a [4] f32 tensor is the traced
spelling, and computes it in f32 as XLA:CPU compiles a division by the
constant n: ``f32(re1 - re0) * f32(1/n)``, the reciprocal rounded once.
The pooled engine's per-frame windows (``pooled_planes``) use the traced
spelling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["DEFAULT_BOUNDS", "KINDS", "fma", "plane", "map_coords",
           "mandelbrot_step", "step_of", "escape_time", "dwell_compute",
           "mandelbrot_ref", "perimeter_coords", "perimeter_query_dyn",
           "perimeter_query_ref",
           "region_index", "region_interior_dyn", "region_interior_ref",
           "pooled_planes", "map_plane", "row_planes", "pooled_region_index",
           "perimeter_query_pooled_ref", "region_interior_pooled_ref",
           "compact_ranks_ref", "batched_ranks"]

# Complex-plane window of the paper's benchmark: bottom-left (-1.5, -1),
# top-right (0.5, 1).
DEFAULT_BOUNDS: Tuple[float, float, float, float] = (-1.5, -1.0, 0.5, 1.0)

# Workload kinds: the escape_time<Kind> instances of csrc/escape_time.cuh.
# One id picks both the plain step (``step_of``) and the CUDA spelling.
KINDS = {"mandelbrot": 0, "julia": 1, "burning_ship": 2, "multibrot": 3}

# escape loops check for a finished set every this many steps (one host
# sync on the card); the result does not depend on it
_EXIT_CHECK = 16


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded f32 ``a * b + c`` (one rounding), on any device.

    The f64 product of two f32 values is exact. The f64 sum is rounded to
    odd (TwoSum gives its error; an inexact sum with an even last bit is
    moved one ulp toward the exact value), which makes the final f64 -> f32
    rounding the correct one (53 >= 24 + 2 bits).
    """
    a = torch.as_tensor(a, dtype=torch.float32)
    p = a.double() * torch.as_tensor(b, dtype=torch.float32,
                                     device=a.device).double()
    cd = torch.as_tensor(c, dtype=torch.float32, device=a.device).double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.tensor(float("inf"), dtype=s.dtype,
                                               device=s.device),
                         torch.tensor(float("-inf"), dtype=s.dtype,
                                      device=s.device))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _f32(x) -> float:
    return float(np.float32(x))


def pooled_planes(n: int, bounds_all) -> np.ndarray:
    """The [F, 4] f32 planes ``(re0, im0, step_re, step_im)`` of F frames
    from their [F, 4] bounds ``(re0, im0, re1, im1)``, in the traced
    spelling: ``step = f32(re1 - re0) * f32(1/n)``, every operation in f32.
    Computed once per batch on the host; the counterpart of JAX's
    ``ops.pooled_bounds``, whose per-row windows XLA divides the same way.
    """
    b = np.asarray(bounds_all, dtype=np.float32)
    if b.ndim != 2 or b.shape[1] != 4:
        raise ValueError(f"bounds must be [F, 4], got {b.shape}")
    inv = np.float32(1.0 / n)
    out = np.empty_like(b)
    out[:, 0], out[:, 1] = b[:, 0], b[:, 1]
    out[:, 2] = (b[:, 2] - b[:, 0]) * inv
    out[:, 3] = (b[:, 3] - b[:, 1]) * inv
    return out


def plane(n: int, bounds=DEFAULT_BOUNDS) -> Tuple[float, float, float, float]:
    """``(re0, im0, step_re, step_im)``, each an exact f32 value.

    A tuple of floats is the static spelling: the step ``(re1 - re0) / n``
    is computed in Python double and rounded to f32, as JAX does for a
    static bounds tuple. A tensor is the traced spelling of
    ``pooled_planes`` (a CUDA tensor is read back to the host here).
    """
    if isinstance(bounds, torch.Tensor):
        b = bounds.detach().to("cpu", torch.float32).numpy().reshape(1, 4)
        return tuple(float(v) for v in pooled_planes(n, b)[0])
    re0, im0, re1, im1 = (float(v) for v in bounds)
    return _f32(re0), _f32(im0), _f32((re1 - re0) / n), _f32((im1 - im0) / n)


def map_plane(xs: torch.Tensor, ys: torch.Tensor, plane_):
    """Pixel (x, y) -> workload-plane (re, im) for one plane
    ``(re0, im0, step_re, step_im)``, whose entries are floats or tensors
    that broadcast against xs/ys (one window per row)."""
    re0, im0, step_re, step_im = plane_
    return fma(xs, step_re, re0), fma(ys, step_im, im0)


def map_coords(xs: torch.Tensor, ys: torch.Tensor, n: int,
               bounds=DEFAULT_BOUNDS):
    """Pixel (x, y) -> workload-plane (re, im). xs/ys are f32 pixel indices."""
    return map_plane(xs, ys, plane(n, bounds))


def row_planes(planes: torch.Tensor, rows: torch.Tensor, ndim: int):
    """Each frame-tagged row's window: ``planes`` [F, 4] gathered by the
    frame tag ``rows[:, 0]``, as four [N, 1, ...] tensors with ``ndim``
    trailing unit dims (they broadcast against per-row pixel planes)."""
    p = planes[rows[:, 0].long()]
    shape = (rows.shape[0],) + (1,) * ndim
    return tuple(p[:, k].reshape(shape) for k in range(4))


def mandelbrot_step(zr, zi, cr, ci):
    """One z -> z^2 + c step under the contract above."""
    return (zr * zr - zi * zi) + cr, fma(2.0 * zr, zi, ci)


def step_of(kind: int, params: Tuple[float, float, int] = (0.0, 0.0, 0)):
    """The plain step ``(zr, zi, cr, ci) -> (zr', zi')`` of
    ``escape_time<kind>`` with its run-time ``params`` = (c_re, c_im, m):
    julia's constant (exact f32 values) and multibrot's power."""
    c_re, c_im, m = params
    if kind == KINDS["mandelbrot"]:
        return mandelbrot_step
    if kind == KINDS["julia"]:
        def julia_step(zr, zi, cr, ci):
            return (zr * zr - zi * zi) + c_re, fma(2.0 * zr, zi, c_im)
        return julia_step
    if kind == KINDS["burning_ship"]:
        def burning_ship_step(zr, zi, cr, ci):
            return (zr * zr - zi * zi) + cr, fma(2.0 * zr.abs(), zi.abs(), ci)
        return burning_ship_step
    if kind == KINDS["multibrot"]:
        def multibrot_step(zr, zi, cr, ci):
            x = zr * zi
            wr, wi = zr * zr - zi * zi, x + x
            for _ in range(m - 2):
                wr, wi = fma(wr, zr, -(wi * zi)), fma(wr, zi, wi * zr)
            return wr + cr, wi + ci
        return multibrot_step
    raise ValueError(f"unknown workload kind {kind}")


def escape_time(cr: torch.Tensor, ci: torch.Tensor, max_dwell: int, *,
                step=mandelbrot_step, unroll: int = 1) -> torch.Tensor:
    """Escape-time iteration with masked updates from z0 = c: the dwell of
    each point is the number of steps taken while ``|z|^2 < 4``, capped at
    ``max_dwell``. An escaped point keeps its z, so it stays escaped and
    the loop may stop once every point has escaped. ``unroll`` is accepted
    for signature parity with the JAX package; it never changes a result.
    """
    del unroll
    zr, zi = cr, ci
    dw = torch.zeros(cr.shape, dtype=torch.int32, device=cr.device)
    for it in range(max_dwell):
        active = (zr * zr + zi * zi) < 4.0
        if it % _EXIT_CHECK == 0 and not bool(active.any()):
            break
        nzr, nzi = step(zr, zi, cr, ci)
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        dw += active.to(torch.int32)
    return dw


def dwell_compute(cr: torch.Tensor, ci: torch.Tensor, max_dwell: int, *,
                  workload=None, unroll: int = 1) -> torch.Tensor:
    """Per-point values at the mapped plane coordinates. ``workload`` is a
    ``repro_torch.workloads.WorkloadSpec`` (only ``.values`` is called);
    None is the classic Mandelbrot iteration."""
    if workload is None:
        return escape_time(cr, ci, max_dwell, unroll=unroll)
    return workload.values(cr, ci, max_dwell, unroll=unroll)


def _arange_f32(k: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.float32, device=device)


def mandelbrot_ref(n: int, bounds=DEFAULT_BOUNDS, max_dwell: int = 512,
                   workload=None, unroll: int = 1,
                   device="cpu") -> torch.Tensor:
    """Plain version of the flat exhaustive kernel: the n x n value image."""
    ys = _arange_f32(n, device)[:, None].expand(n, n)
    xs = _arange_f32(n, device)[None, :].expand(n, n)
    cr, ci = map_coords(xs, ys, n, bounds)
    return dwell_compute(cr, ci, max_dwell, workload=workload, unroll=unroll)


def perimeter_coords(coords: torch.Tensor, side: int):
    """Pixel (y, x) positions of the 4 x side perimeter of each region.

    coords: [N, 2] int32 region coords; the region's pixel origin is
    coords * side. Returns (ys, xs), each [N, 4, side] f32. Rows: top,
    bottom, left, right (corners appear twice).
    """
    N = coords.shape[0]
    py = (coords[:, 0] * side).float()[:, None, None]
    px = (coords[:, 1] * side).float()[:, None, None]
    j = _arange_f32(side, coords.device)[None, None, :]
    row = torch.arange(4, device=coords.device)[None, :, None]
    last = float(side - 1)
    ys = torch.where(row == 0, py, torch.where(row == 1, py + last, py + j))
    xs = torch.where(row == 0, px + j,
                     torch.where(row == 1, px + j,
                                 torch.where(row == 2, px, px + last)))
    return ys.expand(N, 4, side), xs.expand(N, 4, side)


def perimeter_query_dyn(coords: torch.Tensor, *, side: int, n: int,
                        bounds=DEFAULT_BOUNDS, max_dwell: int = 512,
                        workload=None, unroll: int = 1):
    """Border query Q: (homog [N] bool, common [N] int32) -- whether all
    4*side border values equal the value at row 0, column 0, and that
    value. ``bounds`` may be a tuple or a [4] f32 tensor."""
    ys, xs = perimeter_coords(coords, side)
    cr, ci = map_coords(xs, ys, n, bounds)
    return _border_test(dwell_compute(cr, ci, max_dwell, workload=workload,
                                      unroll=unroll))


def _border_test(dw: torch.Tensor):
    """[N, 4, side] border values -> (homog, the value at row 0, column 0)."""
    first = dw[:, 0, 0]
    homog = (dw == first[:, None, None]).all(dim=2).all(dim=1)
    return homog, first


def perimeter_query_ref(coords: torch.Tensor, *, side: int, n: int,
                        bounds=DEFAULT_BOUNDS, max_dwell: int = 512,
                        workload=None, unroll: int = 1):
    """Plain version of the border query Q (paper Sec. 4.2.1)."""
    return perimeter_query_dyn(coords, side=side, n=n, bounds=bounds,
                               max_dwell=max_dwell, workload=workload,
                               unroll=unroll)


def region_index(coords: torch.Tensor, side: int):
    """Integer canvas indices (ys, xs), each [N, side, side] int64, of the
    side x side block of every region in ``coords``."""
    N = coords.shape[0]
    iy = torch.arange(side, device=coords.device)
    ys = coords[:, 0, None, None].long() * side + iy[None, :, None]
    xs = coords[:, 1, None, None].long() * side + iy[None, None, :]
    return ys.expand(N, side, side), xs.expand(N, side, side)


def region_interior_dyn(coords: torch.Tensor, *, side: int, n: int,
                        bounds=DEFAULT_BOUNDS, max_dwell: int = 512,
                        workload=None, unroll: int = 1) -> torch.Tensor:
    """Last-level work A: [N, side, side] value tiles, one per region."""
    ys, xs = _region_pixels(coords, side)
    cr, ci = map_coords(xs, ys, n, bounds)
    return dwell_compute(cr, ci, max_dwell, workload=workload, unroll=unroll)


def _region_pixels(coords: torch.Tensor, side: int):
    """f32 pixel positions (ys, xs), each [N, side, side], of every region."""
    N = coords.shape[0]
    py = (coords[:, 0] * side).float()
    px = (coords[:, 1] * side).float()
    iy = _arange_f32(side, coords.device)
    ys = (py[:, None, None] + iy[None, :, None]).expand(N, side, side)
    xs = (px[:, None, None] + iy[None, None, :]).expand(N, side, side)
    return ys, xs


def region_interior_ref(coords: torch.Tensor, *, side: int, n: int,
                        bounds=DEFAULT_BOUNDS, max_dwell: int = 512,
                        workload=None, unroll: int = 1) -> torch.Tensor:
    """Plain version of the last-level application work A."""
    return region_interior_dyn(coords, side=side, n=n, bounds=bounds,
                               max_dwell=max_dwell, workload=workload,
                               unroll=unroll)


# -- the pooled engine: frame-tagged rows (frame, cy, cx) -----------------------

def pooled_region_index(rows: torch.Tensor, side: int, n: int):
    """Integer indices (ys, xs), each [N, side, side] int64, of every
    frame-tagged region's block on the banded [F*n, n] canvas: frame f owns
    canvas rows [f*n, (f+1)*n)."""
    N = rows.shape[0]
    iy = torch.arange(side, device=rows.device)
    ys = (rows[:, 0, None, None].long() * n + rows[:, 1, None, None].long() * side
          + iy[None, :, None])
    xs = rows[:, 2, None, None].long() * side + iy[None, None, :]
    return ys.expand(N, side, side), xs.expand(N, side, side)


def perimeter_query_pooled_ref(rows: torch.Tensor, planes: torch.Tensor, *,
                               side: int, max_dwell: int = 512,
                               workload=None):
    """Border query Q of frame-tagged rows [N, 3], each in its own frame's
    plane (``planes`` [F, 4], see ``pooled_planes``): (homog [N] bool,
    common [N] int32)."""
    ys, xs = perimeter_coords(rows[:, 1:], side)
    cr, ci = map_plane(xs, ys, row_planes(planes, rows, 2))
    return _border_test(dwell_compute(cr, ci, max_dwell, workload=workload))


def region_interior_pooled_ref(rows: torch.Tensor, planes: torch.Tensor, *,
                               side: int, max_dwell: int = 512,
                               workload=None) -> torch.Tensor:
    """Last-level work A of frame-tagged rows [N, 3]: [N, side, side] value
    tiles, each in its own frame's plane."""
    ys, xs = _region_pixels(rows[:, 1:], side)
    cr, ci = map_plane(xs, ys, row_planes(planes, rows, 2))
    return dwell_compute(cr, ci, max_dwell, workload=workload)


def compact_ranks_ref(flags: torch.Tensor):
    """Exclusive scan of ``flags`` and its total: (ranks [N] int32,
    count int32 scalar)."""
    f = flags.to(torch.int32)
    inc = torch.cumsum(f, dim=0, dtype=torch.int32)
    count = inc[-1] if f.shape[0] else torch.zeros((), dtype=torch.int32,
                                                   device=f.device)
    return inc - f, count


def batched_ranks(flags: torch.Tensor):
    """Per-column exclusive scan of ``flags`` [G, N, E] along N, and each
    column's total: (ranks [G, N, E] int32, counts [G, E] int32). The plain
    version of ``csrc/moe_dispatch.cu``; for G = 1 it is
    ``repro.kernels.moe_dispatch``'s [N, E] contract."""
    f = flags.to(torch.int32)
    inc = torch.cumsum(f, dim=1, dtype=torch.int32)
    if f.shape[1] == 0:
        return inc, torch.zeros((f.shape[0], f.shape[2]), dtype=torch.int32,
                                device=f.device)
    return inc - f, inc[:, -1]
