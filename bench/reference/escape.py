"""The escape-time arithmetic of the rendered workloads, in plain PyTorch.

A frozen copy of the rounding contract that the renderer states for its
kernels (every operation rounded to f32 on its own, except the FMAs it
places by hand):

* the pixel -> plane map: ``cr = fma(x, step_re, re0)``,
  ``ci = fma(y, step_im, im0)``;
* the escape test ``zr*zr + zi*zi < 4``, every operation rounded;
* z starts at the pixel's point; each workload (a kind, found by its name
  as ``bench/reference/kinds/<kind>.py``) states its step, the addend it
  takes and its flops a step;
* the dwell is the number of steps taken while ``|z|^2 < 4``, at most
  ``max_dwell``.

The window has two spellings. ``static``: the step ``(re1 - re0) / n`` in
double, rounded to f32 (a window passed as Python floats). ``traced``:
``f32(re1 - re0) * f32(1 / n)``, every operation in f32 (windows passed as
an array, as a batch or a stream of frames is).

``variant`` names a control, the same arithmetic done below the contract,
which the check has to refuse: ``bf16`` rounds every value to bfloat16
(the next precision below f32); ``fmad`` lets the compiler contract the
products into FMAs where the contract rounds them on their own
(``nvcc -fmad=true``).

This module imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.yardstick import named

VARIANTS = ("f32", "bf16", "fmad")

# steps between compactions of the still-running points
_CHUNK = 16


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a * b + c``: the f64 product of two f32
    values is exact, the f64 sum is rounded to odd (TwoSum gives its
    error; an inexact sum with an even last bit moves one ulp toward the
    exact value), so the last rounding to f32 is the correct one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = s.new_full((), float("inf"))
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def arithmetic(name: str):
    """The module ``kinds/<name>.py``: a workload's escape arithmetic.

    It holds ``STEP_FLOPS`` (f32 flops of one step, an FMA counting 2),
    ``addend(cr, ci, params)`` (the f32 addend of each point's step, from
    its pixel's point and the configuration's constants), ``step(zr, zi,
    ar, ai, variant)`` (the escape test of z and its update), and the same
    in f64 NumPy for the traffic's coarse render, ``coarse_addend(z,
    params)`` and ``coarse_step(z, k)``."""
    return named.load("reference/kinds", name)


def plane(n: int, bounds: Sequence[float], spelling: str) -> Tuple[float, ...]:
    """``(re0, im0, step_re, step_im)`` as exact f32 values."""
    re0, im0, re1, im1 = (float(v) for v in bounds)
    f32 = np.float32
    if spelling == "static":
        return (float(f32(re0)), float(f32(im0)), float(f32((re1 - re0) / n)),
                float(f32((im1 - im0) / n)))
    if spelling == "traced":
        b = np.asarray([re0, im0, re1, im1], dtype=np.float32)
        inv = f32(1.0 / n)
        return (float(b[0]), float(b[1]), float((b[2] - b[0]) * inv),
                float((b[3] - b[1]) * inv))
    raise ValueError(f"unknown window spelling {spelling!r}")


def _fma_bf16(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``a * b + c`` of bfloat16 values, rounded once to bfloat16."""
    return (a.float() * b.float() + c.float()).bfloat16()


def map_points(ys: torch.Tensor, xs: torch.Tensor, plane_,
               variant: str = "f32") -> tuple:
    """f32 pixel positions -> (cr, ci) under the contract; the plane's
    entries are floats or tensors that broadcast against the positions."""
    re0, im0, sr, si = (torch.as_tensor(v, dtype=torch.float32,
                                        device=xs.device) for v in plane_)
    if variant == "bf16":
        b = [t.bfloat16() for t in (xs, ys, re0, im0, sr, si)]
        return _fma_bf16(b[0], b[4], b[2]), _fma_bf16(b[1], b[5], b[3])
    return fma(xs, sr, re0), fma(ys, si, im0)


def quadratic_step(zr, zi, ar, ai, variant: str):
    """(inside, zr', zi') of one step of z -> z^2 + a: the escape test of
    z and ``zr' = (zr*zr - zi*zi) + ar``, ``zi' = fma(2*zr, zi, ai)``."""
    if variant == "fmad":
        zi2 = zi * zi
        return (fma(zr, zr, zi2) < 4.0, fma(zr, zr, -zi2) + ar,
                fma(2.0 * zr, zi, ai))
    zr2, zi2 = zr * zr, zi * zi
    nxt = _fma_bf16 if variant == "bf16" else fma
    return (zr2 + zi2) < 4.0, (zr2 - zi2) + ar, nxt(2.0 * zr, zi, ai)


def dwell(cr: torch.Tensor, ci: torch.Tensor, max_dwell: int, kind: str,
          params: Optional[Mapping] = None,
          variant: str = "f32") -> torch.Tensor:
    """The dwell of each point of the 1-D f32 tensors ``cr``, ``ci``.

    Every ``_CHUNK`` steps the points that escaped are dropped, so the
    work follows the sum of the dwells. An escaped point's z runs on
    unmasked until the next drop; ``alive`` is sticky, so it adds no step.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    arith = arithmetic(kind)
    dev = cr.device
    out = torch.zeros(cr.shape, dtype=torch.int32, device=dev)
    idx = torch.arange(cr.numel(), device=dev)
    zr, zi = cr, ci
    ar, ai = arith.addend(cr, ci, params or {})
    if variant == "bf16":
        ar, ai = ar.bfloat16(), ai.bfloat16()
    done = 0
    while done < max_dwell and idx.numel():
        k = min(_CHUNK, max_dwell - done)
        alive = torch.ones(idx.shape, dtype=torch.bool, device=dev)
        count = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
        for _ in range(k):
            inside, zr, zi = arith.step(zr, zi, ar, ai, variant)
            alive &= inside
            count += alive
        out[idx] += count
        done += k
        keep = alive.nonzero().squeeze(1)
        idx, zr, zi, ar, ai = idx[keep], zr[keep], zi[keep], ar[keep], ai[keep]
    return out
