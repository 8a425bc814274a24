"""T on the banded cross-frame canvas (``csrc/region_fill.cu``, the
single-frame fill's kernel body on frame-tagged rows).

Replaces ``repro/kernels/region_fill_pooled.py::region_fill_pooled``. The
pooled engine renders F frames onto one [F*n, n] canvas where frame f owns
rows [f*n, (f+1)*n); row (f, cy, cx) of the worklist lands at canvas row
f*n + cy*side, column cx*side. The Pallas kernel folds the frame tag into
its BlockSpec index, aliases the canvas and needs duplicate-padded rows
plus a ``nonempty`` flag. Here the canvas is updated in place and the
kernel reads the live row count on the device. A grid of a few blocks per
SM strides over the live rows, each region cut into pieces of about 4096
pixels, so neither the ring's capacity padding nor one large region leaves
blocks idle. Offsets are 64-bit: 8 frames at n=16384 hold 2^31 pixels.
What bounds it on the card is store bandwidth, 4 * side^2 bytes per
region. SBR only, as in JAX.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.region_fill import launch_fill

__all__ = ["region_fill_pooled", "region_fill_pooled_plain"]


def _check_band(canvas: torch.Tensor, side: int, n: int) -> None:
    if n % side:
        raise ValueError(f"n={n} not divisible by side={side}")
    if canvas.ndim != 2 or canvas.shape[1] != n or canvas.shape[0] % n:
        raise ValueError(f"canvas {tuple(canvas.shape)} is not the banded "
                         f"[F*n, n] layout for n={n}")


def region_fill_pooled_plain(canvas: torch.Tensor, rows: torch.Tensor,
                             values: torch.Tensor, count: torch.Tensor, *,
                             side: int, n: int) -> torch.Tensor:
    """The plain version: one indexed write of the first ``count`` rows."""
    _check_band(canvas, side, n)
    k = int(count.reshape(()))
    ys, xs = ref.pooled_region_index(rows[:k], side, n)
    canvas[ys, xs] = values[:k, None, None].to(canvas.dtype).expand(k, side, side)
    return canvas


def region_fill_pooled(canvas: torch.Tensor, rows: torch.Tensor,
                       values: torch.Tensor, count: torch.Tensor, *, side: int,
                       n: int) -> torch.Tensor:
    """Fill ``values[i]`` into the side x side block of frame-tagged row
    ``rows[i]`` = (frame, cy, cx) for the first ``count`` rows, in place;
    returns ``canvas``.

    canvas [F*n, n] int32; rows [N, 3] int32; values [N] int32; count [1]
    int32 on the device. A CUDA canvas launches the kernel (counted in
    ``region_fill_pooled.launches``); a CPU one takes the plain version.
    """
    _check_band(canvas, side, n)
    if not _build.on_card(canvas.device):
        return region_fill_pooled_plain(canvas, rows, values, count, side=side,
                                        n=n)
    for name, x, nd in (("canvas", canvas, 2), ("rows", rows, 2),
                        ("values", values, 1), ("count", count, 1)):
        _build.check(x, name, torch.int32, nd)
    if rows.shape[0] == 0:
        return canvas
    launch_fill("region_fill_pooled_launch", canvas, rows, values, count, side,
                n)
    region_fill_pooled.launches += 1
    return canvas


region_fill_pooled.launches = 0
