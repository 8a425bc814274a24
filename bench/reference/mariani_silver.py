"""Mariani-Silver subdivision of one frame, in plain PyTorch: what the
renderer's canvas has to hold, worked out independently of it.

The semantics (paper Sec. 6, the engines' contract): the n x n canvas is
cut into g x g regions. At each level every live region of side s has
its border evaluated (top row, bottom row, left column, right column,
4 x s points). When every border dwell equals the dwell of its top-left
point the whole s x s block is filled with that value; otherwise the
region splits into r x r children, which are the next level's live
regions. Levels run while the side is above B; every region still live
at side <= B has each of its pixels computed (the leaves).

Regions are processed in blocks of at most ``points`` border or leaf
points, so the reference fits beside the program's state at n = 16384.
This module imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bench.reference import escape


def levels(n: int, g: int, r: int, B: int) -> int:
    """Exploration levels: subdivide while the side is above B."""
    count, side = 0, n // g
    while side > B:
        count, side = count + 1, side // r
    return count


def _border(coords: torch.Tensor, side: int):
    """f32 (ys, xs) [N, 4, side] of each region's border: top, bottom,
    left, right (corners twice)."""
    j = torch.arange(side, device=coords.device, dtype=torch.float32)
    y0 = (coords[:, 0] * side).float()[:, None]
    x0 = (coords[:, 1] * side).float()[:, None]
    last = float(side - 1)
    n_ = coords.shape[0]
    ys = torch.stack([y0.expand(n_, side), (y0 + last).expand(n_, side),
                      y0 + j, y0 + j], dim=1)
    xs = torch.stack([x0 + j, x0 + j, x0.expand(n_, side),
                      (x0 + last).expand(n_, side)], dim=1)
    return ys, xs


def _blocks(view: torch.Tensor, side: int) -> torch.Tensor:
    """The [R, R, side, side] view of an n x n canvas cut into blocks."""
    R = view.shape[0] // side
    return view.view(R, side, R, side).permute(0, 2, 1, 3)


def render(n: int, g: int, r: int, B: int, max_dwell: int, kind: str,
           bounds: Sequence[float], spelling: str, *, params=None,
           device="cpu", points: int = 1 << 24,
           variant: str = "f32") -> torch.Tensor:
    """The [n, n] int32 canvas of one frame. ``params``: the kind's
    constants (the configuration); ``variant``: a control of ``escape``."""
    plane = escape.plane(n, bounds, spelling)
    canvas = torch.zeros((n, n), dtype=torch.int32, device=device)
    gy, gx = torch.meshgrid(torch.arange(g, device=device),
                            torch.arange(g, device=device), indexing="ij")
    live = torch.stack([gy.reshape(-1), gx.reshape(-1)], 1)
    side = n // g
    for _ in range(levels(n, g, r, B)):
        per = max(1, points // (4 * side))
        split = []
        for lo in range(0, live.shape[0], per):
            coords = live[lo:lo + per]
            ys, xs = _border(coords, side)
            cr, ci = escape.map_points(ys.reshape(-1), xs.reshape(-1), plane,
                                       variant)
            d = escape.dwell(cr, ci, max_dwell, kind, params, variant) \
                .view(-1, 4 * side)
            homog = (d == d[:, :1]).all(1)
            fill = coords[homog]
            _blocks(canvas, side)[fill[:, 0], fill[:, 1]] = \
                d[homog, 0][:, None, None].expand(-1, side, side)
            split.append(coords[~homog])
        parents = torch.cat(split) if split else live[:0]
        off = torch.arange(r, device=device)
        oy, ox = torch.meshgrid(off, off, indexing="ij")
        live = (parents[:, None, :] * r + torch.stack(
            [oy.reshape(-1), ox.reshape(-1)], 1)[None]).reshape(-1, 2)
        side //= r
    per = max(1, points // (side * side))
    j = torch.arange(side, device=device, dtype=torch.float32)
    for lo in range(0, live.shape[0], per):
        coords = live[lo:lo + per]
        ys = ((coords[:, 0] * side).float()[:, None, None]
              + j[None, :, None]).expand(-1, side, side)
        xs = ((coords[:, 1] * side).float()[:, None, None]
              + j[None, None, :]).expand(-1, side, side)
        cr, ci = escape.map_points(ys.reshape(-1), xs.reshape(-1), plane,
                                   variant)
        d = escape.dwell(cr, ci, max_dwell, kind, params, variant) \
            .view(-1, side, side)
        _blocks(canvas, side)[coords[:, 0], coords[:, 1]] = d
    return canvas


def points(n: int, max_dwell: int, kind: str, windows, spelling: str,
           ys: torch.Tensor, xs: torch.Tensor, *, params=None,
           device="cpu") -> torch.Tensor:
    """[F, K] dwells of the pixels (ys, xs) [K] of each of F frames'
    windows. On a pixel of a level-0 region's border (every region is
    queried there) the canvas holds exactly this dwell."""
    planes = torch.tensor([escape.plane(n, w, spelling) for w in windows],
                          dtype=torch.float32, device=device)
    re0, im0, sr, si = (planes[:, k:k + 1] for k in range(4))
    yf = ys.to(device, torch.float32)[None, :].expand(len(windows), -1)
    xf = xs.to(device, torch.float32)[None, :].expand(len(windows), -1)
    cr, ci = escape.map_points(yf, xf, (re0, im0, sr, si))
    return escape.dwell(cr.reshape(-1), ci.reshape(-1), max_dwell, kind,
                        params).view(len(windows), -1)
