"""Synthetic k-dimensional SSD fields and the k-D ASK solver (paper Sec. 7).

Counterpart of ``repro/core/ssd_synth.py``. ``generate_field`` draws a
field from exactly the stochastic process the cost model assumes
(Sec. 4.2): from a g^k grid, every region independently subdivides with
probability P into r^k children or freezes to a constant; heterogeneous
leaves at size B get per-cell values. It is a ground-truth SSD workload in
any dimension, and the one setting where Eq. (11)'s region counts
E|G_i| = G (R P)^i can be checked exactly. It runs on the host with numpy,
a copy of JAX's generator, so a seed gives the same field in both
packages.

``solve_ask_3d`` reconstructs a 3-D field with the paper's Sec. 7
machinery, the same level loop as JAX's: serial per-level passes whose OLT
holds scalar Morton codes (``core.olt.subdivide_olt_scalar``, compacted
through the scan kernel on the card) and face queries (a frozen region is
constant, so six uniform faces mean a uniform region, by construction of
the generator). It runs on the field's device: each level decodes its
codes, tests every live region's faces at once and writes the canvas; the
host reads the level's counts, as JAX's loop does (``int(cnt)``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import olt as olt_lib

__all__ = ["SSDField", "generate_field", "solve_ask_3d"]


@dataclasses.dataclass
class SSDField:
    field: np.ndarray  # [n]^k int32
    level_counts: List[int]  # active regions entering each level
    n: int
    g: int
    r: int
    B: int
    P: float
    k: int


def generate_field(seed: int, *, n: int, g: int = 2, r: int = 2, B: int = 4,
                   P: float = 0.6, k: int = 3) -> SSDField:
    rng = np.random.default_rng(seed)
    field = np.zeros((n,) * k, dtype=np.int32)
    # regions as (origin tuple, side); values distinct per frozen region
    regions = [(tuple(int(x) * (n // g) for x in idx), n // g)
               for idx in np.ndindex(*(g,) * k)]
    counts = []
    next_val = 1
    while regions:
        counts.append(len(regions))
        nxt = []
        for origin, s in regions:
            if s > B and rng.random() < P:
                c = s // r
                for off in np.ndindex(*(r,) * k):
                    nxt.append((tuple(o + int(d) * c
                                      for o, d in zip(origin, off)), c))
            else:
                sl = tuple(slice(o, o + s) for o in origin)
                if s > B:
                    field[sl] = next_val  # frozen constant region
                    next_val += 1
                else:
                    # heterogeneous leaf: per-cell values
                    field[sl] = rng.integers(
                        1 << 16, 1 << 20, size=(s,) * k)
        regions = nxt
    return SSDField(field, counts, n, g, r, B, P, k)


def _morton_roots(g: int, device="cpu") -> torch.Tensor:
    """Morton codes (uint32) of the g^3 level-0 regions (g a power of two)."""
    coords = torch.tensor(list(np.ndindex(g, g, g)), dtype=torch.int32,
                          device=device)
    return olt_lib.morton_encode3d(coords)


def _blocks(x: torch.Tensor, side: int) -> torch.Tensor:
    """[n, n, n] -> a view [m, m, m, side, side, side] of its side^3 blocks
    (block (z, y, x) at x[z*side:, y*side:, x*side:])."""
    m = x.shape[0] // side
    return x.view(m, side, m, side, m, side).permute(0, 2, 4, 1, 3, 5)


def solve_ask_3d(fld: SSDField, *, device="cuda") -> Tuple[torch.Tensor, List[int]]:
    """Reconstruct ``fld.field`` by level-serial ASK with a scalar-Morton
    OLT, on ``device``. Returns (canvas [n, n, n] int32 on the device,
    per-level live-region counts)."""
    assert fld.k == 3, "the solver is 3-D (the OLT machinery is k-D)"
    n, g, r, B = fld.n, fld.g, fld.r, fld.B
    field = torch.from_numpy(fld.field).to(device)
    canvas = torch.full_like(field, -1)
    codes = _morton_roots(g, field.device)
    count = codes.shape[0]
    side = n // g
    counts = []
    while count > 0:
        counts.append(count)
        z, y, x = olt_lib.morton_decode3d(codes[:count]).long().unbind(-1)
        reg = _blocks(field, side)[z, y, x]  # [count, side, side, side]
        v0 = reg[:, 0, 0, 0]
        at = v0[:, None, None]
        # face query: the 6 faces (Sec. 7 Q)
        uniform = ((reg[:, 0] == at).flatten(1).all(1)
                   & (reg[:, -1] == at).flatten(1).all(1)
                   & (reg[:, :, 0] == at).flatten(1).all(1)
                   & (reg[:, :, -1] == at).flatten(1).all(1)
                   & (reg[:, :, :, 0] == at).flatten(1).all(1)
                   & (reg[:, :, :, -1] == at).flatten(1).all(1))
        out = _blocks(canvas, side)
        # terminal work T on the uniform regions, leaf work A at the last
        # level on the others; the rest subdivide
        fill = torch.where(uniform[:, None, None, None], v0[:, None, None, None],
                           reg)
        write = uniform | (side <= B)
        out[z[write], y[write], x[write]] = fill[write]
        if side <= B:
            break
        flags = ~uniform
        cap = olt_lib.next_pow2(max(int(flags.sum()), 1) * r ** 3)
        codes, cnt = olt_lib.subdivide_olt_scalar(codes[:count], flags, k=3,
                                                  capacity=cap)
        count = int(cnt)
        side //= r
    return canvas, counts
