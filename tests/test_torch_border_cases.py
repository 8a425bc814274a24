"""Edge regions of the border query Q: one list for the CPU and the card.

``CASES`` is read by tests/test_torch_kernels.py, which holds the port's
Q (its plain version on the CPU) against JAX's ``perimeter_query``
(interpret mode) and ``perimeter_query_dyn`` on every case, and by
tests/test_torch_gpu.py, which holds the CUDA kernels against the plain
versions on the card. This file imports no JAX. Its own test checks that
each case's first region has the border it is named for, in both bounds
spellings (static bounds for ``perimeter_query``, ``pooled_planes`` for
the pooled query).

Most borders are made on the circle |c| = 2. Every workload starts from
z = c and tests |z|^2 < 4 first, so a point outside the circle has dwell
0 and a point just inside it dwell 1 (its first step leaves the circle).
A region placed with one corner pixel just across the circle therefore
has exactly that pixel differ from the rest of its border. Border point k
runs in the order of ``ref.perimeter_coords``: top row, bottom row, left
column, right column, so each corner pixel is two of the 4 * side points.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.workloads import registry as treg

torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
# windows wholly inside each set at max_dwell 64 (julia: beside its
# near-neutral fixed point), as in the edge tests of the escape kernels
INTERIOR = {"julia": (-0.513, 0.075, -0.473, 0.115)}
STEP = 1.0 / 64  # plane step of the circle windows


@dataclasses.dataclass(frozen=True)
class BorderCase:
    """One call of Q. ``rows`` [N, 3] int32 (frame, cy, cx) with
    ``bounds[frame]`` each row's window; a case with one frame also runs
    through ``perimeter_query`` on ``rows[:, 1:]``. ``pattern`` names the
    border of row 0 (``pattern_holds``), or None."""
    name: str
    workload: str
    n: int
    side: int
    max_dwell: int
    bounds: tuple
    rows: np.ndarray
    count: int
    pattern: str = None

    @property
    def id(self) -> str:
        return f"{self.name}-{self.workload}"

    @property
    def single(self) -> bool:
        return len(self.bounds) == 1


def _circle_window(n, side, cy, cx, corner, angle, offset):
    """Bounds that put the ``corner`` pixel ("tl", "tr" or "br") of region
    (cy, cx) at radius 2 + offset * STEP, at ``angle`` degrees."""
    y = cy * side + (side - 1 if corner == "br" else 0)
    x = cx * side + (0 if corner == "tl" else side - 1)
    r = 2.0 + offset * STEP
    re0 = r * math.cos(math.radians(angle)) - x * STEP
    im0 = r * math.sin(math.radians(angle)) - y * STEP
    return tuple(float(np.float32(v)) for v in
                 (re0, im0, re0 + n * STEP, im0 + n * STEP))


# pattern -> (corner pixel on the circle, its angle, radius offset in steps:
# > 0 outside, the rest of the border inside; < 0 inside, the rest outside)
CIRCLE = {
    # bottom-right corner (points 2 side - 1 and 4 side - 1, the last) at
    # 0 and every other point at 1
    "last_differs": ("br", 45, 0.35),
    # the first point (with its twin 2 side) at 1 and every other at 0
    "first_differs": ("tl", 45, -0.35),
    # top-right corner (points side - 1 and 3 side) at f + 1 = 1
    "plus_one": ("tr", 135, -0.35),
    # top-right corner at f - 1 = 0
    "minus_one": ("tr", -45, 0.35),
}


def _rows(coords, frame=0):
    coords = np.asarray(coords, np.int32)
    return np.concatenate([np.full((len(coords), 1), frame, np.int32), coords],
                          axis=1)


def _others(seed, grid, N, skip):
    """N region coords of a grid x grid level other than ``skip``."""
    cells = [c for c in np.random.default_rng(seed).permutation(grid * grid)
             if (c // grid, c % grid) != skip][:N]
    return [(c // grid, c % grid) for c in cells]


def _cases(workload):
    out = []
    for side, n, at in ((8, 64, (3, 5)), (4, 32, (2, 1))):
        for pattern, (corner, angle, offset) in CIRCLE.items():
            # the pattern region first, three more, the last past the count
            rows = _rows([at, *_others(side, n // side, 3, at)])
            out.append(BorderCase(
                f"{pattern}_side{side}", workload, n, side, 64,
                (_circle_window(n, side, *at, corner, angle, offset),), rows,
                len(rows) - 1, pattern))
    at = (3, 5)
    rows = _rows([at, *_others(1, 8, 5, at)])
    # max_dwell 1: the border is at max_dwell but for the last point
    out.append(BorderCase("one_below_max", workload, 64, 8, 1,
                          (_circle_window(64, 8, *at, "br", 45, 0.35),), rows,
                          len(rows), "one_below_max"))
    out.append(BorderCase(
        "all_max", workload, 64, 8, 64,
        (INTERIOR.get(workload, (-0.1, -0.1, 0.1, 0.1)),),
        _rows(_others(2, 8, 6, None)), 6, "all_max"))
    spec = treg.get_workload(workload)
    # a real fractal border: random regions of the default window
    out.append(BorderCase("fractal", workload, 128, 8, 96,
                          (spec.default_bounds,), _rows(_others(3, 16, 40, None)),
                          37))
    # the paper's top level: 16 regions of side 4096 (n=16384, g=4)
    out.append(BorderCase("side4096", workload, 16384, 4096, 24,
                          (spec.default_bounds,), _rows(_others(4, 4, 16, None)),
                          16))
    out.append(BorderCase("count0", workload, 64, 8, 64, (spec.default_bounds,),
                          _rows(_others(5, 8, 5, None)), 0))
    # frames with different planes in one call: three pattern windows
    frames = [_circle_window(64, 8, 3, 5, *CIRCLE[p]) for p in
              ("last_differs", "plus_one", "minus_one")]
    rows = np.concatenate([_rows([(3, 5), *_others(6 + f, 8, 3, (3, 5))], f)
                           for f in range(3)])
    out.append(BorderCase("pooled_frames", workload, 64, 8, 64, tuple(frames),
                          rows, len(rows) - 2, "last_differs"))
    return out


CASES = [c for w in WORKLOADS for c in _cases(w)]


def border_dwells(case: BorderCase, traced: bool) -> torch.Tensor:
    """[N, 4 * side] border dwells of every row of ``case``, in the static
    bounds spelling (one frame) or the traced one (``pooled_planes``)."""
    rows = torch.from_numpy(case.rows)
    ys, xs = ref.perimeter_coords(rows[:, 1:], case.side)
    if traced:
        planes = torch.from_numpy(ref.pooled_planes(case.n, np.asarray(
            case.bounds, np.float32)))
        cr, ci = ref.map_plane(xs, ys, ref.row_planes(planes, rows, 2))
    else:
        cr, ci = ref.map_coords(xs, ys, case.n, case.bounds[0])
    d = ref.dwell_compute(cr, ci, case.max_dwell,
                          workload=treg.get_workload(case.workload))
    return d.reshape(rows.shape[0], -1)


def _only(d, points):
    """The border differs from its point 0 exactly at ``points``."""
    return sorted(torch.nonzero(d != d[0]).reshape(-1).tolist()) == points


def pattern_holds(pattern: str, d: torch.Tensor, side: int,
                  max_dwell: int) -> bool:
    """Whether the border dwells ``d`` [4 * side] have ``pattern``."""
    f = int(d[0])
    tl_twin, tr, br = [2 * side], [side - 1, 3 * side], [2 * side - 1, 4 * side - 1]
    if pattern == "last_differs":
        return _only(d, br)
    if pattern == "first_differs":
        rest = [k for k in range(1, 4 * side) if k not in tl_twin]
        return _only(d, rest) and bool((d[rest] == d[rest[0]]).all())
    if pattern in ("plus_one", "minus_one"):
        want = f + (1 if pattern == "plus_one" else -1)
        return _only(d, tr) and bool((d[tr] == want).all())
    if pattern == "all_max":
        return bool((d == max_dwell).all())
    if pattern == "one_below_max":
        return f == max_dwell and _only(d, br) and bool((d[br] < f).all())
    raise ValueError(pattern)


@pytest.mark.parametrize("case", [c for c in CASES if c.pattern],
                         ids=lambda c: c.id)
def test_case_has_its_border(case):
    """Row 0 of each case has the border it is named for, in the spelling
    of every path that runs it (the pooled frames: frame 0)."""
    for traced in (False, True) if case.single else (True,):
        d = border_dwells(case, traced)[0]
        assert pattern_holds(case.pattern, d, case.side, case.max_dwell), (
            traced, d.tolist())
    if case.pattern == "all_max":  # and so has every row
        assert (border_dwells(case, False) == case.max_dwell).all()


def test_exact_work_of_borders():
    """chip_smoke.border_work, the exact-work bound of Q: a homogeneous
    border needs every dwell; any other its first dwell f plus its
    cheapest witness, min over q with d_q != f of min(d_q, f) + 1."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    d = torch.tensor([[5] * 8,                    # homogeneous: 8 x 5
                      [3, 3, 3, 7, 3, 3, 3, 3],   # f = 3, witness 7: 3 + 4
                      [10, 12, 10, 2, 10, 10, 10, 10]],  # witness 2: 10 + 3
                     dtype=torch.int32).reshape(3, 4, 2)
    assert cs.border_work(d) == (1, 40 + 7 + 13)
