"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``card`` fixture for the device and skips
where there is none. This file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: region_fill and perimeter_query must match exactly; the dwell
kernels may differ in at most 1 pixel per million, because the plain
version's FMA goes through f64 (rounded to odd: exact in theory, and the
bound covers what the card's own FMA could still disagree on).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.ask import run_ask
from repro_torch.kernels import _build
from repro_torch.kernels.mandelbrot_dwell import (mandelbrot_dwell,
                                                  mandelbrot_dwell_plain)
from repro_torch.kernels.perimeter_query import (perimeter_query,
                                                 perimeter_query_plain)
from repro_torch.kernels.region_dwell import region_dwell, region_dwell_plain
from repro_torch.kernels.region_fill import region_fill, region_fill_plain
from repro_torch.workloads import FrameProblem
from repro_torch.workloads import registry as treg

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
WRAPPERS = (mandelbrot_dwell, perimeter_query, region_fill, region_dwell)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run `pytest -m gpu` on the chip)")
    _build.build()  # all four libraries, one nvcc each, in parallel
    return torch.device("cuda")


def _olt(seed, N, grid):
    cells = np.random.default_rng(seed).permutation(grid * grid)[:N]
    return np.stack([cells // grid, cells % grid], axis=1).astype(np.int32)


def _mismatch_ok(got, want):
    bad = int((got.cpu() != want.cpu()).sum())
    assert bad <= got.numel() // 1_000_000, f"{bad} of {got.numel()} differ"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_kernels_match_plain_on_card(card, workload):
    tw = treg.get_workload(workload)
    b, n, md = tw.default_bounds, 512, 256
    start = [w.launches for w in WRAPPERS]
    _mismatch_ok(mandelbrot_dwell(n, bounds=b, max_dwell=md, workload=tw,
                                  device=card),
                 mandelbrot_dwell_plain(n, bounds=b, max_dwell=md, workload=tw,
                                        device=card))
    coords = torch.from_numpy(_olt(1, 40, 16)).to(card)
    count = torch.tensor([33], dtype=torch.int32, device=card)
    every = torch.tensor([40], dtype=torch.int32, device=card)
    for side, live in ((32, every), (8, every), (8, count)):
        h, c = perimeter_query(coords, live, side=side, n=n, bounds=b,
                               max_dwell=md, workload=tw)
        ph, pc = perimeter_query_plain(coords, live, side=side, n=n,
                                       bounds=b, max_dwell=md, workload=tw)
        assert torch.equal(h, ph) and torch.equal(c, pc)
    values = torch.arange(40, dtype=torch.int32, device=card)
    for scheme, tile in (("sbr", 256), ("mbr", 8)):
        base = torch.randint(0, 99, (n, n), dtype=torch.int32, device=card)
        assert torch.equal(
            region_fill(base.clone(), coords, values, count, side=32, n=n,
                        scheme=scheme, tile=tile),
            region_fill_plain(base.clone(), coords, values, count, side=32, n=n))
        _mismatch_ok(
            region_dwell(base.clone(), coords, count, side=32, n=n, bounds=b,
                         max_dwell=md, scheme=scheme, tile=tile, workload=tw),
            region_dwell_plain(base.clone(), coords, count, side=32, n=n,
                               bounds=b, max_dwell=md, workload=tw))
    torch.cuda.synchronize()
    assert [w.launches - s for w, s in zip(WRAPPERS, start)] == [1, 3, 2, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("side,scheme,tile", [(6, "sbr", 256), (18, "sbr", 256),
                                              (18, "mbr", 6)])
def test_region_fill_scalar_stores_on_card(card, side, scheme, tile):
    """A side or n that is no multiple of 4 takes the scalar-store branch."""
    n = 54
    coords = torch.from_numpy(_olt(side, (n // side) ** 2, n // side)).to(card)
    values = torch.arange(coords.shape[0], dtype=torch.int32, device=card) + 1
    count = torch.tensor([coords.shape[0] - 1], dtype=torch.int32, device=card)
    base = torch.randint(0, 99, (n, n), dtype=torch.int32, device=card)
    assert torch.equal(
        region_fill(base.clone(), coords, values, count, side=side, n=n,
                    scheme=scheme, tile=tile),
        region_fill_plain(base.clone(), coords, values, count, side=side, n=n))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 8)])
def test_run_ask_on_card_matches_cpu(card, scheme, tile):
    for workload in WORKLOADS:
        kw = dict(n=256, g=4, r=2, B=16, max_dwell=128, workload=workload,
                  scheme=scheme, tile=tile)
        got, st = run_ask(FrameProblem(**kw, device=card))
        want, want_st = run_ask(FrameProblem(**kw, device="cpu"))
        assert torch.equal(got.cpu(), want)
        assert (st.region_counts, st.leaf_count, st.olt_caps) == \
            (want_st.region_counts, want_st.leaf_count, want_st.olt_caps)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 6)])
def test_run_ask_on_card_matches_cpu_odd_sides(card, scheme, tile):
    """n=54, g=3, r=3, B=2: region sides 18, 6 and 2, none a multiple of 4."""
    kw = dict(n=54, g=3, r=3, B=2, max_dwell=128, scheme=scheme, tile=tile)
    got, st = run_ask(FrameProblem(**kw, device=card))
    want, want_st = run_ask(FrameProblem(**kw, device="cpu"))
    assert torch.equal(got.cpu(), want)
    assert st.region_counts == want_st.region_counts


@pytest.mark.gpu
def test_empty_and_bad_inputs_on_card(card):
    canvas = torch.zeros((64, 64), dtype=torch.int32, device=card)
    coords = torch.zeros((4, 2), dtype=torch.int32, device=card)
    zero = torch.zeros((1,), dtype=torch.int32, device=card)
    region_fill(canvas, coords, zero + 7, zero, side=16, n=64)
    region_dwell(canvas, coords, zero, side=16, n=64)
    assert int(canvas.abs().sum()) == 0  # a count of 0 writes nothing
    homog, common = perimeter_query(coords, zero, side=16, n=64)
    assert not homog.any() and not common.any()
    with pytest.raises(ValueError, match="contiguous"):
        region_fill(canvas, coords.t(), zero, zero, side=16, n=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        region_fill(canvas, coords.cpu(), zero, zero, side=16, n=64)
