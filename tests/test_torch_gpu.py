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
from repro_torch.core import ask, pooled
from repro_torch.core.pooled import run_ask_pooled_batch
from repro_torch.kernels import olt_compact, ops
from repro_torch.kernels.perimeter_query import (perimeter_query_pooled,
                                                 perimeter_query_pooled_plain)
from repro_torch.kernels.region_dwell_pooled import (region_dwell_pooled,
                                                     region_dwell_pooled_plain)
from repro_torch.kernels.region_fill_pooled import (region_fill_pooled,
                                                    region_fill_pooled_plain)
from repro_torch.core import graphs
from repro_torch.workloads import FrameProblem, solve
from repro_torch.workloads import registry as treg
from test_torch_border_cases import CASES as BORDER_CASES

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
    _build.build()  # every library, one nvcc each, in parallel
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


def _unaligned(like):
    """A copy of ``like`` as a contiguous int32 canvas 4 bytes past a
    16-byte boundary: the fill takes its scalar stores there."""
    flat = torch.empty((like.numel() + 4,), dtype=torch.int32,
                       device=like.device)
    canvas = flat[1:1 + like.numel()].view(like.shape)
    assert canvas.data_ptr() % 16 == 4
    return canvas.copy_(like)


@pytest.mark.gpu
@pytest.mark.parametrize("stores", ["int4", "scalar"])
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 4)])
@pytest.mark.parametrize("side", [4 << k for k in range(11)])  # 4 ... 4096
def test_region_fill_every_side_on_card(card, side, scheme, tile, stores):
    """T against its plain version at every region side of the main path,
    with counts 0, 1 and the whole capacity, one launch a call."""
    n = max(2 * side, 64)
    grid = n // side
    coords = torch.from_numpy(_olt(side, grid * grid, grid)).to(card)
    values = torch.arange(grid * grid, dtype=torch.int32, device=card) * 7 + 1
    for live in (0, 1, grid * grid):
        count = torch.tensor([live], dtype=torch.int32, device=card)
        base = torch.randint(0, 99, (n, n), dtype=torch.int32, device=card)
        start = region_fill.launches
        got = region_fill(_unaligned(base) if stores == "scalar" else
                          base.clone(), coords, values, count, side=side, n=n,
                          scheme=scheme, tile=tile)
        assert region_fill.launches == start + 1
        want = region_fill_plain(base.clone(), coords, values, count, side=side,
                                 n=n)
        assert torch.equal(got, want), (side, live)


@pytest.mark.gpu
def test_region_fill_mandelbrot_top_level_on_card(card):
    """The 2 x 4096^2 homogeneous regions of mandelbrot's first level at
    n=16384 (1 GiB canvas), out of a capacity of 16."""
    n, side = 16384, 4096
    coords = torch.from_numpy(_olt(4, 16, 4)).to(card)
    values = torch.tensor([512, 37] + [0] * 14, dtype=torch.int32, device=card)
    count = torch.tensor([2], dtype=torch.int32, device=card)
    base = torch.full((n, n), -1, dtype=torch.int32, device=card)
    got = region_fill(base.clone(), coords, values, count, side=side, n=n)
    want = region_fill_plain(base, coords, values, count, side=side, n=n)
    assert torch.equal(got, want)
    assert int((got == 512).sum()) == side * side


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 4)])
def test_region_dwell_one_large_leaf_on_card(card, scheme, tile):
    """One SBR leaf of side 8192 (2^26 pixels: items of one row, under the
    f32 pixel index's 2^24), and the same leaf as 4M MBR tiles of 4 x 4."""
    n, side = 8192, 8192
    coords = torch.zeros((2, 2), dtype=torch.int32, device=card)
    count = torch.tensor([1], dtype=torch.int32, device=card)
    b = (-0.8, -0.2, -0.6, 0.0)  # a window with structure everywhere
    base = torch.full((n, n), -1, dtype=torch.int32, device=card)
    got = region_dwell(base.clone(), coords, count, side=side, n=n, bounds=b,
                       max_dwell=24, scheme=scheme, tile=tile)
    want = region_dwell_plain(base, coords, count, side=side, n=n, bounds=b,
                              max_dwell=24)
    assert int((got < 0).sum()) == 0
    _mismatch_ok(got, want)
    assert len(torch.unique(got)) > 8


def _plain_ops(monkeypatch):
    """Route the main path's four entry points to their plain versions, on
    whatever device the tensors lie (chip_smoke.plain_of does the same)."""
    monkeypatch.setattr(ops, "mandelbrot", lambda *a, policy, block, **kw:
                        mandelbrot_dwell_plain(*a, **kw))
    monkeypatch.setattr(ops, "perimeter_query", lambda *a, policy, **kw:
                        perimeter_query_plain(*a, **kw))
    monkeypatch.setattr(ops, "region_fill", lambda *a, scheme, tile, policy,
                        **kw: region_fill_plain(*a, **kw))
    monkeypatch.setattr(ops, "region_dwell", lambda *a, scheme, tile, policy,
                        **kw: region_dwell_plain(*a, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ask", "dp"])
def test_large_leaves_on_card_match_plain_path(card, monkeypatch, method):
    """n=16384, g=2, B=8192: four leaves of 2^26 pixels, which the card
    refused before the leaf kernel cut its items; the port's plain path on
    the card is the yardstick."""
    from repro_torch.workloads import solve
    p = FrameProblem(n=16384, g=2, B=8192, max_dwell=32, device=card)
    start = region_dwell.launches
    got, st = solve(p, method)
    torch.cuda.synchronize()
    assert region_dwell.launches > start
    _plain_ops(monkeypatch)
    want, want_st = solve(p, method)
    _mismatch_ok(got, want)
    assert st.leaf_count == want_st.leaf_count == 4


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
    before = olt_compact.compact_ranks.launches
    ranks, count = olt_compact.compact_ranks(torch.zeros(0, dtype=torch.bool,
                                                         device=card))
    assert ranks.shape == (0,) and int(count[0]) == 0  # no launch for N=0
    assert olt_compact.compact_ranks.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        region_fill(canvas, coords.t(), zero, zero, side=16, n=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        region_fill(canvas, coords.cpu(), zero, zero, side=16, n=64)


# -- the blocked escape loop on its edges ---------------------------------------

# n=18 over (-2, -2)-(2.5, 2.5) puts pixels on c = -2, 2 and 2i (|z|^2 = 4.0
# at step 0); over +-3e19, z^2 overflows to inf and NaN inside the first
# block; the interior windows hold only points that reach max_dwell (julia:
# beside its near-neutral fixed point). tests/test_torch_kernels.py holds
# the plain versions against JAX on the same windows.
EDGE_WINDOWS = ((-2.0, -2.0, 2.5, 2.5), (-3e19, -3e19, 3e19, 3e19))
INTERIOR = {"julia": (-0.513, 0.075, -0.473, 0.115)}
# 1, U - 1, U and U + 1 for the escape loop's blocks of U = 8 (Ex, Q) and
# 16 (A), and around the paper's 512
EDGE_DWELLS = (1, 7, 8, 9, 15, 16, 17, 511, 512, 513)


def _edge_workload(name):
    return treg.multibrot(4) if name == "multibrot4" else treg.get_workload(name)


def _all_regions(side, n, seed):
    g = n // side
    return torch.from_numpy(_olt(seed, g * g, g))


@pytest.mark.gpu
@pytest.mark.parametrize("max_dwell", EDGE_DWELLS)
@pytest.mark.parametrize("workload", (*WORKLOADS, "multibrot4"))
def test_escape_kernels_on_edges_on_card(card, workload, max_dwell):
    """Ex, Q and A against their plain versions with 0 mismatches on the edge windows. A: 5 of 9 live rows (no multiple of the
    4 warps a block), odd sides (9), one live row as an MBR tile grid and as
    one SBR region of 324 pixels. multibrot4 runs the run-time power loop."""
    tw = _edge_workload(workload)
    n, md = 18, max_dwell
    interior = INTERIOR.get(workload, (-0.1, -0.1, 0.1, 0.1))
    start = [w.launches for w in WRAPPERS]
    leaves = [(6, _all_regions(6, n, 1), 5, "sbr", 256),
              (9, _all_regions(9, n, 2), 3, "sbr", 256),
              (18, _all_regions(18, n, 3), 1, "mbr", 6),
              (18, _all_regions(18, n, 3), 1, "sbr", 256)]
    for i, b in enumerate((*EDGE_WINDOWS, interior)):
        want = mandelbrot_dwell_plain(n, bounds=b, max_dwell=md, workload=tw,
                                      device=card)
        if i == 2:
            assert (want == md).all()  # every lane reaches max_dwell
        got = mandelbrot_dwell(n, bounds=b, max_dwell=md, workload=tw,
                               device=card)
        assert torch.equal(got, want), b
        for side, coords, count, scheme, tile in leaves:
            coords = coords.to(card)
            live = torch.tensor([count], dtype=torch.int32, device=card)
            ph, pc = perimeter_query_plain(coords, live, side=side, n=n,
                                           bounds=b, max_dwell=md, workload=tw)
            base = torch.randint(0, 99, (n, n), dtype=torch.int32, device=card)
            pa = region_dwell_plain(base.clone(), coords, live, side=side, n=n,
                                    bounds=b, max_dwell=md, workload=tw)
            h, c = perimeter_query(coords, live, side=side, n=n, bounds=b,
                                   max_dwell=md, workload=tw)
            assert torch.equal(h, ph) and torch.equal(c, pc), (b, side)
            a = region_dwell(base.clone(), coords, live, side=side, n=n,
                             bounds=b, max_dwell=md, scheme=scheme, tile=tile,
                             workload=tw)
            assert torch.equal(a, pa), (b, side, scheme)
    torch.cuda.synchronize()
    # Ex: 3 windows; Q and A: 3 windows x 4 leaf sets
    assert [w.launches - s for w, s in zip(WRAPPERS, start)] == [3, 12, 0, 12]


@pytest.mark.gpu
@pytest.mark.parametrize("max_dwell", EDGE_DWELLS)
@pytest.mark.parametrize("workload", (*WORKLOADS, "multibrot4"))
def test_pooled_escape_kernels_on_edges_on_card(card, workload, max_dwell):
    """The pooled Q and A against their plain versions with 0 mismatches: the three edge windows as three frames of one call,
    so one launch holds leaves whose pixels all reach max_dwell beside
    leaves whose dwells run from 0 up; 25 of 27 live rows at side 6 (no
    multiple of the 8 warps a block) and 11 of 12 at side 9 (odd)."""
    tw = _edge_workload(workload)
    n, md = 18, max_dwell
    bounds = np.array([*EDGE_WINDOWS, INTERIOR.get(workload, (-0.1, -0.1, 0.1, 0.1))],
                      np.float32)
    F = len(bounds)
    planes = ops.pooled_planes(n, bounds, card)
    start = [region_dwell_pooled.launches, perimeter_query_pooled.launches]
    for side, count in ((6, 25), (9, 11)):
        grid = n // side
        rows = torch.from_numpy(_pooled_rows(side, F * grid * grid, F, grid)).to(card)
        live = torch.tensor([count], dtype=torch.int32, device=card)
        ph, pc = perimeter_query_pooled_plain(rows, live, planes, side=side,
                                              max_dwell=md, workload=tw)
        base = torch.randint(0, 99, (F * n, n), dtype=torch.int32, device=card)
        pa = region_dwell_pooled_plain(base.clone(), rows, live, planes,
                                       side=side, n=n, max_dwell=md, workload=tw)
        h, c = perimeter_query_pooled(rows, live, planes, side=side,
                                      max_dwell=md, workload=tw)
        assert torch.equal(h, ph) and torch.equal(c, pc), side
        a = region_dwell_pooled(base.clone(), rows, live, planes, side=side,
                                n=n, max_dwell=md, workload=tw)
        assert torch.equal(a, pa), side
        if side == 6:  # the leaves the call holds
            done = pa.view(F, grid, side, grid, side).permute(0, 1, 3, 2, 4)
            done = done.reshape(F * grid * grid, side * side)
            r = rows[:count].long()
            leaf = done[(r[:, 0] * grid + r[:, 1]) * grid + r[:, 2]]
            assert (leaf == md).all(1).any() and (leaf.amin(1) == 0).any()
    torch.cuda.synchronize()
    assert [region_dwell_pooled.launches - start[0],
            perimeter_query_pooled.launches - start[1]] == [2, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BORDER_CASES, ids=lambda c: c.id)
def test_border_cases_on_card(card, case):
    """The shared edge regions of tests/test_torch_border_cases.py (the CPU
    holds them against JAX): the pooled Q on every case and Q on the cases
    of one frame, each against its plain version with 0 mismatches, run
    twice with bitwise-equal outputs, one launch a call."""
    tw = treg.get_workload(case.workload)
    rows = torch.from_numpy(case.rows).to(card)
    live = torch.tensor([case.count], dtype=torch.int32, device=card)
    kw = dict(side=case.side, max_dwell=case.max_dwell, workload=tw)
    planes = ops.pooled_planes(case.n, np.asarray(case.bounds, np.float32),
                               card)
    runs = [(perimeter_query_pooled, perimeter_query_pooled_plain,
             (rows, live, planes), kw)]
    if case.single:
        runs.append((perimeter_query, perimeter_query_plain,
                     (rows[:, 1:].contiguous(), live),
                     dict(kw, n=case.n, bounds=case.bounds[0])))
    for kernel, plain, args, kwargs in runs:
        start = kernel.launches
        first = kernel(*args, **kwargs)
        second = kernel(*args, **kwargs)
        torch.cuda.synchronize()
        assert kernel.launches - start == 2
        want = plain(*args, **kwargs)
        for a, b, c in zip(first, second, want, strict=True):
            assert torch.equal(a, b) and torch.equal(a, c), kernel.__name__


# -- the pooled engine's kernels ----------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 31, 32, 1024, 65536, 65537, (1 << 21) + 3])
@pytest.mark.parametrize("fill", ["zeros", "ones", "random"])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_scan_kernel_matches_cumsum_on_card(card, N, fill, dtype):
    """The single-pass scan (one block up to a tile of 4096 flags, look-back
    above, one launch a call) against torch.cumsum, exactly; int32 flags add
    their values."""
    gen = torch.Generator(device=card).manual_seed(N)
    if fill == "zeros":
        flags = torch.zeros(N, dtype=dtype, device=card)
    elif fill == "ones":
        flags = torch.ones(N, dtype=dtype, device=card)
    elif dtype == torch.bool:
        flags = torch.rand(N, generator=gen, device=card) < 0.37
    else:
        flags = torch.randint(0, 3, (N,), generator=gen, device=card,
                              dtype=torch.int32)
    before = olt_compact.compact_ranks.launches
    ranks, count = olt_compact.compact_ranks(flags)
    inc = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
    assert torch.equal(ranks, inc - flags.to(torch.int32))
    assert int(count[0]) == int(inc[-1])
    want_r, want_c = olt_compact.compact_ranks_plain(flags)
    assert torch.equal(ranks, want_r) and torch.equal(count, want_c)
    assert olt_compact.compact_ranks.launches == before + 1


def _scan_flags(seed, N, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(N, generator=gen, device=device) < 0.37
    return torch.randint(0, 5, (N,), generator=gen, device=device,
                         dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N", [0, 1, 127, olt_compact.TILE, olt_compact.TILE + 1,
                               (1 << 20) + 3, 1 << 26])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_scan_one_launch_a_call_on_card(card, N, dtype, offset):
    """Every N is one launch (none for N = 0) equal to the plain version
    (one block up to a TILE of flags, chained tiles above),
    with 16-byte vectors (offset 0) and without them (flags one element
    past an aligned address)."""
    flags = _scan_flags(N, N + offset, dtype, card)[offset:]
    before = olt_compact.compact_ranks.launches
    ranks, count = olt_compact.compact_ranks(flags)
    want_r, want_c = olt_compact.compact_ranks_plain(flags)
    assert torch.equal(ranks, want_r) and torch.equal(count, want_c)
    assert olt_compact.compact_ranks.launches == before + (N > 0)


@pytest.mark.gpu
def test_scan_back_to_back_across_the_epoch_wrap_on_card(card):
    """1000 chained calls of random sizes on one stream, each held against
    the plain version, starting 500 launches before the stored epoch wraps
    (the scratch zeroed, as a fresh one is): every call's look-back sees
    only its own launch's words."""
    warm = _scan_flags(0, 16 * olt_compact.TILE, torch.bool, card)  # chained
    olt_compact.compact_ranks(warm)
    scratch = olt_compact._SCRATCH[(warm.device.index,
                                    _build.stream(warm).value)]
    epochs = 0x7fffffff
    scratch.zero_()
    scratch[0] = (epochs - 500) << 32
    sizes = np.random.default_rng(0).integers(olt_compact.TILE + 1,
                                              16 * olt_compact.TILE, 1000)
    for i, N in enumerate(sizes):
        dtype = torch.bool if i % 2 else torch.int32
        flags = _scan_flags(i, int(N), dtype, card)
        got = olt_compact.compact_ranks(flags)
        want = olt_compact.compact_ranks_plain(flags)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (i, N)
    assert int(scratch[0]) == 500 << 32  # stored epoch 500, no ticket


@pytest.mark.gpu
def test_scan_graph_replays_on_card(card):
    """A CUDA graph of chained scans, its scratch made by a warm-up call on
    the capture stream, replayed with new flags: each replay equals the
    plain version, and the capture made no scratch."""
    flags = _scan_flags(0, 5 * olt_compact.TILE + 17, torch.bool, card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        olt_compact.compact_ranks(flags)
    torch.cuda.synchronize()
    made = dict(olt_compact._SCRATCH)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        outs = [olt_compact.compact_ranks(flags) for _ in range(3)]
    assert olt_compact._SCRATCH.keys() == made.keys()
    for seed in range(1, 6):
        flags.copy_(_scan_flags(seed, flags.shape[0], torch.bool, card))
        g.replay()
        want_r, want_c = olt_compact.compact_ranks_plain(flags)
        for r, c in outs:
            assert torch.equal(r, want_r) and torch.equal(c, want_c), seed


@pytest.mark.gpu
def test_scan_no_scratch_made_under_capture_on_card(card):
    """A chained scan captured on a stream with no scratch of its size
    raises, naming the warm-up, and makes none."""
    flags = torch.ones(64 * olt_compact.TILE, dtype=torch.bool, device=card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = dict(olt_compact._SCRATCH)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(g, stream=side):
            olt_compact.compact_ranks(flags)
    torch.cuda.synchronize()
    assert olt_compact._SCRATCH.keys() == before.keys()


# -- the one-dispatch engines: CUDA-graph replays ------------------------------

ENGINE = dict(n=512, g=4, r=2, B=16, max_dwell=128)


def _eager_engine(p, method, kw):
    """The engine's level loop launched kernel by kernel on the card:
    (capacities, (canvas, ..., leaf_count, dropped))."""
    if method == "ask_fused":
        caps = ask._fused_capacities(p, kw.get("capacity_factor", 1.0))
        return caps, ask._fused_pipeline(p, caps)
    caps = ask._resolve_capacities(p, kw.get("capacities"), 0.7,
                                   kw.get("safety_factor", 2.0))
    return caps, ask._scan_pipeline(p, caps)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_dispatch_engines_replay_on_card(card, workload):
    """ask_scan (worst case and undersized) and ask_fused: the graph's
    replays (the first call captures, the second replays) equal the eager
    pipeline on the card, and at worst case run_ask; one dispatch each."""
    p = FrameProblem(**ENGINE, workload=workload, device=card)
    want, want_st = run_ask(p)
    for method, kw in (("ask_scan", dict(safety_factor=1e9)),
                       ("ask_scan", dict(capacities=(12, 40, 150, 600))),
                       ("ask_fused", {})):
        caps, eager = _eager_engine(p, method, kw)
        for _ in range(2):
            got, st = solve(p, method, **kw)
            assert torch.equal(got, eager[0]), (method, kw)
            assert st.kernel_launches == 1 and st.olt_caps == caps
            assert st.leaf_count == int(eager[-2])
            assert st.overflow_dropped == int(eager[-1])
            if method == "ask_scan":
                entering = eager[1].tolist()
                assert list(st.region_counts) == entering[:len(st.region_counts)]
        if "capacities" in kw:
            assert st.overflow_dropped > 0
        else:
            assert torch.equal(got, want) and st.leaf_count == want_st.leaf_count


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ask_scan", "ask_fused"])
def test_one_graph_serves_a_zoom_sequence_on_card(card, method):
    """The single-frame graph is keyed on all but the window: a zoom
    sequence of five distinct windows is one capture, and each replay
    equals run_ask on its own window."""
    kw = dict(safety_factor=1e9) if method == "ask_scan" else {}
    graphs.release()
    for k in range(5):
        w = 2.5 / 3 ** k
        b = (-0.7453 - w / 2, 0.1127 - w / 2, -0.7453 + w / 2, 0.1127 + w / 2)
        p = FrameProblem(**ENGINE, bounds=b, device=card)
        want, want_st = run_ask(p)
        got, st = solve(p, method, **kw)
        assert torch.equal(got, want), k
        assert st.leaf_count == want_st.leaf_count and not st.overflow_dropped
    assert graphs.held()[0] == 1


@pytest.mark.gpu
def test_plane_from_memory_on_card(card):
    """The single-frame Q and A read the window from a [4] f32 plane on
    the card: passed explicitly (and ``bounds`` then unused on the card),
    it gives the call on those bounds."""
    n, side = 256, 32
    b = (-0.8, 0.0, -0.6, 0.2)
    coords = torch.from_numpy(_olt(3, 40, n // side)).to(card)
    count = torch.tensor([40], dtype=torch.int32, device=card)
    plane = _build.plane_tensor(n, b, card).clone()
    want_q = perimeter_query(coords, count, side=side, n=n, bounds=b)
    got_q = perimeter_query(coords, count, side=side, n=n, plane=plane)
    assert all(torch.equal(x, y) for x, y in zip(got_q, want_q))
    want = torch.zeros((n, n), dtype=torch.int32, device=card)
    got = torch.zeros_like(want)
    region_dwell(want, coords, count, side=side, n=n, bounds=b)
    region_dwell(got, coords, count, side=side, n=n, plane=plane)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_replays_from_two_streams_on_card(card):
    """Two graphs replayed from two caller streams in turn run on the
    capture stream one after the other: each equals run_ask. Each graph
    holds the look-back scratch its capture used, and no kernel's
    process-long ``_CAPTURED`` list grows."""
    graphs.release()
    captured = len(olt_compact._CAPTURED)
    big = dict(ENGINE, n=4096)  # level 5: 16384 rows, chained scan tiles
    probs = [FrameProblem(**big, workload=wl, device=card)
             for wl in ("mandelbrot", "julia")]
    wants = [run_ask(p)[0] for p in probs]
    for p in probs:
        solve(p, "ask_scan", safety_factor=1e9)
    assert [len(e.scratch) for e in graphs._GRAPHS.values()] == [1, 1]
    assert len(olt_compact._CAPTURED) == captured
    streams = [torch.cuda.Stream(card) for _ in probs]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for p, s in zip(probs, streams):
            with torch.cuda.stream(s):
                outs.append(solve(p, "ask_scan", safety_factor=1e9)[0])
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, wants[i % 2]), i
    graphs.release()


@pytest.mark.gpu
def test_replayed_canvas_is_the_callers_on_card(card):
    """A returned canvas is the caller's: writing it changes no later
    result, and a later call does not write it."""
    p = FrameProblem(**ENGINE, device=card)
    first, _ = solve(p, "ask_scan", safety_factor=1e9)
    keep = first.clone()
    first.fill_(-7)
    second, _ = solve(p, "ask_scan", safety_factor=1e9)
    assert torch.equal(second, keep)
    assert bool((first == -7).all())
    assert first.data_ptr() != second.data_ptr()


@pytest.mark.gpu
def test_graph_cache_release_on_card(card):
    """release() drops every graph and returns its pool; the next call
    captures anew."""
    p = FrameProblem(**dict(ENGINE, n=2048, B=64), device=card)
    want = ask._fused_pipeline(p, ask._fused_capacities(p, 1.0))[0]
    solve(p, "ask_fused")
    count, nbytes = graphs.held()
    assert count >= 1 and nbytes >= 2048 * 2048 * 4
    reserved = torch.cuda.memory_reserved(card)
    graphs.release()
    assert graphs.held() == (0, 0)
    assert torch.cuda.memory_reserved(card) <= reserved - nbytes
    got, _ = solve(p, "ask_fused")
    assert torch.equal(got, want) and graphs.held()[0] == 1


@pytest.mark.gpu
def test_pooled_replay_serves_any_bounds_on_card(card):
    """One graph of the pooled pipeline (same problem, capacities and F;
    the planes and the live mask its static inputs) serves two bound sets,
    each equal to the pooled batch, which launches the pipeline eagerly."""
    kw = dict(n=256, g=4, r=2, B=16, max_dwell=128)
    p = FrameProblem(**kw, device=card)
    sets = [np.array([[-2.0, -2.0, 2.0, 2.0], [-0.8, 0.0, -0.6, 0.2],
                      [-1.8, -0.1, -1.7, 0.0]], np.float32),
            np.array([[-1.5, -1.0, 0.5, 1.0], [-0.7453, 0.1127, -0.7451, 0.1129],
                      [-0.5, -0.5, 0.5, 0.5]], np.float32)]
    caps = pooled._resolve_pooled_capacities(p, 3, None, None, 0.7, 1e9)
    graphs.release()
    for b in sets:
        for live in (None, [True, False, True]):
            want, want_st = run_ask_pooled_batch(p, b, safety_factor=1e9,
                                                 live=live)
            live_t = torch.tensor([True] * 3 if live is None else live,
                                  device=card)
            got, entering, leaf_f, _ = graphs.replay(
                ("pooled", p, caps, 3),
                lambda pl, lv: pooled.pooled_pipeline(p, caps, pl, lv),
                ops.pooled_planes(p.n, b, card), live_t, device=card)
            assert torch.equal(got, want)
            assert tuple(leaf_f.tolist()) == want_st.frame_leaf_counts
    assert graphs.held()[0] == 1
    graphs.release()


def _pooled_rows(seed, N, F, grid):
    cells = np.random.default_rng(seed).permutation(F * grid * grid)[:N]
    f, rest = cells // (grid * grid), cells % (grid * grid)
    return np.stack([f, rest // grid, rest % grid], axis=1).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("n,side", [(96, 6), (120, 30), (512, 128)])
def test_pooled_kernels_match_plain_on_card(card, workload, n, side):
    """region_fill_pooled, region_dwell_pooled and the pooled Q on random
    frame-tagged rows over 3 frames, sides 6 and 30 (no multiple of 4:
    scalar stores) and 128 (int4 stores, a region in several pieces)."""
    tw = treg.get_workload(workload)
    F, md = 3, 128
    grid = n // side
    N = min(40, F * grid * grid)
    rows = torch.from_numpy(_pooled_rows(side, N, F, grid)).to(card)
    bounds = np.array([[-2.0, -1.5, 1.0, 1.5], [-0.8, 0.0, -0.6, 0.2],
                       [-0.7453, 0.1127, -0.7451, 0.1129]], np.float32)
    planes = ops.pooled_planes(n, bounds, card)
    count = torch.tensor([N - 3], dtype=torch.int32, device=card)
    values = torch.arange(N, dtype=torch.int32, device=card) + 1
    h, c = perimeter_query_pooled(rows, count, planes, side=side, max_dwell=md,
                                  workload=tw)
    ph, pc = perimeter_query_pooled_plain(rows, count, planes, side=side,
                                          max_dwell=md, workload=tw)
    assert torch.equal(h, ph) and torch.equal(c, pc)
    base = torch.randint(0, 99, (F * n, n), dtype=torch.int32, device=card)
    assert torch.equal(
        region_fill_pooled(base.clone(), rows, values, count, side=side, n=n),
        region_fill_pooled_plain(base.clone(), rows, values, count, side=side,
                                 n=n))
    _mismatch_ok(
        region_dwell_pooled(base.clone(), rows, count, planes, side=side, n=n,
                            max_dwell=md, workload=tw),
        region_dwell_pooled_plain(base.clone(), rows, count, planes, side=side,
                                  n=n, max_dwell=md, workload=tw))


@pytest.mark.gpu
@pytest.mark.parametrize("caps", [None, (60, 100, 300)])
def test_run_ask_pooled_batch_on_card_matches_cpu(card, caps):
    """Five frames at n=128 (g=4, B=8): worst-case capacities, and small
    ones that drop roots and children; canvases and stats equal."""
    b = np.array([[-2.0, -2.0, 2.0, 2.0], [-1.5, -1.0, 0.5, 1.0],
                  [-0.8, 0.0, -0.6, 0.2], [-0.7453, 0.1127, -0.7451, 0.1129],
                  [-1.8, -0.1, -1.7, 0.0]], np.float32)
    kw = dict(n=128, g=4, r=2, B=8, max_dwell=128)
    sizing = dict(safety_factor=1e9) if caps is None else dict(capacities=caps)
    got, st = run_ask_pooled_batch(FrameProblem(**kw, device=card), b, **sizing)
    want, want_st = run_ask_pooled_batch(FrameProblem(**kw, device="cpu"), b,
                                         **sizing)
    assert torch.equal(got.cpu(), want)
    for f in ("region_counts", "leaf_count", "overflow_dropped",
              "frame_overflow", "frame_leaf_counts", "olt_caps"):
        assert getattr(st, f) == getattr(want_st, f), f
    assert (caps is None) == (st.overflow_dropped == 0)


# -- batched frames and the planner --------------------------------------------

_BATCH = dict(n=128, g=4, r=2, B=8, max_dwell=128)
_BATCH_BOUNDS = np.array([[-2.0, -2.0, 2.0, 2.0], [-1.5, -1.0, 0.5, 1.0],
                          [-0.8, 0.0, -0.6, 0.2],
                          [-0.7453, 0.1127, -0.7451, 0.1129],
                          [40.0, 40.0, 41.0, 41.0]], np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("sizing", [dict(safety_factor=1e9), {},
                                    dict(capacities=8),
                                    dict(capacities=(16, 60, 200))],
                         ids=["worst", "default", "uniform8", "levels"])
def test_run_ask_scan_batch_on_card_matches_cpu(card, sizing):
    """Five frames at n=128 (one far outside the set): canvases and every
    per-frame stat equal the CPU path's, the drops of undersized rings
    too; at worst case each frame equals the pooled batch's on the card."""
    got, st = ask.run_ask_scan_batch(FrameProblem(**_BATCH, device=card),
                                     _BATCH_BOUNDS, **sizing)
    want, want_st = ask.run_ask_scan_batch(FrameProblem(**_BATCH, device="cpu"),
                                           _BATCH_BOUNDS, **sizing)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    for f in ("levels", "region_counts", "leaf_count", "overflow_dropped",
              "frame_overflow", "frame_leaf_counts", "olt_caps", "ring_rows"):
        assert getattr(st, f) == getattr(want_st, f), f
    if "capacities" in sizing:
        assert sum(1 for d in st.frame_overflow if d) >= 2
    if "safety_factor" in sizing:
        pool, pst = run_ask_pooled_batch(FrameProblem(**_BATCH, device=card),
                                         _BATCH_BOUNDS, safety_factor=1e9)
        assert torch.equal(got, pool) and st.overflow_dropped == 0
        assert st.region_counts == pst.region_counts


@pytest.mark.gpu
def test_scan_batch_pipeline_makes_no_host_sync_on_card(card):
    p = FrameProblem(**_BATCH, device=card)
    caps = ask._resolve_capacities(p, 8, 0.7, 2.0)
    planes = ops.pooled_planes(p.n, _BATCH_BOUNDS, card)
    live = torch.ones((len(_BATCH_BOUNDS),), dtype=torch.bool, device=card)
    want, _ = ask.run_ask_scan_batch(p, _BATCH_BOUNDS, capacities=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, *_ = pooled.pooled_pipeline(p, caps, planes, live,
                                            per_frame=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(states, want)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_planned_paths_converge_on_card(card, engine):
    """plan=True (a tight hand plan for the scan) ends with nothing
    dropped, the canvases on the card equal to the worst case, and the
    report equal to the CPU path's."""
    from repro_torch.core import planner
    from repro_torch.workloads import EngineOptions, solve_batch
    reports, canvases = [], []
    for dev in (card, "cpu"):
        p = FrameProblem(**_BATCH, device=dev)
        if engine == "ask_scan":
            tight = planner.CapacityPlan(
                buckets=(planner.BucketPlan(frames=tuple(range(5)),
                                            p_subdiv=0.1,
                                            capacities=(16, 16, 16)),),
                estimates=(), safety_factor=1.0)
            got, rep = solve_batch(p, _BATCH_BOUNDS, plan=tight)
            assert rep.retries > 0
        else:
            got, rep = solve_batch(p, _BATCH_BOUNDS, options=EngineOptions(
                engine=engine, plan=True))
        assert rep.overflow_dropped == 0 and got.device.type == \
            torch.device(dev).type
        canvases.append(got.cpu())
        reports.append(rep)
    worst, _ = ask.run_ask_scan_batch(FrameProblem(**_BATCH, device=card),
                                      _BATCH_BOUNDS, safety_factor=1e9)
    assert torch.equal(canvases[0], worst.cpu())
    assert torch.equal(canvases[0], canvases[1])
    for f in ("dispatches", "retries", "retried_frames", "ring_rows",
              "region_counts", "frame_leaf_counts", "frame_p_subdiv"):
        assert getattr(reports[0], f) == getattr(reports[1], f), f


# -- sharded frames and the split scan -------------------------------------------

_STATS = ("levels", "kernel_launches", "region_counts", "leaf_count",
          "overflow_dropped", "frame_overflow", "frame_leaf_counts",
          "olt_caps", "ring_rows")


@pytest.mark.gpu
def test_make_frames_mesh_raises_without_a_card(monkeypatch):
    """No quiet CPU mesh: without a card the default mesh raises (this
    needs no card, and runs on the CPU as well)."""
    from repro_torch.launch.mesh import make_frames_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_frames_mesh()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
@pytest.mark.parametrize("pad_to", [None, 8])
def test_sharded_batch_equals_unsharded_on_card(card, engine, pad_to):
    """Every visible card is one shard; the sharded batch equals the
    unsharded one on the card, canvases and every stat, at worst case and
    at an undersized ring (but the pool's ring, which pad_to sizes for a
    full shard of 8 frames, as in JAX)."""
    from repro_torch.launch.mesh import make_frames_mesh
    from repro_torch.workloads import EngineOptions, solve_batch
    mesh = make_frames_mesh()
    assert mesh.size == torch.cuda.device_count()
    p = FrameProblem(**_BATCH, device=card)
    for kw in (dict(safety_factor=1e9), dict(capacities=(16, 60, 200))):
        got, st = solve_batch(p, _BATCH_BOUNDS, options=EngineOptions(
            engine=engine, mesh=mesh, pad_to=pad_to, **kw))
        want, wst = solve_batch(p, _BATCH_BOUNDS, options=EngineOptions(
            engine=engine, **kw))
        assert got.device == mesh.devices[0] and torch.equal(got, want)
        sized = engine == "ask_pooled" and pad_to and "capacities" not in kw
        for f in _STATS:
            if not (sized and f in ("olt_caps", "ring_rows")):
                assert getattr(st, f) == getattr(wst, f), f


@pytest.mark.gpu
def test_dispatch_and_split_make_no_host_sync_on_card(card):
    """dispatch_batch (both engines), dispatch_progressive with its
    refine() and the batched split return with no host sync (after a
    warm call that captures the split's graphs); their results equal the
    unsplit, unsharded engines'."""
    from repro_torch.core import progressive
    from repro_torch.launch.mesh import make_frames_mesh
    from repro_torch.workloads import EngineOptions, dispatch_batch, solve_batch
    mesh = make_frames_mesh()
    p = FrameProblem(**_BATCH, device=card)
    progressive.run_ask_scan_progressive(p, safety_factor=1e9)  # capture
    dispatch_batch(p, _BATCH_BOUNDS, mesh=mesh).finalize()  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d_scan = dispatch_batch(p, _BATCH_BOUNDS, mesh=mesh)
        d_pool = dispatch_batch(p, _BATCH_BOUNDS, options=EngineOptions(
            engine="ask_pooled", mesh=mesh))
        coarse = progressive.dispatch_progressive(p, safety_factor=1e9)
        refine = coarse.refine()
        coarse_b = progressive.dispatch_progressive_batch(p, _BATCH_BOUNDS)
        refine_b = coarse_b.refine()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(d_scan.finalize()[0], solve_batch(p, _BATCH_BOUNDS)[0])
    assert torch.equal(d_pool.finalize()[0],
                       solve_batch(p, _BATCH_BOUNDS, options="ask_pooled")[0])
    assert torch.equal(refine.finalize()[0],
                       solve(p, "ask_scan", safety_factor=1e9)[0])
    assert torch.equal(refine_b.finalize()[0],
                       ask.run_ask_scan_batch(p, _BATCH_BOUNDS)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_split_scan_equals_ask_scan_replay_on_card(card, workload):
    """The refined canvas equals the ask_scan replay's and the CPU split's,
    stats too, two launches; the preview equals the CPU path's. Two
    frames in flight on the same graphs, refined out of order (the second
    coarse replay spills the first's carry), each equal its own scan."""
    from repro_torch.core import progressive
    kw = dict(n=256, g=4, r=2, B=16, max_dwell=128, workload=workload)
    p = FrameProblem(**kw, device=card)
    cpu = FrameProblem(**kw, device="cpu")
    for k in (None, 0, 3):
        pre, state, st = progressive.run_ask_scan_progressive(
            p, checkpoint_level=k, safety_factor=1e9)
        want, wst = solve(p, "ask_scan", safety_factor=1e9)
        cpre, cstate, cst = progressive.run_ask_scan_progressive(
            cpu, checkpoint_level=k, safety_factor=1e9)
        assert torch.equal(state, want)
        _mismatch_ok(state, cstate)  # A: the dwell kernels' tolerance
        assert torch.equal(pre.cpu(), cpre)  # Q and T: exact
        assert st.kernel_launches == 2 and st.overflow_dropped == 0
        assert (st.region_counts, st.leaf_count) == \
            (wst.region_counts, wst.leaf_count) == \
            (cst.region_counts, cst.leaf_count)
    zoom = FrameProblem(**dict(kw, bounds=(-0.8, 0.0, -0.6, 0.2)), device=card)
    first = progressive.dispatch_progressive(p, safety_factor=1e9)
    second = progressive.dispatch_progressive(zoom, safety_factor=1e9)
    s2, _ = second.refine().finalize()
    s1, _ = first.refine().finalize()
    assert torch.equal(s1, solve(p, "ask_scan", safety_factor=1e9)[0])
    assert torch.equal(s2, solve(zoom, "ask_scan", safety_factor=1e9)[0])


# -- serving: read-backs that wait only for their own chunk ---------------------

def _mixed_bounds(n_sparse=6, n_dense=2):
    """tests/test_pooled.py ``_mixed_bounds``: a sparse majority and a
    deep seahorse tail, as [F, 4] f32."""
    def window(cx, cy, w):
        return (cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2)

    sparse = [window(-0.5, 0.0, float(w))
              for w in np.geomspace(16.0, 4.0, n_sparse)]
    dense = [window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k)
             for k in np.linspace(4, 10, n_dense)]
    return np.asarray(sparse + dense, np.float32)


_FULL = dict(n=16384, g=4, r=2, B=32, max_dwell=512)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_finalize_waits_only_for_its_own_chunk_on_card(card, engine):
    """Chunk k (8 frames at n=1024), then a heavy chunk k+1 (8 frames at
    n=16384, about 33 ms of device time) on the same stream: chunk k's
    ``finalize()`` returns while chunk k+1's event is still pending, and
    both results equal ``solve_batch``."""
    from repro_torch.launch.mesh import make_frames_mesh
    from repro_torch.workloads import EngineOptions, dispatch_batch, solve_batch
    mesh = make_frames_mesh(1)
    bounds = _mixed_bounds()
    small = FrameProblem(**dict(_FULL, n=1024), device=card)
    heavy = FrameProblem(**_FULL, device=card)
    opts = EngineOptions(engine=engine, mesh=mesh, safety_factor=1e9)
    for p in (small, heavy):  # warm: libraries, scratch, pinned buffers
        dispatch_batch(p, bounds, options=opts).finalize()
    torch.cuda.synchronize()
    dk = dispatch_batch(small, bounds, options=opts)
    dk1 = dispatch_batch(heavy, bounds, options=opts)
    got_k, st_k = dk.finalize()
    pending = not dk1.ready.query()
    got_k1, st_k1 = dk1.finalize()
    assert dk1.ready.query()
    assert pending, "finalize() of chunk k waited for chunk k+1"
    plain = EngineOptions(engine=engine, safety_factor=1e9)
    for got, st, p in ((got_k, st_k, small), (got_k1, st_k1, heavy)):
        want, wst = solve_batch(p, bounds, options=plain)
        assert torch.equal(got, want)
        for f in _STATS:
            assert getattr(st, f) == getattr(wst, f), f
        del want


@pytest.mark.gpu
def test_preview_host_copy_does_not_wait_for_refine_on_card(card):
    """The split batch of 8 deep frames at n=1024 with max_dwell 2^18 (a
    long refine, a 32 MiB preview): ``refine()`` enqueued first, then the
    preview's host copy (``readback.to_host`` on the coarse half's
    event) completes while the refine's event is still pending; the
    preview equals its device tensor and the refined canvases the
    batched scan's."""
    from repro_torch.core import progressive, readback
    p = FrameProblem(**dict(_FULL, n=1024, max_dwell=1 << 18), device=card)
    bounds = _mixed_bounds(0, 8)
    progressive.dispatch_progressive_batch(p, bounds).refine().finalize()
    torch.cuda.synchronize()
    coarse = progressive.dispatch_progressive_batch(p, bounds)
    refine = coarse.refine()
    host = readback.to_host(coarse.preview(block_until_ready=False),
                            coarse.ready)
    pending = not refine.ready.query()
    states, st = refine.finalize()
    assert pending, "the preview's host copy waited for the refine"
    assert isinstance(host, np.ndarray) and host.shape == (8, 1024, 1024)
    assert np.array_equal(host, coarse.preview().cpu().numpy())
    want, wst = ask.run_ask_scan_batch(p, bounds)
    assert torch.equal(states, want)
    assert (st.region_counts, st.frame_leaf_counts) == \
        (wst.region_counts, wst.frame_leaf_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("feedback", [False, True])
def test_render_service_pipelined_on_card(card, tmp_path, feedback):
    """A short pipelined stream through ``RenderService`` on the card
    (n=1024, chunk 4, depth 2): the stacked host canvases equal one
    worst-case ``solve_batch`` of all frames; on the feedback path at a
    hostile safety factor the retried frames are patched in on the
    device and nothing drops. The CLI runs on the card too."""
    from repro_torch.launch import render_service as trs
    from repro_torch.workloads import solve_batch
    p = FrameProblem(**dict(_FULL, n=1024), device=card)
    kw = (dict(feedback=True, safety_factor=0.4) if feedback
          else dict(safety_factor=1e9))
    svc = trs.RenderService(p, chunk_frames=4, **kw)
    bounds = list(trs.zoom_bounds(14, center=(-0.7436447860, 0.1318252536),
                                  width0=6.0, zoom_per_frame=1.3))
    seen = []
    canv, rs = svc.render(bounds, sink=lambda c, s: seen.append(c.shape))
    want, _ = solve_batch(p, np.asarray(bounds, np.float32),
                          safety_factor=1e9)
    assert isinstance(canv, np.ndarray)
    assert np.array_equal(canv, want.cpu().numpy())
    assert rs.overflow_dropped == 0 and rs.frames == 14
    assert seen == [(c.frames, 1024, 1024) for c in rs.chunk_stats]
    assert max(c.in_flight for c in rs.chunk_stats) == 2
    if feedback:
        assert rs.retries > 0
    else:
        assert rs.program_traces == 1 and rs.dispatches == rs.chunks == 4
        assert trs.main(["--n", "256", "--frames", "16", "--chunk", "4"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_service_dispatch_makes_no_host_sync_on_card(card, engine):
    """``RenderService._dispatch`` -- uniform and at a planned capacity
    vector -- returns with no host sync (``set_sync_debug_mode("error")``);
    what it enqueued equals ``solve_batch``."""
    from repro_torch.launch import render_service as trs
    from repro_torch.workloads import EngineOptions, solve_batch
    p = FrameProblem(**dict(_FULL, n=1024), device=card)
    bounds = [tuple(float(x) for x in b) for b in _mixed_bounds()[:4]]
    for kw in (dict(safety_factor=1e9), dict(feedback=True)):
        svc = trs.RenderService(p, chunk_frames=4, engine=engine, **kw)
        caps = None
        if "feedback" in kw:
            ps = [svc.estimator.predict_quantized(svc._depth("", b),
                                                  workload=p.workload)
                  for b in bounds]
            caps = (svc._pooled_caps_for("", ps) if engine == "ask_pooled"
                    else svc._caps_for("", max(ps)))
        svc._dispatch(bounds, caps=caps)[0].finalize()  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d, secs = svc._dispatch(bounds, caps=caps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got, st = d.finalize()
        assert secs >= 0
        opts = dict(capacities=caps) if caps else dict(safety_factor=1e9)
        want, _ = solve_batch(p, np.asarray(bounds, np.float32),
                              options=EngineOptions(engine=engine, **opts))
        assert torch.equal(got, want)


# -- the MoE slice: batched ranks and serving ----------------------------------

def _rank_flags(kind, G, N, E, dtype, device):
    if kind == "zeros":
        f = torch.zeros((G, N, E), dtype=torch.int32)
    elif kind == "ones":
        f = torch.ones((G, N, E), dtype=torch.int32)
    else:
        gen = torch.Generator().manual_seed(G * 7919 + N * 31 + E)
        f = (torch.rand((G, N, E), generator=gen) < 0.3).to(torch.int32)
    return f.to(dtype).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 64, 160])
@pytest.mark.parametrize("N", [1, 31, 48, 6144, 65537])
@pytest.mark.parametrize("G", [1, 4])
def test_batched_ranks_kernel_matches_plain_on_card(card, G, N, E):
    """Integers, exactly, in one launch: a column in one tile and columns
    chained by look-back over many tiles, bool and int32 flags."""
    from repro_torch.kernels import moe_dispatch, ref
    for dtype in (torch.bool, torch.int32):
        for kind in ("zeros", "ones", "random"):
            f = _rank_flags(kind, G, N, E, dtype, card)
            start = moe_dispatch.batched_ranks.launches
            r, c = moe_dispatch.batched_ranks(f)
            pr, pc = ref.batched_ranks(f)
            torch.cuda.synchronize()
            assert moe_dispatch.batched_ranks.launches == start + 1
            assert r.dtype == torch.int32 and c.dtype == torch.int32
            assert torch.equal(r, pr), (dtype, kind)
            assert torch.equal(c, pc), (dtype, kind)
    # JAX's [N, E] contract through ops
    f = _rank_flags("random", 1, N, E, torch.int32, card)[0]
    r, c = ops.batched_ranks(f)
    pr, pc = ref.batched_ranks(f[None])
    assert torch.equal(r, pr[0]) and torch.equal(c, pc[0])


def _flags(seed, shape, dtype, device):
    """Flags from a seed: bool, or int32 of values 0..3 (a flag adds its
    value)."""
    gen = torch.Generator().manual_seed(seed)
    f = torch.randint(0, 4, shape, generator=gen, dtype=torch.int32)
    return (f > 2 if dtype == torch.bool else f).to(device)


# the main path's prefill and decode shapes, 70,000 groups in one and in two
# tiles, and one column of 65,535 x 512 + 1 rows; a larger shape comes
# before each smaller one, so a stale look-back word would show
RANK_SHAPES = [(1, 65535 * 512 + 1, 1), (70_000, 300, 2), (4, 6144, 64),
               (70_000, 3, 2), (2, 1000, 96), (1, 48, 64), (4, 6144, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_batched_ranks_every_shape_one_launch_on_card(card, dtype):
    from repro_torch.kernels import moe_dispatch, ref
    for i, shape in enumerate(RANK_SHAPES):
        for seed in (2 * i, 2 * i + 1):  # twice, with other flags
            f = _flags(seed, shape, dtype, card)
            start = moe_dispatch.batched_ranks.launches
            r, c = moe_dispatch.batched_ranks(f)
            assert moe_dispatch.batched_ranks.launches == start + 1
            pr, pc = ref.batched_ranks(f)
            torch.cuda.synchronize()
            assert torch.equal(r, pr), (shape, seed)
            assert torch.equal(c, pc), (shape, seed)
            del f, r, c, pr, pc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_batched_ranks_tile_edges_on_card(card, dtype):
    """Columns at the edges of the two tiles (128 and 512 rows), in one tile
    and chained, with E a multiple of 4 (16-byte loads) and not."""
    from repro_torch.kernels import moe_dispatch, ref
    for i, shape in enumerate([(3, 128, 64), (3, 129, 33), (2, 512, 64),
                               (2, 513, 40), (1, 4097, 7), (1, 100_000, 1)]):
        for seed in (2 * i, 2 * i + 1):
            f = _flags(seed, shape, dtype, card)
            r, c = moe_dispatch.batched_ranks(f)
            pr, pc = ref.batched_ranks(f)
            assert torch.equal(r, pr) and torch.equal(c, pc), (shape, seed)


@pytest.mark.gpu
def test_batched_ranks_graph_replays_on_card(card):
    """Two CUDA graphs of chained calls, replayed in turn with new flags:
    the scratch is made by a warm-up call on the capture stream, so neither
    graph holds a zeroing of it, and the epoch carries across replays and
    from one graph to the other."""
    from repro_torch.kernels import moe_dispatch, ref
    f = _flags(0, (4, 6144, 64), torch.int32, card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        moe_dispatch.batched_ranks(f)
    torch.cuda.synchronize()
    made = dict(moe_dispatch._SCRATCH)
    graphs, outs = [], []
    for _ in range(2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            outs.append([moe_dispatch.batched_ranks(f) for _ in range(3)])
        graphs.append(g)
    assert moe_dispatch._SCRATCH.keys() == made.keys()
    assert all(moe_dispatch._SCRATCH[k] is v for k, v in made.items())
    for seed in (1, 2, 3, 4, 5):
        f.copy_(_flags(seed, f.shape, torch.int32, card))
        graphs[seed % 2].replay()
        pr, pc = ref.batched_ranks(f)
        torch.cuda.synchronize()
        for r, c in outs[seed % 2]:
            assert torch.equal(r, pr) and torch.equal(c, pc), seed


@pytest.mark.gpu
def test_batched_ranks_no_scratch_made_under_capture_on_card(card):
    """A chained call that a graph captures on a stream with no scratch of
    its size raises, and makes none."""
    from repro_torch.kernels import moe_dispatch
    # more look-back words than any other test's call makes on a stream
    f = _flags(0, (16, 6144, 64), torch.int32, card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = dict(moe_dispatch._SCRATCH)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(g, stream=side):
            moe_dispatch.batched_ranks(f)
    torch.cuda.synchronize()
    assert moe_dispatch._SCRATCH.keys() == before.keys()
    assert all(moe_dispatch._SCRATCH[k] is v for k, v in before.items())


@pytest.mark.gpu
def test_batched_ranks_bad_inputs_on_card(card):
    from repro_torch.kernels import moe_dispatch
    f = torch.zeros((2, 8, 4), dtype=torch.int32, device=card)
    for bad in (f.long(), f.float(), f[0], f.transpose(1, 2)):
        with pytest.raises(ValueError):
            moe_dispatch.batched_ranks(bad)
    start = moe_dispatch.batched_ranks.launches
    r, c = moe_dispatch.batched_ranks(f[:, :0])  # N = 0: nothing to launch
    assert r.shape == (2, 0, 4) and torch.equal(c, torch.zeros_like(c))
    assert moe_dispatch.batched_ranks.launches == start


@pytest.mark.gpu
def test_top_k_ties_on_card(card):
    """The MoE's top-k keeps JAX's tie order (lower index first)."""
    from repro_torch.models.moe import _top_k
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0]] * 3, device=card)
    vals, idx = _top_k(probs, 4)
    assert idx.cpu().tolist() == [[1, 2, 4, 3]] * 3
    # many equal probabilities across 64 experts, as bf16 rounding makes them
    p = torch.full((16, 64), 1 / 64, device=card)
    assert torch.equal(_top_k(p, 6)[1].cpu(), torch.arange(6).expand(16, 6))


def _served_logits(cfg, model, prompt, tokens):
    """The logits of each generated token: the prefill, then a decode step
    on each generated token but the last (the serve loop's own steps)."""
    from repro_torch.models import transformer as T
    P, gen = prompt.shape[1], tokens.shape[1]
    with torch.no_grad():
        logits, cache = T.prefill(cfg, model, prompt, cache_len=P + gen)
        out = [logits]
        for i in range(gen - 1):
            logits, cache = T.decode_step(cfg, model, cache, tokens[:, i:i + 1],
                                          P + i)
            out.append(logits)
    return out


@pytest.mark.gpu
def test_serving_on_card_matches_cpu_full_width(card):
    """moonshot-v1-16b-a3b at full width with 1 layer in f32: B=2, P=16,
    4 tokens. Tokens identical; logits within 1e-4 (f32 on both, TF32 off:
    only the order of the sums differs)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=1,
                              param_dtype="float32", compute_dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        model = init_params(cfg, seed=3, device=card)
        cpu_model = copy.deepcopy(model).to("cpu")
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        start = moe_dispatch.batched_ranks.launches
        got = generate(cfg, model, toks.to(card), 4)
        torch.cuda.synchronize()
        assert moe_dispatch.batched_ranks.launches - start == 4  # 1 + 3 steps
        want = generate(cfg, cpu_model, toks, 4)
        assert torch.equal(got.tokens.cpu(), want.tokens)
        got_logits = _served_logits(cfg, model, toks.to(card), got.tokens)
        want_logits = _served_logits(cfg, cpu_model, toks, want.tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
    for a, b in zip(got_logits, want_logits, strict=True):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_moe_routing_on_card_matches_cpu(card, monkeypatch):
    """Reduced moonshot MoE with groups of 8 and dropping capacity: the
    batched ranks and counts (the kernel on the card, the plain scan on the
    CPU) equal, recorded from ``ops.batched_ranks``; y within 1e-5."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import Init
    from repro_torch.models.moe import MoE, moe_apply
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    mo = cfg.moe
    kw = dict(d_model=cfg.d_model, d_ff=mo.d_ff, num_experts=mo.num_experts,
              top_k=mo.top_k, act=cfg.act)
    p = MoE(Init(card, 0), **kw, dtype=torch.float32)
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator().manual_seed(0))
    run = dict(num_experts=mo.num_experts, top_k=mo.top_k, capacity_factor=0.5,
               group_size=8)
    calls, inner = [], ops.batched_ranks

    def recording(flags):
        ranks, counts = inner(flags)
        calls.append((flags, ranks, counts))
        return ranks, counts

    monkeypatch.setattr(ops, "batched_ranks", recording)
    y, _ = moe_apply(p, x.to(card), **run)
    cy, _ = moe_apply(copy.deepcopy(p).to("cpu"), x, **run)
    (f, r, c), (cf, cr, cc) = calls
    assert f.is_cuda and f.shape == (8, 8 * mo.top_k, mo.num_experts)
    for a, b in ((f, cf), (r, cr), (c, cc)):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(y.cpu(), cy, rtol=1e-5, atol=1e-5)


# -- the tuned tier's schedules and k-D SSD (slices 11 and 13) ------------------

SCHEDULED_KERNELS = ("dwell", "perimeter_query", "region_dwell",
                     "region_dwell_pooled")


@pytest.mark.gpu
def test_card_heuristics_are_the_defaults(card):
    """On the card the heuristic names each kernel's default schedule (the
    same instance as ``unroll=None``, the launch functions' 0), never the
    plain version, and a card's cache key names its capability."""
    from repro_torch.kernels import autotune
    major, minor = torch.cuda.get_device_capability(card)
    tw = treg.get_workload("julia")
    for kernel in SCHEDULED_KERNELS:
        choice = autotune.heuristic(kernel, device=card)
        assert choice.impl == "cuda"
        assert choice.param_dict() == autotune.DEFAULT_SCHEDULES[kernel]
    sched = autotune.DEFAULT_SCHEDULES["dwell"]
    assert torch.equal(
        mandelbrot_dwell(256, bounds=tw.default_bounds, max_dwell=64,
                         workload=tw, device=card),
        mandelbrot_dwell(256, bounds=tw.default_bounds, max_dwell=64,
                         workload=tw, device=card, **sched))
    for kernel in ("region_fill", "region_fill_pooled", "olt_compact",
                   "batched_ranks"):
        assert autotune.heuristic(kernel, device=card) == autotune.Choice("cuda")
    key = autotune.cache_key("dwell", n=64, max_dwell=32, device=card)
    assert f"|plat=cuda-sm_{major}{minor}|" in key


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_schedule_matches_plain_on_card(card, workload):
    """Every U (and Ex block) instance of every escape kernel equals the
    plain version at small sizes (the dwell does not depend on U), one
    launch a call; an unknown schedule raises."""
    tw = treg.get_workload(workload)
    b, n, md = tw.default_bounds, 256, 96
    want_ex = mandelbrot_dwell_plain(n, bounds=b, max_dwell=md, workload=tw,
                                     device=card)
    coords = torch.from_numpy(_olt(2, 40, 16)).to(card)
    count = torch.tensor([33], dtype=torch.int32, device=card)
    ph, pc = perimeter_query_plain(coords, count, side=16, n=n, bounds=b,
                                   max_dwell=md, workload=tw)
    base = torch.randint(0, 99, (n, n), dtype=torch.int32, device=card)
    want_a = region_dwell_plain(base.clone(), coords, count, side=16, n=n,
                                bounds=b, max_dwell=md, workload=tw)
    want_mbr = region_dwell_plain(base.clone(), coords, count, side=16, n=n,
                                  bounds=b, max_dwell=md, workload=tw)
    rows = torch.cat([torch.arange(40, device=card, dtype=torch.int32)[:, None] % 2,
                      coords], dim=1).contiguous()
    windows = np.asarray([b, (b[0] / 2, b[1] / 2, b[2] / 2, b[3] / 2)],
                         np.float32)
    planes = ops.pooled_planes(n, windows, card)
    banded = torch.randint(0, 99, (2 * n, n), dtype=torch.int32, device=card)
    want_pa = region_dwell_pooled_plain(banded.clone(), rows, count, planes,
                                        side=16, n=n, max_dwell=md, workload=tw)
    want_pq = perimeter_query_pooled_plain(rows, count, planes, side=16,
                                           max_dwell=md, workload=tw)
    for u in _build.UNROLLS:
        for blk in _build.EX_BLOCKS:
            _mismatch_ok(mandelbrot_dwell(n, bounds=b, max_dwell=md, workload=tw,
                                          device=card, unroll=u, block=blk),
                         want_ex)
        h, c = perimeter_query(coords, count, side=16, n=n, bounds=b,
                               max_dwell=md, workload=tw, unroll=u)
        assert torch.equal(h, ph) and torch.equal(c, pc)
        h, c = perimeter_query_pooled(rows, count, planes, side=16,
                                      max_dwell=md, workload=tw, unroll=u)
        assert torch.equal(h, want_pq[0]) and torch.equal(c, want_pq[1])
        start = region_dwell.launches
        _mismatch_ok(region_dwell(base.clone(), coords, count, side=16, n=n,
                                  bounds=b, max_dwell=md, workload=tw,
                                  unroll=u), want_a)
        _mismatch_ok(region_dwell(base.clone(), coords, count, side=16, n=n,
                                  bounds=b, max_dwell=md, scheme="mbr", tile=4,
                                  workload=tw, unroll=u), want_mbr)
        assert region_dwell.launches == start + 2
        _mismatch_ok(region_dwell_pooled(banded.clone(), rows, count, planes,
                                         side=16, n=n, max_dwell=md,
                                         workload=tw, unroll=u), want_pa)
    with pytest.raises(ValueError, match="unroll"):
        mandelbrot_dwell(n, bounds=b, device=card, unroll=2)
    with pytest.raises(ValueError, match="block"):
        mandelbrot_dwell(n, bounds=b, device=card, block=(32, 32))


@pytest.mark.gpu
def test_tune_on_card_times_cuda_schedules(card):
    """``tune`` on the card: every candidate is a CUDA schedule, held
    against the default's output before it is timed; the winner is cached
    under the card's key."""
    from repro_torch.kernels import autotune
    cache = autotune.TuningCache()
    for kernel, sig in (("dwell", dict(n=512, max_dwell=64)),
                        ("perimeter_query", dict(side=32, n=512, max_dwell=64)),
                        ("region_dwell", dict(side=32, n=512, max_dwell=64)),
                        ("olt_compact", dict(n=70000)),
                        ("region_fill_pooled", dict(side=32, n=512, F=2)),
                        ("region_dwell_pooled", dict(side=32, n=512, F=2,
                                                     max_dwell=64))):
        report = []
        best = autotune.tune(kernel, cache=cache, reps=2, device=card,
                             report=report, **sig)
        assert best.impl == "cuda" and best.us > 0
        assert sum(r["default"] for r in report) == 1
        assert len(report) == {"dwell": 9, "perimeter_query": 3,
                               "region_dwell": 3, "region_dwell_pooled": 3}.get(
                                   kernel, 1)
        key = autotune.cache_key(kernel, device=card, **sig)
        assert cache.get(key) == best and "|plat=cuda-sm_" in key


@pytest.mark.gpu
def test_ask_tuned_forced_schedule_replays_its_own_graph(card, tmp_path):
    """A cache that forces U=4 on Q and A (and Ex's 4 x 32 block): the tuned
    problem captures a graph of its own, its kernels are the U=4 instances
    where ask_scan's are the defaults, and the canvas equals ask_scan's."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.policy import KernelPolicy
    kw = dict(n=1024, g=4, r=2, B=32, max_dwell=128)
    p = FrameProblem(**kw, device=card)
    cache = autotune.TuningCache()
    side = kw["n"] // kw["g"]
    while side >= kw["B"]:
        for kernel in ("perimeter_query", "region_dwell"):
            cache.put(autotune.cache_key(kernel, device=card, side=side,
                                         n=kw["n"], max_dwell=kw["max_dwell"]),
                      autotune.Choice("cuda", (("unroll", 4),)))
        side //= 2
    path = tmp_path / "tc.json"
    cache.save(str(path))
    autotune.clear_memo()
    graphs.release()

    def names(fn):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, {e.key for e in prof.key_averages()
                     if "query_kernel" in e.key or "dwell_kernel" in e.key}

    (want, want_st), scan_names = names(lambda: solve(p, "ask_scan",
                                                      safety_factor=1e9))
    held = graphs.held()[0]
    tuned = FrameProblem(**kw, device=card,
                         policy=KernelPolicy(tuning_cache=str(path)))
    (got, st), tuned_names = names(lambda: solve(tuned, "ask_tuned",
                                                 safety_factor=1e9))
    assert graphs.held()[0] == held + 1  # a graph of its own
    assert torch.equal(got, want) and st.region_counts == want_st.region_counts
    assert st.kernel_launches == 1
    assert scan_names and tuned_names and not scan_names & tuned_names
    assert all(", 4>" in k for k in tuned_names)
    assert all(", 16>" in k for k in scan_names)
    again, _ = solve(tuned, "ask_tuned", safety_factor=1e9)  # a replay
    assert torch.equal(again, want) and graphs.held()[0] == held + 1
    graphs.release()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["ex", "ask", "ask_scan", "ask_tuned",
                                    "ask_fused", "ask_pooled"])
def test_ssd_synth_on_card_equals_cpu(card, engine):
    """The grid workload on the card: Q and A take the plain path there
    (no host sync, so the one-dispatch engines capture it), T and the scan
    launch their kernels; the canvas equals the CPU's and the field."""
    from repro_torch.core.ssd_synth import generate_field
    spec = treg.ssd_synth(seed=3, n_field=128, g=4, r=2, B=16, P=0.7)
    field = generate_field(3, n=128, g=4, r=2, B=16, P=0.7, k=2).field
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=64, workload=spec)
    extra = {"safety_factor": 1e9} if engine in ("ask_scan", "ask_tuned",
                                                 "ask_pooled") else {}
    scan = olt_compact.compact_ranks
    start = (region_fill.launches, scan.launches, region_fill_pooled.launches,
             perimeter_query.launches, region_dwell.launches,
             mandelbrot_dwell.launches)
    got, _ = solve(FrameProblem(**kw, device=card), engine, **extra)
    torch.cuda.synchronize()
    want, _ = solve(FrameProblem(**kw, device="cpu"), engine, **extra)
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), field)
    ran = (region_fill.launches, scan.launches, region_fill_pooled.launches,
           perimeter_query.launches, region_dwell.launches,
           mandelbrot_dwell.launches)
    fills = ran[2] - start[2] if engine == "ask_pooled" else ran[0] - start[0]
    assert ran[3:] == start[3:]  # no escape kernel
    if engine != "ex":
        assert fills > 0 and ran[1] > start[1]
    graphs.release()


@pytest.mark.gpu
def test_k_d_ssd_on_card(card):
    """The scalar OLT and the codecs on the card equal the CPU's; the 3-D
    solver reconstructs its field there, its compactions through the scan
    kernel."""
    from repro_torch.core import olt
    from repro_torch.core.ssd_synth import generate_field, solve_ask_3d
    rng = np.random.default_rng(0)
    p3 = torch.from_numpy(rng.integers(0, 1 << 10, size=(500, 3)).astype(np.int32))
    codes = olt.morton_encode3d(p3)
    assert torch.equal(olt.morton_encode3d(p3.to(card)).cpu(), codes)
    assert torch.equal(olt.morton_decode3d(codes.to(card)).cpu(), p3)
    flags = torch.from_numpy(rng.integers(0, 2, size=500).astype(bool))
    start = olt_compact.compact_ranks.launches
    got, gc = olt.subdivide_olt_scalar(codes.to(card), flags.to(card), k=3,
                                       capacity=4096)
    assert olt_compact.compact_ranks.launches == start + 1
    want, wc = olt.subdivide_olt_scalar(codes, flags, k=3, capacity=4096)
    assert torch.equal(got.cpu(), want) and int(gc) == int(wc)
    fld = generate_field(0, n=64, g=2, r=2, B=4, P=0.6, k=3)
    canvas, counts = solve_ask_3d(fld, device=card)
    np.testing.assert_array_equal(canvas.cpu().numpy(), fld.field)
    assert counts == fld.level_counts


# -- the decoder families: MLA, Mamba, xLSTM, the int8 cache -----------------

FAMILIES = ("deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-350m")


def _f32_on_card(card, threads=8):
    """TF32 off and torch's CPU threads raised, for a card-vs-CPU test;
    returns the settings to restore."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(threads)
    return saved


def _restore(saved):
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_num_threads(saved[1])


def _teacher_forcing(cfg, model, toks, P, media=None):
    """forward's logits and those of prefill(prompt) + decode_step(token t)
    at each position from P - 1 on; ``media`` goes to forward and prefill,
    and its memory (``make_memory``) to each step."""
    from repro_torch.models import transformer as T
    S = toks.shape[1]
    with torch.no_grad():
        kw = {"memory": T.make_memory(cfg, model, media)}
        full, _ = T.forward(cfg, model, toks, media)
        lp, cache = T.prefill(cfg, model, toks[:, :P], media, cache_len=S)
        steps = [lp]
        for t in range(P, S):
            ld, cache = T.decode_step(cfg, model, cache, toks[:, t:t + 1], t, **kw)
            steps.append(ld)
    return full[:, P - 1:], torch.stack(steps, dim=1), cache


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_teacher_forcing_on_card(card, arch):
    """Reduced config, f32, TF32 off, a capacity factor at which nothing
    drops: on the card prefill + decode equal forward, and every logit
    equals the CPU port's, within rtol / atol 1e-4 (only the order of the
    sums differs)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    saved = _f32_on_card(card)
    try:
        model = init_params(cfg, seed=4, device=card)
        cpu_model = copy.deepcopy(model).to("cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(4))
        start = moe_dispatch.batched_ranks.launches
        full, steps, _ = _teacher_forcing(cfg, model, toks.to(card), 6)
        torch.cuda.synchronize()
        launches = moe_dispatch.batched_ranks.launches - start
        cfull, csteps, _ = _teacher_forcing(cfg, cpu_model, toks, 6)
    finally:
        _restore(saved)
    moe_layers = cfg.num_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    assert launches == moe_layers * (1 + 1 + 6)  # forward, prefill, 6 steps
    assert torch.isfinite(steps).all()
    torch.testing.assert_close(steps, full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(steps.cpu(), csteps, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(full.cpu(), cfull, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b"])
def test_int8_cache_on_card_matches_cpu(card, arch):
    """The int8 cache after prefill and each decode step, on the card and on
    the CPU, same parameters and tokens, f32, TF32 off: the int8 values
    within one count (a value whose quotient lies within rounding of .5 may
    round either way), the scales and the logits within rtol / atol 1e-4."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_cache_dtype="int8")
    attn_slots = sum(s.mixer == "attn" for s in cfg.pattern)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    saved = _f32_on_card(card)
    try:
        model = T.init_params(cfg, seed=5, device=card)
        cpu_model = copy.deepcopy(model).to("cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(5))
        runs = []
        for m, t in ((model, toks.to(card)), (cpu_model, toks)):
            with torch.no_grad():
                lp, cache = T.prefill(cfg, m, t[:, :6], cache_len=12)
                out = [(lp, {k: {n: x.clone() for n, x in c.items()}
                             for k, c in cache.items()})]
                for pos in range(6, 12):
                    ld, cache = T.decode_step(cfg, m, cache, t[:, pos:pos + 1], pos)
                    out.append((ld, {k: {n: x.clone() for n, x in c.items()}
                                     for k, c in cache.items()}))
            runs.append(out)
    finally:
        _restore(saved)
    quantised = 0
    for (gl, gc), (wl, wc) in zip(*runs, strict=True):
        torch.testing.assert_close(gl.cpu(), wl, rtol=1e-4, atol=1e-4)
        for slot, leaves in wc.items():
            for name, want in leaves.items():
                got = gc[slot][name].cpu()
                if want.dtype == torch.int8:
                    quantised += 1
                    assert int((got.int() - want.int()).abs().max()) <= 1, name
                else:
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert quantised == 7 * 2 * attn_slots  # k_q, v_q of 7 snapshots


# the families' MoE flag shapes [G, N, E] on the serving path (8 requests of
# 512 tokens, groups of 1024 tokens; decode 8 tokens): deepseek (E=64,
# K=6) and jamba (E=16, K=2)
FAMILY_RANK_SHAPES = [(4, 1024 * 6, 64, 6), (1, 8 * 6, 64, 6),
                      (4, 1024 * 2, 16, 2), (1, 8 * 2, 16, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("G,N,E,K", FAMILY_RANK_SHAPES)
def test_batched_ranks_at_family_shapes_on_card(card, G, N, E, K):
    """The kernel at deepseek's and jamba's shapes, on routing-like flags
    (each token's K experts distinct, one flag a row, as the MoE makes
    them) and on random flags: equal to the plain version, one launch a
    call."""
    from repro_torch.kernels import moe_dispatch, ref
    gen = torch.Generator().manual_seed(G * N + E)
    ids = torch.argsort(torch.rand((G, N // K, E), generator=gen), dim=-1)[..., :K]
    routed = torch.zeros((G, N, E), dtype=torch.int32)
    routed.scatter_(2, ids.reshape(G, N, 1), 1)
    for f in (routed.to(card), _flags(E, (G, N, E), torch.int32, card)):
        start = moe_dispatch.batched_ranks.launches
        r, c = moe_dispatch.batched_ranks(f)
        pr, pc = ref.batched_ranks(f)
        torch.cuda.synchronize()
        assert moe_dispatch.batched_ranks.launches == start + 1
        assert torch.equal(r, pr) and torch.equal(c, pc)


@pytest.mark.gpu
def test_adaptive_decode_attention_on_card_matches_cpu(card):
    """ASK-refined decode attention on the card: the kept blocks equal the
    CPU's, the output within rtol / atol 1e-5 (f32)."""
    from repro_torch.core.adaptive_attention import (adaptive_decode_attention,
                                                     exact_decode_attention)
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((2, 4, 32), generator=gen)
    k = 0.3 * torch.randn((2, 1024, 4, 32), generator=gen)
    v = torch.randn((2, 1024, 4, 32), generator=gen)
    k[:, 100:108] = 3.0 * q[:, None]  # a dense region
    kw = dict(g=16, r=2, B=32, margin=12.0, capacity=8, live_len=1000)
    got, st = adaptive_decode_attention(q.to(card), k.to(card), v.to(card), **kw)
    want, wst = adaptive_decode_attention(q, k, v, **kw)
    assert torch.equal(st["kept_blocks"].cpu(), wst["kept_blocks"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        exact_decode_attention(q.to(card), k.to(card), v.to(card)).cpu(),
        exact_decode_attention(q, k, v), rtol=1e-5, atol=1e-5)


# -- the encoder-decoder and cross-attention families ---------------------------

CROSS = ("whisper-large-v3", "llama-3.2-vision-90b")


def _media_of(cfg, seed):
    """Vision's media [2, num_media_tokens, D] or whisper's frames
    [2, 10, D], normal, on the CPU."""
    M = cfg.num_media_tokens or 10
    return torch.randn((2, M, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", CROSS)
def test_cross_family_teacher_forcing_on_card(arch, card):
    """Reduced config, f32, TF32 off: on the card prefill + decode (against
    the encoder's memory, or the media) equal forward, and every logit
    equals the CPU port's, within rtol / atol 1e-4."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    saved = _f32_on_card(card)
    try:
        model = init_params(cfg, seed=7, device=card)
        cpu_model = copy.deepcopy(model).to("cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(7))
        media = _media_of(cfg, 7)
        full, steps, _ = _teacher_forcing(cfg, model, toks.to(card), 6,
                                          media.to(card))
        cfull, csteps, _ = _teacher_forcing(cfg, cpu_model, toks, 6, media)
    finally:
        _restore(saved)
    assert torch.isfinite(steps).all()
    torch.testing.assert_close(steps, full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(steps.cpu(), csteps, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(full.cpu(), cfull, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_encode_and_cross_layer_on_card_match_cpu(card):
    """whisper's encoder (reduced, f32, TF32 off) and one cross-attention
    layer at vision's full head layout (64 query heads over 8 KV heads,
    head_dim 128; 16 queries over 512 memory rows): the card's output
    within rtol / atol 1e-4 of the CPU port's on the same inputs."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.common import Init
    from repro_torch.models.transformer import encode, init_params
    cfg = get_config("whisper-large-v3").reduced()
    vision = get_config("llama-3.2-vision-90b")
    dims = dict(num_heads=vision.num_heads, num_kv_heads=vision.num_kv_heads,
                head_dim=vision.head_dim_)
    D = 1024  # the layer's width, cut from 8192 to keep the CPU side short
    saved = _f32_on_card(card)
    try:
        model = init_params(cfg, seed=8, device=card)
        cpu_model = copy.deepcopy(model).to("cpu")
        frames = _media_of(cfg, 8)
        with torch.no_grad():
            got, want = encode(cfg, model, frames.to(card)), encode(cfg, cpu_model,
                                                                    frames)
        layer = A.Attention(Init(card, 9), d_model=D, **dims)
        cpu_layer = copy.deepcopy(layer).to("cpu")
        gen = torch.Generator().manual_seed(9)
        x, mem = torch.randn((2, 16, D), generator=gen), torch.randn(
            (2, 512, D), generator=gen)
        with torch.no_grad():
            cg = A.attn_train(layer, x.to(card), kv_x=mem.to(card), **dims)
            cw = A.attn_train(cpu_layer, x, kv_x=mem, **dims)
    finally:
        _restore(saved)
    assert got.shape == frames.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert cg.shape == (2, 16, D)
    torch.testing.assert_close(cg.cpu(), cw, rtol=1e-4, atol=1e-4)


# -- training (slice 14.7) ------------------------------------------------------

def _train_state_to(state, device):
    """A copy of a train state on ``device``: the model and every tensor."""
    import copy

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(device, copy=True)
                for k, v in tree.items()}

    return {"params": copy.deepcopy(state["params"]).to(device),
            **move({k: v for k, v in state.items() if k != "params"})}


def _leafwise_close(got: dict, want: dict, rel=1e-4):
    """Every tensor of ``got`` within ``rel`` of the largest |value| of its
    counterpart in ``want``."""
    assert list(got) == list(want)
    for n, w in want.items():
        w = w.detach().float()
        err = float((got[n].detach().cpu().float() - w).abs().max())
        assert err <= rel * float(w.abs().max()), f"{n}: {err:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_moe_train_step_on_card_matches_cpu(card, remat):
    """moonshot-v1-16b-a3b reduced, f32, TF32 off, nothing dropped: the
    loss and every gradient on the card (the batched-ranks kernel, under
    autograd and, with remat, in the recomputation) within 1e-4 of each
    leaf's largest value on the CPU; then 3 train steps each side, the
    parameters, master weights, m and v as close, the losses within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepOptions
    from repro_torch.models import transformer as T
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg, remat=remat, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    step, init_state = train.build(cfg, StepOptions(), device=card)
    saved = _f32_on_card(card)
    try:
        state = init_state(11)
        cpu = _train_state_to(state, "cpu")
        gen = torch.Generator().manual_seed(11)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen),
                    "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)}
                   for _ in range(3)]
        grads = {}
        for name, st, dev in (("card", state, card), ("cpu", cpu, "cpu")):
            model = st["params"]
            b = {k: v.to(dev) for k, v in batches[0].items()}
            start = moe_dispatch.batched_ranks.launches
            loss, _ = T.loss_fn(cfg, model, b)
            g = torch.autograd.grad(loss, list(model.parameters()))
            grads[name] = (loss.detach(), dict(zip(dict(model.named_parameters()), g)))
            if name == "card":
                torch.cuda.synchronize()
                assert moe_dispatch.batched_ranks.launches - start == T.moe_forwards(cfg)
        (lc, gc), (lp, gp) = grads["card"], grads["cpu"]
        assert abs(float(lc) - float(lp)) <= 1e-4 * abs(float(lp))
        _leafwise_close(gc, gp)
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(card) for k, v in b.items()})
            cpu, mc = step(cpu, b)
            losses.append((float(m["loss"]), float(mc["loss"])))
    finally:
        _restore(saved)
    for a, b in losses:
        assert abs(a - b) <= 1e-4 * abs(b)
    _leafwise_close(dict(state["params"].named_parameters()),
                    dict(cpu["params"].named_parameters()))
    for k in ("master", "m", "v"):
        _leafwise_close(state["opt"][k], cpu["opt"][k])
    assert int(state["opt"]["step"]) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_batched_ranks_launches_per_train_step_on_card(card, arch, remat):
    """One train step's batched-ranks launches, each call held against the
    plain version: ``transformer.moe_forwards`` (moonshot 1 a MoE layer,
    2 with remat; jamba, whose blocks are checkpointed inside their
    groups, 1 and 3 less one a group), 2x that with ``microbatch=2``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch, ops, ref
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepOptions
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    layers = cfg.num_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    want = {(False, 1): layers, (True, 1): 2 * layers, (False, 8): layers,
            (True, 8): 3 * layers - cfg.num_groups}[(remat, len(cfg.pattern))]
    assert T.moe_forwards(cfg) == want
    gen = torch.Generator().manual_seed(12)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=gen).to(card)
             for k in ("tokens", "labels")}
    calls, inner = [], ops.batched_ranks

    def recording(flags):
        ranks, counts = inner(flags)
        calls.append((flags.clone(), ranks, counts))
        return ranks, counts

    for M in (1, 2):
        step, init_state = train.build(cfg, StepOptions(microbatch=M), device=card)
        state = init_state(12)
        calls.clear()
        start = moe_dispatch.batched_ranks.launches
        ops.batched_ranks = recording
        try:
            state, m = step(state, batch)
        finally:
            ops.batched_ranks = inner
        torch.cuda.synchronize()
        assert moe_dispatch.batched_ranks.launches - start == M * want == len(calls)
        assert np.isfinite(float(m["loss"]))
        for f, r, c in calls:
            pr, pc = ref.batched_ranks(f)
            assert torch.equal(r, pr) and torch.equal(c, pc)


@pytest.fixture
def nccl_one_rank(card):
    """A one-rank NCCL process group on the card (an in-process store: no
    port) and its (1, 1) (data, model) mesh; destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("mode", ["plain", "microbatch2", "compress"])
def test_sharded_step_on_one_nccl_rank_matches_unsharded(card, nccl_one_rank, arch,
                                                         mode):
    """The sharded step (DTensor state, NCCL collectives, EP through the
    batched-ranks kernel for moonshot) on a 1 x 1 mesh, f32 reduced, 3
    steps, against the unsharded step from the same seed: the metrics
    within 1e-6 of each other, every parameter, master, m, v (and
    residual) leaf within 1e-5 of its largest value (test_torch_train_
    step.py's tolerance), the same batched-ranks launches a step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepOptions
    mesh = nccl_one_rank
    opts = StepOptions(**{"plain": {}, "microbatch2": dict(microbatch=2),
                          "compress": dict(compress_grads=True)}[mode])
    cfg = get_config(arch).reduced()
    scfg = dataclasses.replace(cfg, act_sharding=("data",),
                               ep_axis="model" if cfg.moe else None)
    gen = torch.Generator().manual_seed(13)
    batches = [{k: torch.randint(0, cfg.vocab_size, (4, 16), generator=gen).to(card)
                for k in ("tokens", "labels")} for _ in range(3)]
    saved = _f32_on_card(card)
    try:
        runs = {}
        for name, c, m in (("unsharded", cfg, None), ("sharded", scfg, mesh)):
            step, init_state = train.build(c, opts, device=card, mesh=m)
            state = init_state(13)
            metrics, launches = [], []
            for b in batches:
                start = moe_dispatch.batched_ranks.launches
                state, met = step(state, b)
                metrics.append({k: float(v) for k, v in met.items()})
                launches.append(moe_dispatch.batched_ranks.launches - start)
            runs[name] = (state, metrics, launches)
    finally:
        _restore(saved)
    (us, um, ul), (ss, sm, sl) = runs["unsharded"], runs["sharded"]
    assert ul == sl
    for a, b in zip(um, sm):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * max(abs(a[k]), 1e-30), (k, a[k], b[k])
    def host(tree):
        return {n: t.full_tensor() if hasattr(t, "full_tensor") else t.detach().cpu()
                for n, t in tree.items()}

    got = {"params": host(ss["params"])}
    want = {"params": host(dict(us["params"].named_parameters()))}
    for k in ("master", "m", "v"):
        got[k], want[k] = host(ss["opt"][k]), host(us["opt"][k])
    if "residual" in us:
        got["residual"], want["residual"] = host(ss["residual"]), host(us["residual"])
    for k in want:
        _leafwise_close(got[k], want[k], rel=1e-5)
