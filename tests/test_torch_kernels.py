"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain version (the tensors lie on the
CPU); JAX runs its Pallas kernel in interpret mode, as tests/test_kernels.py
does. Both get the same numpy inputs; every output is integer and must
match exactly. The JAX fill/dwell kernels take a duplicate-padded OLT plus
``nonempty``; the port takes the live ``count`` -- the same writes.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mandelbrot_dwell import mandelbrot_dwell as j_mandelbrot
from repro.kernels.perimeter_query import perimeter_query as j_perimeter
from repro.kernels.region_dwell import region_dwell as j_region_dwell
from repro.kernels.region_dwell_pooled import (
    region_dwell_pooled as j_region_dwell_pooled)
from repro.kernels.region_fill import region_fill as j_region_fill
from repro.kernels.region_fill_pooled import (
    region_fill_pooled as j_region_fill_pooled)
from repro.kernels import ref as jref
from repro.kernels import ops as jops
from repro.workloads import registry as jreg
from repro_torch.kernels import _build, ops
from repro_torch.kernels.mandelbrot_dwell import mandelbrot_dwell
from repro_torch.kernels import olt_compact, ref as tref
from repro_torch.kernels.perimeter_query import (perimeter_query,
                                                 perimeter_query_pooled)
from repro_torch.kernels.region_dwell import region_dwell
from repro_torch.kernels.region_dwell_pooled import region_dwell_pooled
from repro_torch.kernels.region_fill import region_fill
from repro_torch.kernels.region_fill_pooled import region_fill_pooled
from repro_torch.workloads import registry as treg
from test_torch_border_cases import CASES as BORDER_CASES

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
WRAPPERS = (mandelbrot_dwell, perimeter_query, region_fill, region_dwell,
            olt_compact.compact_ranks, perimeter_query_pooled,
            region_fill_pooled, region_dwell_pooled)


def _specs(name):
    return jreg.get_workload(name), treg.get_workload(name)


def _olt(seed, N, grid):
    """N distinct region coords on a grid x grid level, from a seed."""
    cells = np.random.default_rng(seed).permutation(grid * grid)[:N]
    return np.stack([cells // grid, cells % grid], axis=1).astype(np.int32)


def _padded(coords, count):
    """JAX's form of a live prefix: duplicate-padded rows plus nonempty."""
    idx = np.where(np.arange(len(coords)) < count, np.arange(len(coords)), 0)
    return coords[idx], np.array([int(count > 0)], np.int32)


@pytest.fixture
def launches_unchanged():
    before = [w.launches for w in WRAPPERS]
    yield
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("workload", WORKLOADS)
def test_mandelbrot_dwell_matches_pallas(workload, launches_unchanged):
    jw, tw = _specs(workload)
    b = jw.default_bounds
    want = j_mandelbrot(64, b, 96, (32, 32), True, workload=jw)
    got = mandelbrot_dwell(64, bounds=b, max_dwell=96, workload=tw,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.mandelbrot is mandelbrot_dwell


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("side", [8, 32])
@pytest.mark.parametrize("dead", [0, 5, 12])
def test_perimeter_query_matches_pallas(workload, side, dead,
                                        launches_unchanged):
    """The first ``count`` rows are JAX's answer; the ``dead`` padding rows
    past the live count are (False, 0) and are not computed."""
    jw, tw = _specs(workload)
    grid = 128 // side
    coords = _olt(side, min(12, grid * grid), grid)
    count = len(coords) - dead
    jh, jc = j_perimeter(jnp.asarray(coords), side=side, n=128,
                         bounds=jw.default_bounds, max_dwell=96,
                         interpret=True, workload=jw)
    th, tc = perimeter_query(torch.from_numpy(coords),
                             torch.tensor([count], dtype=torch.int32),
                             side=side, n=128, bounds=jw.default_bounds,
                             max_dwell=96, workload=tw)
    np.testing.assert_array_equal(th[:count].numpy(), np.asarray(jh)[:count])
    np.testing.assert_array_equal(tc[:count].numpy(), np.asarray(jc)[:count])
    assert not th[count:].any() and not tc[count:].any()
    assert th.dtype == torch.bool and tc.dtype == torch.int32


@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 4)])
@pytest.mark.parametrize("count", [0, 1, 5, 8])
def test_region_fill_matches_pallas(scheme, tile, count, launches_unchanged):
    n, side = 64, 8
    rng = np.random.default_rng(count)
    canvas = rng.integers(0, 1000, size=(n, n)).astype(np.int32)
    coords = _olt(count + 20, 8, n // side)
    values = rng.integers(0, 500, size=8).astype(np.int32)
    jc, ne = _padded(coords, count)
    jv, _ = _padded(values[:, None], count)
    want = j_region_fill(jnp.asarray(canvas), jnp.asarray(jc),
                         jnp.asarray(jv[:, 0]), jnp.asarray(ne), side=side, n=n,
                         scheme=scheme, tile=tile, interpret=True)
    t_canvas = torch.from_numpy(canvas.copy())
    out = region_fill(t_canvas, torch.from_numpy(coords),
                      torch.from_numpy(values),
                      torch.tensor([count], dtype=torch.int32), side=side, n=n,
                      scheme=scheme, tile=tile)
    assert out is t_canvas  # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# pixels where JAX's interpret-mode MBR kernel with 8 x 8 blocks disagrees
# with its own SBR kernel and with its ref oracle (XLA contracts the
# multibrot step differently for that block shape; ROADMAP R3). The port
# equals the SBR result there, so it differs from the MBR one by these.
JAX_MBR8_SELF_DIFF = {"multibrot": 2}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 8), ("mbr", 4)])
def test_region_dwell_matches_pallas(workload, scheme, tile, launches_unchanged):
    jw, tw = _specs(workload)
    n, side, count = 128, 16, 6
    canvas = np.random.default_rng(5).integers(0, 9, size=(n, n)).astype(np.int32)
    coords = _olt(6, 10, n // side)
    jc, ne = _padded(coords, count)

    def jax_dwell(scheme, tile):
        return np.asarray(j_region_dwell(
            jnp.asarray(canvas), jnp.asarray(jc), jnp.asarray(ne), side=side,
            n=n, bounds=jw.default_bounds, max_dwell=96, scheme=scheme,
            tile=tile, interpret=True, workload=jw))

    t_canvas = torch.from_numpy(canvas.copy())
    out = region_dwell(t_canvas, torch.from_numpy(coords),
                       torch.tensor([count], dtype=torch.int32), side=side,
                       n=n, bounds=jw.default_bounds, max_dwell=96,
                       scheme=scheme, tile=tile, workload=tw)
    assert out is t_canvas
    np.testing.assert_array_equal(out.numpy(), jax_dwell("sbr", 256))
    known = JAX_MBR8_SELF_DIFF.get(workload, 0) if tile == 8 else 0
    assert int((out.numpy() != jax_dwell(scheme, tile)).sum()) == known


# -- the pooled engine's kernels: frame-tagged rows on the banded canvas ------

def _pooled_rows(seed, N, F, grid):
    """N distinct frame-tagged rows (frame, cy, cx) over F frames."""
    cells = np.random.default_rng(seed).permutation(F * grid * grid)[:N]
    f, rest = cells // (grid * grid), cells % (grid * grid)
    return np.stack([f, rest // grid, rest % grid], axis=1).astype(np.int32)


def _windows(seed, F):
    rng = np.random.default_rng(seed)
    c = rng.uniform((-1.6, -0.9), (0.3, 0.9), size=(F, 2))
    w = 10 ** rng.uniform(-4, 0.4, size=F)
    return np.stack([c[:, 0] - w / 2, c[:, 1] - w / 2, c[:, 0] + w / 2,
                     c[:, 1] + w / 2], axis=1).astype(np.float32)


@pytest.mark.parametrize("count", [0, 1, 7, 12])
@pytest.mark.parametrize("n,side", [(64, 8), (48, 12)])
def test_region_fill_pooled_matches_pallas(n, side, count, launches_unchanged):
    """Row (f, cy, cx) lands at canvas row f*n + cy*side; the live count
    takes the place of duplicate padding plus nonempty."""
    F = 3
    rng = np.random.default_rng(count + n)
    canvas = rng.integers(0, 1000, size=(F * n, n)).astype(np.int32)
    rows = _pooled_rows(count, 12, F, n // side)
    values = rng.integers(0, 500, size=12).astype(np.int32)
    jr, ne = _padded(rows, count)
    jv, _ = _padded(values[:, None], count)
    want = j_region_fill_pooled(jnp.asarray(canvas), jnp.asarray(jr),
                                jnp.asarray(jv[:, 0]), jnp.asarray(ne),
                                side=side, n=n, F=F, interpret=True)
    t_canvas = torch.from_numpy(canvas.copy())
    out = ops.region_fill_pooled(t_canvas, torch.from_numpy(rows),
                                 torch.from_numpy(values),
                                 torch.tensor([count], dtype=torch.int32),
                                 side=side, n=n)
    assert out is t_canvas
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="banded"):
        region_fill_pooled(t_canvas[:-1], torch.from_numpy(rows),
                           torch.from_numpy(values),
                           torch.tensor([count], dtype=torch.int32),
                           side=side, n=n)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("count", [0, 9])
def test_region_dwell_pooled_matches_pallas(workload, count, launches_unchanged):
    """Each leaf row in its own frame's window (traced spelling, n=96 so the
    step is no power of two)."""
    jw, tw = _specs(workload)
    F, n, side = 3, 96, 12
    canvas = np.random.default_rng(9).integers(0, 9, size=(F * n, n)).astype(np.int32)
    rows = _pooled_rows(11, 12, F, n // side)
    bounds = _windows(12, F)
    jr, ne = _padded(rows, count)
    want = j_region_dwell_pooled(jnp.asarray(canvas), jnp.asarray(jr),
                                 jnp.asarray(ne), jnp.asarray(bounds),
                                 side=side, n=n, F=F, max_dwell=64,
                                 interpret=True, workload=jw)
    t_canvas = torch.from_numpy(canvas.copy())
    out = ops.region_dwell_pooled(t_canvas, torch.from_numpy(rows),
                                  torch.tensor([count], dtype=torch.int32),
                                  ops.pooled_planes(n, bounds, "cpu"),
                                  side=side, n=n, max_dwell=64, workload=tw)
    assert out is t_canvas
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_perimeter_query_pooled_matches_jax(workload, launches_unchanged):
    """JAX computes the pooled Q with jnp (perimeter_query_dyn through
    pooled_bounds); the port's rows past the count are (False, 0)."""
    jw, tw = _specs(workload)
    F, n, side, count = 4, 96, 12, 10
    rows = _pooled_rows(13, 14, F, n // side)
    bounds = _windows(14, F)
    jh, jc = jax.jit(lambda r, b: jref.perimeter_query_dyn(
        r[:, 1:], side=side, n=n, bounds=jops.pooled_bounds(b, r),
        max_dwell=64, workload=jw))(jnp.asarray(rows), jnp.asarray(bounds))
    th, tc = ops.perimeter_query_pooled(
        torch.from_numpy(rows), torch.tensor([count], dtype=torch.int32),
        ops.pooled_planes(n, bounds, "cpu"), side=side, max_dwell=64,
        workload=tw)
    np.testing.assert_array_equal(th[:count].numpy(), np.asarray(jh)[:count])
    np.testing.assert_array_equal(tc[:count].numpy(), np.asarray(jc)[:count])
    assert not th[count:].any() and not tc[count:].any()


@pytest.mark.parametrize("case", BORDER_CASES, ids=lambda c: c.id)
def test_border_cases_match_jax(case, launches_unchanged):
    """The shared edge regions of tests/test_torch_border_cases.py: the
    port's Q on the live rows equals JAX's ``perimeter_query`` (interpret
    mode; cases of one frame) and ``perimeter_query_dyn`` through
    ``pooled_bounds`` (the pooled query, every case); the rows past the
    count are (False, 0). Row 0 of a named border is homogeneous only for
    ``all_max``."""
    jw, tw = _specs(case.workload)
    rows, count = case.rows, case.count
    live = torch.tensor([count], dtype=torch.int32)
    kw = dict(side=case.side, max_dwell=case.max_dwell)
    answers = []
    if case.single:
        coords = np.ascontiguousarray(rows[:, 1:])
        want = j_perimeter(jnp.asarray(coords), n=case.n, bounds=case.bounds[0],
                           interpret=True, workload=jw, **kw)
        got = perimeter_query(torch.from_numpy(coords), live, n=case.n,
                              bounds=case.bounds[0], workload=tw, **kw)
        answers.append((got, want))
    bounds = np.asarray(case.bounds, np.float32)
    want = jax.jit(lambda r, b: jref.perimeter_query_dyn(
        r[:, 1:], n=case.n, bounds=jops.pooled_bounds(b, r), workload=jw,
        **kw))(jnp.asarray(rows), jnp.asarray(bounds))
    got = ops.perimeter_query_pooled(torch.from_numpy(rows), live,
                                     ops.pooled_planes(case.n, bounds, "cpu"),
                                     workload=tw, **kw)
    answers.append((got, want))
    for (th, tc), (jh, jc) in answers:
        np.testing.assert_array_equal(th[:count].numpy(), np.asarray(jh)[:count])
        np.testing.assert_array_equal(tc[:count].numpy(), np.asarray(jc)[:count])
        assert not th[count:].any() and not tc[count:].any()
        if case.pattern and count:
            assert bool(th[0]) == (case.pattern == "all_max")


@pytest.mark.parametrize("N", [1, 31, 4097, 70000])
@pytest.mark.parametrize("dtype", ["bool", "int32"])
def test_olt_compact_matches_jax_ref(N, dtype, launches_unchanged):
    """The scan module's plain version (the CPU path of ops.compact_ranks)
    against JAX's oracle, int32 flags adding their values."""
    rng = np.random.default_rng(N)
    flags = (rng.random(N) < 0.4) if dtype == "bool" else \
        rng.integers(0, 3, N).astype(np.int32)
    jr, jc = jref.compact_ranks_ref(flags)
    tr, tc = ops.compact_ranks(torch.from_numpy(flags))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tc.shape == () and int(tc) == int(jc)
    _, c1 = olt_compact.compact_ranks(torch.from_numpy(flags))
    assert c1.shape == (1,) and int(c1[0]) == int(jc)


def test_bad_scheme_and_tile_raise():
    canvas = torch.zeros((32, 32), dtype=torch.int32)
    one = torch.ones((1,), dtype=torch.int32)
    coords = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="scheme"):
        region_fill(canvas, coords, one, one, side=8, n=32, scheme="xbr")
    with pytest.raises(ValueError, match="divisible"):
        region_dwell(canvas, coords, one, side=8, n=32, scheme="mbr", tile=3)


def test_nvcc_flags_follow_the_contract():
    """The kernels are built for Hopper with contraction off: every FMA
    is placed by hand (__fmaf_rn), as the plain versions place it."""
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "-shared" in flags
    assert set(_build.KERNELS) == {p.stem for p in _build.CSRC.glob("*.cu")}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot show")


def test_cuda_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        mandelbrot_dwell(16)  # the default device is the card
    with pytest.raises(ValueError, match="unsupported device"):
        mandelbrot_dwell(16, device="meta")


# -- the blocked escape loop: edge windows, the build cache --------------------

# n=18 over (-2, -2)-(2.5, 2.5) puts pixels on c = -2, 2 and 2i (|z|^2 = 4.0
# at step 0, so their dwell is 0); over +-3e19, z^2 overflows to inf and NaN
# right after the first test; the interior windows hold only points that
# reach max_dwell (julia: beside its near-neutral fixed point).
EDGE_WINDOWS = ((-2.0, -2.0, 2.5, 2.5), (-3e19, -3e19, 3e19, 3e19))
INTERIOR = {"julia": (-0.513, 0.075, -0.473, 0.115)}
EDGE_WORKLOADS = (*WORKLOADS, "multibrot4")


def _edge_specs(name):
    if name == "multibrot4":  # the run-time power path of the kernels
        return jreg.multibrot(4), treg.multibrot(4)
    return _specs(name)


# 1, U - 1, U and U + 1 for the kernels' blocks of U = 8 (Ex, Q) and 16 (A)
@pytest.mark.parametrize("max_dwell", [1, 7, 8, 9, 16, 17, 513])
@pytest.mark.parametrize("workload", EDGE_WORKLOADS)
def test_edge_windows_match_pallas(workload, max_dwell, launches_unchanged):
    """Ex and A on the windows tests/test_torch_gpu.py holds the kernels
    on: the plain versions equal JAX's Pallas kernels (interpret mode), and
    every interior pixel reaches max_dwell."""
    jw, tw = _edge_specs(workload)
    n, side, count = 18, 6, 5
    coords = _olt(7, 9, n // side)
    jc, ne = _padded(coords, count)
    interior = INTERIOR.get(workload, (-0.1, -0.1, 0.1, 0.1))
    for i, b in enumerate((*EDGE_WINDOWS, interior)):
        want = np.asarray(j_mandelbrot(n, b, max_dwell, (n, n), True,
                                       workload=jw, unroll=4))
        got = mandelbrot_dwell(n, bounds=b, max_dwell=max_dwell, workload=tw,
                               device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        if i == 0:  # c = -2 and c = 2i
            assert want[8, 0] == 0 and want[16, 8] == 0
        elif i == 1:
            assert (want == 0).all()
        else:
            assert (want == max_dwell).all()
        canvas = np.full((n, n), -1, np.int32)
        jd = j_region_dwell(jnp.asarray(canvas), jnp.asarray(jc),
                            jnp.asarray(ne), side=side, n=n, bounds=b,
                            max_dwell=max_dwell, interpret=True, workload=jw,
                            unroll=8)
        td = region_dwell(torch.from_numpy(canvas.copy()),
                          torch.from_numpy(coords),
                          torch.tensor([count], dtype=torch.int32), side=side,
                          n=n, bounds=b, max_dwell=max_dwell, workload=tw)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """The build cache's key covers the flags, the kernel's source and
    every header of csrc/, sorted by name: touching a header, or adding
    one, gives the library a new file name. Nothing is compiled."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._library_path("region_dwell")
    assert first.parent == tmp_path / "build"
    assert _build._library_path("region_dwell") == first  # stable
    header = csrc / "escape_time.cuh"
    header.write_text(header.read_text() + "// touched\n")
    touched = _build._library_path("region_dwell")
    assert touched != first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._library_path("region_dwell") not in (first, touched)
    other = _build._library_path("region_fill")
    (csrc / "region_dwell.cu").write_text("// another kernel's source\n")
    assert _build._library_path("region_fill") == other
    assert not list(tmp_path.glob("build/*"))
