"""The port's plain versions (repro_torch.kernels.ref), workload registry
and cost model against the JAX package, on the same numpy inputs.

JAX runs on the CPU under ``jit``, which is where XLA places the FMAs the
port reproduces (see the rounding contract in ``repro_torch/kernels/ref.py``).
Integer results must match exactly. The one tolerance: the JAX Ex oracle
``mandelbrot_ref`` for julia disagrees with the JAX golden by 26 pixels
(ROADMAP R2); the port matches the golden, so against that oracle it
differs by the same 26 of 65536 pixels, and the bound is 32.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.kernels import ref as jref
from repro.workloads import registry as jreg
from repro_torch.core import cost_model as tcm
from repro_torch.kernels import ref as tref
from repro_torch.workloads import registry as treg

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
# pixels where the port's Ex differs from JAX's mandelbrot_ref at n=256,
# max_dwell=128 (measured); julia is R2, the rest match exactly
EX_ORACLE_DIFF = {"mandelbrot": 0, "julia": 26, "burning_ship": 0,
                  "multibrot": 0}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bounds", [(-1.5, -1.0, 0.5, 1.0),
                                    (-2.5, -2.0, 1.5, 2.0),
                                    (-0.7453, 0.1127, -0.7451, 0.1129)])
@pytest.mark.parametrize("spelling", ["static", "traced"])
def test_map_coords_matches_jax(bounds, spelling):
    rng = np.random.default_rng(1)
    n = 4096
    xs = rng.integers(0, n, size=(32, 32)).astype(np.float32)
    ys = rng.integers(0, n, size=(32, 32)).astype(np.float32)
    if spelling == "static":
        jr, ji = jax.jit(lambda x, y: jref.map_coords(x, y, n, bounds))(xs, ys)
        tb = bounds
    else:
        jr, ji = jax.jit(lambda x, y, b: jref.map_coords(x, y, n, b))(
            xs, ys, jnp.asarray(bounds, jnp.float32))
        tb = torch.tensor(bounds, dtype=torch.float32)
    tr, ti = tref.map_coords(_t(xs), _t(ys), n, tb)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _zoom_windows(seed, k):
    """k random zoom windows (re0, im0, re1, im1) around the mandelbrot set,
    widths from 1e-5 to 3, as f32."""
    rng = np.random.default_rng(seed)
    c = rng.uniform((-1.8, -1.0), (0.4, 1.0), size=(k, 2))
    w = 10 ** rng.uniform(-5, 0.5, size=k)
    return np.stack([c[:, 0] - w / 2, c[:, 1] - w / 2, c[:, 0] + w / 2,
                     c[:, 1] + w / 2], axis=1).astype(np.float32)


@pytest.mark.parametrize("n", [96, 384])
def test_traced_spelling_matches_jax_on_random_windows(n):
    """The traced bounds spelling at widths that are no power of two: XLA
    computes the step as f32(re1 - re0) * f32(1/n), not as a true f32
    division (which differs in about a third of random windows). Held on
    40 random zoom windows in map_coords, region_interior_dyn and
    perimeter_query_dyn; every output must match exactly."""
    side = 16
    rng = np.random.default_rng(n)
    xs = rng.integers(0, n, size=(8, 64)).astype(np.float32)
    ys = rng.integers(0, n, size=(8, 64)).astype(np.float32)
    coords = _coords(n + 1, 6, n // side)
    j_map = jax.jit(lambda x, y, b: jref.map_coords(x, y, n, b))
    j_int = jax.jit(lambda c, b: jref.region_interior_dyn(
        c, side=side, n=n, bounds=b, max_dwell=64))
    j_per = jax.jit(lambda c, b: jref.perimeter_query_dyn(
        c, side=side, n=n, bounds=b, max_dwell=64))
    bad = {"map_coords": 0, "region_interior_dyn": 0, "perimeter_query_dyn": 0}
    for b in _zoom_windows(n, 40):
        tb = torch.from_numpy(b)
        jr, ji = j_map(xs, ys, jnp.asarray(b))
        tr, ti = tref.map_coords(_t(xs), _t(ys), n, tb)
        bad["map_coords"] += int((tr.numpy() != np.asarray(jr)).sum() +
                                 (ti.numpy() != np.asarray(ji)).sum())
        got = tref.region_interior_dyn(_t(coords), side=side, n=n, bounds=tb,
                                       max_dwell=64)
        bad["region_interior_dyn"] += int(
            (got.numpy() != np.asarray(j_int(coords, jnp.asarray(b)))).sum())
        th, tc = tref.perimeter_query_dyn(_t(coords), side=side, n=n,
                                          bounds=tb, max_dwell=64)
        jh, jc = j_per(coords, jnp.asarray(b))
        bad["perimeter_query_dyn"] += int((th.numpy() != np.asarray(jh)).sum() +
                                          (tc.numpy() != np.asarray(jc)).sum())
    assert bad == {k: 0 for k in bad}


def test_pooled_planes_are_the_traced_spelling():
    """``pooled_planes`` rows equal ``plane`` of each frame's [4] tensor, and
    the per-row pooled plain versions equal JAX's pooled_bounds path."""
    from repro.kernels import ops as jops
    n, side = 96, 16
    bounds = _zoom_windows(7, 6)
    planes = tref.pooled_planes(n, bounds)
    for b, p in zip(bounds, planes):
        assert tref.plane(n, torch.from_numpy(b)) == tuple(float(v) for v in p)
    rng = np.random.default_rng(8)
    rows = np.stack([rng.integers(0, 6, 40), rng.integers(0, n // side, 40),
                     rng.integers(0, n // side, 40)], axis=1).astype(np.int32)
    want = jax.jit(lambda r, b: jref.region_interior_dyn(
        r[:, 1:], side=side, n=n, bounds=jops.pooled_bounds(b, r),
        max_dwell=64))(rows, jnp.asarray(bounds))
    got = tref.region_interior_pooled_ref(_t(rows), _t(planes), side=side,
                                          max_dwell=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jh, jc = jax.jit(lambda r, b: jref.perimeter_query_dyn(
        r[:, 1:], side=side, n=n, bounds=jops.pooled_bounds(b, r),
        max_dwell=64))(rows, jnp.asarray(bounds))
    th, tc = tref.perimeter_query_pooled_ref(_t(rows), _t(planes), side=side,
                                             max_dwell=64)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_fma_is_correctly_rounded():
    """The f64 round-to-odd FMA equals the exact rational result rounded
    once to f32 (checked with Python fractions on random operands)."""
    from fractions import Fraction
    rng = np.random.default_rng(2)
    a, b, c = (rng.standard_normal(200).astype(np.float32) for _ in range(3))
    got = tref.fma(_t(a), _t(b), _t(c)).numpy()
    for i in range(200):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # nearest double, then nearest f32
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, i


@pytest.mark.parametrize("workload", WORKLOADS)
def test_exhaustive_ref_matches_jax_oracle(workload):
    jw, tw = jreg.get_workload(workload), treg.get_workload(workload)
    b = jw.default_bounds
    want = np.asarray(jref.mandelbrot_ref(256, b, 128, workload=jw))
    got = tref.mandelbrot_ref(256, b, 128, workload=tw).numpy()
    assert int((got != want).sum()) == EX_ORACLE_DIFF[workload]


def test_escape_time_unroll_changes_nothing():
    ys, xs = torch.meshgrid(torch.arange(48.0), torch.arange(48.0),
                            indexing="ij")
    cr, ci = tref.map_coords(xs, ys, 48)
    base = tref.escape_time(cr, ci, 64)
    for u in (2, 5, 64):
        assert torch.equal(tref.escape_time(cr, ci, 64, unroll=u), base)


def _coords(seed, N, grid):
    return np.random.default_rng(seed).integers(0, grid, size=(N, 2)).astype(np.int32)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("spelling", ["static", "traced"])
def test_perimeter_query_matches_jax(workload, spelling):
    side, grid = 16, 8
    n = side * grid
    coords = _coords(3, 24, grid)
    jw, tw = jreg.get_workload(workload), treg.get_workload(workload)
    b = jw.default_bounds
    if spelling == "static":
        jh, jc = jref.perimeter_query_ref(coords, side=side, n=n, bounds=b,
                                          max_dwell=96, workload=jw)
        th, tc = tref.perimeter_query_ref(_t(coords), side=side, n=n, bounds=b,
                                          max_dwell=96, workload=tw)
    else:
        jh, jc = jax.jit(lambda c, bb: jref.perimeter_query_dyn(
            c, side=side, n=n, bounds=bb, max_dwell=96, workload=jw))(
            coords, jnp.asarray(b, jnp.float32))
        th, tc = tref.perimeter_query_dyn(
            _t(coords), side=side, n=n, bounds=torch.tensor(b), max_dwell=96,
            workload=tw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_region_interior_matches_jax(workload):
    side, grid = 16, 8
    coords = _coords(4, 12, grid)
    jw, tw = jreg.get_workload(workload), treg.get_workload(workload)
    b = jw.default_bounds
    want = jref.region_interior_ref(coords, side=side, n=side * grid, bounds=b,
                                    max_dwell=96, workload=jw)
    got = tref.region_interior_ref(_t(coords), side=side, n=side * grid,
                                   bounds=b, max_dwell=96, workload=tw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N", [1, 7, 1000])
def test_compact_ranks_ref_matches_jax(N):
    flags = np.random.default_rng(N).random(N) < 0.4
    jr, jc = jref.compact_ranks_ref(flags)
    tr, tc = tref.compact_ranks_ref(_t(flags))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tc) == int(jc) and tr.dtype == torch.int32


@pytest.mark.parametrize("name", WORKLOADS)
def test_registry_matches_jax(name):
    j, t = jreg.get_workload(name), treg.get_workload(name)
    assert t.name == j.name
    assert t.default_bounds == j.default_bounds
    assert t.prior_band == j.prior_band
    assert j.escape_radius2 == 4.0 and j.init is jref.mandelbrot_init  # the kernels' own
    assert treg.get_workload(name) is t  # canonical instance


@pytest.mark.parametrize("make", [
    lambda reg: reg.julia((-0.8, 0.156)),
    lambda reg: reg.multibrot(4),
    lambda reg: reg.multibrot(2),
])
def test_parametric_workloads_match_jax(make):
    """Other members of the parametric families. multibrot(m=4) and m=2
    follow the same contraction rule as m=3 (checked here at 64^2)."""
    jw, tw = make(jreg), make(treg)
    assert tw.name == jw.name and make(treg) is tw
    b = jw.default_bounds
    want = np.asarray(jref.mandelbrot_ref(64, b, 64, workload=jw))
    got = tref.mandelbrot_ref(64, b, 64, workload=tw).numpy()
    np.testing.assert_array_equal(got, want)


def test_ssd_synth_waits_for_its_slice():
    """The grid workload's slice (13) has landed: ``ssd_synth`` is the
    registered grid spec, with JAX's name, window and prior band, and its
    values equal JAX's lookup (tests/test_torch_ssd.py holds the engines)."""
    tw, jw = treg.ssd_synth(), jreg.ssd_synth()
    assert treg.get_workload("ssd_synth") is tw and tw.kind == jw.kind == "grid"
    assert (tw.name, tw.default_bounds, tw.prior_band) == (
        jw.name, jw.default_bounds, jw.prior_band)
    want = np.asarray(jref.mandelbrot_ref(256, jw.default_bounds, 64,
                                          workload=jw))
    got = tref.mandelbrot_ref(256, tw.default_bounds, 64, workload=tw)
    np.testing.assert_array_equal(got.numpy(), want)


_GRB = np.array([2, 4, 8, 16, 32])


@pytest.mark.parametrize("fn", ["w_ssd_mandelbrot", "omega", "t_sbr", "t_mbr",
                                "speedup_sbr", "speedup_mbr"])
def test_cost_model_matches_jax_package(fn):
    gg, rr, bb = np.meshgrid(_GRB, _GRB, _GRB, indexing="ij")
    for n, P in ((1024, 0.7), (16384, 0.55)):
        want = getattr(jcm, fn)(n, 512.0, P, 3.0, gg, rr, bb)
        got = getattr(tcm, fn)(n, 512.0, P, 3.0, gg, rr, bb)
        np.testing.assert_array_equal(got, want)


def test_cost_model_scalars_match_jax_package():
    for args in ((256, 4, 2, 16), (16384, 4, 2, 32), (1000, 3, 2, 7)):
        assert tcm.num_levels(*args) == jcm.num_levels(*args)
        assert tcm.expected_level_counts(*args, P=0.6) == \
            jcm.expected_level_counts(*args, P=0.6)
        np.testing.assert_array_equal(tcm.tau_levels(*args),
                                      jcm.tau_levels(*args))
        np.testing.assert_array_equal(tcm.valid_grb(*args), jcm.valid_grb(*args))
    np.testing.assert_array_equal(tcm.t_exhaustive(4096, 512.0),
                                  jcm.t_exhaustive(4096, 512.0))
    assert tcm.w_subdivision_general(
        256, [0.7, 0.6], Q=[1, 2], S=[3, 4], T=[5, 6], A=7.0, G=16, R=4) == \
        jcm.w_subdivision_general(
            256, [0.7, 0.6], Q=[1, 2], S=[3, 4], T=[5, 6], A=7.0, G=16, R=4)
    for metric in ("work", "sbr", "mbr"):
        params = jcm.SSDParams(n=4096, A=256.0, P=0.7, lam=2.0)
        tparams = tcm.SSDParams(n=4096, A=256.0, P=0.7, lam=2.0)
        j = jcm.search_optimal_grb(params, metric)
        t = tcm.search_optimal_grb(tparams, metric)
        assert (t.g, t.r, t.B, t.value, t.metric) == (j.g, j.r, j.B, j.value,
                                                      j.metric)
    np.testing.assert_array_equal(tcm.grb_space(), jcm.grb_space())


# -- the port imports neither JAX nor the JAX package --------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & {
        "jax", "jaxlib", "repro"}) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_port_import_pulls_in_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
