"""The port's k-D SSD slice against the JAX package's, on the CPU: the
synthetic fields (``core.ssd_synth``), the scalar OLT and the Morton and
canonical space-filling-curve codecs (``core.olt``), the 3-D solver, the
``ssd_synth`` grid workload through every engine, and the registry's
``register(kind=, overwrite=)`` / ``escape_time_workloads``.

Tolerance: exact. Fields, level counts, codes, ranks, counts and canvases
are equal bit for bit; the grid workload's canvases also equal its field,
the one workload with known ground truth at every pixel.
"""

import numpy as np
import pytest
import torch

from repro.core import olt as jolt
from repro.core import planner as jplanner
from repro.core import ssd_synth as jssd
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import registry as jreg
from repro.workloads import solve as j_solve
from repro.workloads import solve_batch as j_solve_batch
from repro.workloads.spec import WorkloadSpec as JWorkloadSpec
from repro_torch.core import olt, planner
from repro_torch.core import ssd_synth as tssd
from repro_torch.kernels import _build, ops, ref
from repro_torch.workloads import FrameProblem, solve, solve_batch
from repro_torch.workloads import registry as treg
from repro_torch.workloads.spec import WorkloadSpec

torch.set_num_threads(1)

# tests/test_workloads.py's field, and ssd_synth's defaults (BENCH_6.json)
SPECS = {"seed3": dict(seed=3, n_field=128, g=4, r=2, B=16, P=0.7),
         "default": dict(seed=0, n_field=256, g=4, r=2, B=16, P=0.7)}
ENGINES = ("ex", "ask", "ask_fused", "ask_scan", "ask_tuned", "ask_pooled",
           "dp")
WORST = {"ask_scan": dict(safety_factor=1e9),
         "ask_tuned": dict(safety_factor=1e9),
         "ask_pooled": dict(safety_factor=1e9)}


def _spec_problems(case):
    """(JAX's spec and problem, the port's) for one SPECS case."""
    kw = SPECS[case]
    jw, tw = jreg.ssd_synth(**kw), treg.ssd_synth(**kw)
    common = dict(n=kw["n_field"], g=kw["g"], r=kw["r"], B=kw["B"],
                  max_dwell=64)
    return (jw, JFrameProblem(**common, workload=jw, backend="jnp"),
            tw, FrameProblem(**common, workload=tw, device="cpu"))


# ---------------------------------------------------------------------------
# the generator and the 3-D solver


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("k,n,B,P", [(2, 128, 16, 0.7), (2, 64, 4, 0.55),
                                     (3, 32, 4, 0.6), (3, 64, 4, 0.5)])
def test_generate_field_equals_jax(seed, k, n, B, P):
    want = jssd.generate_field(seed, n=n, g=2, r=2, B=B, P=P, k=k)
    got = tssd.generate_field(seed, n=n, g=2, r=2, B=B, P=P, k=k)
    np.testing.assert_array_equal(got.field, want.field)
    assert got.field.dtype == want.field.dtype == np.int32
    assert got.level_counts == want.level_counts
    assert (got.n, got.g, got.r, got.B, got.P, got.k) == (
        want.n, want.g, want.r, want.B, want.P, want.k)


@pytest.mark.parametrize("seed,n,g,P", [(0, 32, 2, 0.55), (1, 32, 2, 0.55),
                                        (2, 64, 2, 0.6), (4, 64, 4, 0.7)])
def test_solve_ask_3d_equals_jax_and_the_field(seed, n, g, P):
    fld = tssd.generate_field(seed, n=n, g=g, r=2, B=4, P=P, k=3)
    want_canvas, want_counts = jssd.solve_ask_3d(
        jssd.generate_field(seed, n=n, g=g, r=2, B=4, P=P, k=3))
    canvas, counts = tssd.solve_ask_3d(fld, device="cpu")
    assert canvas.dtype == torch.int32 and canvas.device.type == "cpu"
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)
    np.testing.assert_array_equal(canvas.numpy(), fld.field)
    assert counts == want_counts == fld.level_counts[:len(counts)]


def test_morton_roots_equal_jax():
    for g in (1, 2, 4):
        np.testing.assert_array_equal(tssd._morton_roots(g).numpy(),
                                      np.asarray(jssd._morton_roots(g)))


# ---------------------------------------------------------------------------
# the codecs and the scalar OLT


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_morton_codecs_equal_jax(seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    p2 = rng.integers(0, 1 << 16, size=(257, 2)).astype(np.int32)
    p3 = rng.integers(0, 1 << 10, size=(257, 3)).astype(np.int32)
    c2 = olt.morton_encode2d(torch.from_numpy(p2))
    c3 = olt.morton_encode3d(torch.from_numpy(p3))
    assert c2.dtype == c3.dtype == torch.uint32
    np.testing.assert_array_equal(c2.numpy(), _u32(jolt.morton_encode2d(jnp.asarray(p2))))
    np.testing.assert_array_equal(c3.numpy(), _u32(jolt.morton_encode3d(jnp.asarray(p3))))
    np.testing.assert_array_equal(olt.morton_decode2d(c2).numpy(), p2)
    np.testing.assert_array_equal(olt.morton_decode3d(c3).numpy(), p3)
    # decode any uint32 code, as JAX does (the high bits of 3-D codes too)
    codes = rng.integers(0, 1 << 32, size=300, dtype=np.uint64).astype(np.uint32)
    tc = torch.from_numpy(codes.view(np.int32)).to(torch.uint32)
    for t_dec, j_dec in ((olt.morton_decode2d, jolt.morton_decode2d),
                         (olt.morton_decode3d, jolt.morton_decode3d)):
        got = t_dec(tc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_dec(jnp.asarray(codes))))
    # out-of-range coordinates keep their low bits, as in JAX
    wide = np.array([[70000, -3], [1 << 20, 5]], np.int32)
    np.testing.assert_array_equal(
        olt.morton_encode2d(torch.from_numpy(wide)).numpy(),
        _u32(jolt.morton_encode2d(jnp.asarray(wide))))


@pytest.mark.parametrize("grid", [(7,), (4, 5), (3, 8, 5), (2, 3, 4, 5)])
def test_canonical_sfc_equals_jax(grid):
    import jax.numpy as jnp
    rng = np.random.default_rng(len(grid))
    p = np.stack([rng.integers(0, s, size=100) for s in grid], -1).astype(np.int32)
    s = olt.sfc_canonical_encode(torch.from_numpy(p), grid)
    assert s.dtype == torch.int64
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jolt.sfc_canonical_encode(jnp.asarray(p), grid)))
    back = olt.sfc_canonical_decode(s, grid)
    np.testing.assert_array_equal(back.numpy(), p)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jolt.sfc_canonical_decode(jnp.asarray(s.numpy()),
                                                           grid)))
    with pytest.raises(ValueError, match="mismatch"):
        olt.sfc_canonical_encode(torch.from_numpy(p[:, :1]), grid + (2,))


@pytest.mark.parametrize("k,N,capacity", [(2, 16, 64), (3, 40, 512),
                                          (3, 40, 96), (2, 1, 4), (3, 0, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_subdivide_olt_scalar_equals_jax(k, N, capacity, seed):
    """Random codes (the high bits that the shift drops included) and flags;
    a capacity below the children drops the rest, as JAX's mode="drop"."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    flags = rng.integers(0, 2, size=N).astype(bool)
    want, wc = jolt.subdivide_olt_scalar(jnp.asarray(codes), jnp.asarray(flags),
                                         k=k, capacity=capacity)
    got, gc = olt.subdivide_olt_scalar(
        torch.from_numpy(codes.view(np.int32)).to(torch.uint32),
        torch.from_numpy(flags), k=k, capacity=capacity)
    assert got.dtype == torch.uint32 and got.shape == (capacity,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gc) == int(wc)


def test_scalar_olt_matches_coordinate_olt():
    """As tests/test_ssd_3d.py: the Morton step equals the coordinate step."""
    coords = torch.tensor([[0, 1], [1, 1], [2, 3], [3, 0]], dtype=torch.int32)
    flags = torch.tensor([True, False, True, True])
    want, wc = olt.subdivide_olt(coords, flags, r=2, capacity=32)
    got, gc = olt.subdivide_olt_scalar(olt.morton_encode2d(coords), flags, k=2,
                                       capacity=32)
    assert int(wc) == int(gc) == 12
    torch.testing.assert_close(olt.morton_decode2d(got)[:12], want[:12],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the grid workload


def test_ssd_synth_spec_equals_jax():
    for case in SPECS:
        jw, _, tw, _ = _spec_problems(case)
        assert treg.ssd_synth(**SPECS[case]) is tw  # memoised
        assert (tw.name, tw.kind, tw.default_bounds, tw.prior_band) == (
            jw.name, jw.kind, jw.default_bounds, jw.prior_band)
    assert tw.name == "ssd_synth" and treg.get_workload("ssd_synth") is tw
    odd = treg.ssd_synth(seed=2, n_field=64, P=0.6)
    assert odd.name == jreg.ssd_synth(seed=2, n_field=64, P=0.6).name
    # the lookup truncates toward zero and clamps, as JAX's
    import jax.numpy as jnp
    xs = np.array([-3.7, -0.5, 0.0, 0.99, 17.5, 63.9, 64.0, 1e6], np.float32)
    cr, ci = np.meshgrid(xs, xs[::-1])
    want = np.asarray(jreg.ssd_synth(seed=2, n_field=64, P=0.6).grid_fn(
        jnp.asarray(cr), jnp.asarray(ci)))
    got = odd.grid_fn(torch.from_numpy(cr), torch.from_numpy(ci))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(SPECS))
def test_ssd_synth_reconstructs_its_field_like_jax(case, engine):
    """With frame n == field n on the default window, every engine equals
    the generated field and JAX's canvas for the same engine (the engines
    of tests/test_workloads.py, plus ask_tuned and the rest)."""
    jw, jp, tw, tp = _spec_problems(case)
    kw = SPECS[case]
    field = tssd.generate_field(kw["seed"], n=kw["n_field"], g=kw["g"],
                                r=kw["r"], B=kw["B"], P=kw["P"], k=2).field
    canvas, st = solve(tp, engine, **WORST.get(engine, {}))
    np.testing.assert_array_equal(canvas.numpy(), field)
    if engine in ("ex", "ask", "ask_scan", "ask_tuned", "ask_fused"):
        want, wst = j_solve(jp, engine, **WORST.get(engine, {}))
        np.testing.assert_array_equal(canvas.numpy(), np.asarray(want))
        assert st.kernel_launches == wst.kernel_launches
        assert tuple(st.region_counts) == tuple(wst.region_counts)


def test_ssd_synth_batch_equals_jax():
    """A batch of the field's window and its aligned quadrants: each frame
    equals JAX's batched frame (grid lookups at traced bounds)."""
    jw, jp, tw, tp = _spec_problems("seed3")
    bounds = np.asarray([(0, 0, 128, 128), (0, 0, 64, 64), (64, 32, 128, 96)],
                        np.float32)
    for opts in ({}, {"safety_factor": 1e9}):
        got, st = solve_batch(tp, bounds, **opts)
        want, wst = j_solve_batch(jp, bounds, **opts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert st.region_counts == wst.region_counts
        assert st.frame_overflow == wst.frame_overflow


def test_ssd_synth_plans_at_the_generator_p():
    """The grid workload's prior band is the generator's P (slope 0): every
    frame plans at P, as in JAX."""
    kw = dict(seed=3, n_field=128, g=4, r=2, B=16, P=0.6)
    jw, tw = jreg.ssd_synth(**kw), treg.ssd_synth(**kw)
    assert tw.prior_band == (0.6, 0.0, 0.6)
    frames = [tw.default_bounds, (0.0, 0.0, 32.0, 32.0)]
    common = dict(n=128, g=4, r=2, B=16, max_dwell=64)
    got = planner.plan_capacities(FrameProblem(**common, workload=tw,
                                               device="cpu"), frames)
    want = jplanner.plan_capacities(JFrameProblem(**common, workload=jw), frames)
    assert [e.p_subdiv for e in got.estimates] == pytest.approx([0.6, 0.6])
    assert [e.p_subdiv for e in got.estimates] == [e.p_subdiv
                                                   for e in want.estimates]


def test_grid_route_masks_rows_past_the_count():
    """The grid arm's plain path computes every row and masks those past
    the live count with no host sync: dead rows (garbage included) answer
    (False, 0) and write nothing, the live rows equal the plain version's."""
    tw = treg.ssd_synth(**SPECS["seed3"])
    n, side = 128, 16
    coords = torch.tensor([[0, 0], [1, 2], [7, 7], [0, 0], [-5, 99]],
                          dtype=torch.int32)
    count = torch.tensor([3], dtype=torch.int32)
    b = tw.default_bounds
    homog, common = ops.perimeter_query(coords, count, side=side, n=n, bounds=b,
                                        max_dwell=64, workload=tw)
    ph, pc = ref.perimeter_query_ref(coords[:3], side=side, n=n, bounds=b,
                                     max_dwell=64, workload=tw)
    assert torch.equal(homog[:3], ph) and torch.equal(common[:3], pc)
    assert not homog[3:].any() and not common[3:].any()
    canvas = torch.full((n, n), 7, dtype=torch.int32)
    ops.region_dwell(canvas, coords, count, side=side, n=n, bounds=b,
                     max_dwell=64, workload=tw)
    want = torch.full((n, n), 7, dtype=torch.int32)
    tiles = ref.region_interior_ref(coords[:3], side=side, n=n, bounds=b,
                                    max_dwell=64, workload=tw)
    ys, xs = ref.region_index(coords[:3], side)
    want[ys, xs] = tiles
    assert torch.equal(canvas, want)
    # the plane a graph reads (a [4] tensor) gives the same answers
    plane = torch.tensor(ref.plane(n, b), dtype=torch.float32)
    h2, c2 = ops.perimeter_query(coords, count, side=side, n=n, bounds=None,
                                 max_dwell=64, workload=tw, plane=plane)
    assert torch.equal(h2, homog) and torch.equal(c2, common)


def test_grid_workloads_have_no_escape_kernel():
    """``_build.workload_args`` refuses a grid spec: an escape kernel would
    compute it as something else."""
    with pytest.raises(ValueError, match="grid"):
        _build.workload_args(64, treg.ssd_synth(**SPECS["seed3"]))
    assert _build.workload_args(64, treg.get_workload("julia"))[1] == 1
    with pytest.raises(ValueError, match="grid_fn"):
        WorkloadSpec(name="g", kind="grid")
    with pytest.raises(ValueError, match="kind"):
        WorkloadSpec(name="g", kind="volume", kernel_id=0)
    with pytest.raises(ValueError, match="kernel_id"):
        WorkloadSpec(name="e")


# ---------------------------------------------------------------------------
# the registry's kinds


@pytest.fixture
def registries(monkeypatch):
    """Both registries, restored after the test."""
    for mod in (jreg, treg):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
        monkeypatch.setattr(mod, "_KINDS", dict(mod._KINDS))
    return jreg, treg


def test_escape_time_workloads_equal_jax():
    assert treg.available() == jreg.available()
    assert treg.escape_time_workloads() == jreg.escape_time_workloads() == (
        "mandelbrot", "julia", "burning_ship", "multibrot")


def test_register_kind_and_overwrite_behave_as_jax(registries):
    built = {"j": 0, "t": 0}

    def factory(pkg, spec_cls, **spec_kw):
        def make():
            built[pkg] += 1
            return spec_cls(name="lazy_grid", kind="grid",
                            grid_fn=lambda cr, ci: cr, **spec_kw)
        return make

    for pkg, mod, cls, kw in (("j", jreg, JWorkloadSpec, {}),
                              ("t", treg, WorkloadSpec, {})):
        mod.register("lazy_grid", factory(pkg, cls, **kw), kind="grid")
        assert "lazy_grid" not in mod.escape_time_workloads()
        assert built[pkg] == 0  # a kind query builds no factory
        with pytest.raises(ValueError, match="already registered"):
            mod.register("lazy_grid", factory(pkg, cls, **kw), kind="grid")
        spec = mod.get_workload("lazy_grid")
        assert spec.kind == "grid" and built[pkg] == 1
        assert mod.get_workload("lazy_grid") is spec  # resolved once
        # overwrite replaces it; a factory registered as the wrong kind
        # fails when it is built
        mod.register("lazy_grid", factory(pkg, cls, **kw), overwrite=True)
        assert "lazy_grid" in mod.escape_time_workloads()
        with pytest.raises(ValueError, match="registered as kind"):
            mod.get_workload("lazy_grid")
        with pytest.raises(KeyError, match="registered"):
            mod.get_workload("nope")
    assert jreg.escape_time_workloads() == treg.escape_time_workloads()


def test_register_spec_records_its_kind(registries):
    tw = WorkloadSpec(name="tiny_grid", kind="grid", grid_fn=lambda cr, ci: ci)
    treg.register("tiny_grid", tw)
    assert treg.get_workload("tiny_grid") is tw
    assert treg._KINDS["tiny_grid"] == "grid"
    treg.register("wrong_name", lambda: WorkloadSpec(name="other", kernel_id=0))
    with pytest.raises(ValueError, match="named"):
        treg.get_workload("wrong_name")
