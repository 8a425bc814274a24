"""The port's one-dispatch engines -- ``run_ask_scan``, ``run_ask_fused``,
``scan_capacities`` and ``_resolve_capacities`` -- against the JAX package
on the CPU, mirroring tests/test_ask_scan.py.

Both packages' problems are built from one dict of plain values, at
n=256, g=4, r=2, B=16, max_dwell=64 (two exploration levels and the leaf
level; leaves of side 16, as at the golden config: JAX's 8 x 8 dwell
blocks contract multibrot's FMAs otherwise, ROADMAP R3) for the four
escape-time workloads. JAX runs its default Pallas
kernels in interpret mode, as tests/test_torch_ask.py does (its jnp
lowering contracts multibrot's FMAs otherwise: ROADMAP R3). On the CPU the
port runs the engines' level loop eagerly on the plain versions;
on the card the same loop is one CUDA-graph replay (tests/test_torch_gpu.py).

Tolerance: exact for every output. Canvases are equal pixel for pixel and
``levels``, ``kernel_launches``, ``region_counts``, ``leaf_count``,
``overflow_dropped``, ``olt_caps`` and ``ring_rows`` equal JAX's, at the
default sizing, at worst-case capacities and at capacities small enough
to drop roots and children (a dropped region keeps the init value 0).
"""

import numpy as np
import pytest
import torch

from repro.core.ask import _resolve_capacities as j_resolve
from repro.core.ask import run_ask_fused as j_run_ask_fused
from repro.core.ask import run_ask_scan as j_run_ask_scan
from repro.core.ask import scan_capacities as j_scan_capacities
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads import registry as jreg
from repro_torch import convert
from repro_torch.core import ask
from repro_torch.workloads import solve

torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=256, g=4, r=2, B=16, max_dwell=64)
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "olt_caps", "ring_rows")
# scan sizings: the default, worst case, and undersized (drops 4 of the 16
# roots and children at every level)
SCAN_SIZING = {"default": {}, "worst": dict(safety_factor=1e9),
               "undersized": dict(capacities=(12, 40, 120))}
# the fused engine at a quarter of the worst case: its first level holds 4
# of the 16 roots and drops the rest uncounted, as JAX's does; a level's
# children never exceed 4 x its capacity, the next level's, so nothing more
# drops
FUSED_SIZING = {"default": {}, "quarter": dict(capacity_factor=0.25)}


def _problems(d):
    """(JAX's problem, the port's problem on the CPU)."""
    kw = {k: d[k] for k in convert.FIELDS if k in d}
    jp = JFrameProblem(workload=jreg.get_workload(d["workload"]), **kw)
    return jp, convert.problem_from_fields({**d, "device": "cpu"})


def _assert_same(got, got_st, want, want_st):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for f in STAT_FIELDS:
        assert getattr(got_st, f) == getattr(want_st, f), f


@pytest.mark.parametrize("sizing", SCAN_SIZING)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_ask_scan_matches_jax(workload, sizing):
    jp, tp = _problems(dict(SMALL, workload=workload))
    kw = SCAN_SIZING[sizing]
    want, want_st = j_run_ask_scan(jp, **kw)
    got, got_st = solve(tp, "ask_scan", **kw)
    _assert_same(got, got_st, want, want_st)
    assert got_st.kernel_launches == 1
    if sizing == "worst":
        assert got_st.overflow_dropped == 0
    if sizing == "undersized":
        assert got_st.overflow_dropped > 0


@pytest.mark.parametrize("sizing", FUSED_SIZING)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_ask_fused_matches_jax(workload, sizing):
    jp, tp = _problems(dict(SMALL, workload=workload))
    kw = FUSED_SIZING[sizing]
    want, want_st = j_run_ask_fused(jp, **kw)
    got, got_st = solve(tp, "ask_fused", **kw)
    _assert_same(got, got_st, want, want_st)
    assert got_st.region_counts == () and got_st.kernel_launches == 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_dispatch_engines_equal_run_ask(workload):
    """With nothing dropped, both engines equal run_ask's canvas and
    counts (the fused engine records no region_counts)."""
    _, tp = _problems(dict(SMALL, workload=workload))
    want, want_st = ask.run_ask(tp)
    scan, st = ask.run_ask_scan(tp, safety_factor=1e9)
    fused, fst = ask.run_ask_fused(tp)
    assert torch.equal(scan, want) and torch.equal(fused, want)
    assert st.overflow_dropped == fst.overflow_dropped == 0
    assert st.region_counts == want_st.region_counts
    assert st.leaf_count == fst.leaf_count == want_st.leaf_count


def test_dropped_regions_keep_the_init_value():
    """A forced overflow: every pixel either equals run_ask's or is 0."""
    _, tp = _problems(dict(SMALL, workload="mandelbrot"))
    want, _ = ask.run_ask(tp)
    got, st = ask.run_ask_scan(tp, capacities=(12, 40, 120))
    assert st.overflow_dropped > 0
    differ = got != want
    assert differ.any() and (got[differ] == 0).all()


@pytest.mark.parametrize("n,g,r,B", [(1024, 4, 2, 32), (128, 2, 2, 8),
                                     (256, 4, 4, 4), (96, 2, 2, 12),
                                     (64, 2, 2, 64)])
@pytest.mark.parametrize("p,safety", [(0.7, 2.0), (0.3, 1.0), (0.9, 3.5),
                                      (0.5, 1e9)])
def test_scan_capacities_match_jax(n, g, r, B, p, safety):
    got = ask.scan_capacities(n, g, r, B, p_subdiv=p, safety_factor=safety)
    assert got == j_scan_capacities(n, g, r, B, p_subdiv=p,
                                    safety_factor=safety)


@pytest.mark.parametrize("capacities", [None, 7, 0, (16, 50, 200),
                                        (16.0, 50, 0), (16, 50)])
def test_resolve_capacities_match_jax(capacities):
    jp, tp = _problems(dict(SMALL, workload="mandelbrot"))
    kw = dict(p_subdiv=0.6, safety_factor=1.5)
    if capacities == (16, 50):  # one capacity short of levels 0..2
        with pytest.raises(ValueError, match="need 3 capacities"):
            j_resolve(jp, capacities, **kw)
        with pytest.raises(ValueError, match="need 3 capacities"):
            ask._resolve_capacities(tp, capacities, **kw)
        return
    assert ask._resolve_capacities(tp, capacities, **kw) == \
        j_resolve(jp, capacities, **kw)


@pytest.mark.parametrize("method", ["ask_scan", "ask_fused"])
def test_levels_zero_chain(method):
    """n/g <= B: no exploration level; the engine is the leaf work over the
    root OLT."""
    d = dict(n=64, g=2, r=2, B=64, max_dwell=16, workload="mandelbrot")
    jp, tp = _problems(d)
    want, want_st = (j_run_ask_scan if method == "ask_scan" else
                     j_run_ask_fused)(jp)
    got, st = solve(tp, method)
    _assert_same(got, st, want, want_st)
    assert st.region_counts == () and st.leaf_count == 4


# -- the window: what one CUDA graph of the level loop serves -----------------

def test_graph_key_leaves_out_the_window():
    """Two frames that differ only in their window share a graph key; any
    other field gives another key. ``reading`` keeps the problem equal
    (the plane is no part of it) and hands the plane on."""
    from repro_torch.workloads import FrameProblem
    a = FrameProblem(**SMALL, device="cpu")
    b = FrameProblem(**SMALL, bounds=(-0.8, 0.0, -0.6, 0.2), device="cpu")
    assert a.graph_key() == b.graph_key() and hash(a.graph_key())
    for field, value in (("max_dwell", 32), ("workload", "julia"),
                         ("scheme", "mbr"), ("B", 32)):
        other = FrameProblem(**{**SMALL, field: value}, device="cpu")
        assert other.graph_key() != a.graph_key(), field
    plane = torch.zeros(4)
    read = b.reading(plane)
    assert read == b and read.plane is plane and read.window() is plane


@pytest.mark.parametrize("n,g,B,bounds", [
    (256, 4, 16, (-2.0, -2.0, 2.0, 2.0)), (1000, 5, 25, (-0.8, 0.0, -0.6, 0.2)),
    (16384, 4, 32, (-2.5, -1.25, 1.0, 1.25))])
def test_window_is_the_static_plane(n, g, B, bounds):
    """``window`` is ``ref.plane``'s exact f32 values (the static
    spelling, as JAX's static bounds), made once per window."""
    from repro_torch.kernels import _build, ref
    from repro_torch.workloads import FrameProblem
    p = FrameProblem(n=n, g=g, r=2, B=B, bounds=bounds, device="cpu")
    w = p.window()
    assert w.dtype == torch.float32 and w.shape == (4,)
    assert w.tolist() == [float(np.float32(v)) for v in ref.plane(n, bounds)]
    assert p.window() is w
    assert _build.plane_tensor(n, torch.tensor(bounds), "cpu").tolist() == \
        list(ref.plane(n, torch.tensor(bounds)))
