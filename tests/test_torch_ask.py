"""The port's main path end to end -- FrameProblem, run_ask, exhaustive,
run_dp -- against the JAX package and its goldens, at the golden config
(n=256, g=4, r=2, B=16, max_dwell=128), SBR and MBR.

Both packages' problems are built from one dict of plain values
(``repro_torch.convert.problem_from_fields``). JAX runs on the CPU with its
default Pallas kernels in interpret mode. Expectations, as measured:

* the port's run_ask canvas equals ``tests/golden/<workload>_256.pgm``
  pixel for pixel for all four workloads, multibrot included (0 pixels:
  the rounding contract of repro_torch/kernels/ref.py places multibrot's
  FMAs as XLA does);
* its stats (levels, launches, region_counts, leaf_count, olt_caps) equal
  JAX's exactly -- no border pixel differs, so no region flips;
* its Ex equals JAX's Ex for mandelbrot, burning_ship and multibrot; for
  julia they differ in 26 pixels (bound 32): JAX's own Ex disagrees with
  its golden there (ROADMAP R2), and the port's Ex equals the golden.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_golden import read_golden  # noqa: E402

from repro.core.ask import run_ask as j_run_ask  # noqa: E402
from repro.core.dp_emul import run_dp as j_run_dp  # noqa: E402
from repro.workloads import FrameProblem as JFrameProblem  # noqa: E402
from repro.workloads import exhaustive as j_exhaustive  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.ask import run_ask  # noqa: E402
from repro_torch.core.dp_emul import run_dp  # noqa: E402
from repro_torch.workloads import FrameProblem, exhaustive, solve  # noqa: E402

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
GOLDEN = dict(n=256, g=4, r=2, B=16, max_dwell=128)
EX_DIFF = {"mandelbrot": 0, "julia": 26, "burning_ship": 0, "multibrot": 0}
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "olt_caps", "ring_rows")


def _jax_problem(d):
    name = d.get("workload", "mandelbrot")
    if "c" in d:
        spec = jreg.julia(tuple(d["c"]))
    elif "m" in d:
        spec = jreg.multibrot(d["m"])
    else:
        spec = jreg.get_workload(name)
    kw = {k: d[k] for k in convert.FIELDS if k in d}
    return JFrameProblem(workload=spec, **kw)


def _port_problem(d):
    return convert.problem_from_fields({**d, "device": "cpu"})


@pytest.fixture(scope="module")
def jax_ask():
    cache = {}

    def get(workload):
        if workload not in cache:
            canvas, stats = j_run_ask(_jax_problem(dict(GOLDEN, workload=workload)))
            cache[workload] = (np.asarray(canvas), stats)
        return cache[workload]

    return get


def _assert_stats_equal(got, want):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.frame_chains() == want.frame_chains()


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("scheme,tile", [("sbr", 256), ("mbr", 8)])
def test_run_ask_matches_golden_and_jax(jax_ask, workload, scheme, tile):
    prob = _port_problem(dict(GOLDEN, workload=workload, scheme=scheme,
                              tile=tile))
    canvas, stats = run_ask(prob)
    assert canvas.dtype == torch.int32 and canvas.shape == (256, 256)
    np.testing.assert_array_equal(canvas.numpy(), read_golden(workload))
    want_canvas, want_stats = jax_ask(workload)
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)
    _assert_stats_equal(stats, want_stats)
    assert stats.wall_s > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_exhaustive_matches_jax(workload):
    spec = jreg.get_workload(workload)
    want, want_stats = j_exhaustive(256, max_dwell=128, workload=spec)
    got, stats = solve(_port_problem(dict(GOLDEN, workload=workload)), "ex")
    diff = int((got.numpy() != np.asarray(want)).sum())
    assert diff == EX_DIFF[workload] and diff <= 32
    np.testing.assert_array_equal(got.numpy(), read_golden(workload))
    assert (stats.levels, stats.kernel_launches) == (want_stats.levels,
                                                     want_stats.kernel_launches)
    same, _ = exhaustive(256, max_dwell=128, workload=workload, device="cpu")
    assert torch.equal(same, got)


def test_run_dp_matches_ask_and_jax():
    d = dict(GOLDEN, workload="mandelbrot")
    canvas, stats = run_dp(_port_problem(d))
    np.testing.assert_array_equal(canvas.numpy(), read_golden("mandelbrot"))
    _, want = j_run_dp(_jax_problem(d))
    _assert_stats_equal(stats, want)
    assert stats.kernel_launches == 268  # one per tree node


@pytest.mark.parametrize("d", [
    dict(n=128, g=4, r=2, B=8, max_dwell=64, workload="julia", c=(-0.8, 0.156)),
    dict(n=128, g=2, r=2, B=8, max_dwell=64, workload="multibrot", m=4,
         bounds=(-1.2, -1.2, 1.2, 1.2)),
    dict(n=128, g=4, r=4, B=2, max_dwell=48, workload="burning_ship",
         bounds=(-1.9, -0.1, -1.5, 0.3)),
])
def test_problem_from_fields_builds_the_same_problem(d):
    jp, tp = _jax_problem(d), _port_problem(d)
    assert (tp.n, tp.g, tp.r, tp.B, tp.max_dwell, tp.bounds) == \
        (jp.n, jp.g, jp.r, jp.B, jp.max_dwell, jp.bounds)
    assert tp.workload.name == jp.workload.name
    want_canvas, want_stats = j_run_ask(jp)
    canvas, stats = run_ask(tp)
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    _assert_stats_equal(stats, want_stats)


def test_problem_from_fields_rejects_what_it_cannot_carry():
    with pytest.raises(ValueError, match="unknown fields"):
        convert.problem_from_fields(dict(n=64, backend="pallas", device="cpu"))
    with pytest.raises(ValueError, match="no parameters"):
        convert.problem_from_fields(dict(n=64, workload="mandelbrot", m=3,
                                         device="cpu"))


@pytest.mark.parametrize("method,slice_no", [("ask_fused", 6), ("ask_scan", 6),
                                             ("ask_tuned", 11)])
def test_later_engines_name_their_slice(method, slice_no):
    """An engine of a slice still open raises naming it; those of slice 6
    (the one-dispatch engines, landed) run, one dispatch, equal to run_ask
    (tests/test_torch_ask_scan.py holds them against JAX)."""
    prob = FrameProblem(n=64, g=2, B=16, max_dwell=16, device="cpu")
    if slice_no == 6:
        canvas, stats = solve(prob, method)
        assert torch.equal(canvas, run_ask(prob)[0])
        assert stats.kernel_launches == 1
        return
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        solve(prob, method)


def test_unknown_method_and_bad_chain_raise():
    prob = FrameProblem(n=64, g=2, B=16, max_dwell=16, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        solve(prob, "bogus")
    with pytest.raises(ValueError, match="chain"):
        FrameProblem(n=100, g=2, r=3, B=4, device="cpu")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot show")


def test_default_device_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        FrameProblem(n=64)
    with pytest.raises(RuntimeError, match="cuda"):
        exhaustive(64)
