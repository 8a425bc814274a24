"""The port's pooled cross-frame engine (repro_torch.core.pooled) against
JAX's ``run_ask_pooled_batch``, on the CPU.

JAX runs with its default kernels (``backend="pallas"``, interpret mode):
the banded ``region_fill_pooled`` / ``region_dwell_pooled`` Pallas kernels
and, for every pooled compaction up to 65536 rows, ``compact_ranks_kernel``.
The port runs its plain versions (the tensors lie on the CPU). Both get
the same numpy bounds. Canvases must match pixel for pixel and every
ASKStats field exactly: region_counts, leaf_count, overflow_dropped,
frame_overflow, frame_leaf_counts, olt_caps, ring_rows and
kernel_launches (1: one engine dispatch). Sizes are small (n <= 256,
max_dwell <= 64, except the golden config's 128).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_golden import read_golden  # noqa: E402
from test_pooled import _mixed_bounds  # noqa: E402

from repro.core import pooled as jpooled  # noqa: E402
from repro.kernels.olt_compact import (compact_ranks_blocked,  # noqa: E402
                                       compact_ranks_kernel)
from repro.workloads import FrameProblem as JFrameProblem  # noqa: E402
from repro.workloads import solve as j_solve  # noqa: E402
from repro_torch.core import pooled as tpooled  # noqa: E402
from repro_torch.kernels import olt_compact  # noqa: E402
from repro_torch.workloads import (EngineOptions, FrameProblem,  # noqa: E402
                                   solve, solve_batch)

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
GOLDEN = dict(n=256, g=4, r=2, B=16, max_dwell=128)
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")


def _both(kw, workload="mandelbrot"):
    return (JFrameProblem(**kw, backend="pallas", workload=workload),
            FrameProblem(**kw, workload=workload, device="cpu"))


def _assert_same(got, want):
    """(canvases, stats) of the port against JAX's."""
    canvas, stats = got
    want_canvas, want_stats = want
    assert canvas.dtype == torch.int32
    np.testing.assert_array_equal(canvas.numpy(), np.asarray(want_canvas))
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(want_stats, f), f
    assert stats.frame_chains() == want_stats.frame_chains()


def _random_windows(seed, F):
    rng = np.random.default_rng(seed)
    c = rng.uniform((-1.8, -1.0), (0.4, 1.0), size=(F, 2))
    w = 10 ** rng.uniform(-4, 0.5, size=F)
    return np.stack([c[:, 0] - w / 2, c[:, 1] - w / 2, c[:, 0] + w / 2,
                     c[:, 1] + w / 2], axis=1).astype(np.float32)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_pooled_single_frame_matches_jax_and_golden(workload):
    """F=1 at the golden config: solve(p, "ask_pooled") equals the golden
    and JAX's pooled run, with the flat single-frame stats."""
    jp, tp = _both(GOLDEN, workload)
    got = solve(tp, "ask_pooled", safety_factor=1e9)
    _assert_same(got, j_solve(jp, "ask_pooled", safety_factor=1e9))
    np.testing.assert_array_equal(got[0].numpy(), read_golden(workload))
    assert got[1].frame_overflow == () and isinstance(got[1].region_counts[0], int)


@pytest.mark.parametrize("kw,bounds", [
    (dict(n=128, g=4, r=2, B=16, max_dwell=32), _mixed_bounds(4, 2)),
    (dict(n=192, g=3, r=2, B=16, max_dwell=48), _random_windows(3, 5)),
    (dict(n=64, g=4, r=2, B=16, max_dwell=16),
     [(-1.5, -1.0, 0.5, 1.0), (-2.0, -2.0, 2.0, 2.0)]),
], ids=["mixed", "n192-random", "zero-levels"])
def test_pooled_batch_matches_jax(kw, bounds):
    """A heterogeneous batch, a non-power-of-two n with random windows
    (the traced step is no power of two there), and n = g*B, where the
    pool has no level and the roots are the leaves."""
    b = np.asarray(bounds, np.float32)
    jp, tp = _both(kw)
    got = tpooled.run_ask_pooled_batch(tp, b, safety_factor=1e9)
    _assert_same(got, jpooled.run_ask_pooled_batch(jp, b, safety_factor=1e9))
    assert got[1].overflow_dropped == 0 and got[0].shape == (len(b), kw["n"],
                                                             kw["n"])


def test_pooled_live_mask_matches_jax():
    """Dead frames get zero canvases and zero stats; the live ones are
    untouched by them."""
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=32)
    b = np.asarray(_mixed_bounds(2, 2), np.float32)
    live = [True, False, True, False]
    jp, tp = _both(kw)
    got = tpooled.run_ask_pooled_batch(tp, b, live=live, safety_factor=1e9)
    _assert_same(got, jpooled.run_ask_pooled_batch(jp, b, live=live,
                                                   safety_factor=1e9))
    assert not got[0][1].any() and got[1].frame_leaf_counts[3] == 0


@pytest.mark.parametrize("caps", [(96, 150, 200), (60, 100, 300)],
                         ids=["levels", "roots"])
def test_pooled_forced_overflow_matches_jax(caps):
    """Explicit small capacities: children (and, with 60 < 96 roots, whole
    frames) are dropped exactly as JAX drops them, and the drops are
    charged to the same frames."""
    kw = dict(n=256, g=4, r=2, B=16, max_dwell=32)
    b = np.asarray(_mixed_bounds(4, 2), np.float32)
    jp, tp = _both(kw)
    got = tpooled.run_ask_pooled_batch(tp, b, capacities=caps)
    want = jpooled.run_ask_pooled_batch(jp, b, capacities=caps)
    _assert_same(got, want)
    assert got[1].overflow_dropped > 0
    assert sum(1 for d in got[1].frame_overflow if d) >= 2


def test_solve_batch_pooled_matches_jax():
    """EngineOptions(engine="ask_pooled") at the default sizing, and the
    engine name as its shorthand."""
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=32)
    b = np.asarray(_mixed_bounds(3, 1), np.float32)
    jp, tp = _both(kw)
    from repro.workloads import EngineOptions as JEngineOptions
    from repro.workloads import solve_batch as j_solve_batch
    got = solve_batch(tp, b, options=EngineOptions(engine="ask_pooled"))
    _assert_same(got, j_solve_batch(jp, jnp.asarray(b),
                                    options=JEngineOptions(engine="ask_pooled")))
    same = solve_batch(tp, b, options="ask_pooled")
    assert torch.equal(same[0], got[0])


@pytest.mark.parametrize("N", [1, 100, 4096, 4097, 12288, 65536])
def test_scan_plain_matches_both_pallas_scans(N):
    """The port's plain scan against compact_ranks_kernel (one block) and
    compact_ranks_blocked (block 4096, zero-padded to the block multiple
    as JAX's ops pads it), both in interpret mode."""
    flags = np.random.default_rng(N).random(N) < 0.45
    ranks, count = olt_compact.compact_ranks(torch.from_numpy(flags))
    kr, kc = compact_ranks_kernel(jnp.asarray(flags), interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(kr))
    assert count.tolist() == np.asarray(kc).tolist()
    pad = -N % 4096
    br, bc = compact_ranks_blocked(
        jnp.asarray(np.concatenate([flags, np.zeros(pad, bool)])), block=4096,
        interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(br)[:N])
    assert count.tolist() == np.asarray(bc).tolist()


_CAP_PROBLEMS = [dict(n=256, g=4, r=2, B=16), dict(n=16384, g=4, r=2, B=32),
                 dict(n=192, g=3, r=2, B=16), dict(n=64, g=4, r=2, B=16)]


@pytest.mark.parametrize("kw", _CAP_PROBLEMS, ids=lambda kw: f"n{kw['n']}")
def test_capacity_helpers_match_jax(kw):
    """The four sizing helpers, result for result and error for error."""
    jp, tp = _both(dict(kw, max_dwell=16))
    from repro.core.cost_model import num_levels
    levels = num_levels(kw["n"], kw["g"], kw["r"], kw["B"])
    worst = tuple((kw["g"] * kw["r"] ** lv) ** 2 for lv in range(levels + 1))
    for ps, sf in (([0.7] * 3, 2.0), ([0.3, 0.95], 1.5), ([], 2.0),
                   ([1.0] * 8, 1e9), ([0.5], 0.1)):
        assert tpooled.pooled_capacities(tp, ps, safety_factor=sf) == \
            jpooled.pooled_capacities(jp, ps, safety_factor=sf)
    for args in ((4, None, None, 0.7, 2.0), (4, None, [0.2, 0.4, 0.9, 1.0],
                                             0.7, 3.0),
                 (2, 7, None, 0.7, 2.0), (2, tuple(range(1, levels + 2)),
                                          None, 0.7, 2.0)):
        assert tpooled._resolve_pooled_capacities(tp, *args) == \
            jpooled._resolve_pooled_capacities(jp, *args)
    for args in ((3, (1, 2), [0.5] * 3, 0.7, 2.0), (3, None, [0.5], 0.7, 2.0),
                 (3, (1,) * (levels + 2), None, 0.7, 2.0)):
        with pytest.raises(ValueError):
            tpooled._resolve_pooled_capacities(tp, *args)
        with pytest.raises(ValueError):
            jpooled._resolve_pooled_capacities(jp, *args)
    caps = tuple(max(1, w // 3) for w in worst)
    for S, ran in ((2, None), (4, 2), (1, 4)):
        assert tpooled.escalate_pooled_capacities(
            caps, worst, S, [0, 1], dispatched_per_shard=ran) == \
            jpooled.escalate_pooled_capacities(
                caps, worst, S, [0, 1], dispatched_per_shard=ran)
    with pytest.raises(RuntimeError, match="worst-case"):
        tpooled.escalate_pooled_capacities(
            tuple(2 * w for w in worst), worst, 2, [1])
    entered = [tuple(min(w, 5 + 3 * lv) for lv, w in enumerate(worst[:levels])),
               tuple(min(w, 9) for w in worst[:max(0, levels - 1)])]
    for extra in (dict(), dict(leaf_counts=[40, 12]),
                  dict(leaf_counts=[40, 12], frame_ps=[0.9, 0.4]),
                  dict(frame_ps=[0.6, 0.6], caps_prev=caps,
                       dispatched_per_shard=3)):
        assert tpooled.failed_pool_capacities(
            tp, entered, frames_per_shard=2, **extra) == \
            jpooled.failed_pool_capacities(jp, entered, frames_per_shard=2,
                                           **extra)
    with pytest.raises(RuntimeError, match="worst-case"):
        tpooled.failed_pool_capacities(tp, entered, frames_per_shard=2,
                                       caps_prev=tuple(2 * w for w in worst))


def test_later_parts_name_their_slice():
    """What the pooled slice left to later slices has landed: the tuned
    tier (slice 11: ``ask_tuned``, and the pooled engine under the tuned
    policy, each equal to its default) and the sharded pool (slice 12),
    which needs a mesh."""
    from repro_torch.launch.mesh import make_frames_mesh
    tp = FrameProblem(n=64, g=4, B=16, max_dwell=16, device="cpu")
    b = np.asarray([tp.bounds], np.float32)
    pooled_canvas = solve_batch(tp, b, options="ask_pooled")[0]
    assert torch.equal(solve_batch(tp, b, options="ask_tuned")[0],
                       solve_batch(tp, b)[0])
    got, _ = solve_batch(tp, b, options=EngineOptions(
        engine="ask_pooled", mesh=make_frames_mesh(device="cpu")))
    assert torch.equal(got, pooled_canvas)
    opts = EngineOptions(engine="ask_pooled", policy="tuned")
    assert opts.policy.backend.value == "tuned"
    assert torch.equal(solve_batch(tp, b, options=opts)[0], pooled_canvas)
    for fn in (tpooled.run_ask_pooled_sharded,
               tpooled.dispatch_ask_pooled_sharded):
        with pytest.raises(AttributeError):
            fn(tp, b, mesh=None)
    with pytest.raises(ValueError, match="not both"):
        solve_batch(tp, b, options="ask_pooled", safety_factor=2.0)
    with pytest.raises(ValueError, match=r"\[F, 4\]"):
        tpooled.run_ask_pooled_batch(tp, np.zeros((2, 3), np.float32))


def test_engine_options_match_jax():
    """coerce / from_kwargs / engine_kwargs give JAX's values."""
    from repro.workloads import EngineOptions as J
    kw = dict(capacities=[3, 4.0], safety_factor=3.0, block_until_ready=False,
              p_deep=0.9, ref_width=2.0)
    t, j = EngineOptions.from_kwargs(kw, engine="ask_pooled"), \
        J.from_kwargs(kw, engine="ask_pooled")
    assert t.engine_kwargs() == j.engine_kwargs()
    assert (t.capacities, t.extra) == (j.capacities, j.extra)
    assert EngineOptions.coerce("ask_pooled").engine == "ask_pooled"
    assert EngineOptions.coerce(None) == EngineOptions()
    with pytest.raises(ValueError, match="engine"):
        EngineOptions(engine="bogus")
    with pytest.raises(TypeError):
        EngineOptions.coerce(3)
