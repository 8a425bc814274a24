"""The port's OLT layer (repro_torch.core.olt) against repro.core.olt on
the same numpy inputs: every output is integer and must match exactly,
the rows past the live count included."""

import numpy as np
import pytest
import torch

from repro.core import olt as jolt
from repro_torch.core import olt as tolt

# the plain versions' tensors are small: torch's own thread pool would
# only fight the other test workers for the cores
torch.set_num_threads(1)

SIZES = [1, 2, 7, 64, 1000]


def _flags(seed, N, p=0.4):
    return np.random.default_rng(seed).random(N) < p


def _coords(seed, N, grid=64):
    return np.random.default_rng(seed).integers(0, grid, size=(N, 2)).astype(np.int32)


def test_next_pow2_matches_jax():
    for x in list(range(0, 70)) + [1023, 1024, 1025, 65537]:
        assert tolt.next_pow2(x) == jolt.next_pow2(x)


@pytest.mark.parametrize("count,cap", [(1, 1), (3, 4), (5, 8), (16, 16), (9, 64)])
def test_pad_olt_matches_jax(count, cap):
    coords = _coords(count, count)
    jc, jv = jolt.pad_olt(coords, count, cap)
    tc, tv = tolt.pad_olt(torch.from_numpy(coords), count, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        tolt.pad_olt(torch.from_numpy(coords), count, count - 1)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_compact_ranks_matches_jax(N, p):
    flags = _flags(N, N, p)
    jr, jc = jolt.compact_ranks(flags)
    tr, tc = tolt.compact_ranks(torch.from_numpy(flags))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.dtype == torch.int32 and int(tc) == int(jc)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("cap_scale", [1, 2])
def test_compact_gather_matches_jax(N, cap_scale):
    vals = np.random.default_rng(N + 7).integers(-50, 50, size=(N, 3)).astype(np.int32)
    flags = _flags(N + 1, N)
    cap = max(1, N * cap_scale // 2)  # half-size capacity drops the tail
    jo, jc = jolt.compact_gather(vals, flags, cap)
    to, tc = tolt.compact_gather(torch.from_numpy(vals), torch.from_numpy(flags), cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tc) == int(jc)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("r", [2, 4])
def test_subdivide_olt_matches_jax(N, r):
    coords = _coords(N + 11, N)
    flags = _flags(N + 12, N, 0.6)
    cap = jolt.next_pow2(N * r * r)
    jo, jc = jolt.subdivide_olt(coords, flags, r=r, capacity=cap)
    to, tc = tolt.subdivide_olt(torch.from_numpy(coords), torch.from_numpy(flags),
                                r=r, capacity=cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tc) == int(jc) and to.dtype == torch.int32


def _rows(seed, N, F=5, grid=64):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, F, N), rng.integers(0, grid, N),
                     rng.integers(0, grid, N)], axis=1).astype(np.int32)


@pytest.mark.parametrize("count,cap,width", [(3, 3, 8), (5, 4, 4), (1, 1, 1),
                                             (6, 6, 6)])
def test_ring_helpers_match_jax(count, cap, width):
    """ring_init (with its cut at ``capacity``), ring_read at both parities
    and ring_write of a narrower child buffer, row for row."""
    rows = _rows(count, count)
    jring = jolt.ring_init(rows, count, width)
    tring = tolt.ring_init(torch.from_numpy(rows), count, width)
    np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
    child = _rows(count + 50, max(1, width // 2))
    for parity in (0, 1):
        np.testing.assert_array_equal(
            tolt.ring_read(tring, parity, cap).numpy(),
            np.asarray(jolt.ring_read(jring, parity, cap)))
        jw = jolt.ring_write(jring, parity, child)
        tw = tolt.ring_write(tring.clone(), parity, torch.from_numpy(child))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    with pytest.raises(ValueError, match="exceeds ring width"):
        tolt.ring_write(tring, 0, torch.zeros((width + 1, 3), dtype=torch.int32))


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("r,cap_scale", [(2, 1.0), (2, 0.3), (3, 1.0)])
def test_subdivide_olt_tagged_matches_jax(N, r, cap_scale):
    """Frame tags ride along unscaled; a short capacity drops the children
    past it exactly as JAX's mode="drop" does. The precomputed
    ``ranks_count`` spelling gives the same result."""
    rows = _rows(N + 21, N)
    flags = _flags(N + 22, N, 0.6)
    cap = max(1, int(jolt.next_pow2(N * r * r) * cap_scale))
    jo, jc = jolt.subdivide_olt_tagged(rows, flags, r=r, capacity=cap)
    to, tc = tolt.subdivide_olt_tagged(torch.from_numpy(rows),
                                       torch.from_numpy(flags), r=r, capacity=cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tc) == int(jc) and to.dtype == torch.int32
    rc = tolt.compact_ranks(torch.from_numpy(flags))
    to2, _ = tolt.subdivide_olt_tagged(torch.from_numpy(rows),
                                       torch.from_numpy(flags), r=r,
                                       capacity=cap, ranks_count=rc)
    assert torch.equal(to2, to)
    go, gc = tolt.compact_gather(torch.from_numpy(rows), torch.from_numpy(flags),
                                 cap, ranks_count=rc)
    jgo, jgc = jolt.compact_gather(rows, flags, cap)
    np.testing.assert_array_equal(go.numpy(), np.asarray(jgo))
    assert int(gc) == int(jgc)
