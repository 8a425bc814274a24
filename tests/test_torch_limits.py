"""Shapes at the edge of the card kernels' launch limits, on the CPU, against
the JAX package.

The port must take every shape that JAX takes. On the CPU each wrapper
takes its plain version; these tests hold it against JAX's ``jnp`` lowering
(``KernelPolicy(backend="jnp")``) on inputs made from a numpy seed, exactly
(every output is integer):

* T and A under MBR with 262,144 tiles a region (side 2048, tile 4), more
  than one CUDA grid dimension holds;
* the batched ranks with 70,000 groups, more than one grid dimension
  holds.

tests/test_torch_gpu.py holds the card kernels at the same shapes against
these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.policy import KernelPolicy
from repro_torch.kernels import _build, moe_dispatch
from repro_torch.kernels.region_dwell import region_dwell
from repro_torch.kernels.region_fill import region_fill

torch.set_num_threads(1)

JNP = KernelPolicy(backend="jnp")
SIDE, TILE = 2048, 4  # (2048 / 4)^2 = 262,144 MBR tiles a region


def _padded(coords, count):
    """JAX's form of a live prefix: duplicate-padded rows plus nonempty."""
    idx = np.where(np.arange(len(coords)) < count, np.arange(len(coords)), 0)
    return coords[idx], np.array([int(count > 0)], np.int32)


def test_tile_of_takes_any_number_of_tiles():
    assert _build.tile_of(SIDE, "mbr", TILE) == TILE
    assert _build.tile_of(1 << 14, "mbr", 1) == 1
    assert _build.tile_of(8192, "sbr", 4) == 8192
    with pytest.raises(ValueError, match="divisible"):
        _build.tile_of(SIDE, "mbr", 3)


@pytest.mark.parametrize("count", [0, 1, 3])
def test_region_fill_mbr_many_tiles_matches_jax(count):
    n = 2 * SIDE
    rng = np.random.default_rng(16 + count)
    canvas = rng.integers(0, 1000, size=(n, n)).astype(np.int32)
    coords = rng.permutation(4)[:, None] // np.array([[2, 1]]) % 2
    coords = coords.astype(np.int32)
    values = rng.integers(0, 500, size=4).astype(np.int32)
    jc, ne = _padded(coords, count)
    jv, _ = _padded(values[:, None], count)
    want = jops.region_fill(jnp.asarray(canvas), jnp.asarray(jc),
                            jnp.asarray(jv[:, 0]), jnp.asarray(ne), side=SIDE,
                            n=n, scheme="mbr", tile=TILE, policy=JNP)
    t_canvas = torch.from_numpy(canvas.copy())
    out = region_fill(t_canvas, torch.from_numpy(coords),
                      torch.from_numpy(values),
                      torch.tensor([count], dtype=torch.int32), side=SIDE, n=n,
                      scheme="mbr", tile=TILE)
    assert out is t_canvas
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_region_dwell_mbr_many_tiles_matches_jax():
    n, count, max_dwell = SIDE, 1, 32
    canvas = np.random.default_rng(17).integers(0, 9, size=(n, n)).astype(np.int32)
    coords = np.zeros((2, 2), np.int32)  # one live leaf, one padding row
    jc, ne = _padded(coords, count)
    want = jops.region_dwell(jnp.asarray(canvas), jnp.asarray(jc),
                             jnp.asarray(ne), side=SIDE, n=n,
                             max_dwell=max_dwell, scheme="mbr", tile=TILE,
                             policy=JNP)
    t_canvas = torch.from_numpy(canvas.copy())
    out = region_dwell(t_canvas, torch.from_numpy(coords),
                       torch.tensor([count], dtype=torch.int32), side=SIDE,
                       n=n, max_dwell=max_dwell, scheme="mbr", tile=TILE)
    assert out is t_canvas
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert len(np.unique(out.numpy())) > 8  # a leaf with real structure


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_batched_ranks_many_groups_matches_jax(dtype):
    """G = 70,000 groups of [3, 2]: JAX's ranks are per column of [N, E],
    so the groups go side by side as its columns, [N, G * E]."""
    G, N, E = 70_000, 3, 2
    rng = np.random.default_rng(18)
    f = rng.integers(0, 4, size=(G, N, E))  # int32 flags add their value
    f = (f > 1) if dtype is np.bool_ else f.astype(np.int32)
    side_by_side = np.ascontiguousarray(f.transpose(1, 0, 2).reshape(N, G * E))
    jr, jc = jops.batched_ranks(jnp.asarray(side_by_side), policy=JNP)
    r, c = moe_dispatch.batched_ranks(torch.from_numpy(f))
    np.testing.assert_array_equal(
        r.numpy().transpose(1, 0, 2).reshape(N, G * E), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy().reshape(G * E), np.asarray(jc))
    assert r.dtype == torch.int32 and c.dtype == torch.int32
