"""The port's MoE dispatch against the JAX package on the same numpy inputs.

* The batched ranks (``repro_torch.kernels.ref.batched_ranks``, the plain
  version of the batched-ranks CUDA kernel, and the CPU path of its wrapper
  and of ``ops.batched_ranks``) against the Pallas kernel
  ``repro.kernels.moe_dispatch.batched_ranks_kernel`` in interpret mode and
  ``repro.core.olt.batched_compact_ranks``: integers, exactly.
* ``moe_apply`` against ``repro.models.moe.moe_apply`` on the reduced
  moonshot-v1-16b-a3b MoE (8 experts, top-2) in f32, with groups of 1024
  and of 8 tokens and capacity factors 1.25 and 0.5 (tokens drop): the
  routing (expert ids, positions, keep, per-group counts) exactly, ``y``
  within rtol 1e-5 / atol 1e-6 (the combine sums up to K products in
  another order than XLA; the observed error is about 1e-7).
* The dense fallback at capacity factor 8 (nothing drops) against JAX's
  and against the dispatch path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import olt as jolt
from repro.kernels.moe_dispatch import batched_ranks_kernel
from repro.models import moe as jmoe
from repro_torch.core import olt as tolt
from repro_torch.kernels import moe_dispatch, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Init

# small tensors: torch's own thread pool would only fight the other test
# workers for the cores
torch.set_num_threads(1)


def _flags(kind, N, E, seed=0):
    if kind == "zeros":
        return np.zeros((N, E), np.int32)
    if kind == "ones":
        return np.ones((N, E), np.int32)
    return (np.random.default_rng(seed + N * 131 + E).random((N, E)) < 0.3
            ).astype(np.int32)


# -- batched ranks ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zeros", "ones", "random"])
@pytest.mark.parametrize("E", [1, 8, 64, 100])
@pytest.mark.parametrize("N", [1, 31, 48, 6144])
def test_batched_ranks_matches_pallas_and_olt(N, E, kind):
    f = _flags(kind, N, E)
    jr, jc = batched_ranks_kernel(jnp.asarray(f), interpret=True)
    or_, oc = jolt.batched_compact_ranks(jnp.asarray(f))
    tr, tc = tref.batched_ranks(torch.from_numpy(f)[None])
    assert tr.dtype == torch.int32 and tc.dtype == torch.int32
    assert tuple(tr.shape) == (1, N, E) and tuple(tc.shape) == (1, E)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(or_))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(oc))
    # bool flags give the same ranks, through every CPU entry point
    fb = torch.from_numpy(f.astype(bool))
    for r, c in (ops.batched_ranks(fb), tolt.batched_compact_ranks(fb)):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(c.numpy(), np.asarray(oc))


def test_batched_ranks_groups_are_independent():
    """[G, N, E]: each group is the [N, E] scan of its own flags."""
    f = np.stack([_flags("random", 48, 64, seed=g) for g in range(4)])
    tr, tc = moe_dispatch.batched_ranks(torch.from_numpy(f))
    gr, gc = ops.batched_ranks(torch.from_numpy(f))
    for g in range(4):
        jr, jc = jolt.batched_compact_ranks(jnp.asarray(f[g]))
        np.testing.assert_array_equal(tr[g].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc[g].numpy(), np.asarray(jc))
    assert torch.equal(tr, gr) and torch.equal(tc, gc)


def test_batched_ranks_int32_flags_add_their_value():
    f = np.random.default_rng(3).integers(0, 4, (31, 5)).astype(np.int32)
    jr, jc = jolt.batched_compact_ranks(jnp.asarray(f))
    tr, tc = ops.batched_ranks(torch.from_numpy(f))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_batched_ranks_empty():
    tr, tc = tref.batched_ranks(torch.zeros((2, 0, 3), dtype=torch.int32))
    assert tuple(tr.shape) == (2, 0, 3)
    assert torch.equal(tc, torch.zeros((2, 3), dtype=torch.int32))


# -- moe_apply ---------------------------------------------------------------------

CFG = jax_config("moonshot-v1-16b-a3b").reduced()
MO = CFG.moe


def _moe_pair(seed=0, num_shared=0):
    """JAX's MoE parameters and the port's MoE holding the same values."""
    kw = dict(d_model=CFG.d_model, d_ff=MO.d_ff, num_experts=MO.num_experts,
              top_k=MO.top_k, num_shared=num_shared, act=CFG.act)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), **kw, dtype=jnp.float32)
    tp = tmoe.MoE(Init("cpu", seed), **kw, dtype=torch.float32)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for name, p in tp.named_parameters():
        path = tuple(jax.tree_util.DictKey(k) for k in name.split("."))
        p.data.copy_(torch.from_numpy(np.array(flat.pop(path))))
    assert not flat, f"JAX leaves with no port parameter: {list(flat)}"
    return jp, tp


def _x(seed=0, B=4, S=16):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (B, S, CFG.d_model)).astype(np.float32)


def _jax_routing(jp, x, *, group_size, capacity_factor):
    """The routing ``repro.models.moe.moe_apply`` computes (lines 86-101 of
    its source, spelled out: the function returns only y and aux)."""
    B, S, D = x.shape
    T = B * S
    E, K = MO.num_experts, MO.top_k
    Sg = min(group_size, T)
    if T % Sg:
        Sg = T
    G = T // Sg
    xg = jnp.asarray(x).reshape(G, Sg, D)
    logits = jnp.einsum("gsd,de->gse", xg, jp["router"]["w"].astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, K)
    oh = jax.nn.one_hot(expert_ids.reshape(G, Sg * K), E, dtype=jnp.int32)
    inc = jnp.cumsum(oh, axis=1)
    pos = jnp.sum((inc - oh) * oh, axis=-1).reshape(G, Sg, K)
    C = max(1, int(capacity_factor * Sg * K / E))
    keep = (pos < C).astype(jnp.float32)
    return dict(expert_ids=expert_ids, pos=pos, keep=keep,
                counts=inc[:, -1, :], capacity=C)


def _port_routing(calls, *, top_k, capacity_factor):
    """The routing of one ``moe_apply``, from its one recorded
    ``ops.batched_ranks`` call: the expert ids are the set column of each
    flag row, ``pos`` is the rank at that column (as ``moe_apply`` gathers
    it), ``keep`` is ``pos`` under the capacity."""
    (flags, ranks, counts), = calls
    G, N, E = flags.shape
    Sg = N // top_k
    ids = flags.argmax(dim=2, keepdim=True)  # one set column per row
    pos = ranks.gather(2, ids).reshape(G, Sg, top_k)
    C = tmoe.capacity(capacity_factor, Sg, top_k, E)
    return dict(expert_ids=ids.reshape(G, Sg, top_k), pos=pos,
                keep=(pos < C).float(), counts=counts, capacity=C)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("group_size", [1024, 8])
def test_moe_apply_matches_jax(group_size, capacity_factor, monkeypatch):
    jp, tp = _moe_pair()
    x = _x()
    kw = dict(num_experts=MO.num_experts, top_k=MO.top_k,
              capacity_factor=capacity_factor, act=CFG.act,
              group_size=group_size)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), **kw)
    calls, inner = [], ops.batched_ranks

    def recording(flags):
        ranks, counts = inner(flags)
        calls.append((flags, ranks, counts))
        return ranks, counts

    monkeypatch.setattr(ops, "batched_ranks", recording)
    with torch.no_grad():
        ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), **kw)
    route = _port_routing(calls, top_k=MO.top_k, capacity_factor=capacity_factor)
    want = _jax_routing(jp, x, group_size=group_size,
                        capacity_factor=capacity_factor)
    assert route["capacity"] == want["capacity"]
    assert int(calls[0][0].sum(dim=2).max()) == 1  # one expert per flag row
    G = 1 if group_size == 1024 else x.shape[0] * x.shape[1] // group_size
    assert route["counts"].shape == (G, MO.num_experts)
    for k in ("expert_ids", "pos", "keep", "counts"):
        np.testing.assert_array_equal(route[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    if capacity_factor < 1:
        assert float(route["keep"].mean()) < 1.0  # some tokens dropped
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)


def test_moe_dense_fallback_matches_jax_and_dispatch():
    jp, tp = _moe_pair(seed=1, num_shared=1)
    x = _x(seed=1, B=2, S=8)
    kw = dict(num_experts=MO.num_experts, top_k=MO.top_k, act=CFG.act)
    jd = jmoe.moe_apply_dense_fallback(jp, jnp.asarray(x), **kw)
    with torch.no_grad():
        td = tmoe.moe_apply_dense_fallback(tp, torch.from_numpy(x), **kw)
        ty, _ = tmoe.moe_apply(tp, torch.from_numpy(x), capacity_factor=8.0, **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), td.numpy(), rtol=1e-5, atol=1e-6)


def test_decode_capacity_is_one_slot():
    """8 tokens, 64 experts, top-6, cf 1.25: int(0.9375) = 0 -> C = 1."""
    assert tmoe.capacity(1.25, 8, 6, 64) == 1
    assert tmoe.capacity(1.25, 1024, 6, 64) == 120


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 4)
    tv, ti = tmoe._top_k(torch.from_numpy(probs), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("axes", [dict(ep_axis="model"), dict(token_axes=("data",))])
def test_moe_mesh_axes_without_a_mesh_raise(axes):
    """``ep_axis`` / ``token_axes`` name axes of a mesh; without one (no
    process group) no collective can run, so the call raises rather than
    computing unsharded (the sharded MoE: test_torch_sharded_step.py)."""
    _, tp = _moe_pair()
    with pytest.raises(ValueError, match="no mesh was given"):
        tmoe.moe_apply(tp, torch.from_numpy(_x()), num_experts=MO.num_experts,
                       top_k=MO.top_k, **axes)


def test_batched_ranks_other_devices_raise():
    """Only a CPU tensor takes the plain version; anything else that is
    not CUDA raises (a CUDA tensor launches the kernel or raises)."""
    with pytest.raises(ValueError, match="unsupported device"):
        moe_dispatch.batched_ranks(torch.zeros((1, 4, 2), dtype=torch.int32,
                                               device="meta"))
