"""The port's MLA mixer (``repro_torch.models.mla``) against the JAX
package's ``repro.models.mla``.

Same parameters (``mla_init`` carried across by
``repro_torch.convert.module_from_jax``), same numpy inputs, f32, small
widths (d_model 32, 4 heads, kv_lora 16, d_nope 8, d_rope 4, d_v 8):
the non-absorbed train form, with and without ``q_chunk``; prefill's
output and latent cache; and the absorbed decode step's output and cache
after each step.

Tolerance: rtol 1e-5 / atol 1e-5 (the frameworks sum in other orders; the
observed difference is about 1e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JM
from repro_torch.convert import module_from_jax
from repro_torch.models import mla as TM
from repro_torch.models.common import Init

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D = 32
DIMS = dict(num_heads=4, kv_lora=16, d_nope=8, d_rope=4, d_v=8)


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    jp = JM.mla_init(jax.random.PRNGKey(seed), d_model=D, **DIMS)
    tp = TM.MLA(Init("meta"), d_model=D, **DIMS).to_empty(device="cpu")
    return jp, module_from_jax(tp, jax.tree_util.tree_map(np.asarray, jp))


def _x(B, S, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_mla_names_follow_jax():
    jp, tp = _pair()
    want = {".".join(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == want


@pytest.mark.parametrize("q_chunk", [None, 2, 4, 8])
def test_mla_train_matches_jax(q_chunk):
    jp, tp = _pair()
    x = _x(2, 8)
    want = JM.mla_train(jp, jnp.asarray(x), q_chunk=q_chunk, **DIMS)
    with torch.no_grad():
        got = TM.mla_train(tp, torch.from_numpy(x), q_chunk=q_chunk, **DIMS)
    assert got.shape == (2, 8, D)
    _close(got, want)


@pytest.mark.parametrize("q_chunk", [None, 3])
def test_mla_prefill_and_absorbed_decode_match_jax(q_chunk):
    """Prefill writes rows [0, P) of the latent cache (JAX pads them to the
    cache length); each absorbed decode step's output and cache equal
    JAX's."""
    jp, tp = _pair(seed=1)
    B, P, Sc = 2, 6, 11
    x = _x(B, Sc, seed=2)
    jout, jc = JM.mla_prefill(jp, jnp.asarray(x[:, :P]), cache_len=Sc,
                              q_chunk=q_chunk, **DIMS)
    cache = {"c_kv": torch.full((B, Sc, DIMS["kv_lora"]), 7.0),
             "k_rope": torch.zeros((B, Sc, DIMS["d_rope"]))}
    with torch.no_grad():
        out, cache = TM.mla_prefill(tp, torch.from_numpy(x[:, :P]), cache,
                                    q_chunk=q_chunk, **DIMS)
    _close(out, jout, "prefill")
    _close(cache["k_rope"], jc["k_rope"], "k_rope")
    _close(cache["c_kv"][:, :P], jc["c_kv"][:, :P], "c_kv")
    assert bool((cache["c_kv"][:, P:] == 7.0).all())  # rows past P untouched
    cache["c_kv"][:, P:] = 0.0
    jdec = jax.jit(functools.partial(JM.mla_decode, **DIMS))
    for pos in range(P, Sc):
        jout, jc = jdec(jp, jnp.asarray(x[:, pos:pos + 1]), jc, jnp.int32(pos))
        with torch.no_grad():
            out, cache = TM.mla_decode(tp, torch.from_numpy(x[:, pos:pos + 1]),
                                       cache, pos, **DIMS)
        _close(out, jout, f"decode at {pos}")
        for k in ("c_kv", "k_rope"):
            _close(cache[k], jc[k], f"{k} at {pos}")


def test_absorbed_decode_equals_train_form():
    """The absorbed step at the last position equals the non-absorbed
    train form's last row (the port alone; JAX's own tests do the same)."""
    _, tp = _pair(seed=3)
    B, S = 2, 7
    x = torch.from_numpy(_x(B, S, seed=4))
    cache = {"c_kv": torch.zeros((B, S, DIMS["kv_lora"])),
             "k_rope": torch.zeros((B, S, DIMS["d_rope"]))}
    with torch.no_grad():
        full = TM.mla_train(tp, x, **DIMS)
        TM.mla_prefill(tp, x[:, :S - 1], cache, **DIMS)
        step, _ = TM.mla_decode(tp, x[:, S - 1:], cache, S - 1, **DIMS)
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=RTOL, atol=ATOL)


def test_mla_bf16_scores_follow_jax_dtypes():
    """bf16 parameters and inputs: train and decode outputs within bf16
    rounding of JAX's (train widens the scores to f32 before the scale,
    decode divides them in bf16), rtol 2e-2 / atol 2e-2."""
    jp, _ = _pair(seed=5)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = TM.MLA(Init("meta"), d_model=D, dtype=torch.bfloat16,
                **DIMS).to_empty(device="cpu")
    tp = module_from_jax(tp, jax.tree_util.tree_map(np.asarray, jp16))
    x = _x(2, 6, seed=6)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = JM.mla_train(jp16, xj, **DIMS)
    with torch.no_grad():
        got = TM.mla_train(tp, xt, **DIMS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    jout, jc = JM.mla_prefill(jp16, xj[:, :5], cache_len=6, **DIMS)
    jstep, _ = JM.mla_decode(jp16, xj[:, 5:], jc, jnp.int32(5), **DIMS)
    cache = {"c_kv": torch.zeros((2, 6, DIMS["kv_lora"]), dtype=torch.bfloat16),
             "k_rope": torch.zeros((2, 6, DIMS["d_rope"]), dtype=torch.bfloat16)}
    with torch.no_grad():
        TM.mla_prefill(tp, xt[:, :5], cache, **DIMS)
        step, _ = TM.mla_decode(tp, xt[:, 5:], cache, 5, **DIMS)
    np.testing.assert_allclose(step.float().numpy(), np.asarray(jstep, np.float32),
                               rtol=2e-2, atol=2e-2)
