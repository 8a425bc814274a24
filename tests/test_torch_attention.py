"""The port's attention mixer against the JAX package: chunked queries
(``q_chunk``) and the int8 KV cache.

Same parameters (``repro.models.attention.attn_init`` carried across by
``repro_torch.convert.module_from_jax``), same numpy inputs, f32, small
widths (d_model 32, 4 heads, 2 KV heads, head_dim 8).

Tolerance: outputs and f32 cache leaves at rtol 1e-5 / atol 1e-5 (the two
frameworks sum in other orders; the observed difference is about 1e-7).
The int8 values (``k_q``, ``v_q``) must be equal, and ``_quant_kv`` is
exact on the same input.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.convert import module_from_jax
from repro_torch.models import attention as TA
from repro_torch.models.common import Init

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
DIMS = dict(num_heads=4, num_kv_heads=2, head_dim=8)
D = 32


@functools.lru_cache(maxsize=None)
def _pair(qk_norm=False, seed=0):
    jp = JA.attn_init(jax.random.PRNGKey(seed), d_model=D, qk_norm=qk_norm, **DIMS)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = TA.Attention(Init("meta"), d_model=D, qk_norm=qk_norm,
                      **DIMS).to_empty(device="cpu")
    return jp, module_from_jax(tp, tree)


def _x(B, S, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("q_chunk", [None, 2, 4, 16])
@pytest.mark.parametrize("rope", ["1d", "2d"])
def test_attn_train_q_chunk_matches_jax(q_chunk, rope):
    jp, tp = _pair()
    x = _x(2, 8)
    want = JA.attn_train(jp, jnp.asarray(x), rope=rope, q_chunk=q_chunk, **DIMS)
    with torch.no_grad():
        got = TA.attn_train(tp, torch.from_numpy(x), rope=rope, q_chunk=q_chunk,
                            **DIMS)
        full = TA.attn_train(tp, torch.from_numpy(x), rope=rope, **DIMS)
    _close(got, want)
    torch.testing.assert_close(got, full, rtol=RTOL, atol=ATOL)


def test_q_chunk_not_dividing_raises_as_jax():
    jp, tp = _pair()
    x = _x(1, 6)
    with pytest.raises(ValueError, match="not divisible"):
        JA.attn_train(jp, jnp.asarray(x), q_chunk=4, **DIMS)
    with pytest.raises(ValueError, match="not divisible"):
        TA.attn_train(tp, torch.from_numpy(x), q_chunk=4, **DIMS)


def test_quant_kv_exact():
    """Per-(token, head) scale and int8 values equal JAX's on the same f32
    input: random rows, a zero row (scale floored at 1e-8), rows whose
    quotients fall on .5 (round half to even) and rows past +-127."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -127],
                          np.float32)
    x[1, 2, 2] *= 1e-30
    jq, js = JA._quant_kv(jnp.asarray(x))
    tq, ts = TA._quant_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == np.float32(1e-8)
    assert tq[0, 1, 1].tolist() == [127, 0, 2, 2, 0, -2, 64, -127]
    for dtype in (torch.float32, torch.bfloat16):
        want = JA._dequant_kv(jq, js, jnp.float32 if dtype == torch.float32
                              else jnp.bfloat16)
        got = TA._dequant_kv(tq, ts, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _jax_cache(jc, Sc):
    """JAX's prompt-length cache padded with zeros to Sc rows, as its serve
    CLI pads it."""
    def pad(a):
        a = np.asarray(a)
        out = np.zeros((a.shape[0], Sc) + a.shape[2:], a.dtype)
        out[:, :a.shape[1]] = a
        return jnp.asarray(out)
    return {k: pad(v) for k, v in jc.items()}


def _port_cache(B, Sc, quant):
    shape = (B, Sc, DIMS["num_kv_heads"], DIMS["head_dim"])
    if quant:
        return {"k_q": torch.zeros(shape, dtype=torch.int8),
                "k_s": torch.zeros(shape[:-1]),
                "v_q": torch.zeros(shape, dtype=torch.int8),
                "v_s": torch.zeros(shape[:-1])}
    return {"k": torch.zeros(shape), "v": torch.zeros(shape)}


def _same_cache(got, want, pos):
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype == np.int8:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{k} at {pos}")
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} at {pos}")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("q_chunk", [None, 2])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_prefill_and_decode_cache_match_jax(quant, q_chunk, qk_norm):
    """Prefill's output and cache, then each decode step's output and
    cache: the int8 values equal, the scales and outputs within 1e-5."""
    jp, tp = _pair(qk_norm=qk_norm)
    B, P, Sc = 2, 6, 10
    x = _x(B, Sc, seed=3)
    kw = dict(DIMS, qk_norm=qk_norm)
    jout, jc = JA.attn_prefill(jp, jnp.asarray(x[:, :P]), cache_len=P,
                               q_chunk=q_chunk, kv_quant=quant, **kw)
    cache = _port_cache(B, Sc, quant)
    with torch.no_grad():
        out, cache = TA.attn_prefill(tp, torch.from_numpy(x[:, :P]), cache,
                                     q_chunk=q_chunk, **kw)
    _close(out, jout, "prefill")
    jc = _jax_cache(jc, Sc)
    _same_cache(cache, jc, "prefill")
    jdec = jax.jit(functools.partial(JA.attn_decode, **kw))
    for pos in range(P, Sc):
        jout, jc = jdec(jp, jnp.asarray(x[:, pos:pos + 1]), jc, jnp.int32(pos))
        with torch.no_grad():
            out, cache = TA.attn_decode(tp, torch.from_numpy(x[:, pos:pos + 1]),
                                        cache, pos, **kw)
        _close(out, jout, f"decode at {pos}")
        _same_cache(cache, jc, pos)
