"""The port's encoder-decoder and cross-attention families against the JAX
package: whisper-large-v3 (the encoder, ``attn_cross``, sinusoidal
positions) and llama-3.2-vision-90b (``cross`` layers over the media).

Same parameters (carried across by ``repro_torch.convert``), same numpy
tokens and media, f32 reduced configs (tests/test_torch_models.py's
``_pair``; ``-gqa`` is 2 KV heads under 4 query heads, ``-int8`` the int8
KV cache, ``-qchunk`` queries in chunks of 2 rows).

Tolerance: the attention outputs, the encoder's memory, the logits and the
f32 cache leaves at rtol 1e-5 / atol 1e-5 (the frameworks sum in other
orders). ``sinusoidal_pos`` is bit for bit JAX's, ``sinusoidal_at``
within 1e-7 (JAX's sine and cosine and torch's differ by up to one f32 ulp
below 1: 5.96e-8 at most over positions 0-1499 at d = 64 and 1280). The
int8 cache values and every greedy token must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from test_torch_attention import D, DIMS, _pair as _attn_pair, _x
from test_torch_models import (CROSS, _as, _close, _jax_generate, _media, _pair,
                               _tokens, match_jax)

torch.set_num_threads(1)


# -- sinusoidal positions ---------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1, 64), (448, 64), (1500, 1280)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_pos_bit_for_bit(seq, d, dtype):
    want = np.asarray(JC.sinusoidal_pos(seq, d, getattr(jnp, dtype)), np.float32)
    got = TC.sinusoidal_pos(seq, d, getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (seq, d)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoidal_at_matches_jax(d):
    """Rows at decode positions against JAX's, and against the table."""
    table = TC.sinusoidal_pos(1500, d, device="cpu")
    for pos in (0, 1, 5, 63, 223, 447, 1499):
        want = np.asarray(JC.sinusoidal_at(jnp.int32(pos), d))
        got = TC.sinusoidal_at(pos, d, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7,
                                   err_msg=f"pos {pos}")
        # the table's numpy sine is another implementation again
        np.testing.assert_allclose(got.numpy(), table[pos].numpy(), rtol=0,
                                   atol=5e-4)


@pytest.mark.parametrize("fn,arg", [(TC.sinusoidal_pos, 4), (TC.sinusoidal_at, 3)])
def test_sinusoidal_defaults_to_the_card(fn, arg, monkeypatch):
    """With no device given both run on the card, and raise with none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fn(arg, 64)


# -- cross-attention and bidirectional attention --------------------------------

def _mem(B, Sk, seed=3):
    return np.random.default_rng(seed).normal(size=(B, Sk, D)).astype(np.float32)


@pytest.mark.parametrize("q_chunk", [None, 2, 4])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(q_chunk, qk_norm):
    """``kv_x``: 8 queries over 20 memory rows, 4 heads over 2 KV heads;
    no rope on either side (rope="1d" is asked for and not applied), no
    mask. Chunked queries equal the whole."""
    jp, tp = _attn_pair(qk_norm=qk_norm)
    x, mem = _x(2, 8), _mem(2, 20)
    want = JA.attn_train(jp, jnp.asarray(x), kv_x=jnp.asarray(mem),
                         q_chunk=q_chunk, qk_norm=qk_norm, **DIMS)
    with torch.no_grad():
        kw = dict(kv_x=torch.from_numpy(mem), qk_norm=qk_norm, **DIMS)
        got = TA.attn_train(tp, torch.from_numpy(x), q_chunk=q_chunk, **kw)
        whole = TA.attn_train(tp, torch.from_numpy(x), **kw)
    assert got.shape == (2, 8, D)
    _close(got, want)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_chunk", [None, 4])
@pytest.mark.parametrize("rope", ["none", "1d"])
def test_bidirectional_attention_matches_jax(q_chunk, rope):
    """``causal=False``: every query sees every key (rope, when asked for,
    on both sides); the causal output differs."""
    jp, tp = _attn_pair()
    x = _x(2, 8, seed=4)
    want = JA.attn_train(jp, jnp.asarray(x), causal=False, rope=rope,
                         q_chunk=q_chunk, **DIMS)
    with torch.no_grad():
        got = TA.attn_train(tp, torch.from_numpy(x), causal=False, rope=rope,
                            q_chunk=q_chunk, **DIMS)
        causal = TA.attn_train(tp, torch.from_numpy(x), rope=rope, **DIMS)
    _close(got, want)
    assert not torch.allclose(got[:, :-1], causal[:, :-1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[:, -1], causal[:, -1], rtol=1e-5, atol=1e-5)


# -- the whole model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-large-v3", "whisper-large-v3-qchunk"])
def test_encode_matches_jax(arch):
    jc, tc, params, model = _pair(arch)
    frames = _media(jc, 2)
    want = JT.encode(jc, params, jnp.asarray(frames))
    with torch.no_grad():
        got = TT.encode(tc, model, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got, want)


@pytest.mark.parametrize("arch", ["whisper-large-v3-int8",
                                  "whisper-large-v3-qchunk",
                                  "llama-3.2-vision-90b-gqa",
                                  "llama-3.2-vision-90b-qchunk"])
def test_cross_families_match_jax(arch):
    """forward with media, prefill and every decode step, the attention
    caches after prefill and after each step (int8 values exact)."""
    match_jax(arch)


@pytest.mark.parametrize("arch", [*CROSS, "llama-3.2-vision-90b-gqa"])
def test_generate_tokens_equal_jax(arch):
    """``serve.generate`` against JAX's ``make_prefill_step`` /
    ``make_serve_step`` on the same media, JAX's ``encode`` giving its
    decode memory for whisper."""
    jc, tc, params, model = _pair(arch)
    toks = _tokens(jc, 2, 16, seed=5)
    media = _media(jc, 2, seed=5)
    want = _jax_generate(jc, params, toks, 6, media)
    res = tserve.generate(tc, model, torch.from_numpy(toks).long(), 6,
                          media=torch.from_numpy(media))
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (2, 6)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert (res.encode_ms > 0) == bool(tc.encoder_layers)


@pytest.mark.parametrize("arch", CROSS)
def test_decode_without_memory_raises(arch):
    """A cross slot with no memory: the port raises (JAX would run the
    layer as self-attention); prefill gives the cache that decode needs."""
    jc, tc, params, model = _pair(arch)
    t = torch.from_numpy(_tokens(jc, 2, 6)).long()
    media = _as(_media(jc, 2), torch.from_numpy)
    with torch.no_grad():
        _, cache = TT.prefill(tc, model, t, media, cache_len=7)
        assert set(cache) == {str(j) for j, s in enumerate(tc.pattern)
                              if s.mixer != "cross"}
        with pytest.raises(ValueError, match="memory"):
            TT.decode_step(tc, model, cache, t[:, :1], 6)


@pytest.mark.parametrize("entry", ["forward", "prefill", "generate"])
@pytest.mark.parametrize("arch", CROSS)
def test_cross_layers_need_media(arch, entry):
    """With no media, every entry point refuses a config with a cross
    slot before it runs a layer (JAX fails there too), rather than run
    those layers as self-attention."""
    _, tc, _, model = _pair(arch)
    t = torch.zeros((1, 4), dtype=torch.long)
    run = {"forward": lambda: TT.forward(tc, model, t),
           "prefill": lambda: TT.prefill(tc, model, t),
           "generate": lambda: tserve.generate(tc, model, t, 3)}[entry]
    with pytest.raises(ValueError, match="need the media"):
        run()


def test_decode_does_not_encode_frames():
    """Audio frames given to a decode step in place of the memory: the
    step raises rather than encode them at every token."""
    jc, tc, _, model = _pair("whisper-large-v3")
    t = torch.from_numpy(_tokens(jc, 2, 6)).long()
    media = torch.from_numpy(_media(jc, 2))
    with torch.no_grad():
        _, cache = TT.prefill(tc, model, t, media, cache_len=7)
        with pytest.raises(ValueError, match="memory"):
            TT.decode_step(tc, model, cache, t[:, :1], 6, media=media)


def test_encoder_needs_frames():
    _, tc, _, model = _pair("whisper-large-v3")
    t = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        TT.forward(tc, model, t)
    _, qc, _, qwen = _pair("qwen3-4b")
    with pytest.raises(ValueError, match="no encoder"):
        TT.encode(qc, qwen, torch.zeros((1, 4, qc.d_model)))
