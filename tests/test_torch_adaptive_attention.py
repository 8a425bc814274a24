"""The port's ASK-refined decode attention
(``repro_torch.core.adaptive_attention``) against the JAX package's
``repro.core.adaptive_attention``, on ``tests/test_adaptive_attention.py``'s
inputs (its ``_qkv``: planted hot keys), at full and at partial capacity,
with a partly filled cache, and on blocks whose bounds tie.

Tolerance: outputs and envelopes at rtol 1e-5 / atol 1e-5 (the observed
difference is about 1e-7); the kept-block counts and fractions must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive_attention as JA
from repro_torch.core import adaptive_attention as TA
from test_adaptive_attention import _qkv

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _both(*arrays):
    """(JAX arrays, torch tensors) of the same f32 values."""
    np_ = [np.array(a, np.float32) for a in arrays]
    return [jnp.asarray(a) for a in np_], [torch.from_numpy(a) for a in np_]


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _same_stats(got, want):
    assert got["leaf_blocks"] == want["leaf_blocks"]
    np.testing.assert_array_equal(got["kept_blocks"].numpy(),
                                  np.asarray(want["kept_blocks"]))
    np.testing.assert_array_equal(got["kept_fraction"].numpy(),
                                  np.asarray(want["kept_fraction"]))


def test_envelope_pyramid_matches_jax():
    (q, k, _), (tq, tk, _) = _both(*_qkv())
    want = JA.build_envelope_pyramid(k, g=8, r=2, B=64)
    got = TA.build_envelope_pyramid(tk, g=8, r=2, B=64)
    assert len(got) == len(want) == 1
    got = TA.build_envelope_pyramid(tk, g=4, r=2, B=16)
    want = JA.build_envelope_pyramid(k, g=4, r=2, B=16)
    assert [a.shape[1] for a, _ in got] == [4, 8, 16, 32]
    for (a, b), (c, d) in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))


@pytest.mark.parametrize("S,g,r,B,margin,capacity,live_len", [
    (512, 8, 2, 64, 1e9, 8, None),      # full capacity: exact attention
    (1024, 16, 2, 32, 12.0, 8, None),   # 8 of 32 leaves
    (1024, 16, 2, 32, 12.0, None, None),  # the default capacity, half
    (1024, 4, 4, 16, 3.0, 5, None),     # r = 4, a tight margin
    (256, 8, 2, 16, 1e9, 16, 100),      # a partly filled cache
    (256, 8, 2, 16, 6.0, 4, 77),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_decode_attention_matches_jax(S, g, r, B, margin, capacity,
                                               live_len, seed):
    (q, k, v), (tq, tk, tv) = _both(*_qkv(S=S, seed=seed))
    kw = dict(g=g, r=r, B=B, margin=margin, capacity=capacity,
              live_len=live_len)
    want, wst = JA.adaptive_decode_attention(q, k, v, **kw)
    got, st = TA.adaptive_decode_attention(tq, tk, tv, **kw)
    _close(got, want)
    _same_stats(st, wst)
    _close(TA.exact_decode_attention(tq, tk, tv, live_len=live_len),
           JA.exact_decode_attention(q, k, v, live_len=live_len), "exact")


def test_tied_bounds_pick_the_lower_blocks():
    """Every leaf block holds the same keys in another order, so every
    bound ties; the values differ by block, so the output shows which
    blocks were picked: the lowest indices, as jax.lax.top_k picks."""
    rng = np.random.default_rng(3)
    Bt, H, dh, blk, n_leaf = 2, 3, 8, 16, 8
    base = rng.normal(size=(Bt, blk, H, dh)).astype(np.float32)
    k = np.concatenate([base[:, rng.permutation(blk)] for _ in range(n_leaf)],
                       axis=1)
    v = rng.normal(size=(Bt, blk * n_leaf, H, dh)).astype(np.float32)
    q = rng.normal(size=(Bt, H, dh)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    for capacity in (1, 3, 5):
        kw = dict(g=2, r=2, B=blk, margin=1e9, capacity=capacity)
        want, wst = JA.adaptive_decode_attention(jq, jk, jv, **kw)
        got, st = TA.adaptive_decode_attention(tq, tk, tv, **kw)
        _close(got, want, f"capacity {capacity}")
        _same_stats(st, wst)
        lowest, _ = TA.adaptive_decode_attention(
            tq, tk[:, :capacity * blk], tv[:, :capacity * blk], g=1, r=2,
            B=capacity * blk, margin=1e9, capacity=1)
        _close(got, lowest.numpy(), "the lowest blocks")
