"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the JAX
package's ``repro.models.xlstm``.

Same parameters (``mlstm_init`` / ``slstm_init`` carried across by
``repro_torch.convert.module_from_jax``), same numpy inputs, f32, d_model
32, 4 heads (mLSTM dh 16): the mLSTM's parallel form with and without
``q_chunk`` (a q_chunk that does not divide S runs unchunked, as in JAX),
its closed-form final state, its ``parallel=False`` recurrent arm, and the
recurrent decode from the parallel prefill's state; the sLSTM's loop, its
state and decode. States are compared after prefill and after each
decode step, so a wrong m floor shows from the second step on.

Tolerance: rtol 1e-5 / atol 1e-5 (the observed difference is about 1e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro_torch.convert import module_from_jax
from repro_torch.models import xlstm as TX
from repro_torch.models.common import Init

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D, H = 32, 4


@functools.lru_cache(maxsize=None)
def _mlstm(seed=0):
    jp = JX.mlstm_init(jax.random.PRNGKey(seed), d_model=D, num_heads=H)
    tp = TX.MLSTM(Init("meta"), d_model=D, num_heads=H).to_empty(device="cpu")
    return jp, module_from_jax(tp, jax.tree_util.tree_map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _slstm(seed=0):
    jp = JX.slstm_init(jax.random.PRNGKey(seed), d_model=D, num_heads=H)
    tp = TX.SLSTM(Init("meta"), d_model=D).to_empty(device="cpu")
    return jp, module_from_jax(tp, jax.tree_util.tree_map(np.asarray, jp))


def _x(B, S, seed=0):
    return (0.5 * np.random.default_rng(seed).normal(size=(B, S, D))).astype(
        np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _same_state(got, want, msg):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], f"{k} {msg}")


@pytest.mark.parametrize("q_chunk", [None, 4, 5, 16])
def test_mlstm_parallel_matches_jax(q_chunk):
    jp, tp = _mlstm()
    x = _x(2, 16)
    jout, jst = JX.mlstm_train(jp, jnp.asarray(x), num_heads=H,
                               return_state=True, q_chunk=q_chunk)
    with torch.no_grad():
        out, st = TX.mlstm_train(tp, torch.from_numpy(x), num_heads=H,
                                 return_state=True, q_chunk=q_chunk)
    _close(out, jout)
    _same_state(st, jst, "after the parallel form")


def test_mlstm_recurrent_arm_matches_jax():
    jp, tp = _mlstm(seed=1)
    x = _x(2, 9, seed=1)
    jout, jst = JX.mlstm_train(jp, jnp.asarray(x), num_heads=H,
                               return_state=True, parallel=False)
    with torch.no_grad():
        out, st = TX.mlstm_train(tp, torch.from_numpy(x), num_heads=H,
                                 return_state=True, parallel=False)
    _close(out, jout)
    _same_state(st, jst, "after the recurrence")


@pytest.mark.parametrize("q_chunk", [None, 3])
def test_mlstm_prefill_then_decode_match_jax(q_chunk):
    """The parallel prefill hands its closed-form state to the recurrent
    decode; output and (C, n, m) equal JAX's after each of 5 steps."""
    jp, tp = _mlstm(seed=2)
    B, P, S = 2, 6, 11
    x = _x(B, S, seed=2)
    jout, jc = JX.mlstm_train(jp, jnp.asarray(x[:, :P]), num_heads=H,
                              return_state=True, q_chunk=q_chunk)
    cache = TX.mlstm_init_cache(B, d_model=D, num_heads=H, device="cpu")
    with torch.no_grad():
        out, cache = TX.mlstm_prefill(tp, torch.from_numpy(x[:, :P]), cache,
                                      num_heads=H, q_chunk=q_chunk)
    _close(out, jout, "prefill")
    _same_state(cache, jc, "after prefill")
    jdec = jax.jit(functools.partial(JX.mlstm_decode, num_heads=H))
    for t in range(P, S):
        jout, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        with torch.no_grad():
            out, cache = TX.mlstm_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                         cache, num_heads=H)
        _close(out, jout, f"decode at {t}")
        _same_state(cache, jc, f"after decode at {t}")


def test_mlstm_parallel_equals_recurrent_in_the_port():
    """The port's two forms agree (outputs 1e-5; states 1e-5, tighter than
    the 1e-3 JAX's own test allows its forms)."""
    _, tp = _mlstm(seed=3)
    x = torch.from_numpy(_x(2, 12, seed=3))
    with torch.no_grad():
        a, sa = TX.mlstm_train(tp, x, num_heads=H, return_state=True)
        b, sb = TX.mlstm_train(tp, x, num_heads=H, return_state=True,
                               parallel=False)
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=RTOL, atol=ATOL)


def test_mlstm_init_cache_matches_jax():
    c = TX.mlstm_init_cache(3, d_model=D, num_heads=H, device="cpu")
    j = JX.mlstm_init_cache(3, d_model=D, num_heads=H)
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        k: v.shape for k, v in j.items()}


def test_slstm_train_and_state_match_jax():
    jp, tp = _slstm()
    x = _x(2, 9)
    jout, jst = JX.slstm_train(jp, jnp.asarray(x), num_heads=H, return_state=True)
    with torch.no_grad():
        out, st = TX.slstm_train(tp, torch.from_numpy(x), num_heads=H,
                                 return_state=True)
    _close(out, jout)
    _same_state(st, jst, "after the loop")


def test_slstm_prefill_then_decode_match_jax():
    jp, tp = _slstm(seed=1)
    B, P, S = 2, 5, 10
    x = _x(B, S, seed=4)
    jout, jc = JX.slstm_train(jp, jnp.asarray(x[:, :P]), num_heads=H,
                              return_state=True)
    cache = TX.slstm_init_cache(B, d_model=D, device="cpu")
    with torch.no_grad():
        out, cache = TX.slstm_prefill(tp, torch.from_numpy(x[:, :P]), cache,
                                      num_heads=H)
    _close(out, jout, "prefill")
    _same_state(cache, jc, "after prefill")
    jdec = jax.jit(functools.partial(JX.slstm_decode, num_heads=H))
    for t in range(P, S):
        jout, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        with torch.no_grad():
            out, cache = TX.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                         cache, num_heads=H)
        _close(out, jout, f"decode at {t}")
        _same_state(cache, jc, f"after decode at {t}")
    # the three states are separate tensors (written in place)
    assert len({cache[k].data_ptr() for k in cache}) == 3


def test_xlstm_leaves_follow_jax():
    for (jp, tp) in (_mlstm(), _slstm()):
        want = {".".join(k.key for k in path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
        assert {n: tuple(p.shape) for n, p in tp.named_parameters()} == want
