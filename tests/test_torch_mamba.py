"""The port's Mamba mixer (``repro_torch.models.mamba``) against the JAX
package's ``repro.models.mamba``.

Same parameters (``mamba_init`` carried across by
``repro_torch.convert.module_from_jax``: the nested ``dt_proj`` and the
f32 ``A_log`` and ``D``), same numpy inputs, f32, d_model 24 (dt_rank 1,
d_inner 48), d_state 16, d_conv 4: the train pass (prompts of 4, 10 and 37
steps, more than one block of the port's time loop), its final state, and
each decode step's output and state after it. Prompts are at least d_conv
long: JAX's conv tail has no shape for shorter ones.

Tolerance: rtol 1e-5 / atol 1e-5 (the observed difference is about 1e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import mamba as JM
from repro_torch.convert import module_from_jax
from repro_torch.models import mamba as TM
from repro_torch.models.common import Init

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
D = 24


@functools.lru_cache(maxsize=None)
def _pair(seed=0, dt_bias=None):
    jp = JM.mamba_init(jax.random.PRNGKey(seed), d_model=D)
    if dt_bias is not None:  # push softplus's argument past 20 and far below
        b = np.asarray(jp["dt_proj"]["b"]).copy()
        b[::3], b[1::3] = dt_bias, -dt_bias
        jp = dict(jp, dt_proj=dict(jp["dt_proj"], b=jnp.asarray(b)))
    tp = TM.Mamba(Init("meta"), d_model=D).to_empty(device="cpu")
    return jp, module_from_jax(tp, jax.tree_util.tree_map(np.asarray, jp))


def _x(B, S, seed=0):
    return (0.5 * np.random.default_rng(seed).normal(size=(B, S, D))).astype(
        np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_mamba_leaves_and_dtypes_follow_jax():
    jp, tp = _pair()
    want = {".".join(k.key for k in path): (leaf.shape, str(leaf.dtype)) for
            path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {n: (tuple(p.shape), str(p.dtype)[6:]) for n, p in tp.named_parameters()}
    assert got == want
    assert "dt_proj.w" in got and "dt_proj.b" in got
    # bf16 parameters keep A_log and D in f32, and the seeded init gives
    # JAX's A_log, D and dt bias
    m = TM.Mamba(Init("cpu", 0), d_model=D, dtype=torch.bfloat16)
    assert m.in_proj.w.dtype == torch.bfloat16
    assert m.A_log.dtype == m.D.dtype == torch.float32
    np.testing.assert_allclose(m.A_log.numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-7)
    assert bool((m.D == 1).all()) and bool((m.dt_proj.b == torch.tensor(
        -4.6, dtype=torch.bfloat16)).all())


def test_softplus_is_jax_past_the_threshold():
    """JAX's logaddexp(x, 0) on both sides of F.softplus's threshold of 20:
    past it all three are x exactly; below it within an ulp, and within
    the smallest normal f32 (1.2e-38) at x = -100, where the result is
    subnormal and XLA:CPU flushes it to zero."""
    x = np.array([-100, -30, -20.5, -1, -1e-3, 0, 1e-3, 1, 5, 19.9, 20, 20.001,
                  20.5, 25, 30, 88, 100, 1e4], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TM.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=float(np.finfo(np.float32).tiny))
    past = x > 20
    np.testing.assert_array_equal(got[past], x[past])
    np.testing.assert_array_equal(want[past], x[past])
    np.testing.assert_array_equal(F.softplus(torch.from_numpy(x)).numpy()[past],
                                  x[past])


@pytest.mark.parametrize("S", [4, 10, 37])
@pytest.mark.parametrize("dt_bias", [None, 24.0])
def test_mamba_train_and_state_match_jax(S, dt_bias):
    jp, tp = _pair(dt_bias=dt_bias)
    x = _x(2, S, seed=S)
    jout, jst = JM.mamba_train(jp, jnp.asarray(x), return_state=True)
    with torch.no_grad():
        out, st = TM.mamba_train(tp, torch.from_numpy(x), return_state=True)
        plain = TM.mamba_train(tp, torch.from_numpy(x))
    _close(out, jout, "out")
    assert torch.equal(plain, out)
    assert st["conv"].shape == (2, 3, 2 * D) and st["ssm"].dtype == torch.float32
    _close(st["conv"], jst["conv"], "conv")
    _close(st["ssm"], jst["ssm"], "ssm")


def test_mamba_prefill_then_decode_match_jax():
    """Prefill writes its final states into the cache in place; each decode
    step's output, conv window and state equal JAX's."""
    jp, tp = _pair(seed=1, dt_bias=22.0)
    B, P, S = 2, 7, 13
    x = _x(B, S, seed=5)
    jout, jc = JM.mamba_train(jp, jnp.asarray(x[:, :P]), return_state=True)
    cache = TM.mamba_init_cache(B, d_model=D, device="cpu")
    assert cache["conv"].dtype == torch.float32 and cache["ssm"].shape == (B, 2 * D, 16)
    with torch.no_grad():
        out, cache = TM.mamba_prefill(tp, torch.from_numpy(x[:, :P]), cache)
    _close(out, jout, "prefill")
    jdec = jax.jit(JM.mamba_decode)
    for t in range(P, S):
        jout, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        with torch.no_grad():
            out, cache = TM.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache)
        _close(out, jout, f"decode at {t}")
        _close(cache["conv"], jc["conv"], f"conv at {t}")
        _close(cache["ssm"], jc["ssm"], f"ssm at {t}")


def test_mamba_init_cache_dtypes():
    c = TM.mamba_init_cache(3, d_model=8, d_state=4, d_conv=4, expand=2,
                            dtype=torch.bfloat16, device="cpu")
    j = JM.mamba_init_cache(3, d_model=8, d_state=4, d_conv=4, expand=2,
                            dtype=jnp.bfloat16)
    for k in ("conv", "ssm"):
        assert tuple(c[k].shape) == j[k].shape
        assert str(c[k].dtype)[6:] == str(j[k].dtype)
        assert not bool(c[k].any())


def test_short_prompt_raises():
    _, tp = _pair()
    with pytest.raises(ValueError, match="conv tail"):
        TM.mamba_train(tp, torch.zeros((1, 2, D)), return_state=True)
