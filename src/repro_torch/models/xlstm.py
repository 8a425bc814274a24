"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro/models/xlstm.py``. Both blocks carry their own up
and down projections (the config has no FFN). Exponential gating is
stabilised with the max-state m (log space). State per head: mLSTM C
[dh, dh], n [dh], m []; sLSTM c, n, m per hidden unit; all f32.

``mlstm_train`` uses the parallel form by default (a masked matmul over
query rows, chunked under ``q_chunk``); its ``return_state`` gives the
state the recurrence would reach, in closed form. ``parallel=False`` and
``mlstm_decode`` run the recurrent step. ``slstm_train`` is a Python loop
over time (JAX's ``lax.scan``). None of this is a Pallas kernel in JAX.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import query_chunks
from repro_torch.models.common import Init, Linear, f32, gelu, linear

__all__ = ["MLSTM", "SLSTM", "mlstm_train", "mlstm_prefill", "mlstm_init_cache",
           "mlstm_decode", "slstm_train", "slstm_prefill", "slstm_init_cache",
           "slstm_decode"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """JAX's ``mlstm_init``: ``up``, ``wq``, ``wk``, ``wv``, ``wi`` and
    ``wf`` (with biases, one gate a head), ``wo_gate``, ``down``."""

    def __init__(self, init: Init, *, d_model: int, num_heads: int,
                 expand: int = 2, dtype=torch.float32):
        super().__init__()
        d_inner = expand * d_model
        self.up = Linear(init, d_model, 2 * d_inner, dtype=dtype)
        self.wq = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wk = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wv = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wi = Linear(init, d_inner, num_heads, bias=True, dtype=dtype)
        self.wf = Linear(init, d_inner, num_heads, bias=True, dtype=dtype)
        self.wo_gate = Linear(init, d_inner, d_inner, dtype=dtype)
        self.down = Linear(init, d_inner, d_model, dtype=dtype)


def _mlstm_step(qkvif, state, *, num_heads, dh):
    """One time step. qkvif: the step's projections [B, d_inner] (gates
    [B, H]); state: (C, n, m). Returns (state, h [B, d_inner] f32)."""
    q, k, v, i_pre, f_pre = qkvif
    C, n, m = state
    B = q.shape[0]
    qh = q.reshape(B, num_heads, dh).float()
    kh = k.reshape(B, num_heads, dh).float() / f32(math.sqrt(dh), q.device)
    vh = v.reshape(B, num_heads, dh).float()
    i_pre, f_pre = i_pre.float(), f_pre.float()  # [B, H]
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        vh[..., :, None] * kh[..., None, :])  # [B, H, dh, dh] += v k^T
    n = f_g[..., None] * n + i_g[..., None] * kh
    num = torch.einsum("bhvk,bhk->bhv", C, qh)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qh)), min=1.0)
    h = num / den[..., None]  # [B, H, dh]
    return (C, n, m_new), h.reshape(B, num_heads * dh)


def _mlstm_out(p: MLSTM, h, xs, z, dtype):
    h = h.to(dtype) * torch.sigmoid(linear(p.wo_gate, xs))
    return linear(p.down, h * F.silu(z))


def mlstm_train(p: MLSTM, x, *, num_heads: int, expand: int = 2,
                return_state: bool = False, parallel: bool = True, q_chunk=None):
    """Training-mode mLSTM: x [B, S, D] -> [B, S, D] (with ``return_state``
    also {"C", "n", "m"}).

    The parallel form (default), with F_t = cumsum(f_pre) and
    D_ts = F_t - F_s + i_s for s <= t:
      m_t = max(max_s D_ts, F_t)  (the recurrence's m_0 = 0 floors it at F_t)
      h_t = [sum_s e^{D_ts - m_t} (k_s . q_t) v_s]
            / max(|sum_s e^{D_ts - m_t} (k_s . q_t)|, 1).
    Query rows are chunked under ``q_chunk`` when it divides S (as in JAX,
    no chunking otherwise). ``parallel=False`` is the recurrent scan."""
    B, S, D = x.shape
    d_inner = expand * D
    dh = d_inner // num_heads
    xs, z = torch.chunk(linear(p.up, x), 2, dim=-1)
    q, k, v = linear(p.wq, xs), linear(p.wk, xs), linear(p.wv, xs)
    i_pre = linear(p.wi, xs).float()  # [B, S, H]
    f_pre = linear(p.wf, xs).float()

    if parallel:
        qh = q.reshape(B, S, num_heads, dh).float()
        kh = k.reshape(B, S, num_heads, dh).float() / f32(math.sqrt(dh), x.device)
        vh = v.reshape(B, S, num_heads, dh).float()
        Fc = torch.cumsum(f_pre, dim=1)  # [B, S, H]
        a = i_pre - Fc  # a_s = i_s - F_s
        Ft = Fc.transpose(1, 2)  # [B, H, S]
        at = a.transpose(1, 2)
        s_pos = torch.arange(S, device=x.device)

        def rows(q_rows, F_rows, t_pos):
            """h for the query rows t_pos: [B, qc, H, dh]."""
            F_rows = F_rows.transpose(1, 2)  # [B, H, qc]
            Dm = F_rows[..., None] + at[:, :, None, :]  # [B, H, qc, S]
            ok = s_pos[None, :] <= t_pos[0][:, None]
            Dm = Dm.masked_fill(~ok[None, None], float("-inf"))
            m = torch.maximum(torch.amax(Dm, dim=-1), F_rows)
            W = torch.exp(Dm - m[..., None])
            sc = torch.einsum("bthd,bshd->bhts", q_rows, kh)
            WS = W * sc
            num = torch.einsum("bhts,bshd->bthd", WS, vh)
            den = torch.clamp(torch.abs(torch.sum(WS, dim=-1)), min=1.0)
            return num / den.transpose(1, 2)[..., None]

        chunk = None if q_chunk is not None and S % q_chunk else q_chunk
        h = query_chunks(rows, S, chunk, qh, Fc, s_pos[None]).reshape(B, S, d_inner)
        if return_state:
            # m_S = F_S + max(0, max_s a_s): the unrolled stabiliser with its
            # m_0 = 0 floor; w_s = exp(F_S + a_s - m_S)
            m_S = Ft[:, :, -1] + torch.clamp(torch.amax(at, dim=-1), min=0.0)
            w_last = torch.exp(Fc[:, -1][:, :, None] + at - m_S[..., None])
            C = torch.einsum("bhs,bshv,bshk->bhvk", w_last, vh, kh)
            n = torch.einsum("bhs,bshk->bhk", w_last, kh)
            state = (C, n, m_S)
    else:
        state = tuple(mlstm_init_cache(B, d_model=D, num_heads=num_heads,
                                       expand=expand, device=x.device).values())
        hs = []
        for t in range(S):
            state, ht = _mlstm_step((q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                     f_pre[:, t]), state, num_heads=num_heads,
                                    dh=dh)
            hs.append(ht)
        h = torch.stack(hs, dim=1)

    out = _mlstm_out(p, h, xs, z, x.dtype)
    if return_state:
        return out, {"C": state[0], "n": state[1], "m": state[2]}
    return out


def mlstm_prefill(p: MLSTM, x, cache: Dict[str, torch.Tensor], **kw):
    """The parallel form over the prompt; writes its final state into
    ``cache`` in place. Returns (out, cache)."""
    out, state = mlstm_train(p, x, return_state=True, **kw)
    for name, t in state.items():
        cache[name].copy_(t)
    return out, cache


def mlstm_init_cache(batch: int, *, d_model: int, num_heads: int,
                     expand: int = 2, device="cuda"):
    d_inner = expand * d_model
    dh = d_inner // num_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": zeros(batch, num_heads, dh, dh), "n": zeros(batch, num_heads, dh),
            "m": zeros(batch, num_heads)}


def mlstm_decode(p: MLSTM, x, cache: Dict[str, torch.Tensor], *, num_heads: int,
                 expand: int = 2):
    """The recurrent step for x [B, 1, D]; updates ``cache`` in place.
    Returns (out [B, 1, D], cache)."""
    B, _, D = x.shape
    dh = expand * D // num_heads
    xs, z = torch.chunk(linear(p.up, x[:, 0]), 2, dim=-1)
    t = (linear(p.wq, xs), linear(p.wk, xs), linear(p.wv, xs),
         linear(p.wi, xs), linear(p.wf, xs))
    state, h = _mlstm_step(t, (cache["C"], cache["n"], cache["m"]),
                           num_heads=num_heads, dh=dh)
    for name, s in zip(("C", "n", "m"), state):
        cache[name].copy_(s)
    return _mlstm_out(p, h, xs, z, x.dtype)[:, None, :], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """JAX's ``slstm_init``: ``wz``, ``wi``, ``wf``, ``wo`` (with biases),
    ``up`` [D, 2D] and ``down`` [2D, D]."""

    def __init__(self, init: Init, *, d_model: int, dtype=torch.float32):
        super().__init__()
        for name in ("wz", "wi", "wf", "wo"):
            setattr(self, name, Linear(init, d_model, d_model, bias=True,
                                       dtype=dtype))
        self.up = Linear(init, d_model, 2 * d_model, dtype=dtype)
        self.down = Linear(init, 2 * d_model, d_model, dtype=dtype)


def _slstm_step(zifo, state):
    z_pre, i_pre, f_pre, o_pre = (a.float() for a in zifo)
    c, n, m = state
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, m_new), h


def _slstm_out(p: SLSTM, h):
    a, b = torch.chunk(linear(p.up, h), 2, dim=-1)
    return linear(p.down, torch.cat([gelu(a), b], dim=-1))


def slstm_train(p: SLSTM, x, *, num_heads: int, return_state: bool = False):
    """x [B, S, D] -> [B, S, D] (with ``return_state`` also {"c", "n",
    "m"}): the recurrence over time from zero states."""
    B, S, D = x.shape
    # cast once, not a step at a time (the same values; in bf16 a step's
    # four casts of strided slices were a fifth of the loop's launches)
    zifo = [linear(w, x).float() for w in (p.wz, p.wi, p.wf, p.wo)]
    state = tuple(slstm_init_cache(B, d_model=D, device=x.device).values())
    hs = []
    for t in range(S):
        state, h = _slstm_step([a[:, t] for a in zifo], state)
        hs.append(h)
    out = _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype))
    if return_state:
        return out, {"c": state[0], "n": state[1], "m": state[2]}
    return out


def slstm_prefill(p: SLSTM, x, cache: Dict[str, torch.Tensor], **kw):
    """``slstm_train`` over the prompt; writes its final state into
    ``cache`` in place. Returns (out, cache)."""
    out, state = slstm_train(p, x, return_state=True, **kw)
    for name, t in state.items():
        cache[name].copy_(t)
    return out, cache


def slstm_init_cache(batch: int, *, d_model: int, device="cuda"):
    return {k: torch.zeros((batch, d_model), dtype=torch.float32, device=device)
            for k in ("c", "n", "m")}


def slstm_decode(p: SLSTM, x, cache: Dict[str, torch.Tensor], *, num_heads: int):
    """The recurrent step for x [B, 1, D]; updates ``cache`` in place.
    Returns (out [B, 1, D], cache)."""
    xs = x[:, 0]
    t = [linear(w, xs) for w in (p.wz, p.wi, p.wf, p.wo)]
    state, h = _slstm_step(t, (cache["c"], cache["n"], cache["m"]))
    for name, s in zip(("c", "n", "m"), state):
        cache[name].copy_(s)
    return _slstm_out(p, h.to(x.dtype))[:, None, :], cache
