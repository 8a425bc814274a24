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

Tensor parallelism (``tp``, a ``launch.collectives.Split``; the sharded
steps pass it and bind the blocks of ``launch.tensor_parallel``'s plan):
- mLSTM: ``up`` is column-parallel, bound as the rank's x and z blocks
  side by side (Mamba's ``in_proj`` exchange), its input entering through
  ``copy``; ``down`` is row-parallel, its partial products summed. When
  ``wq``/``wk``/``wv``/``wo_gate`` are column blocks (the heads divide
  the axes), the rank gathers x whole (one all-gather, reduce-scattered
  backward) and runs its heads, ``wi``/``wf`` read at their columns;
  when they are row blocks (the heads do not divide), the rank projects
  its x block through them and ``wi``/``wf``'s rows, one sum gives every
  rank the whole projections, and the recurrence runs whole, the rank
  keeping its block of h and of the output gate. Decode runs the step in
  the cache's layout (JAX's): ``C`` split on its value rows and ``n`` on
  the key dim, ``m`` whole: every rank takes q, k, v and the gates of
  every head (one all-gather of the rank's heads' q|k|v, or the sum
  above), updates its rows of ``C`` and its part of ``n`` in place, sums
  n.q over the axes, and gathers h. The prefill writes the rank's block
  of the state it computed (a head block gathered first).
- sLSTM: the rank runs the recurrence on its block of D/M units, the
  split of JAX's ``c`` (so ``c`` stays in place and the loop does 1/M of
  the work; whole, it would need ``c`` gathered): ``wz``/``wi``/``wf``
  (whole) at the block's
  columns, ``wo`` a column block, or a row block whose partial products
  are reduce-scattered into the block; h is gathered once after the loop
  (reduce-scattered backward); ``up`` is column-parallel with no
  exchange (column block r of [a | b] is row block r of ``down``'s input
  [gelu(a), b], so gelu applies to the block's columns in the a half)
  and ``down`` row-parallel. ``c`` is read and written in place; ``n``
  and ``m`` are whole in JAX's cache, and each step gathers the rank's
  new n and m blocks beside h, so every rank's copy stays whole and the
  same.
No xLSTM leaf that the plan splits is bound whole; a module the plan
does not split (a split mesh whose axes the heads divide only in part)
runs whole, as without ``tp``.
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


def _mlstm_step(qkvif, state, *, num_heads, dh, tp=None):
    """One time step. qkvif: the step's projections [B, d_inner] (gates
    [B, H]); state: (C, n, m), or with ``tp`` the rank's block of C's
    value rows and of n's key dim (JAX's cache split; m whole). Returns
    (state, h [B, d_inner] f32, gathered over C's blocks)."""
    q, k, v, i_pre, f_pre = qkvif
    C, n, m = state
    B = q.shape[0]
    qh = q.reshape(B, num_heads, dh).float()
    kh = k.reshape(B, num_heads, dh).float() / f32(math.sqrt(dh), q.device)
    vh = v.reshape(B, num_heads, dh).float()
    vb, kb, qb, v_ax, k_ax = vh, kh, qh, None, None
    if tp is not None:
        v_ax, k_ax = tp.over(dh, C.shape[2]), tp.over(dh, n.shape[2])
        vb, kb, qb = tp.block(vh, v_ax, 2), tp.block(kh, k_ax, 2), tp.block(qh, k_ax, 2)
    i_pre, f_pre = i_pre.float(), f_pre.float()  # [B, H]
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        vb[..., :, None] * kh[..., None, :])  # [B, H, dh, dh] += v k^T
    n = f_g[..., None] * n + i_g[..., None] * kb
    num = torch.einsum("bhvk,bhk->bhv", C, qh)
    dot = torch.einsum("bhk,bhk->bh", n, qb)
    if k_ax:
        from repro_torch.launch import collectives as cc
        dot = cc.psum(dot, tp.mesh, k_ax)
    den = torch.clamp(torch.abs(dot), min=1.0)
    h = num / den[..., None]  # [B, H, dh]
    if v_ax:  # the blocks stacked ([M, B, H, dh / M]), then one copy
        from repro_torch.launch import collectives as cc
        h = cc.gather_dim(h[None], tp.mesh, v_ax, 0).permute(1, 2, 0, 3)
    return (C, n, m_new), h.reshape(B, num_heads * dh)


def _mlstm_out(p: MLSTM, h, xs, z, dtype):
    h = h.to(dtype) * torch.sigmoid(linear(p.wo_gate, xs))
    return linear(p.down, h * F.silu(z))


def _mlstm_axes(p: MLSTM, tp, d_inner: int):
    """(the model axes that split the inner channels, or None; whether
    ``wq``/``wk``/``wv``/``wo_gate`` are their row blocks)."""
    ax = tp.over(2 * d_inner, p.up.w.shape[1]) if tp is not None else None
    return ax, bool(ax) and p.wq.w.shape[0] < d_inner


def _mlstm_proj(p: MLSTM, x, tp, ax, rows: bool, d_inner: int, *,
                every_head: bool):
    """The split projections of x [..., D] (entered through ``copy``):
    (z, the rank's x block, q, k, v, i_pre, f_pre, o_pre), the rank's heads
    (column blocks) or every head (row blocks), i/f in f32, ``o_pre`` the
    output gate's pre-activation at the rank's channels. With
    ``every_head`` (decode, in the cache's layout) q, k, v and the gates
    are every head's."""
    from repro_torch.launch import collectives as cc
    x = tp.copy(x, ax)
    xs, z = torch.chunk(linear(p.up, x), 2, dim=-1)  # the rank's x, z blocks
    if rows:  # one sum of the rank's partial products
        w = torch.cat([p.wq.w, p.wk.w, p.wv.w, p.wo_gate.w,
                       tp.block(p.wi.w, ax, 0), tp.block(p.wf.w, ax, 0)], dim=-1)
        y = tp.reduce(xs @ w, ax)
        q, k, v, o, i_pre, f_pre = torch.split(
            y, [d_inner] * 4 + [p.wi.w.shape[1]] * 2, dim=-1)
        o = cc.take_block(o, tp.mesh, ax, -1)
        return (z, xs, q, k, v, (i_pre + p.wi.b).float(),
                (f_pre + p.wf.b).float(), o)
    full = cc.gather_from(xs, tp.mesh, ax, -1)
    q, k, v = linear(p.wq, full), linear(p.wk, full), linear(p.wv, full)
    o = linear(p.wo_gate, full)
    if not every_head:  # the rank's heads' gates
        i_pre, f_pre = ((full @ tp.block(g.w, ax, 1) + tp.block(g.b, ax, 0)).float()
                        for g in (p.wi, p.wf))
        return z, xs, q, k, v, i_pre, f_pre, o
    qkv = cc.gather_dim(torch.stack([q, k, v], dim=-2), tp.mesh, ax, -1)
    q, k, v = qkv.unbind(dim=-2)
    return (z, xs, q, k, v, linear(p.wi, full).float(),
            linear(p.wf, full).float(), o)


def mlstm_train(p: MLSTM, x, *, num_heads: int, expand: int = 2,
                return_state: bool = False, parallel: bool = True, q_chunk=None,
                tp=None):
    """Training-mode mLSTM: x [B, S, D] -> [B, S, D] (with ``return_state``
    also {"C", "n", "m"}; under ``tp`` with column blocks, of the rank's
    heads).

    The parallel form (default), with F_t = cumsum(f_pre) and
    D_ts = F_t - F_s + i_s for s <= t:
      m_t = max(max_s D_ts, F_t)  (the recurrence's m_0 = 0 floors it at F_t)
      h_t = [sum_s e^{D_ts - m_t} (k_s . q_t) v_s]
            / max(|sum_s e^{D_ts - m_t} (k_s . q_t)|, 1).
    Query rows are chunked under ``q_chunk`` when it divides S (as in JAX,
    no chunking otherwise). ``parallel=False`` is the recurrent scan.
    ``tp``: see the module docstring."""
    B, S, D = x.shape
    d_inner = expand * D
    dh = d_inner // num_heads
    ax, rows = _mlstm_axes(p, tp, d_inner)
    if ax:
        from repro_torch.launch import collectives as cc
        z, xs, q, k, v, i_pre, f_pre, o = _mlstm_proj(p, x, tp, ax, rows,
                                                      d_inner, every_head=False)
        H = q.shape[-1] // dh
        h, state = _mlstm_core(q, k, v, i_pre, f_pre, num_heads=H, dh=dh,
                               return_state=return_state, parallel=parallel,
                               q_chunk=q_chunk)
        if rows:
            h = cc.take_block(h, tp.mesh, ax, -1)
        h = h.to(x.dtype) * torch.sigmoid(o)
        out = tp.reduce((h * F.silu(z)) @ p.down.w, ax)
    else:
        xs, z = torch.chunk(linear(p.up, x), 2, dim=-1)
        q, k, v = linear(p.wq, xs), linear(p.wk, xs), linear(p.wv, xs)
        i_pre = linear(p.wi, xs).float()  # [B, S, H]
        f_pre = linear(p.wf, xs).float()
        h, state = _mlstm_core(q, k, v, i_pre, f_pre, num_heads=num_heads, dh=dh,
                               return_state=return_state, parallel=parallel,
                               q_chunk=q_chunk)
        out = _mlstm_out(p, h, xs, z, x.dtype)
    if return_state:
        return out, {"C": state[0], "n": state[1], "m": state[2]}
    return out


def _mlstm_core(q, k, v, i_pre, f_pre, *, num_heads, dh, return_state,
                parallel, q_chunk):
    """h [B, S, H dh] (f32) of q, k, v [B, S, H dh] and the gates [B, S, H]
    over ``num_heads`` heads, and with ``return_state`` the final (C, n,
    m) (else None)."""
    B, S = q.shape[0], q.shape[1]
    d_inner = num_heads * dh
    state = None
    if parallel:
        qh = q.reshape(B, S, num_heads, dh).float()
        kh = k.reshape(B, S, num_heads, dh).float() / f32(math.sqrt(dh), q.device)
        vh = v.reshape(B, S, num_heads, dh).float()
        Fc = torch.cumsum(f_pre, dim=1)  # [B, S, H]
        a = i_pre - Fc  # a_s = i_s - F_s
        Ft = Fc.transpose(1, 2)  # [B, H, S]
        at = a.transpose(1, 2)
        s_pos = torch.arange(S, device=q.device)

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
        def zeros(*shape):
            return torch.zeros((B, num_heads, *shape), dtype=torch.float32,
                               device=q.device)

        state = (zeros(dh, dh), zeros(dh), zeros())
        hs = []
        for t in range(S):
            state, ht = _mlstm_step((q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                     f_pre[:, t]), state, num_heads=num_heads,
                                    dh=dh)
            hs.append(ht)
        h = torch.stack(hs, dim=1)
    return h, state


def mlstm_prefill(p: MLSTM, x, cache: Dict[str, torch.Tensor], *, tp=None, **kw):
    """The parallel form over the prompt; writes its final state into
    ``cache`` in place (under ``tp``, the cache's blocks of it: a head
    block's state gathered over the heads first). Returns (out, cache)."""
    out, state = mlstm_train(p, x, return_state=True, tp=tp, **kw)
    H = cache["m"].shape[1]
    for name, t in state.items():
        if t.shape[1] < H:  # the rank's heads
            from repro_torch.launch import collectives as cc
            t = cc.gather_dim(t, tp.mesh, tp.over(H, t.shape[1]), 1)
        if name != "m" and tp is not None:  # C's value rows, n's key dim
            t = tp.block(t, tp.over(t.shape[2], cache[name].shape[2]), 2)
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
                 expand: int = 2, tp=None):
    """The recurrent step for x [B, 1, D]; updates ``cache`` in place (under
    ``tp``, its blocks in JAX's layout). Returns (out [B, 1, D], cache)."""
    B, _, D = x.shape
    d_inner = expand * D
    dh = d_inner // num_heads
    ax, rows = _mlstm_axes(p, tp, d_inner)
    state = (cache["C"], cache["n"], cache["m"])
    if not ax:
        xs, z = torch.chunk(linear(p.up, x[:, 0]), 2, dim=-1)
        t = (linear(p.wq, xs), linear(p.wk, xs), linear(p.wv, xs),
             linear(p.wi, xs), linear(p.wf, xs))
        state, h = _mlstm_step(t, state, num_heads=num_heads, dh=dh)
        out = _mlstm_out(p, h, xs, z, x.dtype)
    else:
        z, _, q, k, v, i_pre, f_pre, o = _mlstm_proj(p, x[:, 0], tp, ax, rows,
                                                     d_inner, every_head=True)
        state, h = _mlstm_step((q, k, v, i_pre, f_pre), state,
                               num_heads=num_heads, dh=dh, tp=tp)
        h = tp.block(h, ax, 1).to(x.dtype) * torch.sigmoid(o)
        out = tp.reduce((h * F.silu(z)) @ p.down.w, ax)
    for name, s in zip(("C", "n", "m"), state):
        cache[name].copy_(s)
    return out[:, None, :], cache


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


def _slstm_out(p: SLSTM, h, tp=None, ax=None):
    """``up``, gelu on its first half, ``down``, of the whole h; under
    ``ax`` column-parallel then row-parallel (see the module docstring)."""
    if not ax:
        a, b = torch.chunk(linear(p.up, h), 2, dim=-1)
        return linear(p.down, torch.cat([gelu(a), b], dim=-1))
    u = h @ p.up.w  # the rank's column block of [a | b]
    w = u.shape[-1]
    ga = min(max(h.shape[-1] - tp.index(ax) * w, 0), w)  # its columns in a
    u = torch.cat([gelu(u[..., :ga]), u[..., ga:]], dim=-1)
    return tp.reduce(u @ p.down.w, ax)


def _slstm_axes(p: SLSTM, tp, D: int):
    """The model axes that split the units (None: all)."""
    return tp.over(2 * D, p.up.w.shape[1]) if tp is not None else None


def _slstm_gates(p: SLSTM, x, tp, ax):
    """The f32 pre-activations z, i, f, o of x [..., D] at the rank's block
    of units (every unit without ``ax``)."""
    if not ax:
        # cast once, not a step at a time (the same values; in bf16 a step's
        # four casts of strided slices were a fifth of the loop's launches)
        return [linear(w, x).float() for w in (p.wz, p.wi, p.wf, p.wo)]
    from repro_torch.launch import collectives as cc
    x = tp.copy(x, ax)
    out = [x @ tp.block(w.w, ax, 1) + tp.block(w.b, ax, 0)
           for w in (p.wz, p.wi, p.wf)]
    if p.wo.w.shape[1] < x.shape[-1]:  # a column block
        o = x @ p.wo.w
    else:  # a row block: the rank's inputs, the partial sums scattered
        o = cc.reduce_scatter(tp.block(x, ax, -1) @ p.wo.w, tp.mesh, ax, -1)
    return [t.float() for t in (*out, o + tp.block(p.wo.b, ax, 0))]


def slstm_train(p: SLSTM, x, *, num_heads: int, return_state: bool = False,
                tp=None):
    """x [B, S, D] -> [B, S, D] (with ``return_state`` also {"c", "n",
    "m"}, under ``tp`` of the rank's units): the recurrence over time from
    zero states. ``tp``: see the module docstring."""
    B, S, D = x.shape
    ax = _slstm_axes(p, tp, D)
    zifo = _slstm_gates(p, x, tp, ax)
    state = tuple(slstm_init_cache(B, d_model=zifo[0].shape[-1],
                                   device=x.device).values())
    hs = []
    for t in range(S):
        state, h = _slstm_step([a[:, t] for a in zifo], state)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    if ax:
        from repro_torch.launch import collectives as cc
        h = cc.gather_from(h, tp.mesh, ax, -1)
    out = _slstm_out(p, h, tp, ax)
    if return_state:
        return out, {"c": state[0], "n": state[1], "m": state[2]}
    return out


def slstm_prefill(p: SLSTM, x, cache: Dict[str, torch.Tensor], *, tp=None, **kw):
    """``slstm_train`` over the prompt; writes its final state into
    ``cache`` in place (under ``tp``: ``c`` the rank's units, ``n`` and
    ``m`` gathered whole). Returns (out, cache)."""
    out, state = slstm_train(p, x, return_state=True, tp=tp, **kw)
    c, n, m = state["c"], state["n"], state["m"]
    D = cache["n"].shape[1]
    if c.shape[1] < D:
        from repro_torch.launch import collectives as cc
        n, m = cc.gather_dim(torch.stack([n, m]), tp.mesh,
                             tp.over(D, c.shape[1]), -1).unbind(0)
    for name, t in (("c", c), ("n", n), ("m", m)):
        cache[name].copy_(t)
    return out, cache



def slstm_init_cache(batch: int, *, d_model: int, device="cuda"):
    return {k: torch.zeros((batch, d_model), dtype=torch.float32, device=device)
            for k in ("c", "n", "m")}


def slstm_decode(p: SLSTM, x, cache: Dict[str, torch.Tensor], *, num_heads: int,
                 tp=None):
    """The recurrent step for x [B, 1, D]; updates ``cache`` in place (under
    ``tp``: ``c``'s block, ``n`` and ``m`` whole). Returns (out [B, 1, D],
    cache)."""
    xs = x[:, 0]
    ax = _slstm_axes(p, tp, xs.shape[-1])
    if not ax:
        t = [linear(w, xs) for w in (p.wz, p.wi, p.wf, p.wo)]
        state, h = _slstm_step(t, (cache["c"], cache["n"], cache["m"]))
        for name, s in zip(("c", "n", "m"), state):
            cache[name].copy_(s)
        return _slstm_out(p, h.to(x.dtype))[:, None, :], cache
    from repro_torch.launch import collectives as cc
    t = _slstm_gates(p, xs, tp, ax)
    n_m = [tp.block(cache[k], ax, 1) for k in ("n", "m")]
    (c, n, m), h = _slstm_step(t, (cache["c"], *n_m))
    cache["c"].copy_(c)
    h, n, m = cc.gather_dim(torch.stack([h, n, m]), tp.mesh, ax, -1).unbind(0)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    return _slstm_out(p, h.to(x.dtype), tp, ax)[:, None, :], cache
