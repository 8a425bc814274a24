"""Multi-head attention: GQA/MQA, qk-norm, RoPE, cross-attention, KV cache
(bf16 or int8).

Counterpart of ``repro/models/attention.py``: ``attn_train`` (full
sequence, for ``forward``: causal, bidirectional with ``causal=False``
(whisper's encoder), or cross-attention with ``kv_x``, the keys and values
projected from a memory [B, Sk, D] with no rope and no mask),
``attn_prefill`` (writes the KV cache) and ``attn_decode`` (one token
against the cache). q/k/v are [B, S, H, dh]; the scores are computed in
the compute dtype, then cast to f32 for the softmax, whose weights are
cast back, as JAX does. The dense products are ``torch.matmul``/``einsum``
(JAX leaves them to XLA too). ``q_chunk`` splits the query rows into
``S // q_chunk`` chunks, each with its own causal mask (JAX scans them),
so no [S, S] score matrix is made; unmasked arms keep every key.

The cache is updated in place: ``attn_prefill`` writes the prompt's
post-rope keys and values into the first S rows of ``cache`` and
``attn_decode`` writes row ``pos`` (JAX returns new arrays; the values are
the same). The int8 cache {"k_q", "k_s", "v_q", "v_s"} holds each (token,
head) row as int8 values and one f32 scale (``_quant_kv``); decode
dequantises it into the query's dtype before the scores.

Tensor parallelism (``tp``, a ``launch.collectives.Split``; the sharded
steps pass it): when ``wq`` is bound as a block of the heads, the module
computes those heads only. Its input enters through ``copy``; ``wk`` /
``wv`` are blocks of the KV heads over the leading axes that split them
(all the q heads' axes, some, or none: whole), and each q head reads its
KV head (``h // rep``, ``_rank_kv``); ``wo`` is row-parallel, its partial
products summed over the axes and its bias added after the sum. A cache
holds the KV heads it was given: the bound ones (the rank's block, in
place), or all of them (a sequence-split cache), which a KV block is
gathered into before it is written. A sequence-split cache (a
``common.CacheSlot`` whose ``seq`` names the axes, JAX's layout when the
KV heads do not divide them) is the rank's block of positions, in place:
the prefill writes the prompt's positions that fall in it, and decode
(flash-decoding's split-KV) writes the token on the rank whose block
holds ``pos``, gathers q over the heads (one all-gather), attends over
its block with every head (global key positions, masked past ``pos``;
f32 partial sums, a block past ``pos`` giving none), combines the blocks'
partials over the axes (``collectives.combine_partials``: one all-gather)
and keeps its q heads' output for the row-parallel ``wo``. The local
head counts come from the bound weights' shapes, the whole ones from the
arguments.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch.models.common import (Init, Linear, Norm, apply_rope, f32,
                                       linear, rmsnorm, rope_angles, seq_block)

__all__ = ["Attention", "attn_train", "attn_prefill", "attn_decode",
           "query_chunks", "seq_rows", "softmax_partials"]


class Attention(nn.Module):
    """JAX's ``attn_init``: ``wq``, ``wk``, ``wv``, ``wo`` and, with
    qk-norm, ``q_norm`` and ``k_norm`` (RMSNorm over the head dim)."""

    def __init__(self, init: Init, *, d_model: int, num_heads: int,
                 num_kv_heads: int, head_dim: int, bias: bool = False,
                 qk_norm: bool = False, dtype=torch.float32):
        super().__init__()
        self.wq = Linear(init, d_model, num_heads * head_dim, bias=bias, dtype=dtype)
        self.wk = Linear(init, d_model, num_kv_heads * head_dim, bias=bias, dtype=dtype)
        self.wv = Linear(init, d_model, num_kv_heads * head_dim, bias=bias, dtype=dtype)
        self.wo = Linear(init, num_heads * head_dim, d_model, bias=bias, dtype=dtype)
        if qk_norm:
            self.q_norm = Norm(init, "rmsnorm", head_dim, dtype)
            self.k_norm = Norm(init, "rmsnorm", head_dim, dtype)
        else:
            self.q_norm = self.k_norm = None


def _q_axes(p: Attention, tp, num_heads, head_dim):
    """The model axes that split the bound q heads (None: all heads)."""
    return tp.over(num_heads * head_dim, p.wq.w.shape[1]) if tp is not None else None


def _project_qkv(p: Attention, x, kv_x=None, *, num_heads, num_kv_heads,
                 head_dim, qk_norm, tp=None, axes=None):
    """q from ``x``; k and v from ``kv_x`` (default: ``x``), over the bound
    heads; with ``axes`` (the q heads split) both enter through ``copy``."""
    same = kv_x is None
    kv_x = x if same else kv_x
    if axes:
        x = tp.copy(x, axes)
        kv_x = x if same else tp.copy(kv_x, axes)
    B, S, Sk = x.shape[0], x.shape[1], kv_x.shape[1]
    q = linear(p.wq, x).reshape(B, S, p.wq.w.shape[1] // head_dim, head_dim)
    k = linear(p.wk, kv_x).reshape(B, Sk, p.wk.w.shape[1] // head_dim, head_dim)
    v = linear(p.wv, kv_x).reshape(B, Sk, p.wv.w.shape[1] // head_dim, head_dim)
    if qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def _sdpa(q, k, v, *, q_pos=None, k_pos=None, causal=True):
    """q [B,Sq,H,dh]; k/v [B,Sk,Hkv,dh] (GQA: H % Hkv == 0). Causal: key
    k_pos attends to query q_pos when k_pos <= q_pos; otherwise every key
    to every query (Sq may differ from Sk). f32 softmax."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    scores = scores / f32(math.sqrt(dh), scores.device)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
        scores = scores.masked_fill(~ok[None, None, None], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return out.reshape(B, Sq, H, dh)


def _kv_for(t, *, num_heads, num_kv_heads, lo: int, H: int):
    """The KV heads of ``t`` [B, S, Hkv, dh] (Hkv = ``num_kv_heads``, which
    serve ``num_heads`` q heads) that q heads [lo, lo + H) read (GQA: head
    h reads h // rep): one contiguous block
    when each serves an equal run of the q heads (a single one when H <
    rep), else one KV head a q head."""
    rep = num_heads // num_kv_heads
    need = [(lo + i) // rep for i in range(H)]
    n = need[-1] - need[0] + 1
    if H % n == 0 and need == [need[0] + i // (H // n) for i in range(H)]:
        return t[:, :, need[0]:need[0] + n]
    return torch.cat([t[:, :, j:j + 1] for j in need], dim=2)


def _rank_kv(k, v, tp, axes, *, num_heads, num_kv_heads, H):
    """k, v (all the KV heads, or a block over the leading model axes that
    split them) as the rank's H q heads (split over ``axes``) read them:
    the KV heads that serve the q heads of the block's group, ``_kv_for``
    of the rank's among them; all of them when those are the block."""
    if not axes:
        return k, v
    kv_axes = tp.over(num_kv_heads, k.shape[2])
    group = num_heads * k.shape[2] // num_kv_heads  # q heads the block serves
    lo = tp.index(axes) * H - (tp.index(kv_axes) * group if kv_axes else 0)
    if lo == 0 and H == group:
        return k, v
    kw = dict(num_heads=group, num_kv_heads=k.shape[2], lo=lo, H=H)
    return _kv_for(k, **kw), _kv_for(v, **kw)


def _out(p: Attention, o, tp, axes):
    """``wo``: whole, or row-parallel over ``axes`` with its bias added
    after the sum."""
    if not axes:
        return linear(p.wo, o)
    y = tp.reduce(o @ p.wo.w, axes)
    return y if p.wo.b is None else y + p.wo.b


def _rotate(t, positions, *, head_dim, rope, rope_theta):
    """Rotary embedding of q or k at ``positions`` (none: unchanged)."""
    if rope == "none":
        return t
    frac = 0.5 if rope == "2d" else 1.0
    rot = int(head_dim * frac) - (int(head_dim * frac) % 2)
    cos, sin = rope_angles(positions, rot, rope_theta)
    return apply_rope(t, cos, sin, frac)


def query_chunks(fn, S: int, q_chunk, *rows):
    """``fn(*rows)`` over all S query rows, or, when ``q_chunk`` < S, over
    ``S // q_chunk`` chunks of rows (dim 1 of each of ``rows``), the
    results concatenated along dim 1 (JAX's ``lax.scan`` over the chunks).
    S not a multiple of ``q_chunk`` raises JAX's ValueError."""
    if q_chunk is None or q_chunk >= S:
        return fn(*rows)
    if S % q_chunk:
        raise ValueError(f"S={S} not divisible by q_chunk={q_chunk}")
    return torch.cat([fn(*(r[:, i:i + q_chunk] for r in rows))
                      for i in range(0, S, q_chunk)], dim=1)


def _self_attn(p: Attention, x, *, num_heads, num_kv_heads, head_dim,
               qk_norm, rope, rope_theta, q_chunk, tp=None):
    """Full-sequence causal self-attention: (out [B, S, D], the post-rope
    keys, the values; over the bound KV heads)."""
    B, S = x.shape[0], x.shape[1]
    axes = _q_axes(p, tp, num_heads, head_dim)
    q, k, v = _project_qkv(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm, tp=tp, axes=axes)
    pos = torch.arange(S, device=x.device)
    rk = dict(head_dim=head_dim, rope=rope, rope_theta=rope_theta)
    q, k = _rotate(q, pos, **rk), _rotate(k, pos, **rk)
    H = q.shape[2]
    kr, vr = _rank_kv(k, v, tp, axes, num_heads=num_heads,
                      num_kv_heads=num_kv_heads, H=H)
    out = query_chunks(lambda qc, pc: _sdpa(qc, kr, vr, q_pos=pc[0], k_pos=pos),
                       S, q_chunk, q, pos[None])
    return _out(p, out.reshape(B, S, H * head_dim), tp, axes), k, v


def attn_train(p: Attention, x, *, num_heads, num_kv_heads, head_dim,
               qk_norm=False, rope="1d", rope_theta=10000.0, causal=True,
               q_chunk=None, kv_x=None, tp=None):
    """Full-sequence attention. Returns [B, S, D]. ``kv_x`` [B, Sk, D] is
    not None: cross-attention (keys and values from ``kv_x``, no rope on
    either side, no mask); otherwise self-attention, causal unless
    ``causal=False``. ``tp``: see the module docstring."""
    if kv_x is None and causal:
        return _self_attn(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                          head_dim=head_dim, qk_norm=qk_norm, rope=rope,
                          rope_theta=rope_theta, q_chunk=q_chunk, tp=tp)[0]
    B, S = x.shape[0], x.shape[1]
    axes = _q_axes(p, tp, num_heads, head_dim)
    q, k, v = _project_qkv(p, x, kv_x, num_heads=num_heads,
                           num_kv_heads=num_kv_heads, head_dim=head_dim,
                           qk_norm=qk_norm, tp=tp, axes=axes)
    if kv_x is None:  # bidirectional self-attention: rope on both sides
        pos = torch.arange(S, device=x.device)
        rk = dict(head_dim=head_dim, rope=rope, rope_theta=rope_theta)
        q, k = _rotate(q, pos, **rk), _rotate(k, pos, **rk)
    H = q.shape[2]
    k, v = _rank_kv(k, v, tp, axes, num_heads=num_heads,
                    num_kv_heads=num_kv_heads, H=H)
    out = query_chunks(lambda qc: _sdpa(qc, k, v, causal=False), S, q_chunk, q)
    return _out(p, out.reshape(B, S, H * head_dim), tp, axes)


def _quant_kv(x):
    """[B, S, H, dh] -> (int8 values, f32 per-(token, head) scale): the
    scale is max|x| / 127 floored at 1e-8, the values ``round`` (half to
    even, as ``jnp.round``) of x / scale, clipped to +-127."""
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=-1) / f32(127.0, x.device)
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _dequant_kv(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def attn_prefill(p: Attention, x, cache: Dict[str, torch.Tensor], *, num_heads,
                 num_kv_heads, head_dim, qk_norm=False, rope="1d",
                 rope_theta=10000.0, q_chunk=None, tp=None):
    """``attn_train`` over the prompt that also writes its post-rope keys
    and values into rows [0, S) of ``cache`` (Sc >= S; the rows past S stay
    as they are): {"k", "v"} [B, Sc, Hkv, dh], or the int8 form {"k_q",
    "v_q"} [B, Sc, Hkv, dh] int8 with {"k_s", "v_s"} [B, Sc, Hkv] f32;
    Hkv the bound KV heads. Returns (out, cache)."""
    out, k, v = _self_attn(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm, rope=rope,
                           rope_theta=rope_theta, q_chunk=q_chunk, tp=tp)
    _write_at(cache, 0, *_cached(cache, k, v, tp), tp)
    return out, cache


def seq_rows(cache, start: int, length: int, tp):
    """(source rows, cache rows) of global positions [start, start +
    length) that the rank's block of ``cache`` holds (all of them when the
    sequence dim is whole; None when the block holds none). Raises when
    the positions run past the cache (every rank's blocks)."""
    axes, n = seq_block(cache)
    whole = n * tp.size(axes) if axes else n
    if start < 0 or start + length > whole:
        raise IndexError(f"cache positions [{start}, {start + length}) past "
                         f"its length {whole}")
    lo = tp.index(axes) * n if axes else 0
    a, b = max(start, lo), min(start + length, lo + n)
    if a >= b:
        return None
    return slice(a - start, b - start), slice(a - lo, b - lo)


def _write_at(cache, start: int, k, v, tp) -> None:
    """Positions [start, start + len) of the cache := k, v, those of the
    rank's block only when the sequence dim is split."""
    rows = seq_rows(cache, start, k.shape[1], tp)
    if rows is not None:
        src, dst = rows
        _write_kv(cache, dst, k[:, src], v[:, src])


def _cached(cache, k, v, tp):
    """k, v over the cache's KV heads: as computed, or, when the cache
    holds all of them and the module computes a block, gathered over the
    axes that split them (serving runs without gradients)."""
    held = cache["k_q" if "k_q" in cache else "k"].shape[2]
    if held == k.shape[2]:
        return k, v
    from repro_torch.launch import collectives as cc
    axes = tp.over(held, k.shape[2])
    return (cc.gather_dim(k, tp.mesh, axes, 2), cc.gather_dim(v, tp.mesh, axes, 2))


def _write_kv(cache, rows, k, v) -> None:
    """Rows ``rows`` of the cache := k, v [B, len(rows), Hkv, dh] (int8:
    quantised)."""
    if "k_q" in cache:
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quant_kv(t)
            cache[name + "_q"][:, rows] = tq
            cache[name + "_s"][:, rows] = ts
    else:
        cache["k"][:, rows] = k.to(cache["k"].dtype)
        cache["v"][:, rows] = v.to(cache["v"].dtype)


def attn_decode(p: Attention, x, cache: Dict[str, torch.Tensor], pos: int, *,
                num_heads, num_kv_heads, head_dim, qk_norm=False, rope="1d",
                rope_theta=10000.0, tp=None):
    """One-token step. x: [B, 1, D]; cache {"k", "v"} or the int8 form (see
    ``attn_prefill``); ``pos``: the write position (the mask admits
    k_index <= pos). Writes row ``pos`` of the cache in place. Returns
    (out, cache)."""
    B = x.shape[0]
    axes = _q_axes(p, tp, num_heads, head_dim)
    q, k, v = _project_qkv(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm, tp=tp, axes=axes)
    q_pos = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    rk = dict(head_dim=head_dim, rope=rope, rope_theta=rope_theta)
    q, k = _rotate(q, q_pos, **rk), _rotate(k, q_pos, **rk)
    _write_at(cache, pos, *_cached(cache, k, v, tp), tp)
    if "k_q" in cache:
        ck = _dequant_kv(cache["k_q"], cache["k_s"], q.dtype)
        cv = _dequant_kv(cache["v_q"], cache["v_s"], q.dtype)
    else:
        ck, cv = cache["k"], cache["v"]
    H = q.shape[2]
    seq, n = seq_block(cache)
    if seq:
        from repro_torch.launch import collectives as cc
        qa = cc.gather_dim(q, tp.mesh, axes, 2) if axes else q  # every head
        o, m, l = _block_partials(qa, ck, cv, pos, tp.index(seq) * n)
        out = tp.block(cc.combine_partials(o, m, l, tp.mesh, seq).to(q.dtype),
                       axes, 2)
        return _out(p, out.reshape(B, 1, H * head_dim), tp, axes), cache
    ck, cv = _rank_kv(ck, cv, tp, axes, num_heads=num_heads,
                      num_kv_heads=num_kv_heads, H=H)
    k_pos = torch.arange(ck.shape[1], device=x.device)
    out = _sdpa(q, ck, cv, q_pos=q_pos, k_pos=k_pos)
    return _out(p, out.reshape(B, 1, H * head_dim), tp, axes), cache


def softmax_partials(s, k_pos, pos: int):
    """Scores ``s`` [..., n] (f32) of one block of keys at global positions
    ``k_pos``, masked past ``pos`` -> (exp(s - m) [..., n], m [...], l
    [...]): the block's largest score m (-inf when it holds no key at or
    before ``pos``, its weights and l then 0) and the weights' sum l."""
    s = s.masked_fill(k_pos > pos, float("-inf"))
    m = torch.amax(s, dim=-1)
    w = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return w, m, torch.sum(w, dim=-1)


def _block_partials(q, k, v, pos: int, lo: int):
    """Attention of one query q [B, 1, H, dh] (every head) over one block of
    the cache, k/v [B, n, Hkv, dh] at positions [lo, lo + n): (o [B, 1,
    H, dh], m, l [B, 1, H]), f32, ``softmax_partials``' (o = w v)."""
    B, _, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, dh)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    s = s / f32(math.sqrt(dh), s.device)
    k_pos = lo + torch.arange(k.shape[1], device=q.device)
    w, m, l = softmax_partials(s, k_pos, pos)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w, v.float()).reshape(B, 1, H, dh)
    return o, m.permute(0, 3, 1, 2).reshape(B, 1, H), \
        l.permute(0, 3, 1, 2).reshape(B, 1, H)
