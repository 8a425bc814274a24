"""Multi-head attention: GQA/MQA, qk-norm, RoPE, KV cache.

Counterpart of ``repro/models/attention.py`` for causal self-attention:
``attn_train`` (full sequence, for ``forward``), ``attn_prefill`` (writes
the KV cache) and ``attn_decode`` (one token against the cache). q/k/v are
[B, S, H, dh]; the scores are computed in the compute dtype, then cast to
f32 for the softmax, whose weights are cast back, as JAX does. The dense
products are ``torch.matmul``/``einsum`` (JAX leaves them to XLA too).

The cache is updated in place: ``attn_prefill`` writes the prompt's
post-rope keys and values into the first S rows of ``cache`` and
``attn_decode`` writes row ``pos`` (JAX returns new arrays; the values are
the same). The int8 KV cache and chunked queries (``q_chunk``) raise
``NotImplementedError`` naming their ROADMAP slice; cross-attention and the
encoder's bidirectional attention are not here (``transformer`` refuses
their configs, naming ``CROSS_SLICE``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch.models.common import (Init, Linear, Norm, apply_rope, linear,
                                       rmsnorm, rope_angles)

__all__ = ["Attention", "attn_train", "attn_prefill", "attn_decode",
           "Q_CHUNK_SLICE", "INT8_KV_SLICE", "CROSS_SLICE"]

Q_CHUNK_SLICE = "ROADMAP queue 1 slice 14.6 (chunked queries, q_chunk)"
INT8_KV_SLICE = "ROADMAP queue 1 slice 14.5 (int8 KV cache)"
CROSS_SLICE = "ROADMAP queue 1 slice 14.4 (whisper and vision: cross-attention)"


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


def _project_qkv(p: Attention, x, *, num_heads, num_kv_heads, head_dim, qk_norm):
    B, S = x.shape[0], x.shape[1]
    q = linear(p.wq, x).reshape(B, S, num_heads, head_dim)
    k = linear(p.wk, x).reshape(B, S, num_kv_heads, head_dim)
    v = linear(p.wv, x).reshape(B, S, num_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def _sdpa(q, k, v, *, q_pos, k_pos):
    """Causal: q [B,Sq,H,dh]; k/v [B,Sk,Hkv,dh] (GQA: H % Hkv == 0); key
    k_pos attends to query q_pos when k_pos <= q_pos. f32 softmax."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(dh), dtype=torch.float32,
                                   device=scores.device)
    ok = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
    scores = scores.masked_fill(~ok[None, None, None], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return out.reshape(B, Sq, H, dh)


def _rotate(t, positions, *, head_dim, rope, rope_theta):
    """Rotary embedding of q or k at ``positions`` (none: unchanged)."""
    if rope == "none":
        return t
    frac = 0.5 if rope == "2d" else 1.0
    rot = int(head_dim * frac) - (int(head_dim * frac) % 2)
    cos, sin = rope_angles(positions, rot, rope_theta)
    return apply_rope(t, cos, sin, frac)


def _self_attn(p: Attention, x, *, num_heads, num_kv_heads, head_dim,
               qk_norm, rope, rope_theta, q_chunk):
    """Full-sequence causal self-attention: (out [B, S, D], the post-rope
    keys, the values)."""
    if q_chunk is not None and q_chunk < x.shape[1]:
        raise NotImplementedError(Q_CHUNK_SLICE)
    B, S = x.shape[0], x.shape[1]
    q, k, v = _project_qkv(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm)
    pos = torch.arange(S, device=x.device)
    rk = dict(head_dim=head_dim, rope=rope, rope_theta=rope_theta)
    q, k = _rotate(q, pos, **rk), _rotate(k, pos, **rk)
    out = _sdpa(q, k, v, q_pos=pos, k_pos=pos)
    return linear(p.wo, out.reshape(B, S, num_heads * head_dim)), k, v


def attn_train(p: Attention, x, *, num_heads, num_kv_heads, head_dim,
               qk_norm=False, rope="1d", rope_theta=10000.0, q_chunk=None):
    """Full-sequence causal self-attention. Returns [B, S, D]."""
    return _self_attn(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                      head_dim=head_dim, qk_norm=qk_norm, rope=rope,
                      rope_theta=rope_theta, q_chunk=q_chunk)[0]


def attn_prefill(p: Attention, x, cache: Dict[str, torch.Tensor], *, num_heads,
                 num_kv_heads, head_dim, qk_norm=False, rope="1d",
                 rope_theta=10000.0, q_chunk=None):
    """``attn_train`` over the prompt that also writes its post-rope keys
    and values into rows [0, S) of ``cache`` {"k", "v"} [B, Sc, Hkv, dh]
    (Sc >= S; the rows past S stay as they are). Returns (out, cache)."""
    out, k, v = _self_attn(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm, rope=rope,
                           rope_theta=rope_theta, q_chunk=q_chunk)
    S = x.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return out, cache


def attn_decode(p: Attention, x, cache: Dict[str, torch.Tensor], pos: int, *,
                num_heads, num_kv_heads, head_dim, qk_norm=False, rope="1d",
                rope_theta=10000.0):
    """One-token step. x: [B, 1, D]; cache {"k", "v"} [B, Sc, Hkv, dh];
    ``pos``: the write position (the mask admits k_index <= pos). Writes
    row ``pos`` of the cache in place. Returns (out, cache)."""
    if "k_q" in cache:
        raise NotImplementedError(INT8_KV_SLICE)
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, qk_norm=qk_norm)
    q_pos = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    rk = dict(head_dim=head_dim, rope=rope, rope_theta=rope_theta)
    q, k = _rotate(q, q_pos, **rk), _rotate(k, q_pos, **rk)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    k_pos = torch.arange(Sc, device=x.device)
    out = _sdpa(q, cache["k"], cache["v"], q_pos=q_pos, k_pos=k_pos)
    out = linear(p.wo, out.reshape(B, 1, num_heads * head_dim))
    return out, cache
