"""Multi-head Latent Attention (DeepSeek-V2): the kv_lora-compressed KV.

Counterpart of ``repro/models/mla.py``. ``mla_train`` (and the prefill)
uses the non-absorbed form: the latent ``c_kv`` is decompressed into
per-head keys and values. ``mla_decode`` uses the absorbed form: W_uk folds
into the query and W_uv into the output, so the scores run against the
cached latent ``c_kv`` [B, Sc, kv_lora] and the one shared rope key
``k_rope`` [B, Sc, d_rope]: (kv_lora + d_rope) values per token.

The scale follows JAX in each form: train multiplies the compute-dtype
scores by an f32 ``1/sqrt(d_nope + d_rope)``, which widens them to f32;
decode divides the compute-dtype scores by ``sqrt(d_nope + d_rope)`` (a
weakly typed scalar: the quotient stays in the compute dtype), then casts
to f32. The cache is written in place, as ``attention``'s.

Tensor parallelism (``tp``, as in ``attention``): when ``wq`` is bound as
a block of the heads, so are ``wuk`` and ``wuv``, and ``wo`` is
row-parallel (summed over the axes); the input enters through ``copy``,
and the latent (``wdkv``, ``kv_norm``, ``wkr``, whole) is computed whole
on every rank. The latent cache is split on the sequence (JAX's
``cache_spec``; a ``common.CacheSlot`` with ``seq``): the prefill writes
the prompt's positions in the rank's block, and decode (split-KV) writes
the token's latent on the rank whose block holds ``pos``, gathers the
absorbed query (``q_lat`` beside ``q_rope``) over the heads, attends
with every head over its block, combines the blocks' partial sums of
``out_lat`` over the axes (``attention``'s, one all-gather) and applies
its heads' ``wuv`` and the row-parallel ``wo``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch.models.attention import query_chunks, seq_rows, softmax_partials
from repro_torch.models.common import (Init, Linear, Norm, apply_rope, f32,
                                       linear, rmsnorm, rope_angles, seq_block)

__all__ = ["MLA", "mla_train", "mla_prefill", "mla_decode"]


class MLA(nn.Module):
    """JAX's ``mla_init``: ``wq``, ``wdkv``, ``kv_norm`` (RMSNorm over the
    latent), ``wuk``, ``wuv``, ``wkr``, ``wo``."""

    def __init__(self, init: Init, *, d_model: int, num_heads: int, kv_lora: int,
                 d_nope: int, d_rope: int, d_v: int, dtype=torch.float32):
        super().__init__()
        self.wq = Linear(init, d_model, num_heads * (d_nope + d_rope), dtype=dtype)
        self.wdkv = Linear(init, d_model, kv_lora, dtype=dtype)
        self.kv_norm = Norm(init, "rmsnorm", kv_lora, dtype)
        self.wuk = Linear(init, kv_lora, num_heads * d_nope, dtype=dtype)
        self.wuv = Linear(init, kv_lora, num_heads * d_v, dtype=dtype)
        self.wkr = Linear(init, d_model, d_rope, dtype=dtype)
        self.wo = Linear(init, num_heads * d_v, d_model, dtype=dtype)


def _q_proj(p: MLA, x, *, num_heads, d_nope, d_rope, rope_theta, positions):
    B, S = x.shape[0], x.shape[1]
    q = linear(p.wq, x).reshape(B, S, num_heads, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    cos, sin = rope_angles(positions, d_rope, rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _latent_kv(p: MLA, x, *, rope_theta, positions):
    """(c_kv [B, S, kv_lora], k_rope [B, S, d_rope]): the normed latent and
    the rotated shared rope key (one head)."""
    c_kv = rmsnorm(p.kv_norm, linear(p.wdkv, x))
    k_rope = linear(p.wkr, x)
    cos, sin = rope_angles(positions, k_rope.shape[-1], rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def _split(p: MLA, x, tp, *, num_heads, d_nope, d_rope):
    """(x, the axes that split the bound heads or None, the bound heads):
    ``x`` through ``copy`` when they are split."""
    H = p.wq.w.shape[1] // (d_nope + d_rope)
    axes = tp.over(num_heads, H) if tp is not None else None
    return (tp.copy(x, axes) if axes else x), axes, H


def _out(p: MLA, o, tp, axes):
    return tp.reduce(o @ p.wo.w, axes) if axes else linear(p.wo, o)


def _train(p: MLA, x, *, num_heads, d_nope, d_rope, d_v, rope_theta, q_chunk,
           tp=None):
    """(out [B, S, D], c_kv, k_rope): full-sequence causal MLA."""
    B, S, _ = x.shape
    x, axes, num_heads = _split(p, x, tp, num_heads=num_heads, d_nope=d_nope,
                                d_rope=d_rope)
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope = _q_proj(p, x, num_heads=num_heads, d_nope=d_nope,
                             d_rope=d_rope, rope_theta=rope_theta, positions=pos)
    c_kv, k_rope = _latent_kv(p, x, rope_theta=rope_theta, positions=pos)
    k_nope = linear(p.wuk, c_kv).reshape(B, S, num_heads, d_nope)
    v = linear(p.wuv, c_kv).reshape(B, S, num_heads, d_v)
    scale = 1.0 / torch.sqrt(f32(d_nope + d_rope, x.device))

    def block(qn, qr, qpos):
        s = torch.einsum("bqhd,bkhd->bhqk", qn, k_nope)
        s = s + torch.einsum("bqhd,bkd->bhqk", qr, k_rope)
        s = s.float() * scale
        ok = pos[None, :] <= qpos[0][:, None]
        s = s.masked_fill(~ok[None, None], float("-inf"))
        w = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    out = query_chunks(block, S, q_chunk, q_nope, q_rope, pos[None])
    return _out(p, out.reshape(B, S, num_heads * d_v), tp, axes), c_kv, k_rope


def mla_train(p: MLA, x, *, num_heads, kv_lora, d_nope, d_rope, d_v,
              rope_theta=10000.0, q_chunk=None, tp=None):
    """Full-sequence causal MLA (non-absorbed). Returns [B, S, D]."""
    return _train(p, x, num_heads=num_heads, d_nope=d_nope, d_rope=d_rope,
                  d_v=d_v, rope_theta=rope_theta, q_chunk=q_chunk, tp=tp)[0]


def mla_prefill(p: MLA, x, cache: Dict[str, torch.Tensor], *, num_heads, kv_lora,
                d_nope, d_rope, d_v, rope_theta=10000.0, q_chunk=None, tp=None):
    """``mla_train`` over the prompt that also writes the latent cache
    {"c_kv" [B, Sc, kv_lora], "k_rope" [B, Sc, d_rope]} rows [0, S) in
    place (JAX pads them to the cache length). Returns (out, cache)."""
    out, c_kv, k_rope = _train(p, x, num_heads=num_heads, d_nope=d_nope,
                               d_rope=d_rope, d_v=d_v, rope_theta=rope_theta,
                               q_chunk=q_chunk, tp=tp)
    _write_latent(cache, 0, c_kv, k_rope, tp)
    return out, cache


def _write_latent(cache, start: int, c_kv, k_rope, tp) -> None:
    """Positions [start, start + len) of the latent cache := c_kv, k_rope
    (of the rank's block only, when the sequence dim is split)."""
    rows = seq_rows(cache, start, c_kv.shape[1], tp)
    if rows is not None:
        src, dst = rows
        cache["c_kv"][:, dst] = c_kv[:, src].to(cache["c_kv"].dtype)
        cache["k_rope"][:, dst] = k_rope[:, src].to(cache["k_rope"].dtype)


def mla_decode(p: MLA, x, cache: Dict[str, torch.Tensor], pos: int, *, num_heads,
               kv_lora, d_nope, d_rope, d_v, rope_theta=10000.0, tp=None):
    """Absorbed one-token step against the latent cache; writes row ``pos``
    in place. x: [B, 1, D]. Returns (out, cache)."""
    B = x.shape[0]
    x, axes, num_heads = _split(p, x, tp, num_heads=num_heads, d_nope=d_nope,
                                d_rope=d_rope)
    q_pos = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    q_nope, q_rope = _q_proj(p, x, num_heads=num_heads, d_nope=d_nope,
                             d_rope=d_rope, rope_theta=rope_theta,
                             positions=q_pos)
    c_new, kr_new = _latent_kv(p, x, rope_theta=rope_theta, positions=q_pos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    _write_latent(cache, pos, c_new, kr_new, tp)

    wuk = p.wuk.w.reshape(kv_lora, num_heads, d_nope)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wuk)  # absorb W_uk
    wuv = p.wuv.w.reshape(kv_lora, num_heads, d_v)
    seq, n = seq_block(cache)
    if seq:
        from repro_torch.launch import collectives as cc
        q = torch.cat([q_lat, q_rope], dim=-1)
        if axes:  # every head
            q = cc.gather_dim(q, tp.mesh, axes, 2)
        s = torch.einsum("bqhl,bkl->bhqk", q[..., :kv_lora], c_kv)
        s = s + torch.einsum("bqhd,bkd->bhqk", q[..., kv_lora:], k_rope)
        s = (s / f32(math.sqrt(d_nope + d_rope), x.device)).float()
        k_pos = tp.index(seq) * n + torch.arange(n, device=x.device)
        w, m, l = softmax_partials(s, k_pos, pos)
        o = torch.einsum("bhqk,bkl->bqhl", w, c_kv.float())
        out_lat = tp.block(cc.combine_partials(
            o, m.transpose(1, 2), l.transpose(1, 2), tp.mesh, seq).to(x.dtype),
            axes, 2)
        out = torch.einsum("bqhl,lhd->bqhd", out_lat, wuv)  # absorb W_uv
        return _out(p, out.reshape(B, 1, num_heads * d_v), tp, axes), cache
    s = torch.einsum("bqhl,bkl->bhqk", q_lat, c_kv)
    s = s + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)
    s = (s / f32(math.sqrt(d_nope + d_rope), x.device)).float()
    ok = torch.arange(c_kv.shape[1], device=x.device) <= pos
    s = s.masked_fill(~ok, float("-inf"))
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhqk,bkl->bqhl", w, c_kv)
    out = torch.einsum("bqhl,lhd->bqhd", out_lat, wuv)  # absorb W_uv
    return _out(p, out.reshape(B, 1, num_heads * d_v), tp, axes), cache
