"""Model assembly: pattern-of-blocks decoder stacks.

Counterpart of ``repro/models/transformer.py`` for the mixer ``attn`` with
the FFNs ``mlp`` and ``moe``. A model is ``num_groups`` repetitions of the
block pattern ``cfg.pattern``; JAX scans the group body over stacked
parameters, the port loops over ``Transformer.groups``, one
``nn.ModuleDict`` of blocks (keys "0", "1", ...) per group. A parameter's
dotted name is its JAX pytree path with the group index after ``groups``
(``groups.3.0.mixer.wq.w`` is ``params["groups"]["0"]["mixer"]["wq"]["w"][3]``).

Block = pre-norm mixer (+ residual) then pre-norm FFN (+ residual).

Entry points (cfg first, as in JAX):
  init_params(cfg, seed, device)                  -> Transformer
  forward(cfg, model, tokens)                     -> (logits, aux)
  init_cache(cfg, batch, cache_len, device)
  prefill(cfg, model, tokens, cache_len=None)     -> (logits [B, V], cache)
  decode_step(cfg, model, cache, tokens, pos)     -> (logits [B, V], cache)

The cache mirrors JAX's layout, ``{"<slot>": {"k", "v"}}`` with leaves
[num_groups, B, Sc, Hkv, dh], and is written in place. ``prefill`` sizes it
``cache_len`` (default: the prompt, as JAX), so a server allocates it once
at prompt + generation length. Other mixers, encoders, media and the int8
cache raise ``NotImplementedError`` naming their ROADMAP slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (MLP, Init, Linear, Norm, linear,
                                       mlp_apply, norm_apply)

__all__ = ["Block", "Transformer", "init_params", "forward", "init_cache",
           "prefill", "decode_step", "count_params", "LATER_SLICES"]

# what the port does not run yet, and the ROADMAP slice that brings it
LATER_SLICES = {
    "mla": "ROADMAP queue 1 slice 14.1 (MLA, deepseek-v2-lite)",
    "mamba": "ROADMAP queue 1 slice 14.2 (Mamba, jamba)",
    "mlstm": "ROADMAP queue 1 slice 14.3 (xLSTM)",
    "slstm": "ROADMAP queue 1 slice 14.3 (xLSTM)",
    "attn_cross": attn_lib.CROSS_SLICE,
    "cross": attn_lib.CROSS_SLICE,
    "enc": attn_lib.CROSS_SLICE,
    "int8": attn_lib.INT8_KV_SLICE,
}


def _check_supported(cfg: ArchConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: mixer {spec.mixer!r}: {LATER_SLICES[spec.mixer]}")
        if spec.ffn not in ("mlp", "moe"):
            raise NotImplementedError(f"{cfg.name}: ffn {spec.ffn!r}: "
                                      f"{LATER_SLICES['mlstm']}")
    if cfg.encoder_layers or cfg.num_media_tokens:
        raise NotImplementedError(f"{cfg.name}: encoder/media memory: "
                                  f"{LATER_SLICES['enc']}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(LATER_SLICES["int8"])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``norm1``, ``mixer`` (Attention), ``norm2``, ``ffn`` (MLP or MoE)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, init: Init):
        super().__init__()
        dt = cfg.pdtype
        self.norm1 = Norm(init, cfg.norm, cfg.d_model, dt)
        self.mixer = attn_lib.Attention(
            init, d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
            bias=cfg.attn_bias, qk_norm=cfg.qk_norm, dtype=dt)
        self.norm2 = Norm(init, cfg.norm, cfg.d_model, dt)
        if spec.ffn == "mlp":
            self.ffn = MLP(init, cfg.d_model, cfg.d_ff, act=cfg.act,
                           bias=cfg.attn_bias, dtype=dt)
        else:
            mo = cfg.moe
            self.ffn = moe_lib.MoE(
                init, d_model=cfg.d_model, d_ff=mo.d_ff,
                num_experts=mo.num_experts, top_k=mo.top_k,
                num_shared=mo.num_shared, act=cfg.act, dtype=dt)


class Embed(nn.Module):
    def __init__(self, init: Init, vocab: int, d_model: int, dtype):
        super().__init__()
        self.w = init.dense((vocab, d_model), dtype)


class Transformer(nn.Module):
    """``embed``, ``groups`` (one ModuleDict of Blocks per group),
    ``final_norm`` and, unless the embeddings are tied, ``lm_head``."""

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        _check_supported(cfg)
        self.embed = Embed(init, cfg.padded_vocab, cfg.d_model, cfg.pdtype)
        self.groups = nn.ModuleList(
            nn.ModuleDict({str(j): Block(cfg, spec, init)
                           for j, spec in enumerate(cfg.pattern)})
            for _ in range(cfg.num_groups))
        self.final_norm = Norm(init, cfg.norm, cfg.d_model, cfg.pdtype)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(init, cfg.d_model, cfg.padded_vocab,
                               dtype=cfg.pdtype))


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> Transformer:
    """The model with random parameters (truncated normal at 0.02, norms
    at 1, biases at 0), created on ``device`` one tensor at a time from a
    generator seeded with ``seed``. ``device="meta"`` allocates nothing."""
    return Transformer(cfg, Init(device, seed))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim_, qk_norm=cfg.qk_norm, rope=cfg.rope,
                rope_theta=cfg.rope_theta)


def _apply_block(cfg: ArchConfig, spec: LayerSpec, p: Block, h, *, mode,
                 cache=None, pos=None):
    """mode: train | prefill | decode. Returns (h, aux)."""
    x = norm_apply(p.norm1, h)
    kw = _attn_kw(cfg)
    if mode == "train":
        out = attn_lib.attn_train(p.mixer, x, q_chunk=cfg.q_chunk, **kw)
    elif mode == "prefill":
        out, _ = attn_lib.attn_prefill(p.mixer, x, cache, q_chunk=cfg.q_chunk,
                                       **kw)
    else:
        out, _ = attn_lib.attn_decode(p.mixer, x, cache, pos, **kw)
    h = h + out
    x = norm_apply(p.norm2, h)
    if spec.ffn == "mlp":
        return h + mlp_apply(p.ffn, x), None
    mo = cfg.moe
    y, aux = moe_lib.moe_apply(
        p.ffn, x, num_experts=mo.num_experts, top_k=mo.top_k,
        capacity_factor=mo.capacity_factor, act=cfg.act,
        ep_axis=cfg.ep_axis, token_axes=cfg.act_sharding,
        group_size=mo.group_size)
    return h + y, aux


def _run_stack(cfg: ArchConfig, model: Transformer, h, *, mode, cache=None,
               pos=None):
    """The groups in order (JAX scans them); returns (h, summed aux)."""
    aux = {"load_balance": torch.zeros((), device=h.device),
           "router_z": torch.zeros((), device=h.device)}
    for g, group in enumerate(model.groups):
        for j, spec in enumerate(cfg.pattern):
            c = None
            if cache is not None:
                c = {k: v[g] for k, v in cache[str(j)].items()}
            h, a = _apply_block(cfg, spec, group[str(j)], h, mode=mode,
                                cache=c, pos=pos)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
    return h, aux


def _embed(cfg: ArchConfig, model: Transformer, tokens):
    """Rows of the embedding times sqrt(d_model), the scale computed in
    f32 and cast to the compute dtype first, as JAX does."""
    h = model.embed.w[tokens].to(cfg.cdtype)
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                            device=h.device).to(cfg.cdtype)


def _head(cfg: ArchConfig, model: Transformer, h):
    h = norm_apply(model.final_norm, h)
    if cfg.tie_embeddings:
        return h @ model.embed.w.T
    return linear(model.lm_head, h)


def forward(cfg: ArchConfig, model: Transformer, tokens, media=None):
    """Forward pass -> (logits [B, S, padded_vocab], aux)."""
    if media is not None:
        raise NotImplementedError(LATER_SLICES["cross"])
    h = _embed(cfg, model, tokens)
    h, aux = _run_stack(cfg, model, h, mode="train")
    return _head(cfg, model, h), aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda"):
    """Zeroed KV cache, stacked over groups as JAX's scan layout."""
    _check_supported(cfg)
    shape = (cfg.num_groups, batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    return {str(j): {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
            for j in range(len(cfg.pattern))}


def prefill(cfg: ArchConfig, model: Transformer, tokens, media=None,
            cache_len: Optional[int] = None):
    """Run the prompt; return (last-position logits [B, V], cache), the
    cache sized ``cache_len`` (default: the prompt length)."""
    if media is not None:
        raise NotImplementedError(LATER_SLICES["cross"])
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, model.embed.w.device)
    h = _embed(cfg, model, tokens)
    h, _ = _run_stack(cfg, model, h, mode="prefill", cache=cache)
    logits = _head(cfg, model, h[:, -1:])
    return logits[:, 0], cache


def decode_step(cfg: ArchConfig, model: Transformer, cache: Dict, tokens, pos: int,
                media=None, memory=None):
    """One decode step. tokens [B, 1]; ``pos``: the write position. Returns
    (logits [B, V], cache), the cache updated in place."""
    if media is not None or memory is not None:
        raise NotImplementedError(LATER_SLICES["cross"])
    h = _embed(cfg, model, tokens)
    h, _ = _run_stack(cfg, model, h, mode="decode", cache=cache, pos=int(pos))
    logits = _head(cfg, model, h)
    return logits[:, 0], cache
