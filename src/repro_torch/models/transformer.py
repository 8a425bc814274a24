"""Model assembly: pattern-of-blocks decoder stacks, with an optional
encoder.

Counterpart of ``repro/models/transformer.py``. A model is ``num_groups``
repetitions of the block pattern ``cfg.pattern``; JAX scans the group body
over stacked parameters, the port loops over ``Transformer.groups``, one
``nn.ModuleDict`` of blocks (keys "0", "1", ...) per group. A parameter's
dotted name is its JAX pytree path with the group index after ``groups``
(``groups.3.0.mixer.wq.w`` is ``params["groups"]["0"]["mixer"]["wq"]["w"][3]``).
An encoder-decoder (``cfg.encoder_layers > 0``, whisper) also has
``encoder``: ``encoder.groups.<i>.0.<path>`` (one ``enc`` block a layer)
and ``encoder.final_norm``.

Block = pre-norm mixer (+ residual) then, unless the slot's ffn is
``none``, pre-norm FFN (+ residual). Mixers:
  attn         causal self-attention (GQA/MQA, rope, qk-norm)
  attn_cross   self-attention followed by cross-attention (whisper decoder)
  cross        cross-attention only (llama-3.2-vision media layers)
  enc          bidirectional self-attention (whisper encoder)
  mla          DeepSeek multi-head latent attention
  mamba        selective SSM
  mlstm/slstm  xLSTM blocks (carry their own projections; ffn == none)

The cross mixers attend to the memory: ``encode(media)`` for audio (the
frames [B, T, D] through the encoder), ``media`` [B, M, D] in the compute
dtype for vision. They have no cache: decode recomputes their keys and
values over the whole memory at every step, as JAX does.

Entry points (cfg first, as in JAX):
  init_params(cfg, seed, device)                  -> Transformer
  encode(cfg, model, frames)                      -> memory [B, T, D]
  make_memory(cfg, model, media)                  -> memory, or None
  forward(cfg, model, tokens, media=None)         -> (logits, aux)
  init_cache(cfg, batch, cache_len, device)
  prefill(cfg, model, tokens, media=None, cache_len=None)
                                                  -> (logits [B, V], cache)
  decode_step(cfg, model, cache, tokens, pos, media=None, memory=None)
                                                  -> (logits [B, V], cache)

The cache mirrors JAX's layout, ``{"<slot>": {...}}`` with leaves
[num_groups, B, ...]: attention and ``attn_cross`` {"k", "v"} (or the
int8 form when ``cfg.kv_cache_dtype == "int8"``), MLA {"c_kv", "k_rope"},
Mamba {"conv", "ssm"}, mLSTM {"C", "n", "m"}, sLSTM {"c", "n", "m"}; a
``cross`` or ``enc`` slot has no entry. It is written in place.
``prefill`` sizes the attention and MLA caches ``cache_len`` (default: the
prompt, as JAX), so a server allocates it once at prompt + generation
length; the recurrent states have no length.

Remat: with ``cfg.remat`` in ``train`` mode, while autograd records, each
group runs under ``torch.utils.checkpoint`` (non-reentrant), and so does
each block inside it when the pattern has more than one slot (JAX's nested
``jax.checkpoint``: the backward holds one block's internals and the
block boundaries). ``remat_policy="full"`` saves nothing; any other policy
is JAX's ``dots_with_no_batch_dims_saveable``: the outputs of the plain
matrix products (``aten.mm``/``addmm``, what ``x @ w`` lowers to) are
saved, batched products (``bmm``: attention scores, the experts) are
recomputed. The values do not change; the recomputation runs every
forward operation of a checkpointed block again, the MoE's batched ranks
included.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (MLP, Init, Linear, Norm, linear,
                                       mlp_apply, norm_apply, sinusoidal_at,
                                       sinusoidal_pos)

__all__ = ["Block", "Encoder", "GroupCache", "Transformer", "init_params",
           "encode", "make_memory", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step", "reads_pos", "count_params", "moe_forwards", "stacks"]

MIXERS = ("attn", "attn_cross", "cross", "enc", "mla", "mamba", "mlstm",
          "slstm")
ATTN = ("attn", "attn_cross", "cross", "enc")  # the mixers built on Attention
CROSS = ("attn_cross", "cross")  # the mixers that read the memory
ENC = LayerSpec("enc", "mlp")  # an encoder layer


def _has_cross(cfg: ArchConfig) -> bool:
    return any(spec.mixer in CROSS for spec in cfg.pattern)


def stacks(cfg: ArchConfig) -> Dict[str, int]:
    """JAX's stacked parameter prefixes and their depth: a leaf under
    ``groups.`` is [num_groups, ...], one under ``encoder.groups.``
    [encoder_layers, ...]; the port's name puts the index after the
    prefix (``groups.<g>.<path>``, ``encoder.groups.<i>.<path>``)."""
    return {"groups.": cfg.num_groups, "encoder.groups.": cfg.encoder_layers}


def _check_supported(cfg: ArchConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        if spec.ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown ffn {spec.ffn!r}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _attention(cfg: ArchConfig, init: Init, qk_norm: bool) -> nn.Module:
    return attn_lib.Attention(
        init, d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        bias=cfg.attn_bias, qk_norm=qk_norm, dtype=cfg.pdtype)


def _mixer(cfg: ArchConfig, spec: LayerSpec, init: Init) -> nn.Module:
    dt = cfg.pdtype
    if spec.mixer in ATTN:
        return _attention(cfg, init, cfg.qk_norm)
    if spec.mixer == "mla":
        m = cfg.mla
        return mla_lib.MLA(init, d_model=cfg.d_model, num_heads=cfg.num_heads,
                           kv_lora=m.kv_lora, d_nope=m.d_nope, d_rope=m.d_rope,
                           d_v=m.d_v, dtype=dt)
    if spec.mixer == "mamba":
        mb = cfg.mamba
        return mamba_lib.Mamba(init, d_model=cfg.d_model, d_state=mb.d_state,
                               d_conv=mb.d_conv, expand=mb.expand, dtype=dt)
    if spec.mixer == "mlstm":
        return xlstm_lib.MLSTM(init, d_model=cfg.d_model, num_heads=cfg.num_heads,
                               expand=cfg.lstm_expand, dtype=dt)
    return xlstm_lib.SLSTM(init, d_model=cfg.d_model, dtype=dt)


class Block(nn.Module):
    """``norm1``, ``mixer``, for ``attn_cross`` also ``cross`` (its
    cross-attention, no qk-norm) and ``norm_cross``, and, unless the
    slot's ffn is ``none``, ``norm2`` and ``ffn`` (MLP or MoE)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, init: Init):
        super().__init__()
        dt = cfg.pdtype
        self.norm1 = Norm(init, cfg.norm, cfg.d_model, dt)
        self.mixer = _mixer(cfg, spec, init)
        self.cross = self.norm_cross = None
        if spec.mixer == "attn_cross":
            self.cross = _attention(cfg, init, False)
            self.norm_cross = Norm(init, cfg.norm, cfg.d_model, dt)
        self.norm2 = self.ffn = None
        if spec.ffn != "none":
            self.norm2 = Norm(init, cfg.norm, cfg.d_model, dt)
        if spec.ffn == "mlp":
            self.ffn = MLP(init, cfg.d_model, cfg.d_ff, act=cfg.act,
                           bias=cfg.attn_bias, dtype=dt)
        elif spec.ffn == "moe":
            mo = cfg.moe
            self.ffn = moe_lib.MoE(
                init, d_model=cfg.d_model, d_ff=mo.d_ff,
                num_experts=mo.num_experts, top_k=mo.top_k,
                num_shared=mo.num_shared, act=cfg.act, dtype=dt)


class Embed(nn.Module):
    def __init__(self, init: Init, vocab: int, d_model: int, dtype):
        super().__init__()
        self.w = init.dense((vocab, d_model), dtype)


def _groups(cfg: ArchConfig, pattern, n: int, init: Init) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleDict({str(j): Block(cfg, spec, init)
                       for j, spec in enumerate(pattern)})
        for _ in range(n))


class Encoder(nn.Module):
    """``groups`` (one ModuleDict {"0": enc Block} per encoder layer) and
    ``final_norm``."""

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        self.groups = _groups(cfg, (ENC,), cfg.encoder_layers, init)
        self.final_norm = Norm(init, cfg.norm, cfg.d_model, cfg.pdtype)


class Transformer(nn.Module):
    """``embed``, ``groups`` (one ModuleDict of Blocks per group),
    ``final_norm``, unless the embeddings are tied ``lm_head``, and, when
    ``cfg.encoder_layers > 0``, ``encoder``."""

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        _check_supported(cfg)
        self.embed = Embed(init, cfg.padded_vocab, cfg.d_model, cfg.pdtype)
        self.groups = _groups(cfg, cfg.pattern, cfg.num_groups, init)
        self.final_norm = Norm(init, cfg.norm, cfg.d_model, cfg.pdtype)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(init, cfg.d_model, cfg.padded_vocab,
                               dtype=cfg.pdtype))
        self.encoder = Encoder(cfg, init) if cfg.encoder_layers else None


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda", *,
                requires_grad: bool = False) -> Transformer:
    """The model with random parameters (truncated normal at 0.02, norms
    at 1, biases at 0; Mamba's ``A_log``, ``D`` and dt bias as JAX sets
    them), created on ``device`` one tensor at a time from a
    generator seeded with ``seed``. ``device="meta"`` allocates nothing.
    ``requires_grad=True`` builds a model to train."""
    return Transformer(cfg, Init(device, seed, requires_grad))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def moe_forwards(cfg: ArchConfig) -> int:
    """MoE layer forwards (so batched-ranks calls) in one ``loss_fn`` and
    its gradient: one a MoE layer; with remat, each group's recomputation
    again and, for a pattern of more than one slot, each block's own. A
    group's recomputation stops once its last block's input is made
    (torch's non-reentrant checkpoint stops early by default), so the
    last slot's MoE runs there no more."""
    moe = [spec.ffn == "moe" for spec in cfg.pattern]
    per_group = sum(moe)
    if not cfg.remat:
        return cfg.num_groups * per_group
    if len(moe) == 1:
        return 2 * cfg.num_groups * per_group
    return cfg.num_groups * (3 * per_group - moe[-1])


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _mixer_kw(cfg: ArchConfig, spec: LayerSpec, mode: str) -> dict:
    """The keyword arguments of the slot's mixer functions in ``mode``."""
    if spec.mixer in ATTN:
        kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim_, qk_norm=cfg.qk_norm, rope=cfg.rope,
                  rope_theta=cfg.rope_theta)
    elif spec.mixer == "mla":
        m = cfg.mla
        kw = dict(num_heads=cfg.num_heads, kv_lora=m.kv_lora, d_nope=m.d_nope,
                  d_rope=m.d_rope, d_v=m.d_v, rope_theta=cfg.rope_theta)
    elif spec.mixer == "mamba":
        mb = cfg.mamba
        return dict(d_state=mb.d_state, d_conv=mb.d_conv, expand=mb.expand)
    elif spec.mixer == "mlstm":
        kw = dict(num_heads=cfg.num_heads, expand=cfg.lstm_expand)
    else:
        return dict(num_heads=cfg.num_heads)
    if mode != "decode":
        kw["q_chunk"] = cfg.q_chunk
    return kw


# mixer -> (train, prefill, decode); a decode that takes ``pos`` is in _POS
_MIXER_FNS = {
    "attn": (attn_lib.attn_train, attn_lib.attn_prefill, attn_lib.attn_decode),
    "attn_cross": (attn_lib.attn_train, attn_lib.attn_prefill,
                   attn_lib.attn_decode),
    "mla": (mla_lib.mla_train, mla_lib.mla_prefill, mla_lib.mla_decode),
    "mamba": (mamba_lib.mamba_train, mamba_lib.mamba_prefill,
              mamba_lib.mamba_decode),
    "mlstm": (xlstm_lib.mlstm_train, xlstm_lib.mlstm_prefill,
              xlstm_lib.mlstm_decode),
    "slstm": (xlstm_lib.slstm_train, xlstm_lib.slstm_prefill,
              xlstm_lib.slstm_decode),
}
_POS = ("attn", "attn_cross", "mla")


def _apply_mixer(cfg: ArchConfig, spec: LayerSpec, p: Block, x, *, memory,
                 mode, cache=None, pos=None):
    """JAX's ``_apply_mixer``: the slot's mixer in ``mode`` (train |
    prefill | decode); prefill and decode write ``cache`` in place. ``enc``
    is bidirectional and ``cross`` attends to ``memory`` in every mode;
    ``attn_cross`` runs its self-attention in ``mode``, then
    cross-attention on ``norm_cross(x + self_out)`` (``x`` the normed
    block input, as JAX computes it), and returns the sum of the two."""
    if spec.mixer == "enc":
        return attn_lib.attn_train(p.mixer, x, causal=False,
                                   **_mixer_kw(cfg, spec, "train"))
    if spec.mixer == "cross":
        return attn_lib.attn_train(p.mixer, x, kv_x=memory,
                                   **_mixer_kw(cfg, spec, "train"))
    train, prefill, decode = _MIXER_FNS[spec.mixer]
    kw = _mixer_kw(cfg, spec, mode)
    if mode == "train":
        out = train(p.mixer, x, **kw)
    elif mode == "prefill":
        out = prefill(p.mixer, x, cache, **kw)[0]
    elif spec.mixer in _POS:
        out = decode(p.mixer, x, cache, pos, **kw)[0]
    else:
        out = decode(p.mixer, x, cache, **kw)[0]
    if spec.mixer == "attn_cross":
        xc = norm_apply(p.norm_cross, x + out)
        out = attn_lib.attn_train(p.cross, xc, kv_x=memory,
                                  **_mixer_kw(cfg, spec, "train")) + out
    return out


def _apply_block(cfg: ArchConfig, spec: LayerSpec, p: Block, h, *, memory=None,
                 mode, cache=None, pos=None, mesh=None):
    """mode: train | prefill | decode. Returns (h, aux or None). ``mesh``:
    the DeviceMesh that ``cfg.act_sharding`` and ``cfg.ep_axis`` name axes
    of (the MoE's collectives)."""
    h = h + _apply_mixer(cfg, spec, p, norm_apply(p.norm1, h), memory=memory,
                         mode=mode, cache=cache, pos=pos)
    if spec.ffn == "none":
        return h, None
    x = norm_apply(p.norm2, h)
    if spec.ffn == "mlp":
        return h + mlp_apply(p.ffn, x), None
    mo = cfg.moe
    y, aux = moe_lib.moe_apply(
        p.ffn, x, num_experts=mo.num_experts, top_k=mo.top_k,
        capacity_factor=mo.capacity_factor, act=cfg.act,
        ep_axis=cfg.ep_axis, token_axes=cfg.act_sharding,
        group_size=mo.group_size, mesh=mesh)
    return h + y, aux


def _block_aux(cfg: ArchConfig, spec: LayerSpec, p: Block, h, lb, rz, **kw):
    """``_apply_block`` with the aux losses carried: (h, lb, rz)."""
    h, a = _apply_block(cfg, spec, p, h, **kw)
    if a is not None:
        lb, rz = lb + a["load_balance"], rz + a["router_z"]
    return h, lb, rz


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable`` as a selective-checkpoint
    policy: save the plain matrix products, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(cfg: ArchConfig, fn):
    """``fn`` under ``torch.utils.checkpoint`` with ``cfg.remat_policy``
    (the forward draws no random numbers: no RNG state to keep)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy != "full":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return functools.partial(checkpoint, fn, **kw)


class GroupCache:
    """A cache that the stack reads one group at a time, in place of the
    stacked dict: ``open(g)`` returns group g's ``{slot: {leaf: tensor}}``
    (the tensors the group's mixers read and write in place), and
    ``close(g, c)`` takes them back once the group has run. The sharded
    serving steps (``launch/steps.py``) hold only each rank's block of the
    cache and build a group's whole leaves at ``open``."""

    def open(self, g: int) -> Dict[str, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def close(self, g: int, c: Dict[str, Dict[str, torch.Tensor]]) -> None:
        raise NotImplementedError


def _run_stack(cfg: ArchConfig, groups, h, *, memory=None, mode, cache=None,
               pos=None, pattern=None, mesh=None):
    """The groups in order (JAX scans them); returns (h, summed aux).
    ``cache``: the stacked dict (group g reads ``v[g]`` of each leaf) or a
    ``GroupCache``. A slot with no entry in the cache (``cross``, ``enc``)
    gets none. With
    ``cfg.remat`` in train mode under autograd, each group (and, for a
    pattern of more than one slot, each block) is checkpointed."""
    pattern = pattern or cfg.pattern
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    inner = remat and len(pattern) > 1

    def group_fn(gc, group, h, lb, rz):
        for j, spec in enumerate(pattern):
            blk = functools.partial(_block_aux, cfg, spec, group[str(j)],
                                    memory=memory, mode=mode, cache=gc.get(str(j)),
                                    pos=pos, mesh=mesh)
            h, lb, rz = (_checkpointed(cfg, blk) if inner else blk)(h, lb, rz)
        return h, lb, rz

    lb = rz = torch.zeros((), device=h.device)
    for g, group in enumerate(groups):
        if isinstance(cache, GroupCache):
            gc = cache.open(g)
        else:
            gc = {j: {k: v[g] for k, v in c.items()}
                  for j, c in (cache or {}).items()}
        fn = functools.partial(group_fn, gc, group)
        h, lb, rz = (_checkpointed(cfg, fn) if remat else fn)(h, lb, rz)
        if isinstance(cache, GroupCache):
            cache.close(g, gc)
    return h, {"load_balance": lb, "router_z": rz}


def _embed(cfg: ArchConfig, model: Transformer, tokens):
    """Rows of the embedding times sqrt(d_model), the scale computed in
    f32 and cast to the compute dtype first, as JAX does."""
    h = model.embed.w[tokens].to(cfg.cdtype)
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                            device=h.device).to(cfg.cdtype)


def _sinusoidal(cfg: ArchConfig) -> bool:
    """JAX's condition for adding sinusoidal positions to the embedding."""
    return cfg.rope == "none" and cfg.family == "audio"


def _head(cfg: ArchConfig, model: Transformer, h):
    h = norm_apply(model.final_norm, h)
    if cfg.tie_embeddings:
        return h @ model.embed.w.T
    return linear(model.lm_head, h)


def encode(cfg: ArchConfig, model: Transformer, frames):
    """Whisper's encoder over frame embeddings [B, T, D] (the conv
    frontend is a stub, as in JAX): the frames in the compute dtype plus
    the sinusoidal table, the bidirectional stack, the final norm."""
    if model.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    h = frames.to(cfg.cdtype) + sinusoidal_pos(
        frames.shape[1], cfg.d_model, cfg.cdtype, frames.device)[None]
    h, _ = _run_stack(cfg, model.encoder.groups, h, mode="train",
                      pattern=(ENC,))
    return norm_apply(model.encoder.final_norm, h)


def make_memory(cfg: ArchConfig, model: Transformer, media):
    """The cross mixers' memory: ``encode(media)`` for audio, ``media`` in
    the compute dtype for vision, None for a config with no cross slot.
    Raises ``ValueError`` when a cross slot has no media to attend to
    (JAX fails there too, on ``None``)."""
    if media is None:
        if cfg.encoder_layers or _has_cross(cfg):
            raise ValueError(f"{cfg.name}: the cross layers need the media "
                             "(frames [B, T, D] for audio, [B, M, D] for vision)")
        return None
    if cfg.encoder_layers:
        return encode(cfg, model, media)
    if cfg.num_media_tokens:
        return media.to(cfg.cdtype)
    return None


def forward(cfg: ArchConfig, model: Transformer, tokens, media=None, *,
            mesh=None):
    """Forward pass -> (logits [B, S, padded_vocab], aux). ``media``:
    vision [B, M, D] patch embeddings (the cross-attention memory); audio
    [B, T, D] frame embeddings (through the encoder first). ``mesh``: the
    DeviceMesh of ``cfg.act_sharding`` (the rows of ``tokens`` are this
    rank's block of the batch) and ``cfg.ep_axis``."""
    memory = make_memory(cfg, model, media)
    h = _embed(cfg, model, tokens)
    if _sinusoidal(cfg):
        h = h + sinusoidal_pos(tokens.shape[1], cfg.d_model, cfg.cdtype,
                               h.device)[None]
    h, aux = _run_stack(cfg, model.groups, h, memory=memory, mode="train",
                        mesh=mesh)
    return _head(cfg, model, h), aux


def loss_fn(cfg: ArchConfig, model: Transformer, batch, *, lb_weight: float = 0.01,
            mesh=None):
    """batch: {"tokens" [B, S], "labels" [B, S]} (+ "media"). Returns
    (total, parts): the mean cross-entropy over the labels in [0,
    vocab_size) from f32 logits, plus the z-loss 1e-4 * mean(logsumexp^2),
    ``lb_weight`` x the MoE load-balance loss and the router-z loss; parts
    {"ce", "z_loss", "load_balance", "router_z"}, 0-dim. A label outside
    the padded vocabulary is masked out, its gold logit read at a clamped
    index (JAX's gather fills it; either way the mask drops it).

    With a ``mesh`` and ``cfg.act_sharding``, the batch is this rank's rows
    of the global batch: the cross-entropy is divided by the global count
    of valid labels and the z-loss by the global token count (all-reduced
    first), and the aux losses (already global) weighted by this rank's
    share of the tokens, so ``total`` is this rank's part of the global
    loss and its gradient a partial sum of the global loss's gradient.
    ``parts`` then holds the global values; the global loss is the sum of
    ``total`` over the data ranks."""
    logits, aux = forward(cfg, model, batch["tokens"], batch.get("media"),
                          mesh=mesh)
    logits = logits.to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(0, cfg.padded_vocab - 1)[..., None])[..., 0]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    rows = ()
    if mesh is not None:
        from repro_torch.launch import collectives as cc
        rows = cc.as_axes(cfg.act_sharding)
    count = torch.sum(mask)
    if rows:
        count = cc.psum(count, mesh, rows)
    ce = torch.sum(torch.where(mask, logz - gold, 0.0)) / torch.clamp(count, min=1)
    if not rows:
        zl = 1e-4 * torch.mean(torch.square(logz))
        total = ce + zl + lb_weight * aux["load_balance"] + aux["router_z"]
        return total, {"ce": ce, "z_loss": zl, **aux}
    frac = 1.0 / cc.axis_size(mesh, rows)  # this rank's share of the tokens
    zl = 1e-4 * (torch.mean(torch.square(logz)) * frac)
    total = ce + zl + lb_weight * (aux["load_balance"] * frac) + aux["router_z"] * frac
    return total, {"ce": cc.psum(ce, mesh, rows), "z_loss": cc.psum(zl, mesh, rows),
                   **aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _slot_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, cache_len: int,
                device) -> Optional[Dict[str, torch.Tensor]]:
    """JAX's ``_slot_cache`` with a leading [num_groups] axis, zeroed;
    None for a slot with no cache (``cross``, ``enc``)."""
    G = cfg.num_groups

    def zeros(shape, dtype=cfg.cdtype):
        return torch.zeros((G, *shape), dtype=dtype, device=device)

    if spec.mixer in ("attn", "attn_cross"):
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
        if cfg.kv_cache_dtype == "int8":
            return {"k_q": zeros(shape, torch.int8),
                    "k_s": zeros(shape[:-1], torch.float32),
                    "v_q": zeros(shape, torch.int8),
                    "v_s": zeros(shape[:-1], torch.float32)}
        return {"k": zeros(shape), "v": zeros(shape)}
    if spec.mixer == "mla":
        m = cfg.mla
        return {"c_kv": zeros((batch, cache_len, m.kv_lora)),
                "k_rope": zeros((batch, cache_len, m.d_rope))}
    if spec.mixer == "mamba":
        mb = cfg.mamba
        one = mamba_lib.mamba_init_cache(
            batch, d_model=cfg.d_model, d_state=mb.d_state, d_conv=mb.d_conv,
            expand=mb.expand, dtype=cfg.cdtype, device="meta")
    elif spec.mixer == "mlstm":
        one = xlstm_lib.mlstm_init_cache(batch, d_model=cfg.d_model,
                                         num_heads=cfg.num_heads,
                                         expand=cfg.lstm_expand, device="meta")
    elif spec.mixer == "slstm":
        one = xlstm_lib.slstm_init_cache(batch, d_model=cfg.d_model,
                                         device="meta")
    else:
        return None
    return {k: zeros(t.shape, t.dtype) for k, t in one.items()}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda"):
    """Zeroed cache of every slot that has one, stacked over groups as
    JAX's scan layout; ``cache_len`` sizes the attention and MLA caches."""
    _check_supported(cfg)
    return {str(j): c for j, spec in enumerate(cfg.pattern)
            if (c := _slot_cache(cfg, spec, batch, cache_len, device))
            is not None}


def prefill(cfg: ArchConfig, model: Transformer, tokens, media=None,
            cache_len: Optional[int] = None, *, mesh=None, cache=None):
    """Run the prompt (and, for audio, encode ``media``'s frames); return
    (last-position logits [B, V], cache), the attention and MLA caches
    sized ``cache_len`` (default: the prompt length). ``mesh`` as in
    ``forward``. ``cache``: a ``GroupCache`` to write in place of a new
    zeroed one (its groups must open zeroed, sized as ``init_cache``'s)."""
    memory = make_memory(cfg, model, media)
    B, S = tokens.shape
    if cache is None:
        cache = init_cache(cfg, B, cache_len or S, model.embed.w.device)
    h = _embed(cfg, model, tokens)
    if _sinusoidal(cfg):
        h = h + sinusoidal_pos(S, cfg.d_model, cfg.cdtype, h.device)[None]
    h, _ = _run_stack(cfg, model.groups, h, memory=memory, mode="prefill",
                      cache=cache, mesh=mesh)
    logits = _head(cfg, model, h[:, -1:])
    return logits[:, 0], cache


def reads_pos(cfg: ArchConfig) -> bool:
    """Whether ``decode_step`` reads ``pos``: a slot that writes or masks by
    position (attention, MLA), or sinusoidal positions (whisper); the
    recurrent mixers (Mamba, xLSTM) carry their state instead."""
    return any(spec.mixer in _POS for spec in cfg.pattern) or _sinusoidal(cfg)


def decode_step(cfg: ArchConfig, model: Transformer, cache: Dict, tokens, pos: int,
                media=None, memory=None, *, mesh=None):
    """One decode step. tokens [B, 1]; ``pos``: the write position;
    ``memory``: the cross mixers' memory, ``make_memory``'s output (vision
    may pass ``media`` in its place, as JAX's signature allows); ``mesh``
    as in ``forward``. Returns (logits [B, V], cache), the cache updated
    in place. ``cache``: the stacked dict or a ``GroupCache``.

    Unlike JAX, a config with a cross slot raises ``ValueError`` when no
    memory is given (JAX would run those layers as self-attention); the
    step does not encode audio frames."""
    if memory is None and media is not None and not cfg.encoder_layers:
        memory = make_memory(cfg, model, media)
    if memory is None and _has_cross(cfg):
        raise ValueError(f"{cfg.name}: decode_step needs the memory "
                         "(memory=make_memory(...), or media= for vision)")
    h = _embed(cfg, model, tokens)
    if _sinusoidal(cfg):
        h = h + sinusoidal_at(int(pos), cfg.d_model, cfg.cdtype,
                              h.device)[None, None]
    h, _ = _run_stack(cfg, model.groups, h, memory=memory, mode="decode",
                      cache=cache, pos=int(pos), mesh=mesh)
    logits = _head(cfg, model, h)
    return logits[:, 0], cache
