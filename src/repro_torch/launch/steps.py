"""Step functions: the units the trainer and the server run.

Counterpart of ``repro/launch/steps.py``: ``make_train_step`` (forward,
backward and the AdamW update, with optional gradient accumulation over
microbatches and int8 error-feedback gradient compression),
``make_prefill_step`` (prompt pass returning the last logits and the
cache) and ``make_serve_step`` (one greedy decode token against the
cache). JAX returns functions for ``jax.jit``; PyTorch runs them eagerly.

On one device: ``auto_microbatch`` takes no mesh, and the train step has
no sharding constraints (JAX's ``grad_shardings`` and ``data_axes``).
Sharding is ROADMAP queue 1 slice 14.8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.models import transformer as T
from repro_torch.models.common import f32
from repro_torch.models.moe import SHARDING_SLICE
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["StepOptions", "TRANSIENT_F32_FACTOR", "auto_microbatch",
           "make_train_step", "make_prefill_step", "make_serve_step", "greedy"]


@dataclasses.dataclass(frozen=True)
class StepOptions:
    microbatch: int = 1  # grad-accumulation chunks over the batch dim
    compress_grads: bool = False  # int8 error-feedback (adds residual state)
    opt: AdamWConfig = AdamWConfig()


TRANSIENT_F32_FACTOR = 12  # live f32 [B', S, D]-sized buffers during a
# block's backward window (JAX's figure, from its buffer dumps)


def auto_microbatch(cfg: ArchConfig, case: ShapeCase, mesh=None,
                    *, target_bytes: int = 4 << 30) -> int:
    """The gradient-accumulation factor that keeps activation memory under
    ``target_bytes``: the remat carries (one [B, S, D] bf16 per group, +
    encoder) plus the transient f32 working set of one block's backward;
    M is a power of two, at most the batch. One device: a mesh raises
    (sharding is slice 14.8)."""
    if mesh is not None:
        raise NotImplementedError(f"auto_microbatch over a mesh: {SHARDING_SLICE}")
    if case.kind != "train":
        return 1
    B = case.global_batch
    tokens = max(B, 1) * case.seq_len
    groups = cfg.num_groups + (cfg.encoder_layers or 0)
    carry = tokens * cfg.d_model * 2 * groups
    transient = tokens * cfg.d_model * 4 * TRANSIENT_F32_FACTOR
    M, cap = 1, max(B, 1)
    while (carry + transient) / M > target_bytes and M * 2 <= cap:
        M *= 2
    return M


def make_train_step(cfg: ArchConfig, opts: StepOptions = StepOptions()):
    """state = {"params": the model (its parameters require grad), "opt":
    ``adamw_init``'s dict[, "residual": ``init_residual``'s]}; batch =
    tokens/labels(/media) tensors on the model's device. Returns
    step_fn(state, batch) -> (state, metrics), the state updated in place.

    With ``microbatch=M`` the batch's rows are split into M chunks in
    order, the gradients summed in f32 and scaled by 1/M, the loss the
    mean of the chunks', ``parts`` the last chunk's. With
    ``compress_grads`` the gradients pass through ``compress_with_feedback``
    and the residual is carried. The learning rate's scale is
    ``cosine_schedule`` of the step count *before* the update (0 at step
    0, as in JAX). metrics: "loss", the 0-dim parts, "grad_norm", "lr" (0-dim
    tensors; reading one waits for the step)."""

    def grads_of(model, batch):
        params = dict(model.named_parameters())
        loss, parts = T.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g  # JAX: zeros
                 for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def step(state, batch):
        model = state["params"]
        M = opts.microbatch
        if M > 1:
            B = batch["tokens"].shape[0]
            if B % M:
                raise ValueError(f"batch {B} not divisible by microbatch {M}")
            b = B // M
            loss_sum, grads = 0.0, {}
            for i in range(M):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss, parts, g = grads_of(model, mb)
                loss_sum = loss_sum + loss
                for n, x in g.items():  # the f32 sum, as JAX's scan carries it
                    if n in grads:
                        grads[n].add_(x.to(torch.float32))
                    else:
                        grads[n] = x.to(torch.float32)
                del g
            loss = loss_sum / f32(M, loss_sum.device)
            for x in grads.values():
                x.mul_(1.0 / M)
        else:
            loss, parts, grads = grads_of(model, batch)

        if opts.compress_grads:
            grads, state["residual"] = compress_with_feedback(
                grads, state["residual"], stacks=T.stacks(cfg))

        lr_scale = cosine_schedule(state["opt"]["step"])
        _, state["opt"], om = adamw_update(opts.opt, grads, state["opt"], model,
                                           lr_scale)
        metrics = {"loss": loss, **{k: v for k, v in parts.items()
                                    if v.ndim == 0}, **om}
        return state, metrics

    return step


def greedy(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab padding masked, then argmax (the first maximum, as
    ``jnp.argmax``): logits [B, V] -> next token [B, 1] int32."""
    logits = logits.clone()
    logits[..., cfg.vocab_size:] = float("-inf")
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None):
    """(model, batch{tokens[, media]}) -> (logits [B, V], cache sized
    ``cache_len``, the prompt length by default). ``media``: vision's
    patch embeddings, or audio's frames (encoded by the step)."""

    @torch.no_grad()
    def step(model, batch):
        return T.prefill(cfg, model, batch["tokens"], batch.get("media"),
                         cache_len=cache_len)

    return step


def make_serve_step(cfg: ArchConfig):
    """Greedy decode: (model, cache, batch{tokens, pos[, media|memory]}) ->
    (next_token [B, 1], cache), the cache updated in place. A config with
    a cross slot passes ``memory`` (``transformer.make_memory``'s output);
    vision may pass ``media`` in its place, as in JAX."""

    @torch.no_grad()
    def step(model, cache, batch):
        logits, cache = T.decode_step(
            cfg, model, cache, batch["tokens"], batch["pos"],
            media=batch.get("media"), memory=batch.get("memory"))
        return greedy(cfg, logits), cache

    return step
