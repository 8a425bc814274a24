"""Step builders: the units the server runs.

Counterpart of ``repro/launch/steps.py`` for serving:
``make_prefill_step`` (prompt pass returning the last logits and the
cache) and ``make_serve_step`` (one greedy decode token against the cache).
JAX returns functions for ``jax.jit``; PyTorch runs them eagerly. Training
(``make_train_step``) waits for ROADMAP queue 1 slice 14.7.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

__all__ = ["make_prefill_step", "make_serve_step", "greedy"]


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
