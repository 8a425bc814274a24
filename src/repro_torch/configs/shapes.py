"""The input-shape suite and ``meta``-tensor stand-ins for its operands.

Counterpart of ``repro/configs/shapes.py``. Four shapes per architecture:
``decode_*``/``long_*`` run the serve step (one token against a seq_len
KV cache); ``long_500k`` only applies to sub-quadratic archs (jamba,
xlstm), and ``applicable`` returns the reason a cell is skipped. A spec is
a tensor on the ``meta`` device (JAX's ``ShapeDtypeStruct``): a shape and
a dtype, nothing allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["ShapeCase", "SHAPES", "applicable", "batch_specs", "cache_specs",
           "param_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, case: ShapeCase) -> Optional[str]:
    """None if the cell runs; otherwise the (recorded) skip reason."""
    if case.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k-context requires "
                "sub-quadratic attention (DESIGN.md Sec. 6)")
    return None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, case: ShapeCase, *, dtype=torch.bfloat16):
    """Specs of the *data* operands of the step function.

    train   -> {"tokens", "labels"} (+ "media"/frames for vlm/audio)
    prefill -> {"tokens"} (+ media)
    decode  -> {"tokens" [B, 1], "pos" scalar} (+ media/memory); the cache
               specs come from ``cache_specs``.
    """
    B, S = case.global_batch, case.seq_len
    out = {}
    if case.kind in ("train", "prefill"):
        out["tokens"] = _spec((B, S), torch.int32)
        if case.kind == "train":
            out["labels"] = _spec((B, S), torch.int32)
        if cfg.frontend == "vision":
            out["media"] = _spec((B, cfg.num_media_tokens, cfg.d_model), dtype)
        elif cfg.frontend == "audio":
            out["media"] = _spec((B, S, cfg.d_model), dtype)
    else:  # decode
        out["tokens"] = _spec((B, 1), torch.int32)
        out["pos"] = _spec((), torch.int32)
        if cfg.frontend == "vision":
            out["media"] = _spec((B, cfg.num_media_tokens, cfg.d_model), dtype)
        elif cfg.frontend == "audio":
            # cross-attention memory == encoder output over seq_len frames
            out["memory"] = _spec((B, S, cfg.d_model), dtype)
    return out


def cache_specs(cfg: ArchConfig, case: ShapeCase):
    """The decode cache of ``case`` on the ``meta`` device."""
    from repro_torch.models.transformer import init_cache
    return init_cache(cfg, case.global_batch, case.seq_len, device="meta")


def param_specs(cfg: ArchConfig):
    """The parameters in JAX's pytree layout, a nested dict whose leaves
    are ``meta`` tensors, the group leaves stacked [num_groups, ...] and
    the encoder's [encoder_layers, ...]."""
    from repro_torch.models.transformer import init_params, stacks
    depth = stacks(cfg)
    out: dict = {}
    for name, p in init_params(cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        stack = next((st for st in depth if name.startswith(st)), None)
        if stack:
            index, rest = name[len(stack):].split(".", 1)
            if index != "0":
                continue  # the stack's first layer stands for all of them
            name, shape = stack + rest, (depth[stack], *shape)
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = _spec(shape, p.dtype)
    return out
