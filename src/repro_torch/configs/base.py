"""Architecture config schema + registry.

Counterpart of ``repro/configs/base.py``: the same frozen ``ArchConfig``
(same fields, defaults and ``reduced()`` derivation) with torch dtypes in
place of JAX's. The configs are data, so each ``configs/<id>.py`` is a copy
of the JAX package's file.

``param_count`` and ``active_param_count`` count the port's own model
built on the ``meta`` device (nothing is allocated); they equal JAX's for
every config.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    num_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024  # dispatch token-group size


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One slot of the repeating layer pattern."""

    mixer: str  # attn | attn_cross | cross | mla | mamba | mlstm | slstm
    ffn: str  # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "swiglu"
    rope: str = "1d"  # 1d | 2d | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_bias: bool = False
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    mamba: Optional[MambaSpec] = None
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)
    encoder_layers: int = 0  # > 0 => encoder-decoder (whisper)
    num_media_tokens: int = 0  # vlm cross-attention memory length
    frontend: str = "none"  # none | audio | vision
    tie_embeddings: bool = False
    lstm_expand: int = 2
    vocab_pad_multiple: int = 256
    sub_quadratic: bool = False
    # ---- runtime knobs (overridable via dataclasses.replace) --------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    q_chunk: Optional[int] = None  # chunked attention for long prefill
    kv_cache_dtype: str = "bfloat16"  # "int8": quantised serving KV cache
    act_sharding: Optional[Tuple[str, ...]] = None
    ep_axis: Optional[str] = None

    def __post_init__(self):
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    # ---- derived -----------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def param_count(self) -> int:
        """Exact parameter count: the elements of the port's model, built
        on the ``meta`` device."""
        from repro_torch.models.transformer import count_params, init_params
        return count_params(init_params(self, device="meta"))

    def active_param_count(self) -> int:
        """Parameters active per token: routed-expert parameters (an
        ``experts`` in their name) are scaled by top_k / num_experts (MoE
        MODEL_FLOPS uses 6 * N_active * D)."""
        from repro_torch.models.transformer import init_params
        frac = (self.moe.top_k / self.moe.num_experts) if self.moe else 1.0
        total = 0.0
        for name, p in init_params(self, device="meta").named_parameters():
            total += p.numel() * (frac if "experts" in name.split(".") else 1.0)
        return int(total)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale_heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, scale_heads)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=len(self.pattern) * 2,
            d_model=64,
            num_heads=scale_heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=512,
            encoder_layers=2 if self.encoder_layers else 0,
            num_media_tokens=16 if self.num_media_tokens else 0,
            moe=dataclasses.replace(self.moe, num_experts=8, top_k=2, d_ff=32)
            if self.moe else None,
            mla=MLASpec(kv_lora=32, d_nope=16, d_rope=8, d_v=16)
            if self.mla else None,
            vocab_pad_multiple=64,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            q_chunk=None,
        )


ARCH_IDS = (
    "llama_3_2_vision_90b",
    "chatglm3_6b",
    "command_r_plus_104b",
    "qwen3_4b",
    "granite_34b",
    "jamba_v0_1_52b",
    "moonshot_v1_16b_a3b",
    "deepseek_v2_lite_16b",
    "xlstm_350m",
    "whisper_large_v3",
)


def registry() -> dict:
    out = {}
    for mod_name in ARCH_IDS:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg = mod.CONFIG
        out[cfg.name] = cfg
    return out


def get_config(name: str) -> ArchConfig:
    reg = registry()
    key = name.replace("-", "_")
    for cfg_name, cfg in reg.items():
        if cfg_name == name or cfg_name.replace("-", "_") == key:
            return cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
