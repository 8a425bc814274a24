"""Language-model substrate: counterpart of ``repro/models`` for decoder
models: causal self-attention (bf16 or int8 KV cache, chunked queries),
MLA, Mamba and xLSTM mixers, with dense (``mlp``) or mixture-of-experts
(``moe``) FFNs. ``moe`` dispatches tokens through the batched-ranks CUDA
kernel."""

from repro_torch.models.transformer import (Transformer, decode_step, forward,
                                            init_cache, init_params, prefill)

__all__ = ["Transformer", "init_params", "forward", "init_cache", "prefill",
           "decode_step"]
