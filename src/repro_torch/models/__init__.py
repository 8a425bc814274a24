"""Language-model substrate: counterpart of ``repro/models``: causal
self-attention (bf16 or int8 KV cache, chunked queries), cross-attention
to a media memory and whisper's bidirectional encoder, MLA, Mamba and
xLSTM mixers, with dense (``mlp``) or mixture-of-experts (``moe``) FFNs.
``moe`` dispatches tokens through the batched-ranks CUDA kernel."""

from repro_torch.models.transformer import (Transformer, decode_step, encode,
                                            forward, init_cache, init_params,
                                            make_memory, prefill)

__all__ = ["Transformer", "init_params", "encode", "make_memory", "forward",
           "init_cache", "prefill", "decode_step"]
