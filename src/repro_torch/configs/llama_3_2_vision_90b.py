"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 -- cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Cross-attention layers are interleaved every 5th layer (20 of 100); the
vision tower is a STUB per the assignment -- ``input_specs`` provides
precomputed patch embeddings [B, num_media_tokens, d_model].
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    pattern=(LayerSpec("attn", "mlp"),) * 4 + (LayerSpec("cross", "mlp"),),
    num_media_tokens=4096,
    frontend="vision",
)
