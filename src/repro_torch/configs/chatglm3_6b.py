"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 -- RoPE 2d (half-dim rotary), GQA. [arXiv:2406.12793; hf]
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="2d",  # ChatGLM applies rotary to half the head dims
    attn_bias=True,  # qkv bias in the public checkpoint
    pattern=(LayerSpec("attn", "mlp"),),
)
