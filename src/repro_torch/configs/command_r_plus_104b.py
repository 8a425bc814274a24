"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 -- GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

Cohere uses LayerNorm (not RMSNorm) and no biases anywhere.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    norm="layernorm",
    rope_theta=75000000.0,
    pattern=(LayerSpec("attn", "mlp"),),
)
