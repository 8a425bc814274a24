"""xlstm-350m [ssm]: 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 --
sLSTM + mLSTM blocks (alternating; blocks carry their own projections, no
separate FFN). [arXiv:2405.04517; unverified]

Attention-free and O(1)-state in sequence length => runs long_500k.
The paper's adaptive-attention variant is inapplicable (DESIGN.md Sec. 6).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope="none",
    pattern=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
    sub_quadratic=True,
    tie_embeddings=True,
)
