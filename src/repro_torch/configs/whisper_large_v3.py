"""whisper-large-v3 [audio]: 32L d_model=1280 20H (kv=20 == MHA) d_ff=5120
vocab=51866 -- enc-dec, conv frontend STUB. [arXiv:2212.04356; unverified]

Per the assignment the modality frontend is a stub: ``input_specs``
provides precomputed frame embeddings [B, T, d_model]; the encoder is the
32-layer bidirectional stack, the decoder 32 layers of
self-attn + cross-attn + MLP. Sinusoidal positions, LayerNorm, GELU,
biases on, vocab padded 51866 -> 51968 for TP (DESIGN.md Sec. 5).

20 heads don't divide the 16-way model axis: attention shards fall back to
data-parallel-only for heads, TP comes from d_ff/vocab (launch/sharding.py).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    rope="none",
    attn_bias=True,
    encoder_layers=32,
    frontend="audio",
    pattern=(LayerSpec("attn_cross", "mlp"),),
)
