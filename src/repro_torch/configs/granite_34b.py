"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576
vocab=49152 -- llama-arch, code. [arXiv:2405.04324; hf]

kv=1 (MQA) is the interesting TP case: the single KV head cannot shard on
the model axis, so the sharding rules fall back to sequence-sharded KV for
decode (launch/sharding.py).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    pattern=(LayerSpec("attn", "mlp"),),
)
