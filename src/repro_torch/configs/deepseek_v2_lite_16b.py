"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 (per-expert)
vocab=102400 -- MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]

MLA dims per the paper: d_nope=128, d_rope=64, d_v=128 per head; the KV
cache holds only (kv_lora + d_rope) = 576 values per token (see
models/mla.py). The assignment note says "160 routed" but also "64e"; the
public V2-Lite has 64 routed + 2 shared, which we implement.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoESpec(num_experts=64, top_k=6, d_ff=1408, num_shared=2),
    mla=MLASpec(kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    pattern=(LayerSpec("mla", "moe"),),
)
