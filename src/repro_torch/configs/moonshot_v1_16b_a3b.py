"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16 == MHA)
d_ff=1408 (per-expert), vocab=163840, MoE 64e top-6 -- kimi/moonlight.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Assignment is the source of truth: 64 routed experts, top-6, no shared
expert (the public Moonlight adds 2 shared; recorded in DESIGN.md Sec. 6).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoESpec(num_experts=64, top_k=6, d_ff=1408),
    pattern=(LayerSpec("attn", "moe"),),
)
