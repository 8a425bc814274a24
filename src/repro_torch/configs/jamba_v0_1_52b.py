"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 -- Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Pattern of 8 (x4 groups): attention at slot 4, Mamba elsewhere; MoE
replaces the MLP on every other layer (odd slots), per the public config.
Sub-quadratic (Mamba-dominated) => runs the long_500k cell.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MambaSpec, MoESpec

_P = []
for j in range(8):
    mixer = "attn" if j == 4 else "mamba"
    ffn = "moe" if j % 2 == 1 else "mlp"
    _P.append(LayerSpec(mixer, ffn))

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoESpec(num_experts=16, top_k=2, d_ff=14336),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    pattern=tuple(_P),
    sub_quadratic=True,
)
