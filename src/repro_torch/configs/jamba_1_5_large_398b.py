"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention at
a 7:1 ratio, MoE (16 experts, top-2) on every other layer.

Period of 8: position 0 is the attention layer, 1-7 Mamba; odd
positions carry MoE FFNs, even positions dense FFNs.
"""

from repro_torch.models.config import ArchConfig, LayerSpec, MambaConfig, MoEConfig

_PERIOD = tuple(
    LayerSpec(
        mixer="attn" if i == 0 else "mamba",
        attn="full",
        ff="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    period=_PERIOD,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24_576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)
