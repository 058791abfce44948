"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1 (attention-free),
64 layers, d_state=16, d_inner=2·d_model. No FFN (the Mamba block is
the whole layer)."""

from repro_torch.models.config import ArchConfig, LayerSpec, MambaConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    period=(LayerSpec(mixer="mamba", ff="none"),),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)
