"""Granite-34B-code [arXiv:2405.04324] — 88-layer dense MQA (kv=1)."""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    period=(LayerSpec(),),
)
