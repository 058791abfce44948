"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B family] — dense GQA (kv=2) with QKV
bias."""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    period=(LayerSpec(),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
