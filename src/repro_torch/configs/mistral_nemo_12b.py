"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA
(kv=8), head_dim=128, 128k context.

long_500k qualification (DESIGN.md §4): the real model is full
attention; we provide a sliding-window (SWA-4096) variant via
configs.base.with_sliding_window for the 500k-decode shape, and run all
other shapes full-attention.
"""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    period=(LayerSpec(),),
    rope_theta=1_000_000.0,
)
