"""MusicGen-medium [arXiv:2306.05284] — decoder-only transformer over
EnCodec audio tokens (vocab 2048).

Frontend stub (DESIGN.md §4): the EnCodec tokenizer is out of scope —
input_specs feeds token ids directly. Deviations: single codebook
stream (the real model interleaves 4 codebooks with a delay pattern)
and no text-conditioning cross-attention.
"""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    period=(LayerSpec(),),
    mlp_act="gelu",
    frontend="audio",
)
