"""Gemma-2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA (kv=1),
256k vocab, tied embeddings."""

from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    period=(LayerSpec(),),
    mlp_act="gelu",
    tie_embeddings=True,
)
