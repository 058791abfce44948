"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base] —
40 experts, top-8, expert FFN width 512, tied embeddings.

(The assignment lists both "MoE 40e" and "32 experts"; we follow the
structured field: 40 experts — noted in DESIGN.md.)
"""

from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    period=(LayerSpec(ff="moe"),),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)
