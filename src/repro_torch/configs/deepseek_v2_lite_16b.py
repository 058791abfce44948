"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MoE with multi-head latent
attention (MLA, kv_lora=512), 2 shared + 64 routed experts, top-6.

Deviations noted in DESIGN.md: (a) the real model's first layer uses a
dense FFN; here every layer is MoE (uniform period keeps the scan
square); (b) the assignment lists both "64e" (structured field) and
"160 routed" (bracket note — that is the full V2, not Lite); we use 64,
which reproduces the 16B total-parameter count.
"""

from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    period=(LayerSpec(mixer="attn", attn="mla", ff="moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mlp_act="silu",
)
