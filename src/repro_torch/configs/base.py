"""Config helpers: reduced smoke variants + SWA overlay."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig, MambaConfig, MoEConfig


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant of the same family: ≤2 layers (one period for
    heterogeneous periods, truncated to 2 specs), d_model ≤ 512,
    ≤4 experts — runs a forward/train step on CPU in seconds."""
    period = cfg.period if len(cfg.period) <= 2 else cfg.period[:2]
    # keep at least one of each mixer present in the original period
    mixers = {s.mixer for s in cfg.period}
    if len(mixers) > 1 and {s.mixer for s in period} != mixers:
        attn = next(s for s in cfg.period if s.mixer == "attn")
        mamba = next(s for s in cfg.period if s.mixer == "mamba")
        period = (attn, mamba)
    n_layers = len(period)
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    head_dim = 64 if cfg.head_dim else 0
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            n_shared=min(cfg.moe.n_shared, 1),
        )
    mla = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32) if cfg.mla else None
    mamba = MambaConfig(d_state=cfg.mamba.d_state, d_conv=cfg.mamba.d_conv, expand=2) if cfg.mamba else None
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        period=period,
        moe=moe,
        mla=mla,
        mamba=mamba,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        max_seq_len=256,
    )


def with_sliding_window(cfg: ArchConfig, window: int) -> ArchConfig:
    """Overlay: convert all full-attention layers to sliding-window —
    the sub-quadratic variant used for long_500k on dense archs
    (DESIGN.md §4: mistral-nemo)."""
    period = tuple(
        dataclasses.replace(s, attn="swa") if s.mixer == "attn" and s.attn == "full" else s
        for s in cfg.period
    )
    return dataclasses.replace(
        cfg, name=cfg.name + f"-swa{window}", period=period, sliding_window=window
    )
