"""Architecture configuration for the assigned-architecture zoo — a
plain copy of the reference's (``repro.models.config``), so a config
built in either package describes the same model.

One flexible decoder covers all 10 assigned architectures. A model is a
stack of ``n_periods`` repetitions of a *period* — a short list of
``LayerSpec``s (length 1 for homogeneous models; 8 for Jamba's 1-attn +
7-mamba interleave). Parameters are stacked over periods, as in the
reference, so a parameter tree crosses between the packages leaf for
leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["full", "swa", "mla", "none"]
FFKind = Literal["dense", "moe", "none"]
MixerKind = Literal["attn", "mamba"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer within a period."""

    mixer: MixerKind = "attn"
    attn: AttnKind = "full"  # only read when mixer == "attn"
    ff: FFKind = "dense"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    n_shared: int = 0  # shared (always-on) experts, DeepSeek-style
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention dims."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    mlp_act: Literal["silu", "gelu"] = "silu"  # SwiGLU vs GeGLU gate
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # >0 enables SWA for attn == "swa"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # multimodal stub: number of prefix embedding positions fed directly
    # (ViT patches / audio frames); 0 = text-only
    frontend: Literal["none", "vision", "audio"] = "none"
    max_seq_len: int = 32_768
    # mesh-role profile (the paper's regime-aware mesh selection applied
    # to NN training — EXPERIMENTS.md §Perf-1): "tp" uses the "model"
    # axis for tensor/expert parallelism; "dp" folds the "model" axis
    # into batch/FSDP (small dense models whose heads/ffn cannot使用 a
    # 16-way TP axis profitably).
    sharding_profile: Literal["tp", "dp"] = "tp"
    # serving (decode) keeps expert weights resident instead of
    # FSDP-regathering them per layer per token (§Perf-2/4)
    expert_weight_stationary: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.period):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}"
            )
        for spec in self.period:
            if spec.ff == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: MoE layer without moe config")
            if spec.mixer == "mamba" and self.mamba is None:
                raise ValueError(f"{self.name}: mamba layer without mamba config")
            if spec.attn == "mla" and self.mla is None:
                raise ValueError(f"{self.name}: MLA layer without mla config")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def has_attention(self) -> bool:
        return any(s.mixer == "attn" for s in self.period)

    @property
    def subquadratic(self) -> bool:
        """True if the arch can decode with O(1)-ish per-token state at
        500k context: SSM/hybrid or sliding-window attention."""
        return all(
            s.mixer == "mamba" or (s.mixer == "attn" and s.attn == "swa")
            for s in self.period
        ) or (
            any(s.mixer == "mamba" for s in self.period)  # hybrid: bounded attn share
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.period:
            layer = 0
            if spec.mixer == "attn":
                if spec.attn == "mla":
                    m = self.mla
                    q_dim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    layer += d * q_dim
                    layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    layer += self.n_heads * m.v_head_dim * d
                else:
                    layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    layer += self.n_heads * hd * d
            else:
                mb = self.mamba
                d_in = mb.expand * d
                dt_rank = mb.dt_rank or -(-d // 16)
                layer += d * 2 * d_in + d_in * mb.d_conv
                layer += d_in * (dt_rank + 2 * mb.d_state) + dt_rank * d_in
                layer += d_in * mb.d_state + d_in + d_in * d
            if spec.ff == "dense":
                layer += 3 * d * self.d_ff
            elif spec.ff == "moe":
                e = self.moe
                layer += d * e.n_experts  # router
                layer += e.n_experts * 3 * d * e.d_ff_expert
                layer += e.n_shared * 3 * d * e.d_ff_expert
            total += layer * self.n_periods
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e = self.moe
        moe_layers = sum(1 for s in self.period if s.ff == "moe") * self.n_periods
        unused = (e.n_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return full - moe_layers * unused
