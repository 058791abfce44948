"""Layer blocks of the decoder zoo's dense-attention family: RMS norm,
RoPE, causal attention (GQA/MQA, sliding window), the gated MLP.

Plain PyTorch ops (einsum, softmax) written as the reference's
``repro.models.blocks`` writes them, so the two agree to float32 rounding:
the same einsum contractions, the mask fill ``finfo(float32).min`` on the
flat path and ``-1e30`` on the query-chunked one, softmax in float32,
half-split (not interleaved) RoPE, the tanh-approximated GELU
(``jax.nn.gelu``'s default). No fused attention call: its masking and
accumulation differ from ``_sdpa_flat``'s. No kernel of this slice's path
lies here.

Not in the port yet (ROADMAP.md Queue 1 item 13): the single-token decode
forms and their caches, the grouped no-repeat ``_sdpa`` they use, MLA,
MoE and Mamba.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig, LayerSpec


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g


# ---------------------------------------------------------------- RoPE


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any shape) × head_dim/2."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exponent)
    ang = positions[..., None].to(torch.float32) * inv  # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., n_heads, head_dim); cos/sin broadcast over heads. The two
    halves of the head dimension rotate together (not interleaved pairs)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ----------------------------------------------------------- attention


def _repeat_kv_flat(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, H, D): each KV head repeated for its group."""
    KV = k.shape[2]
    if KV != n_heads:
        k = torch.repeat_interleave(k, n_heads // KV, dim=2)
    return k


def _sdpa_flat(q, k, v, mask, scale) -> torch.Tensor:
    """Flat-head attention (train path): q/k/v (B, S, H, D); scores
    (B, H, S, L), masked entries set to the float32 minimum."""
    logits = torch.einsum("bshd,blhd->bhsl", q, k) * scale
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhsl,blhd->bshd", probs, v)


# sequences longer than this use the query-chunked path (the reference's
# memory bound on the (S × S) scores)
CHUNKED_ATTN_THRESHOLD = 8192
ATTN_Q_CHUNK = 1024


def _sdpa_chunked(q, k, v, scale, window: int = 0, q_chunk: int = ATTN_Q_CHUNK):
    """Causal flat-head attention with the softmax taken over query
    chunks — scores of (B, H, q_chunk, S) at a time instead of (…, S, S).
    Expects k/v already head-repeated (train path)."""
    B, S, H, D = q.shape
    n_chunks = S // q_chunk
    kpos = torch.arange(S, device=q.device)
    outs = []
    for ci in range(n_chunks):
        qc = q[:, ci * q_chunk : (ci + 1) * q_chunk]
        qpos = ci * q_chunk + torch.arange(q_chunk, device=q.device)
        logits = torch.einsum("bshd,blhd->bhsl", qc, k).to(torch.float32) * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask[None, None], logits, -1e30)
        m = torch.amax(logits, dim=-1, keepdim=True)
        p_ = torch.exp(logits - m)
        l_ = torch.sum(p_, dim=-1)
        o = torch.einsum("bhsl,blhd->bshd", p_.to(q.dtype), v)
        outs.append(o / l_.transpose(1, 2)[..., None].to(o.dtype))
    return torch.cat(outs, dim=1)


def attn_train(p, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].reshape(cfg.d_model, H, D))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].reshape(cfg.d_model, KV, D))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].reshape(cfg.d_model, KV, D))
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, D)
        k = k + p["bk"].reshape(KV, D)
        v = v + p["bv"].reshape(KV, D)
    pos = torch.arange(S, device=x.device)
    cos, sin = rope_frequencies(D, cfg.rope_theta, pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    window = cfg.sliding_window if (spec.attn == "swa" and cfg.sliding_window) else 0
    kr = _repeat_kv_flat(k, H)
    vr = _repeat_kv_flat(v, H)
    if S > CHUNKED_ATTN_THRESHOLD and S % ATTN_Q_CHUNK == 0:
        out = _sdpa_chunked(q, kr, vr, D**-0.5, window=window, q_chunk=ATTN_Q_CHUNK)
    else:
        causal = pos[:, None] >= pos[None, :]
        if window:
            causal &= pos[:, None] - pos[None, :] < window
        out = _sdpa_flat(q, kr, vr, causal[None, None], D**-0.5)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].reshape(H, D, cfg.d_model))


# ------------------------------------------------------------------ MLP


def _act(name: str, x):
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    h = _act(cfg.mlp_act, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
