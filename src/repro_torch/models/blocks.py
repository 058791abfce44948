"""Layer blocks of the decoder zoo: RMS norm, RoPE, causal attention
(GQA/MQA, sliding window), multi-head latent attention (MLA), the gated
MLP, token-choice MoE and Mamba-1.

Each mixer has a full-sequence form (training / prefill) and a
single-token decode form threading an explicit cache or state (what
``serve_step`` runs); ``init_attn_cache``, ``init_mla_cache`` and
``init_mamba_state`` make them.

Plain PyTorch ops (einsum, softmax, a loop of matmuls) written as the
reference's ``repro.models.blocks`` writes them, so the two agree to
float32 rounding: the same einsum contractions, the mask fill
``finfo(float32).min`` on the flat paths and ``-1e30`` on the
query-chunked one, softmax in float32, half-split (not interleaved) RoPE,
the tanh-approximated GELU (``jax.nn.gelu``'s default), softplus as
``logaddexp(x, 0)`` (``jax.nn.softplus``; ``F.softplus`` returns x above
its threshold). Where the reference mixes a bfloat16 tensor with a
float32 leaf (``router``, ``A_log``, the SSM state) and ``jnp`` promotes,
the port casts to the promoted type at the same point. No fused attention
call: its masking and accumulation differ from the reference's. No TPU
kernel lies on this path (the reference writes it in ``jnp``/``lax``).

On a model mesh the parameters are DTensors and each ``shard`` call is the
reference's ``with_sharding_constraint`` at the same site
(``models/sharding.py``); on plain tensors it does nothing. ``moe`` takes
the expert-parallel path (``models/moe_ep.py``) when the active mesh's
"model" dim is larger than 1 under the "tp" profile, as the reference's
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch._device import resolve_device
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.sharding import get_abstract_mesh, like, local_region, mesh_sizes, shard


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * g


# ---------------------------------------------------------------- RoPE


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any shape) × head_dim/2."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / torch.pow(theta, exponent)  # a Python base: no host-to-device copy (a sync on a card)
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


def _sdpa(q, k, v, mask, scale, kv_seq_sharded: bool = False) -> torch.Tensor:
    """Grouped-query attention without repeating the KV heads (the decode
    path): q (B, S, H, D); k/v (B, L, KV, D) with H = KV·G.
    ``kv_seq_sharded``: the scores' L dim keeps the cache's "model"
    sharding."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    q5 = q.reshape(B, S, KV, H // KV, D)
    logits = torch.einsum("bskgd,blkd->bkgsl", q5, k) * scale
    seq = "cache_seq" if kv_seq_sharded else None
    if kv_seq_sharded or PIN_SCORE_BATCH:
        logits = shard(logits, "batch", None, None, None, seq)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    if kv_seq_sharded or PIN_SCORE_BATCH:
        probs = shard(probs, "batch", None, None, None, seq)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


def _repeat_kv_flat(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, H, D): each KV head repeated for its group,
    sharded over heads where divisible."""
    KV = k.shape[2]
    if KV != n_heads:
        k = torch.repeat_interleave(k, n_heads // KV, dim=2)
    return shard(k, "batch", None, "heads", None)


def _sdpa_flat(q, k, v, mask, scale) -> torch.Tensor:
    """Flat-head attention (train path): q/k/v (B, S, H, D); scores
    (B, H, S, L), masked entries set to the float32 minimum."""
    logits = torch.einsum("bshd,blhd->bhsl", q, k) * scale
    logits = shard(logits, "batch", "heads", None, None)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    probs = shard(probs, "batch", "heads", None, None)
    return torch.einsum("bhsl,blhd->bshd", probs, v)


# sequences longer than this use the query-chunked path (the reference's
# memory bound on the (S × S) scores)
CHUNKED_ATTN_THRESHOLD = 8192
ATTN_Q_CHUNK = 1024
# pin the batch dim of attention scores (the reference's ablation toggle)
PIN_SCORE_BATCH = True


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
        logits = shard(logits, "batch", "heads", None, None)
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
    cos, sin = (like(t, q) for t in rope_frequencies(D, cfg.rope_theta, pos))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    window = cfg.sliding_window if (spec.attn == "swa" and cfg.sliding_window) else 0
    kr = _repeat_kv_flat(k, H)
    vr = _repeat_kv_flat(v, H)
    # the scores' batch and head dims are both split: a region of this rank's
    # (batch, heads) block, laid out as the reference's annotations pin it
    heads = ("batch", None, "heads", None)
    if S > CHUNKED_ATTN_THRESHOLD and S % ATTN_Q_CHUNK == 0:
        out = local_region(lambda q, k, v: _sdpa_chunked(q, k, v, D**-0.5, window=window, q_chunk=ATTN_Q_CHUNK),
                           (q, heads), (kr, heads), (vr, heads))
    else:
        causal = pos[:, None] >= pos[None, :]
        if window:
            causal &= pos[:, None] - pos[None, :] < window
        out = local_region(lambda q, k, v: _sdpa_flat(q, k, v, causal[None, None], D**-0.5),
                           (q, heads), (kr, heads), (vr, heads))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].reshape(H, D, cfg.d_model))


def init_attn_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int, dtype, device=None):
    """Zero K/V of (batch, L, KV, D): L = max_len, or the window for a
    sliding-window layer (a ring)."""
    L = min(cfg.sliding_window, max_len) if spec.attn == "swa" and cfg.sliding_window else max_len
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, L, KV, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, KV, D), dtype=dtype, device=device),
    }


def attn_decode(p, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor, cache, pos):
    """One-token decode. x: (B, 1, d); pos: the current position, a 0-d
    integer tensor on x's device (never read on the host). The new K/V go
    to slot ``pos % L``: a ring for a sliding window, and past ``max_len``
    for full attention too, where every slot is then attended (the
    reference's semantics)."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    L = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].reshape(cfg.d_model, H, D))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].reshape(cfg.d_model, KV, D))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].reshape(cfg.d_model, KV, D))
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, D)
        k = k + p["bk"].reshape(KV, D)
        v = v + p["bv"].reshape(KV, D)
    cos, sin = rope_frequencies(D, cfg.rope_theta, pos.reshape(1))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = torch.remainder(pos, L).reshape(1).long()
    ck = shard(cache["k"].index_copy(1, slot, k), "batch", "cache_seq", None, None)
    cv = shard(cache["v"].index_copy(1, slot, v), "batch", "cache_seq", None, None)
    valid = (torch.arange(L, device=x.device) <= slot) | (pos >= L)
    out = _sdpa(q, ck, cv, valid[None, None, None, None, :], D**-0.5, kv_seq_sharded=True)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].reshape(H, D, cfg.d_model))
    return y, {"k": ck, "v": cv}


# ------------------------------------------------- MLA (DeepSeek-V2)


def _mla_qkv(p, cfg: ArchConfig, x, positions):
    m = cfg.mla
    H = cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].reshape(cfg.d_model, H, qd))
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    cos, sin = (like(t, q) for t in rope_frequencies(m.qk_rope_head_dim, cfg.rope_theta, positions))
    q_rope = apply_rope(q_rope, cos, sin)
    ckv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])  # (B, S, lora)
    k_rope = torch.einsum("bsd,dk->bsk", x, p["w_kr"])  # one rope key shared by the heads
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, ckv, k_rope, mask, kv_seq_sharded: bool = False):
    """Latent-space attention: the queries are absorbed into the KV-LoRA
    basis, so the cache stays (lora + rope) wide. The scale is applied
    inside the mask's ``where``, as the reference does.
    ``kv_seq_sharded``: the scores' L dim keeps the cache's "model"
    sharding (decode)."""
    m = cfg.mla
    H = cfg.n_heads
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)  # q̃ = q_nope · W_UKᵀ
    pin = ("batch", None, None, "cache_seq") if kv_seq_sharded else ("batch", None, None, None)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    def scores(q_lat, q_rope, ckv, k_rope):
        logits = torch.einsum("bshr,blr->bhsl", q_lat, ckv)
        logits = logits + torch.einsum("bshk,blk->bhsl", q_rope, k_rope)
        if kv_seq_sharded or PIN_SCORE_BATCH:
            logits = shard(logits, *pin)
        logits = torch.where(mask, logits * scale, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q_nope.dtype)
        if kv_seq_sharded or PIN_SCORE_BATCH:
            probs = shard(probs, *pin)
        return torch.einsum("bhsl,blr->bshr", probs, ckv)  # the context in the lora space

    # a region of this rank's batch block, its scores' heads replicated as
    # the reference's pin lays them out (its einsums split two batch dims)
    q_dims, kv_dims = ("batch", None, None, None), ("batch", None, None)
    ctx = local_region(scores, (q_lat, q_dims), (q_rope, q_dims), (ckv, kv_dims), (k_rope, kv_dims))
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhk->bshk", ctx, w_uv)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].reshape(H, m.v_head_dim, cfg.d_model))


def _mla_attend_chunked(p, cfg: ArchConfig, q_nope, q_rope, ckv, k_rope, q_chunk: int = ATTN_Q_CHUNK):
    """Query-chunked MLA: scores of (B, H, q_chunk, S) at a time."""
    S = q_nope.shape[1]
    kpos = torch.arange(S, device=q_nope.device)
    outs = []
    for ci in range(S // q_chunk):
        rows = slice(ci * q_chunk, (ci + 1) * q_chunk)
        qpos = ci * q_chunk + torch.arange(q_chunk, device=q_nope.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None]
        outs.append(_mla_attend(p, cfg, q_nope[:, rows], q_rope[:, rows], ckv, k_rope, mask))
    return torch.cat(outs, dim=1)


def mla_train(p, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, pos)
    if S > CHUNKED_ATTN_THRESHOLD and S % ATTN_Q_CHUNK == 0:
        return _mla_attend_chunked(p, cfg, q_nope, q_rope, ckv, k_rope, q_chunk=ATTN_Q_CHUNK)
    mask = (pos[:, None] >= pos[None, :])[None, None]
    return _mla_attend(p, cfg, q_nope, q_rope, ckv, k_rope, mask)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None):
    m = cfg.mla
    device = resolve_device(device)
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(p, cfg: ArchConfig, spec: LayerSpec, x, cache, pos):
    """One-token MLA decode against the latent cache. The write slot is
    ``min(pos, L - 1)``: the reference's ``dynamic_update_slice`` clamps a
    start past the end, so past ``max_len`` each token overwrites the last
    slot and attends to every slot."""
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv(p, cfg, x, pos.reshape(1))
    L = cache["ckv"].shape[1]
    slot = torch.clamp(pos, max=L - 1).reshape(1).long()
    ckv = shard(cache["ckv"].index_copy(1, slot, ckv_new), "batch", "cache_seq", None)
    kr = cache["kr"].index_copy(1, slot, kr_new)
    valid = torch.arange(L, device=x.device) <= pos
    y = _mla_attend(p, cfg, q_nope, q_rope, ckv, kr, valid[None, None, None, :], kv_seq_sharded=True)
    return y, {"ckv": ckv, "kr": kr}


# -------------------------------------------------------------- MLP/MoE


def _act(name: str, x):
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    h = _act(cfg.mlp_act, x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard(h, "batch", None, "ff")
    return h @ p["w_down"]


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands cast to their promoted type: ``jnp`` promotes a
    bfloat16 operand against a float32 one, ``torch.matmul``/``einsum``
    refuse mixed types."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def _grouped_mlp(cfg: ArchConfig, rows: torch.Tensor, sizes: list[int], w_gate, w_up, w_down) -> torch.Tensor:
    """The gated MLP of expert e on its ``sizes[e]`` consecutive rows of
    ``rows`` (sorted by expert), one matmul per non-empty group (the
    reference's ``ragged_dot``). Returns the sum(sizes) processed rows."""
    # one view an expert: the backward stacks their gradients once, where
    # indexing [ex] would materialize a full-size zero gradient per expert
    wg, wu, wd = w_gate.unbind(0), w_up.unbind(0), w_down.unbind(0)
    ys = []
    start = 0
    for ex, n in enumerate(sizes):
        if n:
            r = rows[start:start + n]
            ys.append((_act(cfg.mlp_act, r @ wg[ex]) * (r @ wu[ex])) @ wd[ex])
            start += n
    return torch.cat(ys) if ys else rows[:0]


_MOE_WEIGHTS = ("router", "w_gate_e", "w_up_e", "w_down_e", "w_gate_sh", "w_up_sh", "w_down_sh")


def moe(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE, the reference's local path: a float32
    softmax router, ``top_k`` renormalised (the sum clipped at 1e-9), the
    (token, k) pairs stably sorted by expert, one matmul per non-empty
    expert group (the reference's ``ragged_dot``), the inverse permutation,
    the weighted sum over k, then the shared experts. The group sizes are
    read on the host: one device sync per call.

    On a mesh whose "model" dim is larger than 1 (profile "tp") it is the
    expert-parallel ``moe_ep``. On any other mesh (DTensor ``x``) no DTensor
    rule routes tokens, so each rank runs the local path on its batch shard
    with the weights replicated — what GSPMD does with the reference's
    ``ragged_dot``, which has no partitioning rule.
    """
    mesh = get_abstract_mesh()
    if mesh is not None and cfg.sharding_profile == "tp" and mesh_sizes(mesh).get("model", 1) > 1:
        from repro_torch.models.moe_ep import moe_ep

        return moe_ep(cfg, p, x)
    if isinstance(x, DTensor):
        x = shard(x, "batch", None, None)
        pl = list(x.placements)
        # a weight's gradient is a partial sum over the dims that split the batch
        grad = [Partial() if isinstance(q, Shard) else Replicate() for q in pl]
        rep = [Replicate()] * len(pl)
        loc = {k: v.redistribute(x.device_mesh, rep).to_local(grad_placements=grad) if isinstance(v, DTensor) else v
               for k, v in p.items() if k in _MOE_WEIGHTS}
        y = _moe_local(loc, cfg, x.to_local(grad_placements=pl))
        return DTensor.from_local(y, x.device_mesh, pl, run_check=False)
    return _moe_local(p, cfg, x)


def _moe_local(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    e = cfg.moe
    B, S, d = x.shape
    t = x.reshape(B * S, d)
    logits = torch.matmul(*_promoted(t, p["router"]))  # (T, E); the router is float32
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i = torch.topk(probs, e.top_k, dim=-1)  # (T, k)
    top_p = (top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)).to(x.dtype)

    flat_expert = top_i.reshape(-1)  # (T·k,)
    order = torch.argsort(flat_expert, stable=True)
    inv = torch.argsort(order, stable=True)
    t_rep = t[:, None, :].expand(-1, e.top_k, -1).reshape(-1, d)[order]  # k copies a token, by expert
    # group sizes over the allocated (padded) experts; .tolist() is the one
    # host sync (bincount and an int repeat_interleave would add their own)
    sizes = torch.zeros(p["w_gate_e"].shape[0], dtype=torch.int64, device=x.device)
    sizes = sizes.scatter_add_(0, flat_expert, torch.ones_like(flat_expert)).tolist()
    y = _grouped_mlp(cfg, t_rep, sizes, p["w_gate_e"], p["w_up_e"], p["w_down_e"])
    y = y[inv].reshape(B * S, e.top_k, d)
    y = torch.einsum("tkd,tk->td", y, top_p.to(y.dtype))

    if e.n_shared:
        sh = _act(cfg.mlp_act, t @ p["w_gate_sh"]) * (t @ p["w_up_sh"])
        y = y + sh @ p["w_down_sh"]
    return y.reshape(B, S, d)


# ------------------------------------------------------------- Mamba-1


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mamba_dims(cfg: ArchConfig):
    mb = cfg.mamba
    d_in = mb.expand * cfg.d_model
    dt_rank = mb.dt_rank or -(-cfg.d_model // 16)
    return mb, d_in, dt_rank


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t·h_{t−1} + b_t along dim 1 (from h = 0)
    in log₂(T) doubling steps (Hillis–Steele): (A_t, B_t) with
    h_t = A_t·h_{−1} + B_t."""
    T = a.shape[1]
    off = 1
    while off < T:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _ssm_scan_chunked(dt, xi, Bc, Cc, A, h0, chunk: int):
    """Selective scan with the (B, chunk, d_in, N) discretized tensors made
    one chunk at a time: sequential over the S/chunk chunks, a doubling
    scan inside each. The recurrence runs in float32.
    Returns (y: (B, S, d_in) float32, h_last: (B, d_in, N) float32)."""
    S = dt.shape[1]
    h = h0
    ys = []
    for c in range(S // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        dt_c, xi_c, b_c, c_c = dt[:, rows], xi[:, rows], Bc[:, rows], Cc[:, rows]
        a_bar = torch.exp(dt_c[..., None].to(torch.float32) * A)  # (B, chunk, d_in, N)
        bx = ((dt_c * xi_c)[..., None] * b_c[:, :, None, :]).to(torch.float32)
        a_acc, b_acc = _doubling_scan(a_bar, bx)
        hs = a_acc * h[:, None] + b_acc  # the states inside the chunk
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, c_c.to(torch.float32)))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_train(p, cfg: ArchConfig, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Full-sequence Mamba-1 (selective SSM) forward."""
    mb, d_in, dt_rank = _mamba_dims(cfg)
    S = x.shape[1]
    xz = x @ p["in_proj"]  # (B, S, 2·d_in)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = shard(xi, "batch", None, "d_inner")

    def conv(xi, conv_w, conv_b):  # causal depthwise convolution over time
        pad = F.pad(xi, (0, 0, mb.d_conv - 1, 0))
        return F.silu(sum(pad[:, i : i + S, :] * conv_w[:, i] for i in range(mb.d_conv)) + conv_b)

    # regions of this rank's (batch, channel) block: the padded convolution
    # and the scan are channel-local
    chan = ("batch", None, "d_inner")
    xi = local_region(conv, (xi, chan), (p["conv_w"], ("d_inner", None)), (p["conv_b"], ("d_inner",)))

    proj = xi @ p["x_proj"]  # (B, S, dt_rank + 2N)
    dt, Bc, Cc = torch.split(proj, [dt_rank, mb.d_state, mb.d_state], dim=-1)
    dt = _softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (B, S, d_in)
    A = -torch.exp(p["A_log"].to(torch.float32))  # (d_in, N)

    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # a single chunk, as the reference falls back

    def scan(dt, xi, Bc, Cc, A):
        h0 = torch.zeros((dt.shape[0], dt.shape[2], mb.d_state), dtype=torch.float32, device=dt.device)
        return _ssm_scan_chunked(dt, xi, Bc, Cc, A, h0, chunk)[0]

    seq = ("batch", None, None)
    y = local_region(scan, (dt, chan), (xi, chan), (Bc, seq), (Cc, seq), (A, ("d_inner", None)))
    y = y + (xi * p["D"]).to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return y @ p["out_proj"]


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device=None):
    """The last d_conv − 1 inputs of the convolution (``dtype``) and the
    SSM state (float32)."""
    mb, d_in, _ = _mamba_dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, mb.d_conv - 1, d_in), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_in, mb.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, state, pos):
    """Single-token recurrence: O(1) state whatever the position."""
    del pos
    mb, d_in, dt_rank = _mamba_dims(cfg)
    xz = x[:, 0, :] @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)  # (B, d_in)
    window = torch.cat([state["conv"], xi[:, None, :]], dim=1)  # (B, d_conv, d_in)
    xi = torch.einsum("bcd,dc->bd", window, p["conv_w"]) + p["conv_b"]
    xi = F.silu(xi)
    proj = xi @ p["x_proj"]
    dt, Bc, Cc = torch.split(proj, [dt_rank, mb.d_state, mb.d_state], dim=-1)
    dt = _softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    a_bar = torch.exp(dt[..., None] * A)  # (B, d_in, N), float32
    h = a_bar * state["ssm"] + (dt * xi)[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", *_promoted(h, Cc)) + xi * p["D"]
    y = y * F.silu(z)
    y = (y.to(x.dtype) @ p["out_proj"])[:, None, :]
    return y, {"conv": window[:, 1:, :], "ssm": h}
