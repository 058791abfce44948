"""Decoder stack: the period loop's forward, the LM loss, and the
KV/SSM-cache decode.

  forward(cfg, params, tokens, prefix_emb)   → logits (train/prefill)
  lm_loss(cfg, params, tokens, targets, …)   → mean next-token NLL
  init_cache(cfg, batch, max_len, dtype)     → the decode cache
  decode_step(cfg, params, cache, tokens)    → (logits, cache)

The reference scans a period body over the ``n_periods`` stacked layer
parameters (and caches); here a Python loop takes period r's slice of
each stacked tensor, in the same order, with the same arithmetic.
``remat`` recomputes each period's activations in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
does. The cache is the reference's tree, ``{"layers": tuple, "pos": 0-d
int32}``, so a reference cache carried through ``params_from_numpy``
decodes here; ``pos`` stays on the device.

On a model mesh (DTensor parameters, ``models/sharding.py``) the same code
runs with the reference's sharding annotations at its sites; token ids,
targets and masks enter as replicated DTensors. ``set_profile`` takes
``cfg.sharding_profile`` at each entry point, as the reference's does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import like, set_profile, shard


def _mix_train(p, cfg: ArchConfig, spec, h):
    if spec.mixer == "mamba":
        return blocks.mamba_train(p, cfg, h)
    if spec.attn == "mla":
        return blocks.mla_train(p, cfg, spec, h)
    return blocks.attn_train(p, cfg, spec, h)


def _feed_forward(p, cfg: ArchConfig, spec, x):
    if spec.ff == "none":
        return x
    h = blocks.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + (blocks.moe(p, cfg, h) if spec.ff == "moe" else blocks.mlp(p, cfg, h))


def _apply_layer_train(p, cfg: ArchConfig, spec, x):
    x = x + _mix_train(p, cfg, spec, blocks.rmsnorm(p["ln1"], x, cfg.norm_eps))
    return _feed_forward(p, cfg, spec, x)


def forward(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S_text) integer ids
    prefix_emb: torch.Tensor | None = None,  # (B, S_prefix, d) stub frontend
    remat: bool = False,
    last_only: bool = False,
) -> torch.Tensor:
    """Full-sequence causal LM forward → logits (B, S_total, V).

    ``remat``: activation-checkpoint at period granularity (training).
    ``last_only``: head applied to the final position only (prefill —
    no (B, S, V) logits)."""
    set_profile(cfg.sharding_profile)
    x = params["embed"][like(tokens.long(), params["embed"])]
    if prefix_emb is not None:
        x = torch.cat([like(prefix_emb, params["proj"]) @ params["proj"], x], dim=1)
    x = shard(x, "batch", None, None)

    def period_fn(x, r: int):
        for spec, stacked in zip(cfg.period, params["layers"]):
            x = _apply_layer_train({k: v[r] for k, v in stacked.items()}, cfg, spec, x)
        return x

    for r in range(cfg.n_periods):
        x = checkpoint(period_fn, x, r, use_reentrant=False) if remat else period_fn(x, r)
    x = blocks.rmsnorm(params["norm_f"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if last_only:
        return x[:, -1:, :] @ head
    return shard(x @ head, "batch", None, "vocab")


def lm_loss(
    cfg: ArchConfig, params: dict, tokens, targets, mask=None, prefix_emb=None,
    remat: bool = False,
) -> torch.Tensor:
    """Mean next-token cross entropy (float32 logits path)."""
    logits = forward(cfg, params, tokens, prefix_emb, remat=remat)
    if prefix_emb is not None:
        logits = logits[:, prefix_emb.shape[1]:, :]
    logits = shard(logits.to(torch.float32), "batch", None, "vocab")
    logz = torch.logsumexp(logits, dim=-1)
    # DTensor cannot gather along a vocab-sharded dim (its masked partial
    # sum fails): the gold logit is read with the vocab dim replicated
    gold = torch.gather(shard(logits, "batch", None, None), -1, like(targets.long(), logits)[..., None])[..., 0]
    nll = shard(logz - gold, "batch", None)
    if mask is None:
        return torch.mean(nll)
    mask = like(mask, nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


# ------------------------------------------------------------- decode


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Per-period-position caches, each stacked over the periods, and the
    position (a 0-d int32 tensor) on ``device`` (None: the CUDA device or
    an error). Attention and MLA caches are ``dtype``; a Mamba layer's SSM
    state is float32."""
    device = resolve_device(device)
    per_pos = []
    for spec in cfg.period:
        if spec.mixer == "mamba":
            one = blocks.init_mamba_state(cfg, batch, dtype, device=device)
        elif spec.attn == "mla":
            one = blocks.init_mla_cache(cfg, batch, max_len, dtype, device=device)
        else:
            one = blocks.init_attn_cache(cfg, spec, batch, max_len, dtype, device=device)
        per_pos.append({k: v.expand((cfg.n_periods,) + v.shape).clone() for k, v in one.items()})
    return {"layers": tuple(per_pos), "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _mix_decode(p, cfg: ArchConfig, spec, h, c, pos):
    if spec.mixer == "mamba":
        return blocks.mamba_decode(p, cfg, h, c, pos)
    if spec.attn == "mla":
        return blocks.mla_decode(p, cfg, spec, h, c, pos)
    return blocks.attn_decode(p, cfg, spec, h, c, pos)


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token per sequence: tokens (B, 1) → logits (B, 1, V) and the
    next cache (new tensors; ``cache`` is not changed)."""
    set_profile(cfg.sharding_profile)
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    new = [[] for _ in cfg.period]  # per period position, the periods' caches
    for r in range(cfg.n_periods):
        for i, (spec, stacked_p, stacked_c) in enumerate(zip(cfg.period, params["layers"], cache["layers"])):
            p = {k: v[r] for k, v in stacked_p.items()}
            h, c = _mix_decode(p, cfg, spec, blocks.rmsnorm(p["ln1"], x, cfg.norm_eps),
                               {k: v[r] for k, v in stacked_c.items()}, pos)
            x = _feed_forward(p, cfg, spec, x + h)
            new[i].append(c)
    layers = tuple({k: torch.stack([c[k] for c in cs]) for k in cs[0]} for cs in new)
    x = blocks.rmsnorm(params["norm_f"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, {"layers": layers, "pos": pos + 1}
