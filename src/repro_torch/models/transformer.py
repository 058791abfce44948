"""Decoder stack: the period loop's forward and the LM loss.

  forward(cfg, params, tokens, prefix_emb)   → logits (train/prefill)
  lm_loss(cfg, params, tokens, targets, …)   → mean next-token NLL

The reference scans a period body over the ``n_periods`` stacked layer
parameters; here a Python loop takes period r's slice of each stacked
tensor, in the same order, with the same arithmetic. ``remat``
recomputes each period's activations in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
does. The decode cache and ``decode_step`` are not in the port yet
(ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig
from repro_torch.models.init import check_supported


def _apply_layer_train(p, cfg: ArchConfig, spec, x):
    h = blocks.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + blocks.attn_train(p, cfg, spec, h)
    if spec.ff != "none":
        h = blocks.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + blocks.mlp(p, cfg, h)
    return x


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
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    if prefix_emb is not None:
        x = torch.cat([prefix_emb @ params["proj"], x], dim=1)

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
    return x @ head


def lm_loss(
    cfg: ArchConfig, params: dict, tokens, targets, mask=None, prefix_emb=None,
    remat: bool = False,
) -> torch.Tensor:
    """Mean next-token cross entropy (float32 logits path)."""
    logits = forward(cfg, params, tokens, prefix_emb, remat=remat)
    if prefix_emb is not None:
        logits = logits[:, prefix_emb.shape[1]:, :]
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
