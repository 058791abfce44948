"""Parameter initialization for the decoder zoo, and the carry between
the packages' parameter trees.

Params are a tree of tensors in the reference's layout:
  {"embed": (V,d), "proj": (d,d)?, "norm_f": (d,), "lm_head": (d,V)?,
   "layers": tuple(per period position) of dicts whose tensors all carry
   a leading n_periods axis}

``init_params`` draws from an explicit ``torch.Generator`` (the reference
draws from ``jax.random``, which the port cannot reproduce), with the
reference's shapes and scales: N(0, 1/fan_in) matrices, unit norms, zero
biases. The parameters of the two packages are held together through
``params_from_numpy`` (the reference's tree as numpy arrays → this
package's tensors) and ``params_to_numpy`` (the inverse, what a pytree
checkpoint stores).

Built here: attention layers (full and sliding-window, GQA/MQA,
``qkv_bias``) with a dense FF, the embedding, ``lm_head`` and the
``proj`` prefix projection. MLA, MoE and Mamba layers raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 13), and so do the mesh
partition specs of the reference's ``param_pspecs``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.models.config import ArchConfig, LayerSpec

_WAITS = "is not in the port yet (ROADMAP.md Queue 1 item 13)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg``'s
    period is an attention layer (full or swa) with a dense FF."""
    for spec in cfg.period:
        if spec.mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: the {spec.mixer} mixer {_WAITS}")
        if spec.attn == "mla":
            raise NotImplementedError(f"{cfg.name}: multi-head latent attention (MLA) {_WAITS}")
        if spec.ff == "moe":
            raise NotImplementedError(f"{cfg.name}: the MoE feed-forward {_WAITS}")


def _norm(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(dtype)


def _init_layer(gen, cfg: ArchConfig, spec: LayerSpec, dtype) -> dict:
    d = cfg.d_model
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p: dict = {"ln1": torch.ones((d,), dtype=dtype)}
    p |= {
        "wq": _norm(gen, (d, H * D), d**-0.5, dtype),
        "wk": _norm(gen, (d, KV * D), d**-0.5, dtype),
        "wv": _norm(gen, (d, KV * D), d**-0.5, dtype),
        "wo": _norm(gen, (H * D, d), (H * D) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        p |= {
            "bq": torch.zeros((H * D,), dtype=dtype),
            "bk": torch.zeros((KV * D,), dtype=dtype),
            "bv": torch.zeros((KV * D,), dtype=dtype),
        }
    if spec.ff != "none":
        p["ln2"] = torch.ones((d,), dtype=dtype)
    if spec.ff == "dense":
        p |= {
            "w_gate": _norm(gen, (d, cfg.d_ff), d**-0.5, dtype),
            "w_up": _norm(gen, (d, cfg.d_ff), d**-0.5, dtype),
            "w_down": _norm(gen, (cfg.d_ff, d), cfg.d_ff**-0.5, dtype),
        }
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None, dtype=torch.bfloat16,
                device=None, seed: int = 0) -> dict:
    """Random parameters of ``cfg`` on ``device`` (None: the CUDA device
    or an error). Drawn on the host from ``generator`` (default: a fresh
    CPU generator seeded with ``seed``) in a fixed order — period
    position, then period, then the layer's tensors; then the embedding,
    ``lm_head`` and ``proj`` — so one seed gives the same weights on every
    device."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    layers = []
    for spec in cfg.period:
        per_period = [_init_layer(gen, cfg, spec, dtype) for _ in range(cfg.n_periods)]
        layers.append({k: torch.stack([p[k] for p in per_period]) for k in per_period[0]})
    params = {
        "embed": _norm(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, dtype),
        "norm_f": torch.ones((cfg.d_model,), dtype=dtype),
        "layers": tuple(layers),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _norm(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dtype)
    if cfg.frontend != "none":
        params["proj"] = _norm(gen, (cfg.d_model, cfg.d_model), cfg.d_model**-0.5, dtype)
    return tree_map(lambda t: t.to(device), params)


def param_pspecs(*args, **kwargs):
    """The reference's mesh partition specs: not in the port yet."""
    raise NotImplementedError(f"param_pspecs (models/sharding.py) {_WAITS}")


# ---- the carry between the packages ----


def params_from_numpy(tree, device=None, dtype=None):
    """The reference's parameter (or optimizer-state) tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) → this package's tree of
    tensors on ``device`` (None: the CUDA device or an error), leaf for
    leaf, the same nesting of dicts and tuples. ``dtype`` casts floating
    leaves (default: each array's own)."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: numpy holds no torch bf16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """This package's tree of tensors → numpy arrays on the host, the
    reference's layout (the inverse of ``params_from_numpy``; bf16 leaves
    widen to float32, which numpy can hold)."""

    def leaf(t):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()

    return tree_map(leaf, tree)
