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

Built here: every layer of the registry — attention (full and
sliding-window, GQA/MQA, ``qkv_bias``), multi-head latent attention (MLA),
Mamba-1, and the dense and MoE feed-forwards — the embedding, ``lm_head``
and the ``proj`` prefix projection. ``router`` and ``A_log`` stay float32
whatever ``dtype`` is, as in the reference. The mesh partition specs of
the reference's ``param_pspecs`` raise ``NotImplementedError``
(``models/sharding.py``, ROADMAP.md Queue 1 item 13c).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.models.blocks import _mamba_dims
from repro_torch.models.config import ArchConfig, LayerSpec


def padded_experts(n_experts: int) -> int:
    """Experts allocated, padded to a multiple of 16 (the reference's
    production model axis) when there are at least 16 — reduced smoke
    configs stay unpadded. The router stays (d, n_experts), so a pad is
    never routed to."""
    return -(-n_experts // 16) * 16 if n_experts >= 16 else n_experts


def _norm(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(dtype)


def _init_layer(gen, cfg: ArchConfig, spec: LayerSpec, dtype) -> dict:
    """One layer's tensors, drawn from ``gen`` in the reference's key
    order: the mixer's matrices, then the feed-forward's."""
    d = cfg.d_model
    p: dict = {"ln1": torch.ones((d,), dtype=dtype)}
    if spec.mixer == "attn":
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        if spec.attn == "mla":
            m = cfg.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p |= {
                "wq": _norm(gen, (d, H * qd), d**-0.5, dtype),
                "w_dkv": _norm(gen, (d, m.kv_lora_rank), d**-0.5, dtype),
                "w_kr": _norm(gen, (d, m.qk_rope_head_dim), d**-0.5, dtype),
                "w_uk": _norm(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim), m.kv_lora_rank**-0.5, dtype),
                "w_uv": _norm(gen, (m.kv_lora_rank, H * m.v_head_dim), m.kv_lora_rank**-0.5, dtype),
                "wo": _norm(gen, (H * m.v_head_dim, d), (H * m.v_head_dim) ** -0.5, dtype),
            }
        else:
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
    else:  # mamba
        mb, d_in, dt_rank = _mamba_dims(cfg)
        p |= {
            "in_proj": _norm(gen, (d, 2 * d_in), d**-0.5, dtype),
            "conv_w": _norm(gen, (d_in, mb.d_conv), mb.d_conv**-0.5, dtype),
            "conv_b": torch.zeros((d_in,), dtype=dtype),
            "x_proj": _norm(gen, (d_in, dt_rank + 2 * mb.d_state), d_in**-0.5, dtype),
            "dt_proj": _norm(gen, (dt_rank, d_in), dt_rank**-0.5, dtype),
            "dt_bias": torch.full((d_in,), -4.6, dtype=dtype),  # softplus ≈ 0.01
            "A_log": torch.log(torch.arange(1, mb.d_state + 1, dtype=torch.float32)).repeat(d_in, 1),
            "D": torch.ones((d_in,), dtype=dtype),
            "out_proj": _norm(gen, (d_in, d), d_in**-0.5, dtype),
        }
    if spec.ff != "none":
        p["ln2"] = torch.ones((d,), dtype=dtype)
    if spec.ff == "dense":
        p |= {
            "w_gate": _norm(gen, (d, cfg.d_ff), d**-0.5, dtype),
            "w_up": _norm(gen, (d, cfg.d_ff), d**-0.5, dtype),
            "w_down": _norm(gen, (cfg.d_ff, d), cfg.d_ff**-0.5, dtype),
        }
    elif spec.ff == "moe":
        e = cfg.moe
        e_pad = padded_experts(e.n_experts)
        p |= {
            "router": _norm(gen, (d, e.n_experts), d**-0.5, torch.float32),
            "w_gate_e": _norm(gen, (e_pad, d, e.d_ff_expert), d**-0.5, dtype),
            "w_up_e": _norm(gen, (e_pad, d, e.d_ff_expert), d**-0.5, dtype),
            "w_down_e": _norm(gen, (e_pad, e.d_ff_expert, d), e.d_ff_expert**-0.5, dtype),
        }
        if e.n_shared:
            ff_sh = e.n_shared * e.d_ff_expert
            p |= {
                "w_gate_sh": _norm(gen, (d, ff_sh), d**-0.5, dtype),
                "w_up_sh": _norm(gen, (d, ff_sh), d**-0.5, dtype),
                "w_down_sh": _norm(gen, (ff_sh, d), ff_sh**-0.5, dtype),
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
    raise NotImplementedError("param_pspecs (models/sharding.py) is not in the port yet "
                              "(ROADMAP.md Queue 1 item 13c)")


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
