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
whatever ``dtype`` is, as in the reference.

Specs: ``param_pspecs`` returns the reference's tree of partition specs,
entry for entry (model-parallel dims on "model", the paper's p_c role; the
FSDP dim on "data" where divisible; replicated on any dim that does not
divide, so every arch places on every mesh), as tuples of per-dim axis
tuples. ``distribute_params`` places a full tree on a ``DeviceMesh`` as
DTensors with those placements; ``gather_params`` (and
``params_to_numpy``) gives the full tensors back, so checkpoints keep the
reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.models.blocks import _mamba_dims
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.sharding import mesh_sizes, placements


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


# ---------------------------------------------------------------- specs


def _div(size: int, axes: tuple[str, ...], sizes: dict[str, int]) -> bool:
    total = 1
    for a in axes:
        total *= sizes.get(a, 1)
    return size % total == 0


def _wspec(shape, want: tuple[tuple[str, ...] | None, ...], sizes: dict[str, int]) -> tuple:
    """The spec of a (possibly period-stacked) weight, dropping any axis
    group that does not divide its dim."""
    entries = []
    for size, axes in zip(shape, want):
        if not axes:
            entries.append(None)
            continue
        axes = tuple(a for a in axes if a in sizes)
        if axes and _div(size, axes, sizes):
            entries.append(axes[0] if len(axes) == 1 else axes)
        else:
            entries.append(None)
    return tuple(entries)


_MODEL = ("model",)
_FSDP = ("data",)

# per-param logical layout: name -> tuple of axis groups per dim (None =
# replicated); the leading n_periods dim is the caller's
_LAYOUTS = {
    "wq": (_FSDP, _MODEL), "wk": (_FSDP, _MODEL), "wv": (_FSDP, _MODEL),
    "wo": (_MODEL, _FSDP),
    "bq": (_MODEL,), "bk": (_MODEL,), "bv": (_MODEL,),
    "w_dkv": (_FSDP, None), "w_kr": (_FSDP, None),
    "w_uk": (None, _MODEL), "w_uv": (None, _MODEL),
    "w_gate": (_FSDP, _MODEL), "w_up": (_FSDP, _MODEL), "w_down": (_MODEL, _FSDP),
    "router": (_FSDP, None),
    # experts: E over the model axis (expert parallelism) and dim-1 FSDP
    # over data (all-gathered a layer in models/moe_ep.py); replicated
    # where E does not divide
    "w_gate_e": (_MODEL, _FSDP, None), "w_up_e": (_MODEL, _FSDP, None),
    "w_down_e": (_MODEL, _FSDP, None),
    "w_gate_sh": (_FSDP, _MODEL), "w_up_sh": (_FSDP, _MODEL), "w_down_sh": (_MODEL, _FSDP),
    "in_proj": (_FSDP, _MODEL), "out_proj": (_MODEL, _FSDP),
    "conv_w": (_MODEL, None), "conv_b": (_MODEL,),
    "x_proj": (_MODEL, None), "dt_proj": (None, _MODEL), "dt_bias": (_MODEL,),
    "A_log": (_MODEL, None), "D": (_MODEL,),
    "ln1": (None,), "ln2": (None,),
}


_DP_FSDP = ("data", "model")  # "dp" profile: the model axis folds into FSDP


def param_pspecs(cfg: ArchConfig, params_shape, mesh) -> dict:
    """The reference's spec tree for ``params_shape`` (a tree of anything
    with ``.shape``) on ``mesh`` (a ``DeviceMesh``, or a {dim: size}
    mapping): per leaf a tuple with one entry a dim — None, an axis name,
    or a tuple of axis names (the reference's ``PartitionSpec`` entries).
    Honors cfg.sharding_profile: "dp" shards every weight's dim 0 over
    ("data", "model") and nothing else (pure FSDP)."""
    sizes = mesh_sizes(mesh)
    dp = cfg.sharding_profile == "dp"

    def leaf_spec(path: tuple, leaf) -> tuple:
        shape = tuple(leaf.shape)
        name = path[-1]
        if dp:
            if name in ("norm_f", "ln1", "ln2") or len(shape) < 2:
                return (None,) * len(shape)
            if name == "embed":
                # vocab-parallel even under dp
                return _wspec(shape, (_MODEL, _FSDP), sizes)
            if name == "lm_head":
                return _wspec(shape, (_FSDP, _MODEL), sizes)
            if name == "proj":
                return _wspec(shape, (_DP_FSDP, None), sizes)
            # layer params carry the leading n_periods axis: FSDP dim 1
            return _wspec(shape, (None, _DP_FSDP) + (None,) * (len(shape) - 2), sizes)
        if name == "embed":
            # vocab-parallel (Megatron-style): d_model replicated so the
            # logits matmul contracts locally
            return _wspec(shape, (_MODEL, None), sizes)
        if name == "lm_head":
            return _wspec(shape, (None, _MODEL), sizes)
        if name == "norm_f":
            return (None,)
        if name == "proj":
            return _wspec(shape, (_FSDP, _MODEL), sizes)
        layout = _LAYOUTS.get(name)
        if layout is None:
            return (None,) * len(shape)
        if cfg.expert_weight_stationary and name in ("w_gate_e", "w_up_e", "w_down_e"):
            # serving: experts resident a rank — E over "model" only
            return _wspec(shape, (None, _MODEL, None, None), sizes)
        # layer params carry a leading n_periods axis
        return _wspec(shape, (None,) + tuple(layout), sizes)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        return leaf_spec(path, tree)

    return walk(params_shape)


def distribute_params(params, specs, mesh):
    """A full tree (every rank holds the same tensors, on the host or the
    device) → DTensors on ``mesh`` (a ``DeviceMesh``) with the placements of
    ``specs`` (``param_pspecs``' tree, or any tree of specs of its
    structure). Each rank keeps its own shard of its own copy: no data
    moves between ranks."""
    return tree_map(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None),
                    params, specs)


def gather_params(tree):
    """A tree of DTensors (or plain tensors) → the full tensors on every
    rank (collective where a leaf is sharded)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


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
    widen to float32, which numpy can hold). DTensor leaves are gathered
    to their full values (collective: every rank of their mesh calls it)."""

    def leaf(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()

    return tree_map(leaf, tree)
