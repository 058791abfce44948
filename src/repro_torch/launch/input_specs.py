"""Stand-in inputs and their layouts for every (arch × shape): the
reference's ``repro.launch.input_specs``.

The four input shapes:

  train_4k      seq 4,096   global_batch 256   → train_step
  prefill_32k   seq 32,768  global_batch 32    → prefill_step
  decode_32k    seq 32,768  global_batch 128   → serve_step (1 token,
                                                  a KV cache of seq_len)
  long_500k     seq 524,288 global_batch 1     → serve_step; only for
                 sub-quadratic archs (SSM / hybrid / SWA overlay)

Nothing here allocates. The reference's ``ShapeDtypeStruct`` is a tensor on
the ``meta`` device (``token_specs``, ``params_shape``, ``cache_shape``; a
caller under ``FakeTensorMode`` may pass its own ``device``). Its
``PartitionSpec`` is the entry tuple ``param_pspecs`` returns (per dim None,
an axis name, or a tuple of them), and its ``NamedSharding`` is that tuple
laid out by ``distribute_params(tree, specs, mesh)`` (``models/init.py``),
which places a cache as it places parameters. A mesh is a ``DeviceMesh``
or a {dim name: size} mapping (a production mesh's shape needs no
processes).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config, with_sliding_window
from repro_torch.models.config import ArchConfig
from repro_torch.models.init import init_params, padded_experts, param_pspecs
from repro_torch.models.sharding import mesh_sizes
from repro_torch.models.transformer import init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# prefix positions supplied by the stub frontend
VISION_PREFIX_TRAIN = 576  # one 24×24 tile
VISION_PREFIX_PREFILL = 2880  # anyres: 5 tiles × 576


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k":
        if cfg.name.startswith("mistral-nemo"):
            return True, "runs with SWA-4096 overlay"
        if cfg.subquadratic:
            return True, ""
        return False, "pure full-attention arch: 500k decode cache/attn is not sub-quadratic"
    return True, ""


# Small dense models cannot use a 16-way model axis (gemma: 8 heads), so the
# "model" axis folds into batch/FSDP ("dp" profile) whenever the step's batch
# can fill it (train) or its compute is negligible (decode). Prefill's small
# batch cannot fill the mesh: TP stays.
DP_PROFILE_ARCHS = {"gemma-2b", "qwen2.5-3b", "musicgen-medium"}


def select_profile(arch: str, shape: ShapeSpec) -> str:
    if arch in DP_PROFILE_ARCHS and shape.kind in ("train", "decode"):
        return "dp"
    return "tp"


def _stationary_experts_ok(cfg: ArchConfig) -> bool:
    """Weight-stationary serving only when the resident expert bytes a rank
    (bf16, a 16-way model axis) stay under 4 GB (jamba's 43 GB a rank would
    not)."""
    if cfg.moe is None:
        return False
    e = cfg.moe
    per_rank = max(padded_experts(e.n_experts) // 16, 1)
    moe_layers = sum(1 for sp in cfg.period if sp.ff == "moe") * cfg.n_periods
    resident = per_rank * 3 * cfg.d_model * e.d_ff_expert * 2 * moe_layers
    return resident < 4e9


def resolve_config(arch: str, shape: ShapeSpec) -> ArchConfig:
    cfg = get_config(arch)
    if shape.name == "long_500k" and cfg.name.startswith("mistral-nemo"):
        cfg = with_sliding_window(cfg, 4096)
    return dataclasses.replace(
        cfg,
        max_seq_len=max(cfg.max_seq_len, shape.seq_len),
        sharding_profile=select_profile(arch, shape),
        expert_weight_stationary=shape.kind == "decode" and _stationary_experts_ok(cfg),
    )


def batch_axes(mesh, profile: str = "tp") -> tuple[str, ...]:
    names = ("pod", "data", "model") if profile == "dp" else ("pod", "data")
    present = mesh_sizes(mesh)
    return tuple(a for a in names if a in present)


def _bspec(mesh, batch: int, *rest, profile: str = "tp") -> tuple:
    """Batch split over the profile's batch axes, dropping trailing axes
    until the batch divides."""
    axes = batch_axes(mesh, profile)
    sizes = mesh_sizes(mesh)
    while axes:
        total = 1
        for a in axes:
            total *= sizes[a]
        if batch % total == 0:
            break
        axes = axes[:-1]
    first = axes or None
    if first and len(first) == 1:
        first = first[0]
    return (first, *rest)


def token_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, device="meta"):
    """(stand-in tensors on ``device``, specs) for the data inputs of the
    step: int32 token ids (and targets), the bfloat16 prefix embedding of a
    vision frontend."""
    B = shape.global_batch
    prof = cfg.sharding_profile
    structs: dict = {}
    specs: dict = {}

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        s_text = shape.seq_len
        if cfg.frontend == "vision":
            prefix = VISION_PREFIX_TRAIN if shape.kind == "train" else VISION_PREFIX_PREFILL
            s_text = shape.seq_len - prefix
            structs["prefix_emb"] = empty((B, prefix, cfg.d_model), torch.bfloat16)
            specs["prefix_emb"] = _bspec(mesh, B, None, None, profile=prof)
        structs["tokens"] = empty((B, s_text), torch.int32)
        specs["tokens"] = _bspec(mesh, B, profile=prof)
        if shape.kind == "train":
            structs["targets"] = empty((B, s_text), torch.int32)
            specs["targets"] = _bspec(mesh, B, profile=prof)
    else:  # decode
        structs["tokens"] = empty((B, 1), torch.int32)
        specs["tokens"] = _bspec(mesh, B, profile=prof)
    return structs, specs


def params_shape(cfg: ArchConfig, dtype=torch.bfloat16, device="meta"):
    """The parameter tree of ``cfg`` as tensors on ``device`` (default
    ``meta``: shapes and dtypes only; ``router`` and ``A_log`` float32)."""
    with torch.device(device):
        return init_params(cfg, dtype=dtype, device=device)


def params_shardings(cfg: ArchConfig, mesh, pshape=None) -> dict:
    """The parameters' spec tree on ``mesh`` (``param_pspecs``);
    ``distribute_params(params, specs, mesh)`` lays a tree out by it."""
    pshape = pshape or params_shape(cfg)
    return param_pspecs(cfg, pshape, mesh)


def cache_shape(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16, device="meta") -> dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype, device=device)


def cache_pspec_for_leaf(path_names: tuple[str, ...], leaf, mesh, batch: int) -> tuple:
    """Decode-cache layout: batch over (pod, data); the long cache dim (KV
    seq) over "model" — sequence-parallel cache reads (kv heads rarely
    divide 16, the seq dim always does here). Mamba states split d_inner
    over "model"."""
    sizes = mesh_sizes(mesh)
    name = path_names[-1]
    if name == "pos":
        return ()
    # leading dim is n_periods (stacked), then the block-cache dims
    shape = tuple(leaf.shape)
    spec: list = [None] * len(shape)
    baxes = batch_axes(mesh)
    btotal = 1
    for a in baxes:
        btotal *= sizes[a]
    if batch % btotal == 0 and baxes:
        spec[1] = baxes[0] if len(baxes) == 1 else baxes
    model = sizes.get("model", 1)
    if name in ("k", "v", "ckv", "kr"):
        if shape[2] % model == 0:  # cache seq dim
            spec[2] = "model"
    elif name == "ssm":
        if shape[2] % model == 0:  # d_inner
            spec[2] = "model"
    elif name == "conv":
        if shape[3] % model == 0:  # d_inner (B, c, d_in) + period dim
            spec[3] = "model"
    return tuple(spec)


def cache_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh, cshape=None) -> dict:
    """The cache's spec tree on ``mesh``, leaf for leaf of ``cshape``
    (default: ``cache_shape``)."""
    cshape = cshape or cache_shape(cfg, shape)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        return cache_pspec_for_leaf(path, tree, mesh, shape.global_batch)

    return walk(cshape)
