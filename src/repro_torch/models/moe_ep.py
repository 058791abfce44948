"""Expert-parallel MoE over the active mesh: experts sharded over
"model", tokens routed to their experts' owners with ``all_to_all``.

The reference writes this as a nested ``shard_map`` (``lax.ragged_dot``
has no GSPMD partitioning rule). Here the manual region is this rank's
local shards: the DTensor inputs go in through ``to_local`` and the
output comes back through ``DTensor.from_local``, with explicit
collectives over the "model" (and "data") process groups in between:

  * experts are sharded over "model" (E/m a rank — the paper's p_c
    exact-sharding role);
  * tokens are block-split over "model" inside the region (padded when
    not divisible, e.g. decode's few tokens);
  * one ``all_to_all`` routes token copies to their experts' owners, a
    second routes results back; each rank runs a local loop of matmuls
    over its resident experts' non-empty groups (one host read of the
    group sizes, as ``blocks.moe``);
  * an ``all_gather`` over "model" restores the activation layout.

Capacity: each (src, dst) pair carries cap = ⌊T_pad·k·⌊4·cf⌋ / (4·m)⌋
slots, at least 1 — the reference's code rounds down, though its comment
says ceil; overflow copies are dropped (capacity-factor routing, cf = 2)
and the surviving router weights keep their normalization. The sorts are
stable (``jnp.argsort`` is), so the same copies drop as in the reference.

Fallback when the padded E does not divide the model axis: experts
replicated inside the region, tokens still split over "model".

Expert weights are FSDP-stored (dim 1 over "data") and all-gathered over
"data" a layer inside the region; the gather's backward sums the
gradient over "data" and keeps this rank's block (a reduce-scatter).

Gradients leave the region with the placements that make DTensor sum
them right: a tensor every rank along a dim used on its own tokens gets a
``Partial`` gradient there, a sharded one its shard's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.blocks import _act, _grouped_mlp
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import auto_mesh, mesh_sizes, placements

# the capacity factor moe_ep uses when its caller (blocks.moe) passes none
CAPACITY_FACTOR = 2.0

# token copies this process routed through moe_ep, and how many of them
# overflowed their capacity and were dropped (summed over calls)
copies = {"routed": 0, "dropped": 0}


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, length=n)`` without a host read of the output size."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))


class _AllToAll(torch.autograd.Function):
    """Equal-split ``all_to_all`` over dim 0 (m blocks); its backward is
    the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if not x.requires_grad:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    return _AllToAll.apply(x, group)


class _Gather(torch.autograd.Function):
    """Tiled ``all_gather`` along ``dim``. Backward: this rank's block of
    the gradient — summed over the group first (a reduce-scatter) when
    each rank's gradient of the gathered tensor is its own part of the sum
    (``partial``), taken as it is when every rank holds the same one."""

    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        m = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((m * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        m, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        full = g.movedim(ctx.dim, 0).contiguous()
        n = full.shape[0] // m
        if ctx.partial:
            mine = full.new_empty((n,) + full.shape[1:])
            dist.reduce_scatter_tensor(mine, full, group=ctx.group)
        else:
            mine = full[r * n:(r + 1) * n]
        return mine.movedim(0, ctx.dim), None, None, None


def _gather(x: torch.Tensor, group, dim: int = 0, partial: bool = False) -> torch.Tensor:
    return _Gather.apply(x, group, dim, partial)


def _route(cfg: ArchConfig, t, router):
    e = cfg.moe
    logits = t.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, e.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p.to(t.dtype), top_i


def _my_tokens(t_all, m: int, r: int):
    """Contiguous block split of T_loc tokens over m ranks, padded so
    every rank holds T_pad = ceil(T_loc/m); returns (t, valid, T_pad)."""
    T_loc = t_all.shape[0]
    T_pad = -(-T_loc // m)
    idx = r * T_pad + torch.arange(T_pad, device=t_all.device)
    valid = idx < T_loc
    t = t_all[torch.clamp(idx, max=T_loc - 1)]
    return torch.where(valid[:, None], t, 0), valid, T_pad


def _dispatch_slots(dst: torch.Tensor, n_dst: int, cap: int) -> torch.Tensor:
    """Slot in the (n_dst · cap) send buffer per pair, -1 on overflow:
    within each destination, pairs keep their order (a stable sort) and
    the first ``cap`` get slots. ``dst`` may contain the sentinel n_dst-1
    for invalid pairs; the caller discards the sentinel bucket's slots."""
    n = dst.shape[0]
    order = torch.argsort(dst, stable=True)
    sorted_dst = dst[order]
    counts = _counts(dst, n_dst)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos_in_group = torch.arange(n, device=dst.device) - starts[sorted_dst]
    slot_sorted = torch.where(pos_in_group < cap, sorted_dst * cap + pos_in_group, -1)
    return torch.zeros(n, dtype=torch.int32, device=dst.device).scatter(0, order, slot_sorted.to(torch.int32))


def _pairs(t, k: int):
    """Each token's k copies, in (token, k) order (``jnp.repeat(t, k, 0)``)."""
    return t[:, None].expand(t.shape[0], k, *t.shape[1:]).reshape(t.shape[0] * k, *t.shape[1:])


def _moe_ep_body(cfg: ArchConfig, t_all, router, wg, wu, wd, group, cf: float):
    """The region, expert-parallel path. t_all: (T_loc, d), the same on
    every rank of ``group`` (the "model" group); wg/wu/wd: this rank's
    (E/m, d, ffe) expert slices."""
    e = cfg.moe
    m, r = dist.get_world_size(group), dist.get_rank(group)
    d = t_all.shape[-1]
    k = e.top_k
    e_per_rank = wg.shape[0]  # padded-E/m: pads are never routed to

    t, tok_valid, T_pad = _my_tokens(t_all, m, r)
    top_p, top_i = _route(cfg, t, router)  # (T_pad, k)

    pairs_e = top_i.reshape(-1)
    pair_valid = _pairs(tok_valid, k)
    dst = torch.where(pair_valid, pairs_e // e_per_rank, m)  # sentinel bucket m
    # the reference's -(-T_pad·k·⌊4cf⌋) // (4m): the unary minus binds first,
    # so this is the floor
    cap = max((T_pad * k * int(cf * 4)) // (4 * m), 1)

    slot = _dispatch_slots(dst, m + 1, cap)
    slot = torch.where((slot >= 0) & (slot < m * cap), slot, -1)
    ok = slot >= 0
    safe = torch.where(ok, slot, 0).long()

    # at most one real row a slot: the zeros of dropped pairs add exactly
    send = t.new_zeros((m * cap, d)).index_add(0, safe, torch.where(ok[:, None], _pairs(t, k), 0))
    send_eid = torch.full((m * cap,), e_per_rank, dtype=torch.int64, device=t.device).scatter_reduce(
        0, safe, torch.where(ok, pairs_e % e_per_rank, e_per_rank), reduce="amin")

    recv_flat = _all_to_all(send, group)  # (m·cap, d): block j came from rank j
    eid_flat = _all_to_all(send_eid, group)

    order = torch.argsort(eid_flat, stable=True)  # pads (eid = e_per_rank) sort last
    t_sorted = recv_flat[order]
    # one host read: the group sizes, and this rank's routed / dropped copies
    dropped = (pair_valid & ~ok).sum()
    read = torch.cat([_counts(eid_flat, e_per_rank + 1)[:e_per_rank], pair_valid.sum()[None], dropped[None]]).tolist()
    sizes = read[:e_per_rank]
    copies["routed"] += read[-2]
    copies["dropped"] += read[-1]
    y_sorted = _grouped_mlp(cfg, t_sorted, sizes, wg, wu, wd)
    y_sorted = torch.cat([y_sorted, y_sorted.new_zeros((m * cap - y_sorted.shape[0], d))])
    y_flat = y_sorted[torch.argsort(order)]  # back to slot order

    y_slots = _all_to_all(y_flat, group)
    y_pairs = torch.where(ok[:, None], y_slots[safe], 0)
    y_tok = torch.einsum("tkd,tk->td", y_pairs.reshape(T_pad, k, d), top_p.to(y_pairs.dtype))

    out = _gather(y_tok, group)  # (m·T_pad, d)
    return out[: t_all.shape[0]]


def _moe_repl_body(cfg: ArchConfig, t_all, router, wg, wu, wd, group):
    """Fallback: experts replicated, tokens split over ``group``."""
    e = cfg.moe
    m, r = dist.get_world_size(group), dist.get_rank(group)
    d = t_all.shape[-1]
    k = e.top_k
    t, tok_valid, T_pad = _my_tokens(t_all, m, r)
    top_p, top_i = _route(cfg, t, router)
    top_p = top_p * tok_valid[:, None]
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    t_rep = _pairs(t, k)[order]
    y = _grouped_mlp(cfg, t_rep, _counts(flat_e, wg.shape[0]).tolist(), wg, wu, wd)
    y = y[inv].reshape(T_pad, k, d)
    y_tok = torch.einsum("tkd,tk->td", y, top_p.to(y.dtype))
    out = _gather(y_tok, group)
    return out[: t_all.shape[0]]


def _into_region(t, mesh, spec: tuple, grad: list):
    """This rank's block of ``t`` (a DTensor, or a plain tensor every rank
    holds whole) laid out as ``spec`` on ``mesh``; the gradient of the
    block leaves the region with the placements ``grad``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, placements(spec, mesh)).to_local(grad_placements=grad)


def moe_ep(cfg: ArchConfig, p: dict, x, cf: float | None = None):
    """Expert-parallel MoE over the active mesh (its "model" dim larger
    than 1). x: (B, S, d), a DTensor on the mesh's non-manual dims.
    ``cf``: the capacity factor (None: ``CAPACITY_FACTOR``)."""
    from repro_torch.models.init import padded_experts

    cf = CAPACITY_FACTOR if cf is None else cf
    e = cfg.moe
    B, S, d = x.shape
    mesh = auto_mesh()
    sizes = mesh_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    m = sizes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    btotal = 1
    for a in batch_axes:
        btotal *= sizes[a]
    if B % btotal:
        batch_axes = ()
    ep = padded_experts(e.n_experts) % m == 0

    # FSDP for the expert weights: stored with dim 1 sharded over "data",
    # all-gathered over "data" a layer inside the region
    dsize = sizes.get("data", 1)
    fsdp = (ep and not cfg.expert_weight_stationary and "data" in batch_axes
            and d % dsize == 0 and e.d_ff_expert % dsize == 0)

    def grad_of(spec):
        """A region input's gradient placements: its shard where it is
        sharded (complete: the region's collectives sum what crosses), a
        partial sum along the dims whose ranks used it on their own
        tokens, replicated elsewhere."""
        out = placements(spec, mesh)
        for i, a in enumerate(names):
            if isinstance(out[i], Replicate) and (a in batch_axes or a == "model"):
                out[i] = Partial()
        return out

    bspec = ((batch_axes,) if batch_axes else (None,)) + (None, None)
    x_loc = _into_region(x, mesh, bspec, grad_of(bspec))
    router = _into_region(p["router"].to(x.dtype), mesh, (None, None), grad_of((None, None)))
    wspec = (("model", "data") if fsdp else ("model",)) if ep else ()
    wspec = wspec + (None,) * (3 - len(wspec))
    wg, wu, wd = (_into_region(p[k], mesh, wspec, grad_of(wspec)) for k in ("w_gate_e", "w_up_e", "w_down_e"))

    t_all = x_loc.reshape(-1, d)
    model_group = mesh.get_group("model")
    if fsdp:
        data_group = mesh.get_group("data")
        wg, wu, wd = (_gather(w, data_group, dim=1, partial=True) for w in (wg, wu, wd))
    if ep:
        out = _moe_ep_body(cfg, t_all, router, wg, wu, wd, model_group, cf)
    else:
        out = _moe_repl_body(cfg, t_all, router, wg, wu, wd, model_group)
    y = DTensor.from_local(out.reshape(x_loc.shape), mesh, placements(bspec, mesh), run_check=False)

    if e.n_shared:
        sh = _act(cfg.mlp_act, x @ p["w_gate_sh"]) * (x @ p["w_up_sh"])
        y = y + sh @ p["w_down_sh"]
    return y
