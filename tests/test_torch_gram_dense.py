"""The Gram kernel's dense-row route on the CPU: its plain version
(``ell_gram_dense_plain``) against the reference's ``ell_gram_and_v``
(its Pallas kernel in interpret mode) and against the port's plain panel
walk, in both modes; the route rule on every registered dataset's shape;
the route's launch plan; the round graphs' route counts; and the tuner on
a dense-routed profile. The CUDA kernel itself (``csrc/ell_gram_dense.cu``)
is held against this plain version on the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ell_gram as jgram
from repro_torch.core import round_graph
from repro_torch.core.teams import stack_row_teams
from repro_torch.kernels import ell_gram as tgram
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tune as ttune
from repro_torch.sparse.synthetic import DATASET_STATS, SM_STATS, make_dataset

# (G, v): the reference's own kernel tolerance (tests/test_kernels.py), float32
# sums in another order; bf16 against the reference at its bf16 tolerance:
# where a row repeats an id the reference rounds each entry, the dense route
# their sum
GV_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _dense_rows(sb, n, seed, *, shuffled=True, repeat=False, pads=False):
    """Rows that cover all n columns (epsilon's kind): ids 0..n−1 in order,
    or shuffled a row; ``repeat``: every row's id at entry 1 also stands at
    entry 0; ``pads``: row 0 is pads only and row 1 keeps its first half."""
    rng = np.random.default_rng(seed)
    idx = np.tile(np.arange(n, dtype=np.int32), (sb, 1))
    if shuffled:
        idx = np.stack([rng.permutation(n) for _ in range(sb)]).astype(np.int32)
    val = (rng.standard_normal((sb, n)) / math.sqrt(n)).astype(np.float32)
    if repeat:
        idx[:, 0] = idx[:, 1]
    if pads:
        idx[0], val[0] = 0, 0.0
        idx[1, n // 2 :], val[1, n // 2 :] = 0, 0.0
    return idx, val, rng.standard_normal(n).astype(np.float32)


def _epsilon_sm_bundle(sb):
    """The first sb rows of team 0 of epsilon-sm, stacked as the engine
    stacks it (one team at sb = 512, four below)."""
    ds = make_dataset("epsilon-sm", seed=0)
    tp = stack_row_teams(ds.A, ds.y, 1 if sb >= 512 else 4, row_multiple=sb, device="cpu")
    x = np.random.default_rng(sb).standard_normal(tp.n).astype(np.float32)
    return tp.indices[0, :sb].numpy(), tp.values[0, :sb].numpy(), x


CASES = {
    "epsilon-sm-128": lambda: _epsilon_sm_bundle(128),
    "epsilon-sm-512": lambda: _epsilon_sm_bundle(512),
    "ordered-72": lambda: _dense_rows(72, 520, 0, shuffled=False),
    "shuffled-72": lambda: _dense_rows(72, 600, 1),
    "shuffled-128": lambda: _dense_rows(128, 777, 2),
    "pads-72": lambda: _dense_rows(72, 544, 3, pads=True),
    "repeated-id-72": lambda: _dense_rows(72, 520, 4, repeat=True),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_plain_matches_the_reference(case, precision):
    """The dense route's plain version against the reference's kernel
    (interpret mode) in the same mode, against the port's panel walk
    (which rounds as it does: GV_TOL in both modes, repeated ids
    included), and against the dense fp32 oracle."""
    idx, val, x = CASES[case]()
    sb, w = idx.shape
    n = x.shape[0]
    assert tgram.gram_route(sb, w, n) == "dense"
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    g, v = tgram.ell_gram_dense_plain(ti, tv, tx, n=n, precision=precision)
    assert g.dtype == v.dtype == torch.float32 and g.shape == (sb, sb) and v.shape == (sb,)
    assert not torch.triu(g).any()
    jg, jv = jgram.ell_gram_and_v(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), n=n, bk=512,
                                  precision=precision)
    ref_tol = GV_TOL if precision == "fp32" else BF16_TOL
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **ref_tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **ref_tol)
    pg, pv = tgram.ell_gram_and_v_blocked(ti, tv, tx, n=n, bk=512, precision=precision)
    np.testing.assert_allclose(g.numpy(), pg.numpy(), **GV_TOL)
    np.testing.assert_allclose(v.numpy(), pv.numpy(), **GV_TOL)
    og, ov = tref.ell_gram_and_v_ref(ti, tv, tx, n)
    np.testing.assert_allclose(g.numpy(), og.numpy(), **ref_tol)
    np.testing.assert_allclose(v.numpy(), ov.numpy(), **ref_tol)
    assert float(g.abs().max()) > 0
    if case.startswith("pads"):  # pads add nothing, exactly
        assert not g[0].any() and not g[:, 0].any() and v[0] == 0
    if precision == "bf16":  # the rounding is live
        g32, _ = tgram.ell_gram_dense_plain(ti, tv, tx, n=n)
        assert not torch.equal(g, g32)


@pytest.mark.parametrize("splits", [1, 3, 7, 32])
def test_dense_plain_split_order_does_not_change_the_function(splits):
    """The column ranges, whether or not their count divides n's 32-column
    chunks (n = 1,000: 32 chunks), give the same (G, v) up to the order
    of float32 sums; v does not depend on them."""
    idx, val, x = _dense_rows(64, 1000, 5)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    geo = tgram.dense_geometry(64, 1000, splits=splits)
    assert (geo.splits - 1) * geo.per < geo.chunks <= geo.splits * geo.per
    g, v = tgram.ell_gram_dense_plain(ti, tv, tx, n=1000, splits=splits)
    g1, v1 = tgram.ell_gram_dense_plain(ti, tv, tx, n=1000, splits=1)
    np.testing.assert_allclose(g.numpy(), g1.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(v, v1)


def test_dense_plain_on_meta_tensors_gives_shapes():
    g, v = tgram.ell_gram_dense_plain(torch.empty((8, 5), dtype=torch.int32, device="meta"),
                                      torch.empty((8, 5), device="meta"), torch.empty(5, device="meta"), n=5)
    assert g.shape == (8, 8) and v.shape == (8,) and g.is_meta


def _full_size_shapes():
    """(name, sb, w, n) of every registered dataset at the main path's
    bundle (s·b = 128) and the s-step corner's (512), whole rows or a
    column shard of the paper's grid at p_c = 2 and 4: n = ⌈n/p_c⌉ columns
    and w = ⌈z̄/p_c⌉ entries, the registry's mean row length
    (``PanelProfile.width``) cut as the shard cuts it — from the statistics
    alone."""
    for stats in list(DATASET_STATS.values()) + list(SM_STATS.values()):
        for sb in (128, 512):
            for p_c in (1, 2, 4):
                yield stats.name, sb, p_c, -(-stats.zbar // p_c), -(-stats.n // p_c)


@pytest.mark.parametrize("name,sb,p_c,w,n", list(_full_size_shapes()))
def test_gram_route_of_every_registered_dataset(name, sb, p_c, w, n):
    """Epsilon's bundles (whole rows and the grid's column shards) and
    epsilon-sm's whole rows take the dense route; every full-size sparse
    dataset's the hash route (n/w ≥ 240 there: rcv1 638, synthetic_uniform
    250, news20 2,978, url 27,862)."""
    route = tgram.gram_route(sb, w, n)
    if name == "epsilon" or (name == "epsilon-sm" and p_c == 1):
        assert route == "dense"
    elif name in DATASET_STATS:
        assert route == "hash" and n / w >= 240
    else:  # the scaled variants' other shapes: whatever the rule says
        dense = w >= tgram.DENSE_MIN_WIDTH and n <= tgram.DENSE_RATIO * w
        assert route == ("dense" if dense else "hash")


def test_gram_route_rule_edges():
    w = max(500, tgram.DENSE_MIN_WIDTH)
    assert tgram.gram_route(128, w, tgram.DENSE_RATIO * w) == "dense"
    assert tgram.gram_route(128, w, tgram.DENSE_RATIO * w + 1) == "hash"
    # below the width floor the hash route's few lookups win, dense rows or not
    floor = tgram.DENSE_MIN_WIDTH
    assert tgram.gram_route(128, floor, floor) == "dense" and tgram.gram_route(128, floor - 1, floor - 1) == "hash"
    # a densified row must fit pass A's shared memory, whatever the ratio
    fits = tgram.SMEM_LIMIT // 4 // tgram.DENSE_KT * tgram.DENSE_KT
    assert tgram.dense_fits(fits) and not tgram.dense_fits(fits + 1)
    assert tgram.gram_route(8, 10**6, fits + 1) == "hash" and tgram.gram_route(8, 10**6, fits) == "dense"
    with pytest.raises(ValueError, match="empty"):
        tgram.gram_route(0, 10, 10)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("sb,n", [(1, 1), (72, 64), (128, 500), (128, 1000), (128, 2000), (512, 2000),
                                  (128, 32000), (1024, 4096)])
def test_dense_geometry_plan(sb, n, precision):
    """Tiles cover sb rows and chunks n columns; the column ranges cover
    the chunks with none empty, about √(2·chunks) of them but no more than
    fill the SMs; the workspace is the image, the partial tiles (none at
    one range) and a ticket a tile, each part aligned; the shared memory
    fits a block."""
    geo = tgram.dense_geometry(sb, n, precision)
    assert (geo.tiles - 1) * 64 < sb <= geo.tiles * 64 == geo.sb_pad
    assert geo.tile_count == geo.tiles * (geo.tiles + 1) // 2
    assert geo.chunks == -(-n // 32) and geo.n_pad == 32 * geo.chunks
    assert (geo.splits - 1) * geo.per < geo.chunks <= geo.splits * geo.per
    assert geo.splits <= max(1, min(math.isqrt(2 * geo.chunks), -(-132 // geo.tile_count)))
    elem = 2 if precision == "bf16" else 4
    assert geo.image_bytes == geo.sb_pad * geo.n_pad * elem
    partial = geo.tile_count * geo.splits * 64 * 64 * 4 if geo.splits > 1 else 0
    assert geo.ws_offset >= geo.image_bytes and geo.ws_offset % 256 == 0
    assert geo.ticket_offset >= geo.ws_offset + partial and geo.ticket_offset % 256 == 0
    assert geo.workspace_bytes == geo.ticket_offset + 4 * geo.tile_count
    assert geo.densify_smem == 4 * geo.n_pad <= tgram.SMEM_LIMIT == 232_448
    assert geo.ring_bytes == 4 * 2 * 64 * ((16 if precision == "bf16" else 32) + 4) * 4 <= tgram.SMEM_LIMIT


def test_dense_geometry_at_epsilons_bundles():
    """The plans the card runs: 3 tiles × 11 ranges at (128, 2,000), 36 × 4
    at the s-step corner's 512 rows, and the grid's shards."""
    plans = {(sb, n): tgram.dense_geometry(sb, n) for sb, n in ((128, 2000), (512, 2000), (128, 1000), (128, 500))}
    assert [(g.tile_count, g.splits, g.per) for g in plans.values()] == [(3, 11, 6), (36, 4, 16), (3, 8, 4), (3, 4, 4)]
    assert plans[(128, 2000)].workspace_bytes < 2 * 2**20


def test_dense_geometry_refuses_an_empty_bundle():
    for sb, n in ((0, 10), (8, 0)):
        with pytest.raises(ValueError, match="empty"):
            tgram.dense_geometry(sb, n)


def test_the_wrapper_on_cpu_tensors_stays_the_panel_walk():
    """A dense-routed shape on CPU tensors: the plain panel walk, bitwise,
    and no count of either route moves."""
    idx, val, x = _dense_rows(72, 200, 6)
    ti, tv, tx = torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(x)
    launches = dict(tgram.ell_gram_and_v.launches)
    routes = {r: dict(c) for r, c in tgram.ell_gram_and_v.route_launches.items()}
    for precision in ("fp32", "bf16"):
        got = tgram.ell_gram_and_v(ti, tv, tx, n=200, precision=precision)
        want = tgram.ell_gram_and_v_blocked(ti, tv, tx, n=200, precision=precision)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tgram.ell_gram_and_v.launches == launches
    assert tgram.ell_gram_and_v.route_launches == routes
    assert set(tgram.ell_gram_and_v.route_launches) == set(tgram.ROUTES) == {"hash", "dense"}


def test_round_graphs_keep_the_route_counts(monkeypatch):
    """A capture takes back what it counted by route too, and a replay adds
    it: the route counters are among the graphs' counters."""
    monkeypatch.setattr(tgram.ell_gram_and_v, "launches", {"fp32": 0, "bf16": 0})
    monkeypatch.setattr(tgram.ell_gram_and_v, "route_launches",
                        {"hash": {"fp32": 0, "bf16": 0}, "dense": {"fp32": 0, "bf16": 0}})
    before = round_graph._launch_counts()
    assert ("ell_gram.dense", "fp32") in before and ("ell_gram", "bf16") in before
    tgram._counted("dense", "bf16")
    delta = {k: n - before[k] for k, n in round_graph._launch_counts().items() if n != before[k]}
    assert delta == {("ell_gram", "bf16"): 1, ("ell_gram.dense", "bf16"): 1}
    round_graph._add_launches(delta, -1)
    assert round_graph._launch_counts() == before
    round_graph._add_launches(delta, 3)
    assert tgram.ell_gram_and_v.route_launches["dense"]["bf16"] == 3 == tgram.ell_gram_and_v.launches["bf16"]


@pytest.mark.parametrize("profile_kw,route", [(dict(rows=128, width=2000, n_local=2000, dense=True), "dense"),
                                              (dict(rows=128, width=74, n_local=47236), "hash")],
                         ids=["epsilon", "rcv1"])
def test_tune_panel_on_a_dense_routed_shape_times_no_hash_geometry(profile_kw, route, monkeypatch, tmp_path):
    """On the card (stood in for: the device kind, the timer and the
    wrapper are stubs) a dense-routed profile is timed once through the
    wrapper with no geometry and recorded as route "dense" without a tile
    or ks, so a Session reads no geometry from it; a hash-routed profile
    still times every (tile, ks)."""
    calls = []

    class Card:
        type = "cuda"

    def wrapper(*args, geometry=None, **kwargs):
        calls.append(geometry)

    monkeypatch.setattr(ttune, "resolve_device", lambda device: Card())
    monkeypatch.setattr(ttune, "ell_gram_and_v", wrapper)
    monkeypatch.setattr(ttune, "_device_seconds", lambda fn, repeats: fn() or 1e-3)
    monkeypatch.setattr(ttune, "_synthesize", lambda profile, max_n, device: (
        *(torch.from_numpy(a) for a in _dense_rows(profile.rows, 64, 0)[:2]), torch.zeros(profile.n_local),
        profile.n_local, profile.width))
    rec = ttune.tune_panel(ttune.PanelProfile(**profile_kw), device="cuda:NVIDIA H100 80GB HBM3",
                           cache_dir=tmp_path)
    assert rec["route"] == route
    if route == "dense":
        assert calls == [None] and "tile" not in rec and ttune.tuned_geometry(rec) is None
        assert [c["route"] for c in rec["candidates"]] == ["dense"]
    else:
        assert sorted(calls) == sorted(tgram.supported_tile_ks()) and ttune.tuned_geometry(rec) is not None
    assert ttune.lookup_panel(ttune.PanelProfile(**profile_kw), device="cuda:NVIDIA H100 80GB HBM3",
                              cache_dir=tmp_path) == rec
