"""The port's Gram autotuner, its panel model and the ``bk=None`` front
door, against the reference's ``repro.kernels.tune``,
``repro.launch.roofline`` and ``repro.api``.

On the CPU the port tunes what the reference tunes there (the plain
panel walk's (bk, bm)); on the card it tunes the CUDA kernel's (tile, ks),
which ``chip_smoke.py`` exercises. Cache keys are the reference's strings
for equal arguments, while the port's kernel version and cache directory
are its own. Runs are held at the engine tolerances of
tests/test_torch_api.py.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.core.engine import ParallelSGDSchedule as JS
from repro.kernels import tune as jtune
from repro.launch import roofline as jroof
from repro_torch.core import engine as tengine
from repro_torch.core.engine import ParallelSGDSchedule as TS
from repro_torch.kernels import ell_gram as tgram
from repro_torch.kernels import tune as ttune
from repro_torch.launch import roofline as troof

ROOT = pathlib.Path(__file__).resolve().parents[1]
X_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu:cpu"


def _profile(mod, **kw):
    defaults = dict(rows=64, width=74, n_local=2368, dense=False, precision="fp32")
    defaults.update(kw)
    return mod.PanelProfile(**defaults)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Each test gets empty caches of both packages."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port"))


# ---- cache keys and records ----


@pytest.mark.parametrize("device", [CPU, "tpu:TPU v5e", "cuda:NVIDIA H100 80GB HBM3"])
@pytest.mark.parametrize("kw", [{}, dict(precision="bf16"), dict(rows=128, width=111, n_local=47236),
                                dict(dense=True, width=2000)], ids=["base", "bf16", "rcv1", "dense"])
@pytest.mark.parametrize("version", [2, 100])
def test_cache_key_equals_the_references_string(device, kw, version):
    assert ttune.cache_key(_profile(ttune, **kw), device, version) == \
        jtune.cache_key(_profile(jtune, **kw), device, version)


def test_cache_key_separates_device_version_and_package():
    p = _profile(ttune)
    assert ttune.cache_key(p, CPU) == ttune.cache_key(p, CPU)
    assert ttune.cache_key(p, CPU) != ttune.cache_key(p, "cuda:NVIDIA H100 80GB HBM3")
    assert ttune.cache_key(p, CPU) != ttune.cache_key(_profile(ttune, precision="bf16"), CPU)
    assert ttune.cache_key(p, CPU) != ttune.cache_key(p, CPU, kernel_version=ttune.KERNEL_VERSION + 1)
    # the port's own version and directory: it never reads the reference's records
    assert ttune.KERNEL_VERSION != jtune.KERNEL_VERSION
    assert ttune.cache_key(p, CPU) != jtune.cache_key(_profile(jtune), CPU)
    assert ttune.default_cache_dir() != jtune.default_cache_dir()
    assert ttune.device_kind("cpu") == CPU


def test_default_cache_dirs_differ_without_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert ttune.default_cache_dir() != jtune.default_cache_dir()
    assert ttune.default_cache_dir().parts[-2:] == ("repro_torch", "tune")


def test_profile_from_stats_equals_the_references():
    sched_j, sched_t = JS.hybrid(2, 4, 8, 0.1, 8, rounds=2), TS.hybrid(2, 4, 8, 0.1, 8, rounds=2)
    for name in ("rcv1-sm", "news20-sm", "epsilon-sm"):
        for p_c in (None, 2):
            pj = jtune.PanelProfile.from_stats(J.spec.dataset_stats(name), sched_j, p_c)
            pt = ttune.PanelProfile.from_stats(T.spec.dataset_stats(name), sched_t, p_c)
            assert pt.to_dict() == pj.to_dict()


def test_resolve_hits_cache_without_retuning(tmp_path):
    """A stored record IS the answer; a kernel-version bump misses; a miss
    without tuning allowed is the static fallback."""
    p = _profile(ttune)
    key = ttune.cache_key(p, CPU)
    ttune.store_record(
        {"key": key, "kernel_version": ttune.KERNEL_VERSION, "device": CPU,
         "profile": p.to_dict(), "bk": 192, "bm": 8, "measured_s": 1.0,
         "attainable_s": 0.5, "efficiency": 0.5, "candidates": []},
        cache_dir=tmp_path,
    )
    assert ttune.resolve_panel(p, device=CPU, cache_dir=tmp_path) == (192, 8)
    stale = ttune.cache_key(p, CPU, kernel_version=ttune.KERNEL_VERSION + 1)
    assert ttune.load_record(stale, tmp_path) is None
    assert ttune.resolve_panel(_profile(ttune, rows=32), device=CPU, cache_dir=tmp_path,
                               allow_tune=False) == (ttune.FALLBACK_BK, ttune.FALLBACK_BM)
    assert ttune.tuned_geometry(ttune.lookup_panel(p, device=CPU, cache_dir=tmp_path)) is None
    assert list(tmp_path.glob("*.tmp")) == []


def test_tune_writes_once_then_hits(tmp_path, monkeypatch):
    p = _profile(ttune, rows=16, width=8, n_local=512)
    rec = ttune.tune_panel(p, device=CPU, cache_dir=tmp_path, repeats=1, max_n=512)
    assert [f.stem for f in tmp_path.glob("*.json")] == [rec["key"]]
    raw = (tmp_path / f"{rec['key']}.json").read_bytes()

    def no_measure(*a, **k):
        raise AssertionError("a cache hit re-measured")

    monkeypatch.setattr(ttune, "_wall_seconds", no_measure)
    hit = ttune.tune_panel(p, device=CPU, cache_dir=tmp_path, repeats=1, max_n=512)
    assert hit == rec and (tmp_path / f"{rec['key']}.json").read_bytes() == raw
    assert rec["bk"] >= 1 and rec["efficiency"] is not None and rec["kernel_version"] == ttune.KERNEL_VERSION
    live = [c for c in rec["candidates"] if c.get("skipped") is None]
    assert live and all("attainable_s" in c and c["measured_s"] >= c["attainable_s"] for c in live)
    assert set(rec) >= {"key", "kernel_version", "device", "profile", "bk", "bm", "measured_s",
                        "attainable_s", "efficiency", "candidates"}
    assert ttune.tuned_geometry(rec) is None  # the CPU tunes (bk, bm), not the kernel's geometry


def test_cpu_tuner_skips_what_does_not_fit_shared_memory(tmp_path):
    """The fit check is the card's shared memory a block: at rows = 128 a
    (512, None) panel walk's working set does not fit and is skipped."""
    p = _profile(ttune, rows=128, width=16, n_local=1024)
    rec = ttune.tune_panel(p, device=CPU, cache_dir=tmp_path, repeats=1, max_n=1024)
    skipped = {(c["bk"], c["bm"]) for c in rec["candidates"] if c.get("skipped") == "vmem"}
    assert (512, None) in skipped
    assert all(troof.panel_vmem_bytes(128, 16, bk, bm) > troof.SMEM_BYTES for bk, bm in skipped)
    assert (rec["bk"], rec["bm"]) not in skipped


def test_synthesized_rows_have_distinct_ids():
    idx, val, x, n, width = ttune._synthesize(_profile(ttune, rows=64, width=74, n_local=300), None, "cpu")
    assert idx.shape == (64, 74) and n == 300 and x.shape == (300,)
    assert all(len(set(r.tolist())) == 74 for r in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 300


# ---- the heavy-tail rule ----


@pytest.mark.parametrize("width,rows", [(33, 8), (32, 8), (104, 64), (1000, 64), (257, 64), (256, 64), (111, 16)])
def test_select_gram_path_on_the_cpu_is_the_references(width, rows):
    ref = jtune.select_gram_path(width, rows)
    assert ttune.select_gram_path(width, rows) == {"pallas": "kernel"}.get(ref, ref)
    assert ttune.select_gram_path(width, rows, "kernel", device=CPU) == {"pallas": "kernel"}.get(ref, ref)


def test_select_gram_path_honours_explicit_choices_and_the_cards_rule():
    assert ttune.select_gram_path(1000, 64, "blocked") == "blocked"
    assert ttune.select_gram_path(1000, 64, "dense", device="cuda:NVIDIA H100 80GB HBM3") == "dense"
    card = "cuda:NVIDIA H100 80GB HBM3"
    assert ttune.heavy_tail_factor(card) == ttune.CARD_HEAVY_TAIL_FACTOR
    assert ttune.heavy_tail_factor(CPU) == ttune.HEAVY_TAIL_FACTOR == jtune.HEAVY_TAIL_FACTOR
    for width, rows in ((111, 16), (540, 128), (13100, 8)):
        want = "kernel" if ttune.CARD_HEAVY_TAIL_FACTOR is None or width <= ttune.CARD_HEAVY_TAIL_FACTOR * rows else "dense"
        assert ttune.select_gram_path(width, rows, device=card) == want


# ---- the kernel's geometry ----


@pytest.mark.parametrize("sb", [1, 8, 16, 128, 512, 1024, 2048])
@pytest.mark.parametrize("w", [1, 16, 111, 540, 2000, 13100])
def test_gram_geometry_default_is_unchanged_and_overrides_keep_the_width_rule(sb, w):
    geo = tgram.gram_geometry(sb, w)
    assert (geo.tile, geo.ks) == tgram.default_tile_ks(sb)
    assert tgram.gram_geometry(sb, w, *tgram.default_tile_ks(sb)) == geo
    for tile, ks in tgram.supported_tile_ks():
        g = tgram.gram_geometry(sb, w, tile, ks)
        assert (g.tile, g.ks, g.threads, g.tiles) == (tile, ks, tile * tile * ks, -(-sb // tile))
        assert g.threads % 32 == 0 and g.threads <= 512 and g.smem_bytes <= tgram.SMEM_LIMIT
        assert g.chunk <= tgram.MAX_CHUNK and g.cap >= 2 * g.chunk and g.cap & (g.cap - 1) == 0
        assert g.smem_bytes == 4 * (2 * tile * (g.cap + 4) + 4 * tile * g.chunk + 2 * tile + ks * tile * tile)


def test_supported_pairs():
    assert tgram.supported_tile_ks() == ((4, 2), (4, 4), (4, 8), (4, 16), (4, 32),
                                         (8, 1), (8, 2), (8, 4), (8, 8), (16, 1), (16, 2))
    assert (8, 8) in tgram.supported_tile_ks() and (16, 2) in tgram.supported_tile_ks()


@pytest.mark.parametrize("tile,ks", [(4, 1), (8, 16), (16, 4), (32, 1), (12, 2), (2, 8), (8, 0), (16, 3), (8, None), (None, 2)])
def test_gram_geometry_refuses_pairs_the_kernel_cannot_run(tile, ks):
    with pytest.raises(ValueError):
        tgram.gram_geometry(128, 111, tile, ks)


def test_geometry_is_ignored_by_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 500, size=(32, 20)).astype(np.int32))
    val = torch.from_numpy(rng.standard_normal((32, 20)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(500).astype(np.float32))
    g0, v0 = tgram.ell_gram_and_v(idx, val, x, n=500)
    g1, v1 = tgram.ell_gram_and_v(idx, val, x, n=500, geometry=(4, 8))
    assert torch.equal(g0, g1) and torch.equal(v0, v1)


# ---- the panel model and the probe bound ----


@pytest.mark.parametrize("rows,width,n,bk,bm,cb", [
    (128, 74, 47236, 512, None, 4), (128, 111, 47236, 256, 16, 2), (16, 8, 512, 128, 32, 4),
    (512, 74, 16384, 1024, 32, 4), (64, 2000, 2000, 128, None, 2), (8, 3, 10, 8, 16, 4)])
def test_panel_counts_equal_the_references(rows, width, n, bk, bm, cb):
    assert troof.panel_vmem_bytes(rows, width, bk, bm, cb) == jroof.panel_vmem_bytes(rows, width, bk, bm, cb)
    assert troof.panel_flops(rows, width, n, bk) == jroof.panel_flops(rows, width, n, bk)
    assert troof.panel_hbm_bytes(rows, width, n, bk, cb) == jroof.panel_hbm_bytes(rows, width, n, bk, cb)
    for precision in ("fp32", "bf16"):
        t = troof.panel_roofline(rows, width, n, bk, bm, precision)
        j = jroof.panel_roofline(rows, width, n, bk, bm, precision)
        assert (t.flops, t.hbm_bytes, t.vmem_bytes) == (j.flops, j.hbm_bytes, j.vmem_bytes)
        assert t.hbm_bw == 3.35e12 and t.peak_flops == (989e12 if precision == "bf16" else 67e12)
        assert t.fits_vmem == (t.vmem_bytes <= tgram.SMEM_LIMIT)
        assert t.attainable_s == max(t.flops / t.peak_flops, t.hbm_bytes / 3.35e12)


def test_the_port_names_no_tpu_constant():
    text = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    for tpu in ("197e12", "819e9", "50e9", "16 * 2**20", "VMEM_BYTES"):
        assert tpu not in text


def test_probe_bound_counts_pairs_bytes_and_operations():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, size=(12, 6)).astype(np.int32)
    val = rng.standard_normal((12, 6)).astype(np.float32)
    val[:, 5] = 0.0
    pairs = 0
    for i in range(12):
        for j in range(i):
            for a in range(6):
                for c in range(6):
                    pairs += val[i, a] != 0 and val[j, c] != 0 and idx[i, a] == idx[j, c]
    b = troof.probe_bound(idx, val)
    assert b.pairs == pairs
    assert b.operations == 2 * pairs + 2 * np.count_nonzero(val)
    assert b.bytes == idx.size * 8 + len(np.unique(idx)) * 4 + 12 * 12 * 4 + 12 * 4
    assert b.attainable_s == max(b.bytes / 3.35e12, b.operations / 67e12)
    assert troof.probe_bound(torch.from_numpy(idx), torch.from_numpy(val)) == b


# ---- the front door with bk=None ----


def _specs(backend="simulated", **sched_kw):
    kw = {**dict(p_r=2, s=2, b=4, eta=0.05, tau=8, rounds=3, loss_every=1), **sched_kw}
    mesh = dict(p_r=2, p_c=2, backend=backend)
    j = J.ExperimentSpec(dataset="rcv1-sm", schedule=JS(**{**kw, "gram": {"kernel": "pallas"}.get(kw.get("gram"), kw.get("gram", "pallas"))}),
                         mesh=J.MeshSpec(**mesh))
    t = T.ExperimentSpec(dataset="rcv1-sm", schedule=TS(**kw), mesh=T.MeshSpec(**mesh))
    assert t.content_hash() == j.content_hash()
    return j, t


def _seed(profile_of, bk, bm, extra=None):
    """The same (bk, bm) record in each package's cache, keyed for the CPU."""
    for mod in (jtune, ttune):
        p = profile_of(mod)
        key = mod.cache_key(p, CPU)
        mod.store_record({"key": key, "kernel_version": mod.KERNEL_VERSION, "device": CPU,
                          "profile": p.to_dict(), "bk": bk, "bm": bm, "measured_s": 1.0,
                          "attainable_s": 0.5, "efficiency": 0.5, "candidates": [],
                          **(extra or {} if mod is ttune else {})})


def _profile_of(spec_j, spec_t):
    return lambda mod: mod.PanelProfile.from_stats(
        (J if mod is jtune else T).spec.dataset_stats("rcv1-sm"),
        (spec_j if mod is jtune else spec_t).schedule, 2)


def test_plan_summaries_equal_the_references_cold_and_warm():
    sj, st = _specs(bk=None)
    pj, pt = J.plan(sj), T.plan(st, device="cpu")
    assert pt.summary() == pj.summary() and "bk=auto (tuned at build)" in pt.summary()
    assert pt.tuned_panel is None
    _seed(_profile_of(sj, st), 256, 16)
    pj, pt = J.plan(sj), T.plan(st, device="cpu")
    assert pt.tuned_panel == pj.tuned_panel == (256, 16)
    assert pt.summary() == pj.summary() and "bk=auto→256 bm=16" in pt.summary()


def test_plan_without_a_card_neither_raises_nor_tunes(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: plan(spec) probes its records")

    def no_tuning(*a, **k):
        raise AssertionError("plan() tuned")

    monkeypatch.setattr(ttune, "tune_panel", no_tuning)
    _, st = _specs(bk=None)
    pl = T.plan(st)  # device=None, no card: the probe misses
    assert pl.tuned_panel is None and "bk=auto (tuned at build)" in pl.summary()
    assert not (tmp_path / "port").exists()
    # even with a CPU record in the cache: plan() without a device keys no CPU probe
    _seed(_profile_of(*_specs(bk=None)), 256, 16)
    assert T.plan(st).tuned_panel is None
    assert T.plan(st, device="cpu").tuned_panel == (256, 16)


def test_sweep_cli_plan_only_takes_bk_none_without_a_card(tmp_path):
    spec = json.loads((ROOT / "examples/specs/rcv1_hybrid.json").read_text())
    specs = spec if isinstance(spec, list) else [spec]
    for s in specs:
        s["schedule"]["bk"] = None
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(specs))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "", "CUDA_VISIBLE_DEVICES": "",
           "REPRO_TORCH_TUNE_CACHE": str(tmp_path / "cache"), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.sweep", "--spec", str(path), "--plan-only"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "bk=auto (tuned at build)" in out.stdout
    assert not (tmp_path / "cache").exists()


def test_session_resolves_bk_none_and_reports():
    _, st = _specs(bk=None)
    assert "bk=auto (tuned at build)" in T.plan(st, device="cpu").summary()
    sess = T.Session(st, device="cpu")
    assert sess.spec.schedule.bk is not None and sess.gram_geometry is None
    assert sess.input_spec.schedule.bk is None
    pl2 = T.plan(st, device="cpu")
    assert pl2.tuned_panel == (sess.spec.schedule.bk, sess.spec.schedule.bm)
    assert f"bk=auto→{sess.spec.schedule.bk}" in pl2.summary()


def test_session_gram_autoselect_rides_autotune_optin():
    """Heavy-tailed ELL width (w > 4·s·b) flips the tuned CPU build to the
    dense oracle; the default bk=512 build never flips; an explicit
    choice is honored — as in the reference."""
    _, tuned = _specs(bk=None)
    assert T.Session(tuned, device="cpu").spec.schedule.gram == "dense"
    _, static = _specs()
    assert T.Session(static, device="cpu").spec.schedule.gram == "kernel"
    _, manual = _specs(bk=None, gram="blocked")
    assert T.Session(manual, device="cpu").spec.schedule.gram == "blocked"


@pytest.mark.parametrize("case", [
    dict(s=2, b=4),  # width ≫ 4·s·b: both flip to the dense oracle
    dict(s=4, b=8),  # the panel walk at the seeded (bk, bm)
    dict(s=4, b=8, precision="bf16", delay=1),
], ids=["heavy-tail-dense", "kernel", "kernel-bf16-D1"])
def test_session_bk_none_matches_the_reference_with_seeded_caches(case):
    sj, st = _specs(bk=None, **case)
    _seed(_profile_of(sj, st), 256, 16)
    js, ts = J.Session(sj), T.Session(st, device="cpu")
    assert (ts.spec.schedule.bk, ts.spec.schedule.bm) == (js.spec.schedule.bk, js.spec.schedule.bm) == (256, 16)
    assert {"pallas": "kernel"}.get(js.spec.schedule.gram, js.spec.schedule.gram) == ts.spec.schedule.gram
    assert ts.spec.content_hash() == js.spec.content_hash()
    assert ts.input_spec.content_hash() == js.input_spec.content_hash()
    rj, rt = js.run(), ts.run()
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), **X_TOL)
    np.testing.assert_allclose(rt.losses, rj.losses, **LOSS_TOL)


def test_a_tuned_geometry_reaches_every_gram_launch(monkeypatch):
    """A record with the card's (tile, ks) is carried Session → driver →
    ``bundle_gram_v`` → ``ell_gram_and_v(geometry=)`` at every launch (on
    the CPU the plain version then ignores it, so the iterates do not
    move)."""
    sj, st = _specs(bk=None, s=4, b=8, rounds=2)
    _seed(_profile_of(sj, st), 512, None, extra={"tile": 8, "ks": 4})
    seen = []
    real = tengine.ell_gram_and_v

    def spy(*a, geometry=None, **k):
        if not a[0].is_meta:  # the ledger's capture on meta tensors launches nothing
            seen.append(geometry)
        return real(*a, geometry=geometry, **k)

    monkeypatch.setattr(tengine, "ell_gram_and_v", spy)
    sess = T.Session(st, device="cpu")
    assert sess.gram_geometry == (8, 4) and sess.spec.schedule.gram == "kernel"
    x_tuned = sess.run().x
    assert seen and set(seen) == {(8, 4)} and len(seen) == 2 * 2 * (8 // 4)
    seen.clear()
    probes = sess._driver.phase_probes()
    fn, args, _ = probes["bundle_compute"]
    fn(*args)
    assert seen == [(8, 4)]
    # the same spec with bk given: no geometry, the same bits on the CPU
    seen.clear()
    _, plain = _specs(bk=512, s=4, b=8, rounds=2)
    x_plain = T.Session(plain, device="cpu").run().x
    assert set(seen) == {None}
    np.testing.assert_array_equal(x_tuned, x_plain)


def test_the_mesh_round_carries_the_geometry(monkeypatch):
    """The mesh's round body passes its geometry to each bundle's Gram."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core.comm import COUNTING

    from repro_torch.api.run import build_problem

    _, st = _specs(bk=512, s=4, b=8, rounds=1)

    b = build_problem(dataclasses.replace(st, mesh=dataclasses.replace(st.mesh, backend="shard_map")), device="cpu")
    seen = []
    real = tdist.bundle_gram_v

    def spy(*a, geometry=None, **k):
        seen.append(geometry)
        return real(*a, geometry=geometry, **k)

    monkeypatch.setattr(tdist, "bundle_gram_v", spy)
    prob = b.prob2d
    round_fn = tdist._build_round_fn(prob, st.schedule, COUNTING, geometry=(16, 2))
    x = torch.zeros(prob.n_loc)
    round_fn(prob.indices[0, 0], prob.values[0, 0], x, 0)
    assert seen == [(16, 2)] * (st.schedule.tau // st.schedule.s)
