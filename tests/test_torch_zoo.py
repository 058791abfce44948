"""The port's MLA, MoE and Mamba-1 layers against the reference's:
``repro_torch.models`` and ``repro.models`` on the same weights (the
reference's, carried through ``params_from_numpy``) and the same numpy
inputs, on the CPU.

Whole models (the four configs these layers complete, reduced) are held
at the tolerances of ``tests/test_torch_models.py``: logits 1e-5, loss
1e-6, each gradient leaf 2e-5, relative to the largest entry (measured
≤ 1.3e-6, 7e-8 and 3.2e-6). The chunked scan is held at the reference's
own scan tolerance, 1e-4 (``tests/test_moe_dispatch_props.py``). A
bfloat16 tree is held at 2e-2 relative (a few bf16 roundings: the
reference fuses its scan body and may keep float32 between ops that the
port rounds one at a time). Every MoE comparison first asserts that both
packages routed each token to the same experts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.blocks as jbl
import repro_torch.configs as TC
import repro_torch.models.blocks as tbl
from repro.models.init import init_params as jinit
from repro.models.init import padded_experts as j_padded
from repro.models.transformer import forward as jforward
from repro.models.transformer import lm_loss as jloss
from repro_torch._tree import tree_paths
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import lm_loss as tloss
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.models.init import padded_experts as t_padded

LOGIT_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-6, 2e-5
SCAN_TOL = 1e-4
BF16_RTOL = 2e-2
NEW = ["deepseek-v2-lite-16b", "granite-moe-3b-a800m", "jamba-1.5-large-398b", "falcon-mamba-7b"]


def _cfgs(name):
    return JC.reduced(JC.get_config(name)), TC.reduced(TC.get_config(name))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@functools.cache
def _ref_params(jcfg, seed, dtype):
    """The reference's weights as a numpy tree (one draw per process)."""
    return jax.tree.map(np.asarray, jax.jit(lambda k: jinit(jcfg, k, dtype=dtype))(jax.random.PRNGKey(seed)))


def _carried(jcfg, seed=0, dtype=jnp.float32):
    """(the reference's weights, the same carried into the port)."""
    pnp = _ref_params(jcfg, seed, dtype)
    return jax.tree.map(jnp.asarray, pnp), params_from_numpy(pnp, device="cpu")


def _layer(jp, pos=0):
    """Period 0's tensors of period position ``pos``: (reference, port)."""
    layer_np = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"][pos])
    return ({k: jnp.asarray(v) for k, v in layer_np.items()},
            params_from_numpy(layer_np, device="cpu"))


@pytest.mark.parametrize("name", NEW)
def test_new_configs_match_the_reference(name):
    """Logits, loss and every gradient of the four configs that MLA, MoE
    and Mamba complete (they raised ``NotImplementedError`` before)."""
    jcfg, tcfg = _cfgs(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = _carried(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    targs = np.roll(toks, -1, axis=1)

    lj = np.asarray(jax.jit(lambda q, t: jforward(jcfg, q, t))(jp, jnp.asarray(toks)))
    lt = tforward(tcfg, tp, torch.from_numpy(toks))
    assert lt.shape == lj.shape == (2, 32, jcfg.vocab_size)
    assert _rel(lj, lt.numpy()) <= LOGIT_RTOL

    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda q: jloss(jcfg, q, jnp.asarray(toks), jnp.asarray(targs))))(jp)
    leaves = [t.requires_grad_(True) for _, t in tree_paths(tp)]
    loss_t = tloss(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(targs))
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True, materialize_grads=True)
    assert abs(float(loss_j) - float(loss_t.detach())) <= LOSS_RTOL * abs(float(loss_j))
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat_j) == len(grads_t)
    for (path, gj), gt, (tpath, _) in zip(flat_j, grads_t, tree_paths(tp)):
        assert _key(path) == "/".join(map(str, tpath))
        assert _rel(gj, gt.numpy()) <= GRAD_RTOL, _key(path)


@pytest.mark.parametrize("name", sorted(JC.REGISTRY))
def test_init_builds_every_registry_config_with_the_references_tree(name):
    """Shapes and dtypes leaf for leaf — ``router`` and ``A_log`` float32
    in a bf16 tree — seeded, and the round trip through numpy lossless
    (bf16 leaves widen to float32 there, which numpy can hold)."""
    jcfg, tcfg = _cfgs(name)
    a = tinit(tcfg, device="cpu", seed=3)  # the reference's default dtype: bf16
    b = tinit(tcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    want = jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0)))
    jleaves = {_key(path): (tuple(leaf.shape), str(leaf.dtype))
               for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    tleaves = {"/".join(map(str, path)): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for path, t in tree_paths(a)}
    assert tleaves == jleaves
    for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y)
    back = params_from_numpy(params_to_numpy(a), device="cpu")
    for (_, x), (_, y) in zip(tree_paths(a), tree_paths(back)):
        assert y.dtype == torch.float32 and torch.equal(x, y.to(x.dtype))


def test_layer_constants_are_the_references():
    """dt_bias −4.6, A_log = log(1..N) over (d_in, N), conv_b 0, D 1 —
    and a reference bf16 tree (float32 router and A_log beside bf16
    leaves) carries leaf for leaf."""
    jcfg, tcfg = _cfgs("jamba-1.5-large-398b")
    tp = tinit(tcfg, dtype=torch.float32, device="cpu")
    mamba = tp["layers"][1]
    d_in, n = 2 * tcfg.d_model, tcfg.mamba.d_state
    assert torch.equal(mamba["dt_bias"], torch.full((1, d_in), -4.6))
    assert torch.equal(mamba["A_log"][0], torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(d_in, n))
    assert torch.equal(mamba["conv_b"], torch.zeros(1, d_in)) and torch.equal(mamba["D"], torch.ones(1, d_in))
    jp, carried = _carried(jcfg, seed=5, dtype=jnp.bfloat16)  # the reference's default dtype
    kinds = set()
    for (path, t), leaf in zip(tree_paths(carried), jax.tree.leaves(jp)):
        kinds.add(t.dtype)
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        np.testing.assert_array_equal(t.to(torch.float32).numpy(), np.asarray(leaf, np.float32))
    assert kinds == {torch.bfloat16, torch.float32}
    assert carried["layers"][1]["router"].dtype == carried["layers"][1]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("n", [1, 4, 15, 16, 17, 40, 64, 160, 300])
def test_padded_experts_is_the_references(n):
    assert t_padded(n) == j_padded(n)


@pytest.mark.parametrize("seq,thr,chunk", [(64, 32, 16), (96, 64, 32)])
def test_mla_chunked_matches_flat_and_the_reference(seq, thr, chunk):
    """``_mla_attend_chunked`` (above the threshold) ≡ ``_mla_attend``
    within the reference's own 2e-3, and each path equals the
    reference's path of the same kind."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    jp, _ = _carried(jcfg)
    lj, lt = _layer(jp)
    x = np.random.default_rng(seq).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    spec = tcfg.period[0]
    flat = tbl.mla_train(lt, tcfg, spec, torch.from_numpy(x))
    flat_j = np.asarray(jax.jit(lambda q, y: jbl.mla_train(q, jcfg, jcfg.period[0], y))(lj, jnp.asarray(x)))
    saved = (tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK, jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK)
    try:
        tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK = thr, chunk
        jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK = thr, chunk
        chunked = tbl.mla_train(lt, tcfg, spec, torch.from_numpy(x))
        chunked_j = np.asarray(jax.jit(lambda q, y: jbl.mla_train(q, jcfg, jcfg.period[0], y))(lj, jnp.asarray(x)))
    finally:
        tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK, jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK = saved
    np.testing.assert_allclose(chunked.numpy(), flat.numpy(), rtol=2e-3, atol=2e-3)
    assert _rel(flat_j, flat.numpy()) <= LOGIT_RTOL
    assert _rel(chunked_j, chunked.numpy()) <= LOGIT_RTOL


def _sequential_scan(dt, xi, Bc, Cc, A):
    """h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t·B_t, y_t = h_t·C_t in float64."""
    b, S, d = dt.shape
    h = np.zeros((b, d, A.shape[1]))
    ys = np.zeros((b, S, d))
    for t in range(S):
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xi[:, t])[..., None] * Bc[:, t, None, :]
        ys[:, t] = np.einsum("bdn,bn->bd", h, Cc[:, t])
    return ys, h


@pytest.mark.parametrize("b,n_chunks,chunk,d,nstate,seed",
                         [(1, 1, 4, 4, 2, 0), (2, 3, 8, 8, 4, 1), (3, 4, 16, 4, 16, 2), (2, 2, 256, 8, 16, 3),
                          (1, 2, 7, 4, 2, 4)])
def test_ssm_scan_matches_the_reference_and_a_sequential_recurrence(b, n_chunks, chunk, d, nstate, seed):
    rng = np.random.default_rng(seed)
    S = n_chunks * chunk
    dt = rng.random((b, S, d)).astype(np.float32) * 0.1
    xi = rng.standard_normal((b, S, d)).astype(np.float32)
    Bc = rng.standard_normal((b, S, nstate)).astype(np.float32)
    Cc = rng.standard_normal((b, S, nstate)).astype(np.float32)
    A = -rng.random((d, nstate)).astype(np.float32)
    h0 = np.zeros((b, d, nstate), np.float32)
    y, h = tbl._ssm_scan_chunked(*(torch.from_numpy(a) for a in (dt, xi, Bc, Cc, A, h0)), chunk)
    yj, hj = jbl._ssm_scan_chunked(*(jnp.asarray(a) for a in (dt, xi, Bc, Cc, A, h0)), chunk)
    ys, hs = _sequential_scan(dt, xi, Bc, Cc, A)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (b, S, d)
    np.testing.assert_allclose(y.numpy(), ys, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), hs, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("seq", [24, 40])
def test_mamba_train_matches_the_reference_on_the_single_chunk_fallback(seq):
    """S % chunk ≠ 0 falls back to one chunk in both packages (chunk 16
    over 24 and 40 tokens); an S that divides runs several chunks."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b")
    jp, _ = _carried(jcfg, seed=2)
    lj, lt = _layer(jp)
    x = np.random.default_rng(seq).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    for chunk in (16, 8):
        yt = tbl.mamba_train(lt, tcfg, torch.from_numpy(x), chunk=chunk)
        yj = np.asarray(jax.jit(lambda q, y, c=chunk: jbl.mamba_train(q, jcfg, y, chunk=c))(lj, jnp.asarray(x)))
        assert _rel(yj, yt.numpy()) <= LOGIT_RTOL


def _routes_j(lj, jcfg, x):
    t = x.reshape(-1, x.shape[-1])
    return np.asarray(jax.lax.top_k(jax.nn.softmax((t @ lj["router"]).astype(jnp.float32), axis=-1),
                                    jcfg.moe.top_k)[1])


def _routes_t(lt, tcfg, x):
    t = x.reshape(-1, x.shape[-1])
    logits = torch.matmul(*tbl._promoted(t, lt["router"]))
    return torch.topk(torch.softmax(logits.to(torch.float32), dim=-1), tcfg.moe.top_k, dim=-1)[1].numpy()


def _moe_pair(jcfg, tcfg, lj, lt, x):
    """The reference's and the port's ``moe`` on ``x`` (in the experts'
    dtype), after asserting that both routed every token to the same
    experts in the same order. Returns (reference, port, routes)."""
    xj = jnp.asarray(x).astype(lj["w_gate_e"].dtype)
    xt = torch.from_numpy(x).to(lt["w_gate_e"].dtype)
    top = _routes_t(lt, tcfg, xt)
    assert np.array_equal(_routes_j(lj, jcfg, xj), top)
    yj = jax.jit(lambda q, y: jbl.moe(q, jcfg, y))(lj, xj)
    return np.asarray(yj, np.float32), tbl.moe(lt, tcfg, xt), top


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "granite-moe-3b-a800m"])
def test_moe_on_a_bf16_tree_matches_the_reference(name):
    """bf16 experts with the float32 router: the router matmul promotes to
    float32 in both packages; the output is bf16."""
    jcfg, tcfg = _cfgs(name)
    jp, _ = _carried(jcfg, dtype=jnp.bfloat16)
    lj, lt = _layer(jp)
    assert lt["router"].dtype == torch.float32 and lt["w_gate_e"].dtype == torch.bfloat16
    x = np.random.default_rng(7).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)  # representable in bf16
    yj, yt, _ = _moe_pair(jcfg, tcfg, lj, lt, x)
    assert yt.dtype == torch.bfloat16
    assert _rel(yj, yt.to(torch.float32).numpy()) <= BF16_RTOL


def test_moe_with_padded_experts_never_routes_to_a_pad():
    """granite-moe's 40 experts at a narrow width: 48 allocated, tokens
    routed among the first 40 only, the pads' gradients exactly zero, and
    the output the reference's."""
    base = JC.reduced(JC.get_config("granite-moe-3b-a800m"))
    jcfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, n_experts=40, top_k=8, d_ff_expert=32))
    tbase = TC.reduced(TC.get_config("granite-moe-3b-a800m"))
    tcfg = dataclasses.replace(tbase, moe=dataclasses.replace(tbase.moe, n_experts=40, top_k=8, d_ff_expert=32))
    jp, _ = _carried(jcfg, seed=4)
    lj, lt = _layer(jp)
    assert lt["w_gate_e"].shape[0] == 48 and lt["router"].shape[1] == 40
    x = np.random.default_rng(8).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    yj, yt, top = _moe_pair(jcfg, tcfg, lj, lt, x)
    assert int(top.max()) < 40 and len(np.unique(top)) > 8
    assert _rel(yj, yt.numpy()) <= LOGIT_RTOL
    w = lt["w_down_e"].requires_grad_(True)
    (g,) = torch.autograd.grad(tbl.moe({**lt, "w_down_e": w}, tcfg, torch.from_numpy(x)).square().sum(), [w])
    assert torch.count_nonzero(g[40:]) == 0 and torch.count_nonzero(g[:40]) > 0


def test_a_bf16_hybrid_model_matches_the_reference_layer_by_layer():
    """jamba reduced (attention, Mamba and MoE) on a bf16 tree: the residual
    stream after each layer and the logits within a few bf16 roundings of
    the reference's layers run one by one, the MoE layer routing every
    token as the reference does. (The reference's scanned ``forward`` is
    held against its own layer-by-layer run here too: it fuses the period
    body and keeps float32 between ops, which moved its bf16 logits by
    0.165 relative on this input, more than the port's 0.010.)"""
    import repro_torch.models.transformer as tt

    jcfg, tcfg = _cfgs("jamba-1.5-large-398b")
    jp, tp = _carried(jcfg, seed=5, dtype=jnp.bfloat16)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    xj = jnp.take(jp["embed"], jnp.asarray(toks), axis=0)
    xt = tp["embed"][torch.from_numpy(toks).long()]
    for i, (jspec, tspec) in enumerate(zip(jcfg.period, tcfg.period)):
        lj = jax.tree.map(lambda a: a[0], jp["layers"][i])
        lt = {k: v[0] for k, v in tp["layers"][i].items()}
        mix = jbl.mamba_train(lj, jcfg, jbl.rmsnorm(lj["ln1"], xj, jcfg.norm_eps)) if jspec.mixer == "mamba" \
            else jbl.attn_train(lj, jcfg, jspec, jbl.rmsnorm(lj["ln1"], xj, jcfg.norm_eps))
        hj = jbl.rmsnorm(lj["ln2"], xj + mix, jcfg.norm_eps)
        ht = tbl.rmsnorm(lt["ln2"], xt + tt._mix_train(lt, tcfg, tspec, tbl.rmsnorm(lt["ln1"], xt, tcfg.norm_eps)),
                         tcfg.norm_eps)
        if tspec.ff == "moe":  # each package's own MoE input, routed alike
            assert np.array_equal(_routes_j(lj, jcfg, hj), _routes_t(lt, tcfg, ht))
        xj = xj + mix + (jbl.moe(lj, jcfg, hj) if jspec.ff == "moe" else jbl.mlp(lj, jcfg, hj))
        xt = tt._apply_layer_train(lt, tcfg, tspec, xt)
        assert xt.dtype == torch.bfloat16
        assert _rel(np.asarray(xj, np.float32), xt.to(torch.float32).numpy()) <= BF16_RTOL, i
    lj = np.asarray(jbl.rmsnorm(jp["norm_f"], xj, jcfg.norm_eps) @ jp["lm_head"], np.float32)
    lt = tbl.rmsnorm(tp["norm_f"], xt, tcfg.norm_eps) @ tp["lm_head"]
    assert _rel(lj, lt.to(torch.float32).numpy()) <= BF16_RTOL


def test_softplus_is_jaxs_above_torchs_threshold():
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.0, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(tbl._softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(x)))
