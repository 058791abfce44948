"""The port's decoder zoo (the dense-attention family; MLA, MoE and Mamba
are in ``tests/test_torch_zoo.py``, decode in ``test_torch_decode.py``)
against the reference's: ``repro_torch.models`` / ``repro_torch.configs`` and
``repro.models`` / ``repro.configs`` on the same weights and tokens.

The reference draws its weights from ``jax.random``; they cross into the
port through the carry (``params_from_numpy``). Each reduced dense config
(and the sliding-window overlay, at a length past its window) must then
give the reference's logits, loss and every gradient, all float32 on the
CPU. Tolerances are relative to the largest entry of each tensor: logits
1e-5, loss 1e-6, each gradient leaf 2e-5 (measured ≈ 1e-6, 2e-7 and
1.6e-6: the same ops summed in another order).
"""

import dataclasses

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
from repro.models.transformer import forward as jforward
from repro.models.transformer import lm_loss as jloss
from repro_torch._tree import tree_paths
from repro_torch.models import (
    forward as tforward,
    init_params as tinit,
    lm_loss as tloss,
    params_from_numpy,
    params_to_numpy,
)

LOGIT_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-6, 2e-5
DENSE = ["qwen2.5-3b", "gemma-2b", "granite-34b", "mistral-nemo-12b", "musicgen-medium",
         "llava-next-mistral-7b", "swa"]


def _cfgs(name):
    if name == "swa":
        return (JC.reduced(JC.with_sliding_window(JC.get_config("mistral-nemo-12b"), 4096)),
                TC.reduced(TC.with_sliding_window(TC.get_config("mistral-nemo-12b"), 4096)))
    return JC.reduced(JC.get_config(name)), TC.reduced(TC.get_config(name))


def _same(jcfg, tcfg):
    """The two packages' config dataclasses hold the same fields."""
    return dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _inputs(cfg, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, seq)).astype(np.int32)
    prefix = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32) if cfg.frontend == "vision" else None
    return toks, np.roll(toks, -1, axis=1), prefix


@pytest.mark.parametrize("name", list(JC.REGISTRY) + ["qwen2.5-3b-swa"])
def test_registry_configs_equal_the_references(name):
    if name.endswith("-swa"):
        j = JC.with_sliding_window(JC.get_config(name[:-4]), 4096)
        t = TC.with_sliding_window(TC.get_config(name[:-4]), 4096)
    else:
        j, t = JC.get_config(name), TC.get_config(name)
    assert _same(j, t) and _same(JC.reduced(j), TC.reduced(t))
    assert t.param_count() == j.param_count() and t.active_param_count() == j.active_param_count()
    assert (t.n_periods, t.resolved_head_dim, t.subquadratic) == (j.n_periods, j.resolved_head_dim, j.subquadratic)
    assert sorted(TC.REGISTRY) == sorted(JC.REGISTRY)


@pytest.mark.parametrize("name", DENSE)
def test_forward_loss_and_gradients_match_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    assert _same(jcfg, tcfg)
    seq = 80 if name == "swa" else 32  # past the reduced window of 64
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, targs, prefix = _inputs(jcfg, seq)
    jpre = None if prefix is None else jnp.asarray(prefix)
    tpre = None if prefix is None else torch.from_numpy(prefix)

    lj = np.asarray(jforward(jcfg, jp, jnp.asarray(toks), jpre))
    lt = tforward(tcfg, tp, torch.from_numpy(toks), tpre)
    assert lt.shape == lj.shape == (2, seq + (0 if prefix is None else 8), jcfg.vocab_size)
    assert _rel(lj, lt.numpy()) <= LOGIT_RTOL

    loss_j, grads_j = jax.value_and_grad(
        lambda q: jloss(jcfg, q, jnp.asarray(toks), jnp.asarray(targs), prefix_emb=jpre))(jp)
    leaves = [t.requires_grad_(True) for _, t in tree_paths(tp)]
    loss_t = tloss(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(targs), prefix_emb=tpre)
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True, materialize_grads=True)
    assert abs(float(loss_j) - float(loss_t.detach())) <= LOSS_RTOL * abs(float(loss_j))
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat_j) == len(grads_t)
    for (path, gj), gt, (tpath, _) in zip(flat_j, grads_t, tree_paths(tp)):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        assert key == "/".join(map(str, tpath))
        assert _rel(gj, gt.numpy()) <= GRAD_RTOL, key


@pytest.mark.parametrize("name", ["qwen2.5-3b", "llava-next-mistral-7b"])
def test_last_only_and_remat_change_nothing(name):
    _, cfg = _cfgs(name)
    tp = tinit(cfg, dtype=torch.float32, device="cpu", seed=1)
    toks, targs, prefix = _inputs(cfg, 16, seed=1)
    pre = None if prefix is None else torch.from_numpy(prefix)
    full = tforward(cfg, tp, torch.from_numpy(toks), pre)
    last = tforward(cfg, tp, torch.from_numpy(toks), pre, last_only=True)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-6, atol=1e-6)
    leaves = [t.requires_grad_(True) for _, t in tree_paths(tp)]
    grads = []
    for remat in (False, True):
        loss = tloss(cfg, tp, torch.from_numpy(toks), torch.from_numpy(targs), prefix_emb=pre, remat=remat)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_masked_loss_matches_the_reference():
    jcfg, tcfg = _cfgs("gemma-2b")
    jp = jinit(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, targs, _ = _inputs(jcfg, 24, seed=3)
    mask = (np.arange(24)[None] % 3 != 0).astype(np.float32).repeat(2, axis=0)
    lj = float(jloss(jcfg, jp, jnp.asarray(toks), jnp.asarray(targs), mask=jnp.asarray(mask)))
    lt = float(tloss(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(targs), mask=torch.from_numpy(mask)))
    assert abs(lj - lt) <= LOSS_RTOL * abs(lj)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "swa"])
def test_chunked_attention_matches_flat(name):
    """The query-chunked path (−1e30 fill, softmax a chunk at a time) ≡
    the flat path (float32-min fill), as the reference's
    test_chunked_attention_matches_dense holds its own; and each equals the
    reference's path of the same kind on the same weights."""
    jcfg, tcfg = _cfgs(name)
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    layer_np = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"][0])
    layer_t = {k: torch.from_numpy(v.copy()) for k, v in layer_np.items()}
    layer_j = {k: jnp.asarray(v) for k, v in layer_np.items()}
    seq, thr, chunk = (128, 64, 32) if name == "swa" else (64, 32, 16)
    x = np.random.default_rng(2).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    spec = tcfg.period[0]
    flat = tbl.attn_train(layer_t, tcfg, spec, torch.from_numpy(x))
    flat_j = np.asarray(jbl.attn_train(layer_j, jcfg, jcfg.period[0], jnp.asarray(x)))
    saved = (tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK, jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK)
    try:
        tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK = thr, chunk
        jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK = thr, chunk
        chunked = tbl.attn_train(layer_t, tcfg, spec, torch.from_numpy(x))
        chunked_j = np.asarray(jbl.attn_train(layer_j, jcfg, jcfg.period[0], jnp.asarray(x)))
    finally:
        tbl.CHUNKED_ATTN_THRESHOLD, tbl.ATTN_Q_CHUNK, jbl.CHUNKED_ATTN_THRESHOLD, jbl.ATTN_Q_CHUNK = saved
    np.testing.assert_allclose(chunked.numpy(), flat.numpy(), rtol=2e-3, atol=2e-3)
    assert _rel(flat_j, flat.numpy()) <= LOGIT_RTOL
    assert _rel(chunked_j, chunked.numpy()) <= LOGIT_RTOL


def test_sliding_window_masks_outside_the_window():
    """Past the window the swa overlay differs from full attention; inside
    it the two agree."""
    _, full_cfg = _cfgs("mistral-nemo-12b")
    _, swa_cfg = _cfgs("swa")
    assert swa_cfg.sliding_window == 64 and swa_cfg.period[0].attn == "swa"
    tp = tinit(full_cfg, dtype=torch.float32, device="cpu", seed=4)
    toks, _, _ = _inputs(full_cfg, 80, seed=4)
    a = tforward(full_cfg, tp, torch.from_numpy(toks))
    b = tforward(swa_cfg, tp, torch.from_numpy(toks))
    torch.testing.assert_close(a[:, :64], b[:, :64], rtol=0, atol=0)
    assert float((a[:, 64:] - b[:, 64:]).abs().max()) > 1e-4


@pytest.mark.parametrize("name", ["qwen2.5-3b", "gemma-2b"])
def test_rope_gelu_and_norm_match_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(5)
    pos = np.arange(40)
    cj, sj = jbl.rope_frequencies(64, tcfg.rope_theta, jnp.asarray(pos))
    ct, st = tbl.rope_frequencies(64, tcfg.rope_theta, torch.from_numpy(pos))
    assert _rel(cj, ct.numpy()) <= 1e-6 and _rel(sj, st.numpy()) <= 1e-6
    x = rng.standard_normal((2, 40, 3, 64)).astype(np.float32)
    assert _rel(jbl.apply_rope(jnp.asarray(x), cj, sj), tbl.apply_rope(torch.from_numpy(x), ct, st).numpy()) <= 1e-6
    h = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3
    g = rng.standard_normal(16).astype(np.float32)
    assert _rel(jbl._act(jcfg.mlp_act, jnp.asarray(h)), tbl._act(tcfg.mlp_act, torch.from_numpy(h)).numpy()) <= 1e-6
    assert _rel(jbl.rmsnorm(jnp.asarray(g), jnp.asarray(h), 1e-6),
                tbl.rmsnorm(torch.from_numpy(g), torch.from_numpy(h), 1e-6).numpy()) <= 1e-6


def test_init_is_seeded_and_has_the_references_tree():
    _, cfg = _cfgs("llava-next-mistral-7b")
    a = tinit(cfg, dtype=torch.float32, device="cpu", seed=7)
    b = tinit(cfg, generator=torch.Generator().manual_seed(7), dtype=torch.float32, device="cpu")
    jp = jax.eval_shape(lambda: jinit(JC.reduced(JC.get_config("llava-next-mistral-7b")),
                                      jax.random.PRNGKey(0), dtype=jnp.float32))
    jshapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tshapes = {"/".join(map(str, path)): tuple(t.shape) for path, t in tree_paths(a)}
    assert tshapes == jshapes and isinstance(a["layers"], tuple)
    for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert tinit(cfg, device="cpu")["embed"].dtype == torch.bfloat16  # the reference's default dtype
    # the carry both ways is lossless
    back = params_from_numpy(params_to_numpy(a), device="cpu")
    for (_, x), (_, y) in zip(tree_paths(a), tree_paths(back)):
        assert torch.equal(x, y)


def test_bf16_reference_weights_carry():
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    jp = jinit(jcfg, jax.random.PRNGKey(0))  # the reference's default: bf16
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for (_, t), leaf in zip(tree_paths(tp), jax.tree.leaves(jp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.to(torch.float32).numpy(), np.asarray(leaf, np.float32))
