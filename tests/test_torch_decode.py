"""The port's decode path and step functions against the reference's:
``init_cache``/``decode_step`` and ``repro_torch.launch.steps`` beside
``repro.models.transformer`` and ``repro.launch.steps``, on the
reference's weights carried through ``params_from_numpy``, on the CPU.

Decode is held step by step on a cache the reference filled and the port
took over (the reference's tree, carried), past ``max_len`` — where full
attention writes slot ``pos % L`` and MLA the clamped last slot, as the
reference does — at the logits tolerance of ``tests/test_torch_models.py``
(1e-5 relative; measured ≤ 2.4e-6). Decode ≡ forward inside the port is
held at the reference's own 2e-3 (``tests/test_models_smoke.py``). One
train step with two microbatches is held at the loss tolerance 1e-6 and
each parameter at 2e-5 relative to its largest entry. The reference runs
under ``jax.jit`` (its eager decode re-dispatches every op).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.launch.steps as jsteps
import repro_torch.configs as TC
import repro_torch.launch.steps as tsteps
from repro.models.init import init_params as jinit
from repro.models.transformer import decode_step as jdecode
from repro.models.transformer import init_cache as jinit_cache
from repro.optim.sgd import sgd as jsgd
from repro_torch._tree import tree_paths
from repro_torch.models import decode_step as tdecode
from repro_torch.models import forward as tforward
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit
from repro_torch.models import lm_loss as tloss
from repro_torch.models import params_from_numpy
from repro_torch.optim.sgd import Optimizer, sgd as tsgd

LOGIT_RTOL, LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-6, 2e-5
DECODE_FORWARD_TOL = 2e-3
CONFIGS = sorted(JC.REGISTRY) + ["swa"]


def _cfgs(name):
    """Reduced configs of both packages; "swa" is mistral-nemo's reduced
    config with a 6-token window, so a short run wraps the ring."""
    if name == "swa":
        return (JC.with_sliding_window(JC.reduced(JC.get_config("mistral-nemo-12b")), 6),
                TC.with_sliding_window(TC.reduced(TC.get_config("mistral-nemo-12b")), 6))
    return JC.reduced(JC.get_config(name)), TC.reduced(TC.get_config(name))


@functools.cache
def _ref_params(name, seed=0):
    """The reference's float32 weights as a numpy tree (one draw a config
    per process; each test carries its own copy)."""
    jcfg, _ = _cfgs(name)
    return jax.tree.map(np.asarray, jax.jit(lambda k: jinit(jcfg, k, dtype=jnp.float32))(jax.random.PRNGKey(seed)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _tokens(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_matches_the_reference_on_a_carried_cache(name):
    """Three reference steps, the cache carried into the port, then both
    step by step to pos = 13 over a 10-deep cache: the logits at each step
    and every cache leaf at the end."""
    jcfg, tcfg = _cfgs(name)
    pnp = _ref_params(name)
    jp, tp = jax.tree.map(jnp.asarray, pnp), params_from_numpy(pnp, device="cpu")
    toks = _tokens(jcfg, 2, 14, seed=1)
    jstep = jax.jit(lambda p, c, t: jdecode(jcfg, p, c, t))
    jc = jinit_cache(jcfg, 2, 10, dtype=jnp.float32)
    for i in range(3):
        _, jc = jstep(jp, jc, jnp.asarray(toks[:, i : i + 1]))
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == () and int(tc["pos"]) == 3
    for i in range(3, 14):
        lj, jc = jstep(jp, jc, jnp.asarray(toks[:, i : i + 1]))
        lt, tc = tdecode(tcfg, tp, tc, torch.from_numpy(toks[:, i : i + 1]))
        assert lt.shape == (2, 1, jcfg.vocab_size)
        assert _rel(lj, lt.numpy()) <= LOGIT_RTOL, f"pos {i}"
    assert int(tc["pos"]) == int(jc["pos"]) == 14
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(jleaves) == len(tree_paths(tc))
    for (path, a), (tpath, b) in zip(jleaves, tree_paths(tc)):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), tpath
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5 * max(np.abs(a).max(), 1))


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_matches_forward_in_the_port(name):
    """Decoding a sequence token by token gives ``forward``'s logits at
    every position (the swa config past its 6-token window)."""
    _, cfg = _cfgs(name)
    tp = params_from_numpy(_ref_params(name), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 10, seed=2))
    full = tforward(cfg, tp, toks)
    cache = tinit_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    outs = []
    for i in range(10):
        logits, cache = tdecode(cfg, tp, cache, toks[:, i : i + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=DECODE_FORWARD_TOL, atol=DECODE_FORWARD_TOL)


def test_cache_slots_past_max_len_are_the_references():
    """Full attention past ``max_len`` writes slot ``pos % L`` (a ring);
    MLA writes the last slot again (the reference's clamped
    ``dynamic_update_slice``); both then attend to every slot."""
    for name, key, slot_of in (("qwen2.5-3b", "k", lambda pos, L: pos % L),
                               ("deepseek-v2-lite-16b", "ckv", lambda pos, L: min(pos, L - 1))):
        _, cfg = _cfgs(name)
        tp = params_from_numpy(_ref_params(name), device="cpu")
        cache = tinit_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
        toks = torch.from_numpy(_tokens(cfg, 1, 7, seed=3))
        for pos in range(7):
            before = cache["layers"][0][key].clone()
            _, cache = tdecode(cfg, tp, cache, toks[:, pos : pos + 1])
            changed = (cache["layers"][0][key] != before).flatten(3).any(-1)[0, 0]
            assert changed.nonzero().flatten().tolist() == [slot_of(pos, 4)], (name, pos)


def test_init_cache_is_the_references_tree():
    for name in CONFIGS:
        jcfg, tcfg = _cfgs(name)
        want = jax.eval_shape(lambda: jinit_cache(jcfg, 3, 12))
        got = tinit_cache(tcfg, 3, 12, device="cpu")
        jl = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(want)]
        tl = [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in tree_paths(got)]
        assert tl == jl, name
        assert all(not torch.any(t) for _, t in tree_paths(got))


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "jamba-1.5-large-398b", "llava-next-mistral-7b"])
def test_train_step_with_two_microbatches_matches_the_reference(name):
    """``make_train_step`` at M = 2 (batch 2, a microbatch a shard, remat)
    and one sgd step: the mean loss and every parameter after the step."""
    jcfg, tcfg = _cfgs(name)
    pnp = _ref_params(name)
    jp, tp = jax.tree.map(jnp.asarray, pnp), params_from_numpy(pnp, device="cpu")
    toks = _tokens(jcfg, 2, 16, seed=4)
    targs = np.roll(toks, -1, axis=1)
    prefix = (np.random.default_rng(4).standard_normal((2, 4, jcfg.d_model)).astype(np.float32)
              if jcfg.frontend == "vision" else None)
    jstep = jax.jit(jsteps.make_train_step(jcfg, _one_device_mesh(), opt=jsgd(0.5)))
    tstep = tsteps.make_train_step(tcfg, opt=tsgd(0.5))
    extra = () if prefix is None else (prefix,)
    jnew, _, jloss = jstep(jp, (), *(jnp.asarray(a) for a in (toks, targs) + extra))
    tnew, _, tloss = tstep(tp, (), *(torch.from_numpy(a) for a in (toks, targs) + extra))
    assert abs(float(jloss) - float(tloss)) <= LOSS_RTOL * abs(float(jloss))
    for (path, a), (_, b), (_, before) in zip(jax.tree_util.tree_flatten_with_path(jnew)[0], tree_paths(tnew),
                                              tree_paths(tp)):
        assert _rel(a, b.numpy()) <= PARAM_RTOL, path
    moved = [not torch.equal(b, before) for (_, b), (_, before) in zip(tree_paths(tnew), tree_paths(tp))]
    assert sum(moved) >= len(moved) - 1  # every leaf the loss reads moved


def test_train_step_keeps_float32_accumulators_for_float32_leaves():
    """A bf16 tree with ``grad_dtype=bf16``: the bf16 leaves' gradients
    reach the optimizer in bf16, ``router`` and ``A_log``'s (stored
    float32) in float32; the loss of two microbatches is their mean."""
    _, cfg = _cfgs("jamba-1.5-large-398b")
    tp = tinit(cfg, dtype=torch.bfloat16, device="cpu", seed=5)
    seen = {}

    def update(grads, state, params):
        seen.update({"/".join(map(str, path)): g.dtype for path, g in tree_paths(grads)})
        return params, state

    toks = torch.from_numpy(_tokens(cfg, 4, 8, seed=5))
    targs = torch.roll(toks, -1, 1)
    step = tsteps.make_train_step(cfg, opt=Optimizer(lambda p: (), update), microbatch_per_shard=2,
                                  grad_dtype=torch.bfloat16)
    _, _, loss = step(tp, (), toks, targs)
    assert seen["layers/1/router"] == seen["layers/1/A_log"] == torch.float32
    assert seen["layers/0/wq"] == seen["layers/1/w_up_e"] == seen["embed"] == torch.bfloat16
    halves = [float(tloss(cfg, tp, toks[i : i + 2], targs[i : i + 2])) for i in (0, 2)]
    assert abs(float(loss) - sum(halves) / 2) <= 1e-6 * abs(float(loss))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "falcon-mamba-7b"])
def test_prefill_and_serve_steps_match_the_reference(name):
    jcfg, tcfg = _cfgs(name)
    pnp = _ref_params(name)
    jp, tp = jax.tree.map(jnp.asarray, pnp), params_from_numpy(pnp, device="cpu")
    toks = _tokens(jcfg, 2, 12, seed=6)
    lj = jax.jit(jsteps.make_prefill_step(jcfg))(jp, jnp.asarray(toks))
    lt = tsteps.make_prefill_step(tcfg)(tp, torch.from_numpy(toks))
    assert lt.shape == (2, 1, jcfg.vocab_size) and not lt.requires_grad
    assert _rel(lj, lt.numpy()) <= LOGIT_RTOL
    jserve, tserve = jax.jit(jsteps.make_serve_step(jcfg)), tsteps.make_serve_step(tcfg)
    jc, tc = jinit_cache(jcfg, 2, 8, dtype=jnp.float32), tinit_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(4):
        lj, jc = jserve(jp, jc, jnp.asarray(toks[:, i : i + 1]))
        lt, tc = tserve(tp, tc, torch.from_numpy(toks[:, i : i + 1]))
        assert _rel(lj, lt.numpy()) <= LOGIT_RTOL


def test_steps_without_a_mesh_and_the_mesh_refusal():
    """Without a mesh the steps run on one device; a mesh's (pod × data)
    size is the reference's; a mesh needs a process group of its size, and
    one is refused, saying how to start it, without one."""
    from repro.compat import abstract_mesh
    from repro_torch.launch.mesh import make_mesh

    params = {"w": torch.ones(2)}
    assert tsteps.data_parallel_size() == 1 == jsteps.data_parallel_size(_one_device_mesh())
    assert tsteps.make_pod_sync_step()(params) is params
    for shape, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                        ((2, 4), ("pod", "data")), ((1, 8), ("data", "model"))):
        assert tsteps.data_parallel_size(dict(zip(axes, shape))) == jsteps.data_parallel_size(abstract_mesh(shape, axes))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node=4"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
