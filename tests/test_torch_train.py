"""The port's NN trainer against the reference's: the token stream
(``repro_torch.train.data``, bitwise), the optimizers
(``repro_torch.optim``), the single-device loop (``repro_torch.train.loop``)
and its pytree checkpoints, which cross between the packages both ways.

Tolerances: optimizer updates on the same numpy gradients rtol 1e-6
(float32 elementwise math in the same order, measured ≤ 1e-7); trainer loss
traces on the reference's weights, carried, rtol 1e-5 under sgd and
momentum (measured ≤ 1.5e-7 over 6 steps) and 1e-4 under adamw (measured
7e-7: its first steps move each weight by ≈ lr·sign(g), so a gradient
entry near zero whose sign differs by rounding moves that weight by 2·lr).
Resume ≡ uninterrupted is bitwise on the CPU.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.optim as jopt
import repro_torch.configs as TC
from repro.models.init import init_params as jinit
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train.loop import train as jtrain
from repro_torch import optim as topt
from repro_torch._tree import tree_map, tree_paths
from repro_torch.models import init_params as tinit
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.train import checkpoint as tck
from repro_torch.train import data as tdata
from repro_torch.train.loop import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
TRACE_RTOL = {"sgd": 1e-5, "momentum": 1e-5, "adamw": 1e-4}


# ---- the token stream ----


@pytest.mark.parametrize("vocab,seed,batch,seq", [(64, 0, 4, 8), (256, 3, 2, 32), (2048, 7, 8, 16), (151936, 0, 1, 4)])
def test_markov_stream_is_bitwise_the_references(vocab, seed, batch, seq):
    js, ts = jdata.MarkovTextStream(vocab, seed=seed), tdata.MarkovTextStream(vocab, seed=seed)
    assert np.array_equal(js.succ, ts.succ) and np.array_equal(js.succ_p, ts.succ_p)
    for start in (0, 2):
        ji, ti = js.batches(batch, seq, start_seed=start), ts.batches(batch, seq, start_seed=start)
        for _ in range(3):
            (a, b), (c, d) = next(ji), next(ti)
            assert a.dtype == c.dtype == np.int32
            assert np.array_equal(a, c) and np.array_equal(b, d)
    jm = jdata.MarkovTextStream(vocab, seed=seed, batch=batch, seq_len=seq)
    tm = tdata.MarkovTextStream(vocab, seed=seed, batch=batch, seq_len=seq)
    for x, y in zip((b for b, _ in zip(jm.micro_batches(1), range(3))), (b for b, _ in zip(tm.micro_batches(1), range(3)))):
        assert x.index == y.index and np.array_equal(x.tokens, y.tokens) and np.array_equal(x.targets, y.targets)
    if vocab <= 2048:
        assert tdata.bigram_entropy_floor(ts) == jdata.bigram_entropy_floor(js)


def test_markov_stream_micro_batches_replay():
    st = tdata.MarkovTextStream(vocab_size=64, seed=5, batch=4, seq_len=8)
    full = [b for b, _ in zip(st.micro_batches(0), range(8))]
    tail = [b for b, _ in zip(st.micro_batches(5), range(3))]
    assert [b.index for b in full] == list(range(8))
    for got, want in zip(tail, full[5:]):
        assert isinstance(got, tdata.TokenMicroBatch)
        assert got.index == want.index and got.rows == 4
        assert np.array_equal(got.tokens, want.tokens)
        assert np.array_equal(got.targets, want.targets)


def test_markov_batches_api_unchanged():
    st = tdata.MarkovTextStream(vocab_size=32, seed=1)
    toks, targs = next(st.batches(4, 16))
    assert toks.shape == targs.shape == (4, 16)
    assert np.array_equal(toks[:, 1:], targs[:, :-1])


def test_bigram_entropy_floor_sampling_cap():
    st = tdata.MarkovTextStream(vocab_size=128, seed=3)
    sampled = tdata.bigram_entropy_floor(st)
    exact = tdata.bigram_entropy_floor(st, sample_states=None)
    assert sampled == tdata.bigram_entropy_floor(st, sample_states=64)
    assert abs(sampled - exact) < 0.1 * max(exact, 1e-9)
    small = tdata.MarkovTextStream(vocab_size=16, seed=3)
    assert tdata.bigram_entropy_floor(small) == tdata.bigram_entropy_floor(small, sample_states=None)
    with pytest.raises(ValueError):
        tdata.bigram_entropy_floor(st, sample_states=0)
    assert tdata.bigram_entropy_floor(tdata.MarkovTextStream(256, seed=3)) < 0.8 * np.log(256)


# ---- the optimizers ----


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "layers": ({"w": (rng.standard_normal((2, 5, 3)) * scale).astype(np.float32)},
                       {"w": (rng.standard_normal((2, 7)) * scale).astype(np.float32)})}


@pytest.mark.parametrize("name,kw", [("sgd", dict(lr=0.1)), ("momentum", dict(lr=0.05, beta=0.8)),
                                     ("adamw", dict(lr=1e-2)), ("adamw", dict(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, wd=0.1))],
                         ids=["sgd", "momentum", "adamw", "adamw-wd"])
def test_optimizer_updates_match_the_reference(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 1e-2) for _ in range(4)]
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(params_from_numpy(g, device="cpu"), ts, tp)
    for (path, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, jp)), tree_paths(tp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=OPT_RTOL, atol=1e-7, err_msg=str(path))
    # the state has the reference's layout, leaf for leaf
    jstate = {"/".join(map(str, p)): np.asarray(v) for p, v in tree_paths(jax.tree.map(np.asarray, js))}
    tstate = {"/".join(map(str, p)): v for p, v in tree_paths(ts)}
    assert sorted(jstate) == sorted(tstate)
    for k in jstate:
        assert tstate[k].dtype == torch.from_numpy(np.array(jstate[k])).dtype, k
        np.testing.assert_allclose(tstate[k].numpy(), jstate[k], rtol=OPT_RTOL, atol=1e-7, err_msg=k)


def test_optimizer_does_not_change_its_inputs():
    rng = np.random.default_rng(1)
    tp, g = params_from_numpy(_tree(rng), device="cpu"), params_from_numpy(_tree(rng), device="cpu")
    before = tree_map(torch.clone, tp)
    opt = topt.adamw(1e-2)
    new, state = opt.update(g, opt.init(tp), tp)
    for (_, a), (_, b), (_, c) in zip(tree_paths(before), tree_paths(tp), tree_paths(new)):
        assert torch.equal(a, b) and not torch.equal(b, c)
    assert int(state["t"]) == 1 and state["t"].dtype == torch.int32


# ---- the trainer ----


def _carried(arch, seed=0):
    jcfg = JC.reduced(JC.get_config(arch))
    tcfg = TC.reduced(TC.get_config(arch))
    return jcfg, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)), device="cpu")


@pytest.mark.parametrize("name,lr", [("sgd", 0.5), ("momentum", 0.2), ("adamw", 3e-3)])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b"])
def test_trainer_loss_trace_matches_the_reference(arch, name, lr):
    """From the reference's seed-0 weights (carried) on the same stream,
    each step's loss equals the reference trainer's."""
    jcfg, tcfg, params = _carried(arch)
    jr = jtrain(jcfg, steps=6, batch=2, seq_len=16, log_every=1, opt=getattr(jopt, name)(lr))
    tr = ttrain(tcfg, steps=6, batch=2, seq_len=16, log_every=1, opt=getattr(topt, name)(lr),
                params=params, device="cpu")
    assert tr.steps == jr.steps == 6 and len(tr.losses) == len(jr.losses) == 6
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=TRACE_RTOL[name], atol=0)
    assert tr.tokens_per_s > 0


def test_a_train_step_frees_the_previous_state_at_once():
    """A step leaves no reference cycle behind: the replaced parameters
    and the gradients are freed when the step returns, not when the cyclic
    garbage collector next runs (a cycle there ran an 80 GB card out of
    memory within 20 steps of qwen2.5-3b at its published width)."""
    import gc

    from repro_torch.train.loop import make_train_step

    cfg = TC.reduced(TC.get_config("qwen2.5-3b"))
    params = tinit(cfg, dtype=torch.float32, device="cpu")
    opt = topt.adamw(1e-3)
    step = make_train_step(cfg, opt)
    toks, targs = next(tdata.MarkovTextStream(cfg.vocab_size, seed=0).batches(2, 8))
    batch_ = (torch.from_numpy(toks), torch.from_numpy(targs))
    state, _ = step((params, opt.init(params)), batch_)
    del params
    gc.collect()
    gc.disable()
    try:
        state, _ = step(state, batch_)
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_train_loop_loss_decreases():
    cfg = TC.reduced(TC.get_config("qwen2.5-3b"))
    report = ttrain(cfg, steps=30, batch=4, seq_len=32, log_every=10, device="cpu")
    assert len(report.losses) >= 3
    assert report.losses[-1] < report.losses[0]


def _ckpt_tree(path):
    data = np.load(pathlib.Path(path).with_suffix(".npz"))
    return {k: data[k] for k in data.files}


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    cfg = TC.reduced(TC.get_config("gemma-2b"))
    whole = ttrain(cfg, steps=10, batch=2, seq_len=16, checkpoint_dir=str(tmp_path / "a"),
                   checkpoint_every=5, log_every=1, device="cpu")
    first = ttrain(cfg, steps=5, batch=2, seq_len=16, checkpoint_dir=str(tmp_path / "b"),
                   checkpoint_every=5, log_every=1, device="cpu")
    rest = ttrain(cfg, steps=10, batch=2, seq_len=16, checkpoint_dir=str(tmp_path / "b"),
                  checkpoint_every=5, log_every=1, device="cpu")
    assert first.losses + rest.losses == whole.losses
    a, b = _ckpt_tree(tmp_path / "a" / "ckpt"), _ckpt_tree(tmp_path / "b" / "ckpt")
    assert sorted(a) == sorted(b) and "1/t" in a and "0/layers/0/wq" in a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(a["1/t"]) == 10


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port's trainer state read by the reference's
    ``restore_checkpoint``, and the reference's read by the port's."""
    cfg = TC.reduced(TC.get_config("llava-next-mistral-7b"))
    params = tinit(cfg, dtype=torch.float32, device="cpu", seed=2)
    opt = topt.adamw(1e-3)
    state = (params, opt.init(params))
    tck.save_checkpoint(tmp_path / "port", state, step=7)
    like = jax.tree.map(jnp.asarray, (params_to_numpy(params),
                                      {"mu": params_to_numpy(params), "nu": params_to_numpy(params),
                                       "t": np.zeros((), np.int32)}))
    restored, step = jck.restore_checkpoint(tmp_path / "port", like)
    assert step == 7
    for (p, a), (_, b) in zip(tree_paths(jax.tree.map(np.asarray, restored)), tree_paths(state)):
        assert np.array_equal(a, b.numpy()), p
    # the other way: a reference trainer checkpoint restores in the port
    jcfg = JC.reduced(JC.get_config("llava-next-mistral-7b"))
    jparams = jinit(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jstate = (jparams, jopt.momentum(0.1).init(jparams))
    jck.save_checkpoint(tmp_path / "ref", jstate, step=3)
    mom = topt.momentum(0.1)
    got, step = tck.restore_checkpoint(tmp_path / "ref", (params, mom.init(params)))
    assert step == 3
    for (p, a), (q, b) in zip(tree_paths(jax.tree.map(np.asarray, jstate)), tree_paths(got)):
        assert p == q and b.dtype == torch.float32 and np.array_equal(a, b.numpy()), p


def test_checkpoint_roundtrip_and_missing(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)},
            "tup": (torch.zeros((2,)), torch.full((1,), 7.0))}
    tck.save_checkpoint(tmp_path / "ckpt", tree, step=42)
    restored, step = tck.restore_checkpoint(tmp_path / "ckpt", tree)
    assert step == 42
    for (_, a), (_, b) in zip(tree_paths(tree), tree_paths(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert tck.restore_checkpoint(tmp_path / "nope", {"a": torch.zeros(1)}) == (None, 0)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore_checkpoint(tmp_path / "ckpt", {**tree, "a": torch.zeros(3)})
    (tmp_path / "ckpt.npz").write_bytes(b"garbage")
    with pytest.raises(tck.CheckpointCorruptError):
        tck.restore_checkpoint(tmp_path / "ckpt", tree)


def test_trainer_refuses_a_mesh_and_multi_pod_schedules():
    from repro_torch.core.engine import ParallelSGDSchedule

    cfg = TC.reduced(TC.get_config("qwen2.5-3b"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrain(cfg, steps=1, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="p_r"):
        ttrain(cfg, steps=1, device="cpu", schedule=ParallelSGDSchedule.hybrid(2, 1, 2, 0.1, 4, rounds=1))
    rep = ttrain(cfg, steps=2, batch=1, seq_len=8, device="cpu", schedule=ParallelSGDSchedule.hybrid(1, 1, 2, 0.1, 4, rounds=1))
    assert rep.steps == 2 and len(rep.losses) == 1


def test_train_cli_on_the_cpu_and_refusals():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma-2b", "--device", "cpu",
                          "--steps", "4", "--batch", "2", "--seq-len", "8"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=gemma-2b-smoke steps=4 tokens/s=") and lines[1].startswith("losses: ")
    assert len(lines[1].split()) == 2  # log_every=10: the last step only
    refused = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma-2b", "--device", "cpu",
                              "--mesh", "2x2:data,model"], capture_output=True, text=True, timeout=120, env=env)
    assert refused.returncode != 0 and "torchrun --nproc-per-node=4" in refused.stderr
    nocard = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma-2b", "--steps", "1"],
                            capture_output=True, text=True, timeout=120, env=env)
    assert nocard.returncode != 0 and "CUDA" in nocard.stderr
