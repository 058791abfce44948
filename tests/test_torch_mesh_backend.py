"""The model mesh's backend rules, on the CPU with the CUDA queries and the
process group stubbed where a card or a group would be needed:

* ``launch/train._mesh`` joins NCCL for a CUDA device (and makes the rank's
  card current), gloo for ``--device cpu`` or when ``--backend`` says so;
* ``resolve_device`` gives rank r the card ``cuda:(r % device_count)``;
* ``launch/mesh`` registers the plain c10d all-gather only on a gloo mesh
  (``plain_all_gather_needed``): NCCL runs DTensor's functional all-gather;
* ``roofline.count_collectives`` counts DTensor's own all-to-all
  (``_dtensor::shard_dim_alltoall``, what a Shard(i) → Shard(j)
  redistribute issues on a CUDA mesh) as torch's ``CommDebugMode`` does;
* ``chip_smoke.py``'s model_mesh helpers: its note names the backend,
  ``deferred_checks`` keeps every failure of a part, ``_torch_kinds`` maps
  torch's counts to the dry run's kinds.
"""

import importlib.util
import pathlib
import tempfile

import pytest
import torch
import torch.distributed as dist

import repro_torch._device as device_mod
import repro_torch.launch.mesh as mesh_mod
import repro_torch.launch.train as train_cli
from repro_torch.launch.roofline import count_collectives

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh_backend", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Group:
    """Stands in for ``torch.distributed``'s default group: joined by the
    stubbed ``init_process_group``, which records its arguments."""

    def __init__(self, rank: int):
        self.rank, self.joined, self.cards = rank, [], []

    def install(self, monkeypatch, cuda: bool, count: int = 4):
        monkeypatch.setattr(dist, "is_initialized", lambda: bool(self.joined))
        monkeypatch.setattr(dist, "get_rank", lambda group=None: self.rank)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: self.joined.append((backend, kw)))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.cuda, "set_device", lambda d: self.cards.append(torch.device(d)))
        monkeypatch.setattr(train_cli, "make_mesh", lambda shape, axes, device=None: ("mesh", shape, axes, device))


@pytest.mark.parametrize("device, backend, want, card", [
    (None, None, "nccl", "cuda:2"),
    ("cuda", None, "nccl", "cuda:2"),
    ("cuda:3", None, "nccl", "cuda:3"),
    ("cpu", None, "gloo", None),
    (None, "gloo", "gloo", None),
])
def test_the_launcher_joins_nccl_on_the_card_and_gloo_on_the_cpu(monkeypatch, device, backend, want, card):
    group = _Group(rank=6)
    group.install(monkeypatch, cuda=device != "cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "6")
    mesh = train_cli._mesh("2x2x2:pod,data,model", device, backend, "env://")
    assert mesh == ("mesh", (2, 2, 2), ("pod", "data", "model"), device)
    assert group.joined == [(want, {"init_method": "env://"})]
    # NCCL: rank 6 of 8 on a host of 4 cards takes cuda:2 (or the card it names) before the mesh is built
    assert group.cards == ([torch.device(card)] if card else [])


def test_the_launcher_passes_rank_and_world_to_a_file_store(monkeypatch):
    group = _Group(rank=1)
    group.install(monkeypatch, cuda=True)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    train_cli._mesh("2x2:data,model", None, None, "file:///tmp/store")
    assert group.joined == [("nccl", {"init_method": "file:///tmp/store", "rank": 1, "world_size": 4})]
    assert group.cards == [torch.device("cuda:1")]


def test_the_launcher_joins_no_group_without_a_launcher_or_when_one_exists(monkeypatch):
    group = _Group(rank=0)
    group.install(monkeypatch, cuda=True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    train_cli._mesh("2x2:data,model", None, None, "env://")  # make_mesh then refuses, saying how
    assert group.joined == [] and group.cards == []
    monkeypatch.setenv("WORLD_SIZE", "4")
    group.joined.append(("nccl", {}))  # already joined
    train_cli._mesh("2x2:data,model", None, None, "env://")
    assert len(group.joined) == 1 and group.cards == []


@pytest.mark.parametrize("rank", range(8))
@pytest.mark.parametrize("count", [1, 2, 4])
def test_resolve_device_gives_rank_r_the_card_r_mod_count(monkeypatch, rank, count):
    group = _Group(rank)
    group.install(monkeypatch, cuda=True, count=count)
    group.joined.append(("nccl", {}))
    assert device_mod.resolve_device(None) == torch.device("cuda", rank % count)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_outside_a_group_and_without_a_card(monkeypatch):
    group = _Group(0)
    group.install(monkeypatch, cuda=True)
    assert device_mod.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device(None)


@pytest.mark.parametrize("backend, needed", [
    ("gloo", True), ("nccl", False), ("fake", False), ("cpu:gloo,cuda:nccl", True), (dist.Backend.GLOO, True),
    (dist.Backend.NCCL, False),
])
def test_the_plain_all_gather_is_the_rule_only_on_gloo(backend, needed):
    assert mesh_mod.plain_all_gather_needed(backend) is needed


@pytest.mark.parametrize("backend, registered", [("gloo", True), ("nccl", False), ("fake", False)])
def test_make_mesh_registers_the_plain_all_gather_by_the_rule(monkeypatch, backend, registered):
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(mesh_mod, "DeviceMesh", lambda device_type, ranks, mesh_dim_names: (device_type, mesh_dim_names))
    monkeypatch.setattr(mesh_mod, "_use_plain_all_gather", lambda: calls.append(backend))
    monkeypatch.setattr(mesh_mod, "_MESHES", {})
    assert mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu") == ("cpu", ("data", "model"))
    assert calls == ([backend] if registered else [])


@pytest.fixture
def world_of_one():
    """A world-size-1 gloo group in this process, destroyed after the test."""
    assert not dist.is_initialized(), "a process group is already initialized in this process"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("shape, gather_dim, shard_dim", [((2, 4), 0, 1), ((3, 5, 6), 1, 2), ((8, 2), 1, 0)])
def test_count_collectives_counts_dtensors_all_to_all(world_of_one, shape, gather_dim, shard_dim):
    from torch.distributed.tensor.debug import CommDebugMode

    x = torch.arange(torch.Size(shape).numel(), dtype=torch.float32).reshape(shape)
    log = []
    with CommDebugMode() as torch_counted, count_collectives(log) as stats:
        out = torch.ops._dtensor.shard_dim_alltoall(x, gather_dim, shard_dim, world_of_one.group_name)
    assert torch.equal(out, x)  # one rank: the exchange gives each block back
    assert {k: v for k, v in stats.count_by_kind.items() if v} == {"all-to-all": 1}
    assert log == [("all-to-all", out.numel() * out.element_size())]
    assert sum(torch_counted.get_comm_counts().values()) == 1


def test_count_collectives_agrees_with_commdebugmode_on_a_gloo_mesh(world_of_one):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.debug import CommDebugMode

    from torch.distributed.device_mesh import DeviceMesh

    cs = _chip_smoke()
    # a DeviceMesh of its own: make_mesh would install gloo's plain all-gather in this process
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
    x = torch.randn(4, 6)
    with CommDebugMode() as torch_counted, count_collectives() as stats:
        funcol.all_gather_tensor(x, 0, (mesh, 0)).wait()
        funcol.all_reduce(x, "sum", (mesh, 1)).wait()
        torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, mesh.get_group(1).group_name)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.get_group(0))
    assert cs._torch_kinds(torch_counted) == {k: v for k, v in stats.count_by_kind.items() if v} == {
        "all-gather": 1, "all-reduce": 1, "all-to-all": 2}


def test_the_model_mesh_note_names_the_backend():
    cs = _chip_smoke()
    assert "gloo moves each CUDA tensor through the host" in cs._mm_note("gloo")
    assert cs._mm_note("nccl").startswith("nccl, one card a rank") and "gloo" not in cs._mm_note("nccl")


def test_deferred_checks_keep_every_failure_and_restore_check():
    cs = _chip_smoke()
    real = cs.check
    with cs.deferred_checks() as failed:
        cs.check(True, "holds")
        cs.check(False, "first")
        cs.check(False, "second")
    assert failed == ["first", "second"] and cs.check is real
    with cs.deferred_checks() as failed:
        cs.check(False, "before")
        raise KeyError("decode")
    assert failed[0] == "before" and "KeyError" in failed[1] and cs.check is real
    with pytest.raises(SystemExit, match="FAILED — outside"):
        cs.check(False, "outside")


def test_the_ranks_timeout_is_shorter_on_nccl():
    cs = _chip_smoke()
    assert set(cs.MM_TIMEOUT_S) == {"gloo", "nccl"} and cs.MM_TIMEOUT_S["nccl"] < cs.MM_TIMEOUT_S["gloo"]


def test_the_dry_runs_step_counter_counts_dtensors_all_to_all(world_of_one):
    """The dry run counts a step's collectives with ``StepCounter``, which
    must route DTensor's all-to-all to the collective count (not to FLOPs
    and HBM bytes), as a real step's ``count_collectives`` counts it."""
    from repro_torch.launch.dryrun import StepCounter

    x = torch.randn(4, 6)
    with StepCounter() as counter:
        out = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, world_of_one.group_name)
        y = out * 2
    assert {k: v for k, v in counter.stats.count_by_kind.items() if v} == {"all-to-all": 1}
    assert counter.stats.bytes_by_kind["all-to-all"] == out.numel() * out.element_size()
    # only the multiply's operands and result are HBM traffic
    assert counter.hbm_bytes == 2 * y.numel() * y.element_size()
