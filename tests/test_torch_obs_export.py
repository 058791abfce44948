"""Trace export of the port (``repro_torch.obs.export``) and its CLI
(``python -m repro_torch.launch.trace summarize``), modelled on the export
cases of the reference's tests/test_obs.py, including its mesh case: a
traced + timed mesh run is bitwise the untraced one, the phase probes
land as spans, and both export formats read back.

The formats are the reference's: each package loads the other's files
and prints the same table for them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import export as j_export
from repro.obs import trace as j_trace
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from test_torch_distributed import launch

ROOT = Path(__file__).resolve().parents[1]


def make_recorder(trace=obs_trace):
    rec = trace.TraceRecorder()
    with rec.span("round", name="rounds[0+2]", start_round=0):
        with rec.span("ckpt_save", name="swap-2"):
            pass
    rec.add_span("allreduce_gv", "probe:allreduce_gv", dur=0.5, calls_per_round=2)
    return rec


def test_chrome_trace_fields():
    rec = make_recorder()
    blob = obs_export.chrome_trace_dict(rec, metrics={"m": {"kind": "counter", "value": 1}})
    assert blob["schemaVersion"] == obs_export.TRACE_SCHEMA_VERSION == j_export.TRACE_SCHEMA_VERSION
    json.dumps(blob)
    xs = [e for e in blob["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in blob["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 3
    assert {e["name"] for e in ms} == {"process_name", "thread_name"}
    pid = ms[0]["pid"]
    for e in xs:
        assert e["cat"] in obs_trace.SPAN_CATEGORIES
        assert e["pid"] == pid and isinstance(e["tid"], int)
        assert e["dur"] >= 0.0 and e["ts"] >= 0.0 or e["cat"] == "allreduce_gv"
    probe = next(e for e in xs if e["cat"] == "allreduce_gv")
    assert probe["dur"] == pytest.approx(0.5e6)
    assert probe["args"]["calls_per_round"] == 2
    assert blob["otherData"]["metrics"]["m"]["value"] == 1
    assert blob["otherData"]["categories"] == list(obs_trace.SPAN_CATEGORIES)


def test_dict_keys_are_the_references():
    """Key for key the reference's forms, on the same spans."""
    ours, theirs = make_recorder(), make_recorder(j_trace)
    a, b = obs_export.chrome_trace_dict(ours), j_export.chrome_trace_dict(theirs)
    assert set(a) == set(b) and set(a["otherData"]) == set(b["otherData"])
    assert [sorted(e) for e in a["traceEvents"]] == [sorted(e) for e in b["traceEvents"]]
    assert [(e["ph"], e.get("cat"), e["name"]) for e in a["traceEvents"]] == [
        (e["ph"], e.get("cat"), e["name"]) for e in b["traceEvents"]]


def test_both_formats_round_trip(tmp_path):
    rec = make_recorder()
    cj = obs_export.write_chrome_trace(rec, tmp_path / "t.json")
    jl = obs_export.write_jsonl(rec, tmp_path / "t.jsonl")
    a, b = obs_export.load_trace(cj), obs_export.load_trace(jl)
    assert a["schemaVersion"] == b["schemaVersion"] == obs_export.TRACE_SCHEMA_VERSION
    assert len(a["spans"]) == len(b["spans"]) == len(rec.spans)
    for sa, sb, s in zip(a["spans"], b["spans"], rec.spans):
        assert sa["cat"] == sb["cat"] == s.category
        assert sa["name"] == sb["name"] == s.name
        assert sa["dur"] == pytest.approx(s.dur, abs=1e-9)
        assert sb["dur"] == pytest.approx(s.dur, abs=1e-12)


@pytest.mark.parametrize("writer", ["chrome", "jsonl"])
def test_each_package_loads_the_others_files(writer, tmp_path):
    ours, theirs = make_recorder(), make_recorder(j_trace)
    write = {"chrome": "write_chrome_trace", "jsonl": "write_jsonl"}[writer]
    suffix = {"chrome": ".json", "jsonl": ".jsonl"}[writer]
    p_ours = getattr(obs_export, write)(ours, tmp_path / f"ours{suffix}")
    p_theirs = getattr(j_export, write)(theirs, tmp_path / f"theirs{suffix}")
    for path in (p_ours, p_theirs):
        a, b = obs_export.load_trace(path), j_export.load_trace(path)
        assert a == b
        assert [s["cat"] for s in a["spans"]] == ["ckpt_save", "round", "allreduce_gv"]
    # the same table for the same file, whichever package prints it
    assert obs_export.summarize_text(p_theirs) == j_export.summarize_text(p_theirs)
    assert obs_export.summarize_text(p_ours) == j_export.summarize_text(p_ours)


def test_category_table_and_summary_line():
    rec = make_recorder()
    rows = obs_export.category_table(rec.spans)
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
    assert rows[0]["category"] == "allreduce_gv"
    assert rows[0]["count"] == 1
    line = obs_export.summary_line(rec)
    assert line.startswith("[trace] 3 spans over ")
    assert "allreduce_gv" in line and "%" in line
    assert rows == j_export.category_table(rec.spans)


def test_summarize_text(tmp_path):
    rec = make_recorder()
    path = obs_export.write_chrome_trace(rec, tmp_path / "t.json")
    text = obs_export.summarize_text(path)
    assert "schema v1" in text and "3 spans" in text
    assert "allreduce_gv" in text and "round" in text


def test_trace_cli(tmp_path):
    path = obs_export.write_jsonl(make_recorder(), tmp_path / "t.jsonl")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ok = subprocess.run([sys.executable, "-m", "repro_torch.launch.trace", "summarize", str(path)],
                        capture_output=True, text=True, env=env, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.strip() == obs_export.summarize_text(path)
    missing = subprocess.run([sys.executable, "-m", "repro_torch.launch.trace", "summarize",
                              str(tmp_path / "nope.json")], capture_output=True, text=True,
                             env=env, timeout=120)
    assert missing.returncode == 2 and "does not exist" in missing.stderr


MESH_BODY = """
from repro_torch.obs import export as obs_export, trace as obs_trace


def make():
    return ExperimentSpec(
        dataset="rcv1-sm",
        schedule=ParallelSGDSchedule.hybrid(p_r=2, s=2, b=4, eta=0.2, tau=4, rounds=4, loss_every=2),
        mesh=MeshSpec(p_r=2, p_c=2, backend="shard_map"),
        comm_timing=True,
    )


a = Session(make(), device="cpu")
while not a.done:
    a.step_rounds()
with obs_trace.install() as rec:
    b = Session(make(), device="cpu")
    while not b.done:
        b.step_rounds()
arrays["untraced.x"], arrays["traced.x"] = a.current_x(), b.current_x()
arrays["untraced.losses"] = np.asarray(a.losses, np.float32)
arrays["traced.losses"] = np.asarray(b.losses, np.float32)
info["categories"] = sorted(rec.by_category())
info["spans"] = len(rec.spans)
info["exposed_comm_s"] = b.ledger.exposed_comm_s
if rank == 0:
    obs_export.write_chrome_trace(rec, out / "t.json")
    obs_export.write_jsonl(rec, out / "t.jsonl")
"""


def test_mesh_traced_bitwise_probes_and_export(tmp_path):
    """The whole plane on a 2×2 mesh of gloo ranks: traced + timed ≡
    untraced bitwise, the phase probes populate the ledger and land as
    spans, and both exports read back in both packages."""
    runs = launch(tmp_path, 4, MESH_BODY)
    for arrays, info in runs:
        assert (arrays["traced.x"] == arrays["untraced.x"]).all(), "tracing changed numerics"
        assert (arrays["traced.losses"] == arrays["untraced.losses"]).all()
        want = {"compile", "round", "bundle_compute", "allreduce_gv", "param_avg"}
        assert want <= set(info["categories"]), info["categories"]
        assert info["exposed_comm_s"] is not None and info["exposed_comm_s"] >= 0.0
        assert (arrays["traced.x"] == runs[0][0]["traced.x"]).all()
    spans = runs[0][1]["spans"]
    for path in (tmp_path / "t.json", tmp_path / "t.jsonl"):
        for loader in (obs_export.load_trace, j_export.load_trace):
            blob = loader(path)
            assert blob["schemaVersion"] == 1
            assert len(blob["spans"]) == spans
        assert obs_export.summarize_text(path) == j_export.summarize_text(path)
