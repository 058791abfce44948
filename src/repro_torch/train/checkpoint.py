"""Session checkpoints: the ``repro_torch.api.Session`` lifecycle's
on-disk format.

The solver carry (weights, loss trace) goes into an .npz and a JSON
manifest holds the full spec dict, its content hash, and the round
counter. The hash keys the checkpoint: restoring under a spec whose
``content_hash()`` differs is a hard ``SpecMismatchError`` — a
checkpoint is only ever resumed into the exact experiment that wrote it
(elastic resume is an explicit, separate door:
``Session.restore_elastic``).

The format (``"repro-session-v1"``, an .npz + .json pair, the manifest's
self-hash and the payload's sha256) is the reference package's, byte for
byte: a checkpoint written by either package loads in the other. The
weights cross as numpy arrays.

The NN trainer's pytree checkpoints (``save_checkpoint`` /
``restore_checkpoint``) are the reference's format too: the same .npz +
.json pair under the same atomic write, each leaf under its path key
(``0/layers/0/wq``) with its stacked shape, so a trainer checkpoint
crosses between the packages both ways.

Durability contract:

* writes are atomic — both files land via write-to-temp + rename, and
  a failure anywhere in the write phase (including an injected fault in
  the ``repro_torch.core.faults`` "commit" window) leaves the
  destination untouched and no temp files behind;
* the manifest carries a sha256 of the payload and of itself, so a
  truncated/torn .npz, a flipped byte, or a crash between the two
  renames is *detected* on load — every corruption path raises a typed
  ``CheckpointCorruptError`` naming the offending file, never a raw
  zipfile/JSON traceback (checkpoints written before the hashes existed
  still load; they just skip the integrity check).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch._tree import path_key, tree_paths, tree_replace_leaves
from repro_torch.core import faults
from repro_torch.obs import trace as obs_trace


class SpecMismatchError(ValueError):
    """A session checkpoint was opened under a different spec."""


class CheckpointCorruptError(ValueError):
    """A checkpoint on disk is unreadable or inconsistent — truncated
    payload, garbled/missing manifest, failed integrity hash, or the
    leftovers of an interrupted save."""


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_digest(manifest: dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "manifest_sha256"}
    payload = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _write_atomic(path: Path, npz_payload: dict, manifest: dict) -> None:
    """Commit (payload, manifest) under ``path`` (.npz/.json pair).

    Temps first, then two renames. The window between the renames is
    irreducible with two files, but never silent: the manifest's
    ``npz_sha256`` won't match a payload from a different save, so a
    crash there reads back as ``CheckpointCorruptError``, not as a
    plausible-but-wrong checkpoint. Any failure before the first rename
    (the ``faults`` "commit" site sits there) leaves the previous
    checkpoint intact and no temp files."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp_npz = path.with_suffix(".tmp.npz")
    tmp_json = path.with_suffix(".tmp.json")
    try:
        np.savez(tmp_npz, **npz_payload)
        manifest = dict(manifest)
        manifest["npz_sha256"] = _sha256_file(tmp_npz)
        manifest["manifest_sha256"] = _manifest_digest(manifest)
        tmp_json.write_text(json.dumps(manifest))
        faults.poke("commit", at=int(manifest.get("rounds_done", 0)), path=tmp_npz)
        os.replace(tmp_npz, path.with_suffix(".npz"))
        os.replace(tmp_json, path.with_suffix(".json"))
    except BaseException:
        tmp_npz.unlink(missing_ok=True)
        tmp_json.unlink(missing_ok=True)
        raise


def _read_manifest(manifest_path: Path, npz_path: Path) -> dict:
    """Parse + integrity-check a checkpoint manifest; verify the payload
    hash when the manifest carries one."""
    try:
        meta = json.loads(manifest_path.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{manifest_path}: garbled checkpoint manifest ({e})"
        ) from e
    if not isinstance(meta, dict):
        raise CheckpointCorruptError(
            f"{manifest_path}: checkpoint manifest is not an object"
        )
    stored = meta.get("manifest_sha256")
    if stored is not None and _manifest_digest(meta) != stored:
        raise CheckpointCorruptError(
            f"{manifest_path}: manifest integrity hash mismatch — the manifest "
            f"was modified after it was written"
        )
    expected = meta.get("npz_sha256")
    if expected is not None:
        actual = _sha256_file(npz_path)
        if actual != expected:
            raise CheckpointCorruptError(
                f"{npz_path}: payload integrity hash mismatch (truncated or torn "
                f"write, or a manifest from a different save)"
            )
    return meta


def _load_npz(npz_path: Path):
    try:
        return np.load(npz_path)
    except Exception as e:  # zipfile/pickle/OS errors — never surfaced raw
        raise CheckpointCorruptError(
            f"{npz_path}: unreadable checkpoint payload ({e})"
        ) from e


def _require_pair(path: Path) -> tuple[Path, Path]:
    """Resolve the (.npz, .json) pair; distinguish 'never written'
    (FileNotFoundError) from 'a save was interrupted here'
    (CheckpointCorruptError: half a pair, or only .tmp.* leftovers)."""
    path = Path(path)
    npz, manifest = path.with_suffix(".npz"), path.with_suffix(".json")
    if npz.exists() and manifest.exists():
        return npz, manifest
    stale = [p for p in (path.with_suffix(".tmp.npz"), path.with_suffix(".tmp.json"))
             if p.exists()]
    partial = [p for p in (npz, manifest) if p.exists()]
    if partial or stale:
        found = ", ".join(str(p) for p in partial + stale)
        raise CheckpointCorruptError(
            f"{path}: interrupted save — found {found} but no complete "
            f"checkpoint pair"
        )
    raise FileNotFoundError(f"no session checkpoint at {path}(.npz/.json)")


def _first_spec_diff(ck: dict, ours: dict, prefix: str = "") -> str | None:
    """First differing field between two spec dicts, depth-first in key
    order — the human-readable half of a SpecMismatchError."""
    for key in sorted(set(ck) | set(ours)):
        a, b = ck.get(key, "<absent>"), ours.get(key, "<absent>")
        if isinstance(a, dict) and isinstance(b, dict):
            sub = _first_spec_diff(a, b, prefix=f"{prefix}{key}.")
            if sub is not None:
                return sub
        elif a != b:
            return f"{prefix}{key}: checkpoint has {a!r}, session has {b!r}"
    return None


# ---------------- pytree checkpoints (NN training loop) ----------------


def _flatten(tree) -> dict[str, np.ndarray]:
    """Each leaf of a tree (nested dicts and tuples of tensors or arrays)
    as a host array under its path key — the reference's key strings
    (``0/layers/0/wq``) and stacked shapes. bf16 leaves widen to float32."""
    flat = {}
    for path, leaf in tree_paths(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to("cpu")
            leaf = (leaf.to(torch.float32) if leaf.dtype == torch.bfloat16 else leaf).numpy()
        flat[path_key(path)] = np.asarray(leaf)
    return flat


def save_checkpoint(path: str | os.PathLike, tree, step: int) -> None:
    """The trainer's state (a tree) at ``step`` as an .npz + .json pair,
    written atomically, readable by the reference's
    ``restore_checkpoint`` and the other way round."""
    flat = _flatten(tree)
    _write_atomic(Path(path), flat, {"step": step, "keys": sorted(flat)})


def restore_checkpoint(path: str | os.PathLike, tree_like):
    """Restore into the structure of ``tree_like``; returns (tree, step)
    or (None, 0) if absent. Each leaf takes the dtype and device of the
    ``tree_like`` leaf in its place (a tensor, or a numpy array).
    Corruption (truncated npz, garbled manifest) raises
    ``CheckpointCorruptError``, never a raw traceback."""
    path = Path(path)
    npz, manifest = path.with_suffix(".npz"), path.with_suffix(".json")
    if not npz.exists() or not manifest.exists():
        return None, 0
    meta = _read_manifest(manifest, npz)
    data = _load_npz(npz)
    new_leaves = []
    for path_elems, leaf in tree_paths(tree_like):
        key = path_key(path_elems)
        try:
            arr = data[key]
        except KeyError as e:
            raise CheckpointCorruptError(
                f"{npz}: checkpoint payload is missing key {key!r}"
            ) from e
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            new_leaves.append(torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype))
        else:
            new_leaves.append(arr.astype(np.asarray(leaf).dtype))
    return tree_replace_leaves(tree_like, new_leaves), meta["step"]


# ---------------- session checkpoints (repro_torch.api.Session) ----------------

_SESSION_FORMAT = "repro-session-v1"


@dataclasses.dataclass
class SessionCheckpoint:
    """One saved ``Session`` carry — everything needed to fast-forward a
    freshly built session to the interrupted round."""

    spec_dict: dict
    spec_hash: str
    rounds_done: int
    x: np.ndarray
    losses: np.ndarray
    wall_time_s: float
    compile_time_s: float


def save_session_checkpoint(
    path: str | os.PathLike,
    *,
    spec_dict: dict,
    spec_hash: str,
    rounds_done: int,
    x: np.ndarray,
    losses: np.ndarray,
    wall_time_s: float,
    compile_time_s: float,
) -> None:
    manifest = {
        "format": _SESSION_FORMAT,
        "spec": spec_dict,
        "spec_hash": spec_hash,
        "rounds_done": int(rounds_done),
        "wall_time_s": float(wall_time_s),
        "compile_time_s": float(compile_time_s),
    }
    payload = {
        "x": np.asarray(x),
        "losses": np.asarray(losses, np.float32),
    }
    path = Path(path)
    with obs_trace.span("ckpt_save", name=path.name, rounds_done=int(rounds_done)):
        _write_atomic(path, payload, manifest)
    # chaos seam: a "save"-site ckpt_truncate tears the durable payload
    # here — the integrity hash must catch it on the next restore.
    faults.poke("save", at=int(rounds_done), path=path.with_suffix(".npz"))


def load_session_checkpoint(
    path: str | os.PathLike,
    expect_spec_hash: str | None = None,
    expect_spec_dict: dict | None = None,
) -> SessionCheckpoint:
    """Load a session checkpoint; with ``expect_spec_hash``, refuse
    (``SpecMismatchError``) if the checkpoint was written under a
    different spec. ``expect_spec_dict`` (the expecting spec's
    ``to_dict()``) upgrades that error from bare hashes to the first
    differing spec field."""
    path = Path(path)
    with obs_trace.span("ckpt_verify", name=path.name):
        npz, manifest = _require_pair(path)
        meta = _read_manifest(manifest, npz)
    if meta.get("format") != _SESSION_FORMAT:
        raise CheckpointCorruptError(
            f"{path}: not a session checkpoint (format={meta.get('format')!r})"
        )
    if expect_spec_hash is not None and meta.get("spec_hash") != expect_spec_hash:
        detail = ""
        if expect_spec_dict is not None and isinstance(meta.get("spec"), dict):
            diff = _first_spec_diff(meta["spec"], expect_spec_dict)
            detail = (
                f"; first differing field — {diff}"
                if diff is not None
                else "; spec fields agree — the hash inputs drifted"
            )
        raise SpecMismatchError(
            f"{path}: checkpoint was written under spec hash "
            f"{meta.get('spec_hash')} but the session's spec hashes to "
            f"{expect_spec_hash}{detail} — a checkpoint only resumes into the "
            f"exact spec that wrote it (use Session.restore_elastic to re-shape "
            f"a run deliberately)"
        )
    data = _load_npz(npz)
    try:
        x, losses = data["x"], data["losses"]
        return SessionCheckpoint(
            spec_dict=meta["spec"],
            spec_hash=meta["spec_hash"],
            rounds_done=int(meta["rounds_done"]),
            x=x,
            losses=losses,
            wall_time_s=float(meta["wall_time_s"]),
            compile_time_s=float(meta["compile_time_s"]),
        )
    except KeyError as e:
        raise CheckpointCorruptError(
            f"{path}: checkpoint is missing field {e.args[0]!r}"
        ) from e


def load_model_weights(path: str | os.PathLike) -> tuple[np.ndarray, dict]:
    """Swap-safe read of a session checkpoint's *weights only* — the
    serving plane's hot-swap door.

    Integrity is verified exactly like a full restore (manifest
    self-hash + npz sha256), so a torn or truncated checkpoint raises
    ``CheckpointCorruptError`` *before* any weight byte is trusted — a
    swap either installs a fully verified model or changes nothing. No
    Session is rebuilt: the returned manifest dict carries the spec,
    its hash, and ``rounds_done`` for staleness accounting."""
    path = Path(path)
    with obs_trace.span("ckpt_verify", name=path.name):
        npz, manifest = _require_pair(path)
        meta = _read_manifest(manifest, npz)
    if meta.get("format") != _SESSION_FORMAT:
        raise CheckpointCorruptError(
            f"{path}: not a session checkpoint (format={meta.get('format')!r})"
        )
    data = _load_npz(npz)
    try:
        x = np.asarray(data["x"])
    except KeyError as e:
        raise CheckpointCorruptError(
            f"{path}: checkpoint is missing field 'x'"
        ) from e
    return x, meta


def discard_session_checkpoint(path: str | os.PathLike) -> None:
    """Remove a session checkpoint (durable pair + any stale temps) —
    what retry logic does with a checkpoint that failed to load."""
    path = Path(path)
    for suffix in (".npz", ".json", ".tmp.npz", ".tmp.json"):
        path.with_suffix(suffix).unlink(missing_ok=True)
