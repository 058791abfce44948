"""ModelStore — the serving side's model holder, hot-swappable.

The prediction service reads models from here; the training side
publishes into it. The two never share mutable state: a published model
is an immutable ``ModelSnapshot`` holding a private copy of the weights
on the store's device, and a swap is one atomic reference assignment
under a lock — a reader either sees the whole previous model or the
whole next one, never a mix.

Torch has no read-only flag, so privacy is by copy: ``publish`` copies
whatever it is given (a host array, or a device tensor such as a
session's carry, which the next round updates in place) into a buffer
nothing else references. All device work — the publish copy and every
``predict`` — is issued on the calling thread's current stream, the
device's default stream unless a caller picks another, the same stream
the training kernels launch on; stream order therefore puts a publish
copy before any read of the snapshot it makes.

The hot-swap door is ``swap_from_checkpoint``: weights come from an
integrity-hashed session checkpoint via
``repro_torch.train.checkpoint.load_model_weights``, which verifies the
manifest self-hash and payload sha256 *before* anything is installed.
A corrupt/torn checkpoint raises and leaves the current model serving —
ingest and prediction never pause for a failed swap.

``device=None`` means the CUDA device, or an error when there is none;
``device="cpu"`` serves on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.checkpoint import load_model_weights

__all__ = ["ModelSnapshot", "ModelStore"]


def _check_ids(indices: np.ndarray, n: int) -> None:
    """Raise ``ValueError`` unless every id lies in [-n, n) — the ids a
    numpy gather over n weights accepts (negatives count from the end)."""
    if indices.size and (indices.max() >= n or indices.min() < -n):
        raise ValueError(
            f"feature ids must lie in [-{n}, {n}); got [{indices.min()}, {indices.max()}]"
        )


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One immutable served model.

    weights      (n,) float32 tensor on the store's device — a private
                 copy no publisher holds.
    version      monotonically increasing store version.
    rounds_done  training rounds behind this model (staleness unit).
    spec_hash    content hash of the spec that trained it ("" if
                 published directly from weights).
    loaded_at    ``time.monotonic()`` at install (staleness in seconds).
    """

    weights: torch.Tensor
    version: int
    rounds_done: int = 0
    spec_hash: str = ""
    loaded_at: float = 0.0

    @property
    def n(self) -> int:
        return int(self.weights.shape[0])

    @property
    def x(self) -> np.ndarray:
        """The weights as a read-only host array (a fresh copy each call)."""
        x = self.weights.to("cpu", copy=True).numpy()
        x.flags.writeable = False
        return x

    def predict(self, indices, values) -> np.ndarray:
        """Batched margins for (B, width) ELL rows: Σ_w x[idx]·val, a
        gather and a row sum on the store's device, returned as float32 on
        the host. Padded slots (value 0) contribute nothing; an id outside
        [-n, n) raises ``ValueError`` before anything reaches the device
        (on a card an out-of-range gather would be a device-side assert,
        which fails every later CUDA call of the process)."""
        indices = np.asarray(indices, np.int64)
        _check_ids(indices, self.n)
        dev = self.weights.device
        idx = torch.as_tensor(indices).to(dev)
        val = torch.as_tensor(np.asarray(values, np.float32)).to(dev)
        return (self.weights[idx] * val).sum(dim=-1).cpu().numpy()


class ModelStore:
    """Thread-safe holder of the current ``ModelSnapshot``, on ``device``.

    ``snapshot()`` hands out the current immutable model (readers pin it
    for their whole batch — a concurrent swap never tears a batch);
    ``publish``/``swap_from_checkpoint`` install the next one
    atomically. ``swaps`` counts successful installs,
    ``failed_swaps`` the rejected (corrupt) ones.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pinned to an index: the batcher thread's current device is
            # its own, not the one the constructing thread had
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.Lock()
        self._snapshot: ModelSnapshot | None = None
        self.swaps = 0
        self.failed_swaps = 0

    # ---- read side ----

    def snapshot(self) -> ModelSnapshot:
        snap = self._snapshot  # atomic ref read
        if snap is None:
            raise RuntimeError("ModelStore is empty — publish or swap a model first")
        return snap

    @property
    def version(self) -> int:
        snap = self._snapshot
        return snap.version if snap is not None else 0

    def check_ids(self, indices) -> None:
        """Raise ``ValueError`` for ids the current model cannot gather
        (nothing to check on an empty store: ``predict`` raises there)."""
        snap = self._snapshot
        if snap is not None:
            _check_ids(np.asarray(indices, np.int64), snap.n)

    def predict(self, indices, values) -> tuple[np.ndarray, int]:
        """Margins + the version that served them (one snapshot pin for
        the whole batch — never a torn model mid-batch)."""
        snap = self.snapshot()
        return snap.predict(indices, values), snap.version

    # ---- write side ----

    def publish(self, x, rounds_done: int = 0, spec_hash: str = "") -> ModelSnapshot:
        """Install weights directly (initial model, tests): a host array
        or a tensor on any device. The weights are copied to the store's
        device — later writes by the publisher can't reach a served
        model."""
        if isinstance(x, torch.Tensor):
            buf = x.detach().to(device=self.device, dtype=torch.float32, copy=True)
        else:
            buf = torch.tensor(np.asarray(x, np.float32), device=self.device)
        with self._lock:
            snap = ModelSnapshot(
                weights=buf,
                version=self.version + 1,
                rounds_done=int(rounds_done),
                spec_hash=spec_hash,
                loaded_at=time.monotonic(),
            )
            self._snapshot = snap
            self.swaps += 1
        return snap

    def swap_from_checkpoint(self, path) -> ModelSnapshot:
        """Hot-swap from an integrity-hashed session checkpoint (either
        package's: the format is shared). Verification (manifest
        self-hash + payload sha256) happens before install; on
        ``CheckpointCorruptError`` the current model keeps serving
        untouched."""
        reg = obs_metrics.registry()
        try:
            with obs_trace.span("swap", name=str(getattr(path, "name", path))):
                x, meta = load_model_weights(path)
        except BaseException:
            self.failed_swaps += 1
            reg.counter("serve.failed_swaps_total").inc()
            raise
        reg.counter("serve.swaps_total").inc()
        return self.publish(
            x,
            rounds_done=int(meta.get("rounds_done", 0)),
            spec_hash=str(meta.get("spec_hash", "")),
        )

    def stats(self) -> dict:
        snap = self._snapshot
        return {
            "version": self.version,
            "swaps": self.swaps,
            "failed_swaps": self.failed_swaps,
            "rounds_done": snap.rounds_done if snap is not None else 0,
            "model_age_s": (
                time.monotonic() - snap.loaded_at if snap is not None else None
            ),
        }
