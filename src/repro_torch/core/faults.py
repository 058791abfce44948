"""Deterministic fault injection — the repo's chaos seam.

Production runs lose workers, tear checkpoints, and hit transient I/O;
the paper's trade-off space (§5) assumes none of that. This module
gives the runtime *one* place where such failures are injected, so the
fault-tolerance layer (Session autosave, sweep retry/quarantine,
elastic re-planning) can be driven deterministically in tests instead
of hoping a real preemption lands in the right window.

A ``FaultPlan`` is a list of ``FaultEvent``s — (kind, site, at) plus
kind-specific knobs — either hand-written or generated deterministically
from a seed (``FaultPlan.from_seed``; seed a plan from a spec's
``content_hash()`` to make chaos reproducible per experiment). A plan
is ``install``-ed for a scope; instrumented code consults the seam at
named *sites* via ``poke``:

  site "round"    ``Session.step_rounds`` after every completed round
                  boundary (``at`` = global rounds done). Backend-
                  neutral: the seam sits in the Session, above the
                  engine it drives.
  site "commit"   ``train.checkpoint._write_atomic`` between temp-write
                  and rename — the atomicity window.
  site "save"     after a session checkpoint is durably committed
                  (``at`` = rounds_done; ``path`` = the final .npz) —
                  where ``ckpt_truncate`` tears the file.
  site "point"    ``repro_torch.api.sweep`` immediately before a sweep point
                  runs (``at`` = point index).

Kinds:

  kill           SIGKILL the process (``install(..., hard_kill=True)``
                 — a real worker death, nothing runs after it) or raise
                 ``WorkerKilled`` (the in-process stand-in).
  io_error       raise ``TransientIOError`` — clears after ``times``
                 firings (a retry eventually succeeds).
  stall          sleep ``delay_s`` — a slow round / straggler.
  ckpt_truncate  truncate the just-committed checkpoint payload by
                 ``truncate_bytes`` — a torn write the integrity hashes
                 must catch on restore.

When no plan is installed every ``poke`` is a no-op — the seam costs
one ContextVar read on the host between rounds, nothing on the device.

The same module as the reference package's ``core/faults.py`` (numpy
and the standard library only), kept as a copy so the port imports
nothing of that package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import signal
import time
from contextvars import ContextVar

import numpy as np

FAULT_KINDS = ("kill", "io_error", "stall", "ckpt_truncate")
FAULT_SITES = ("round", "commit", "save", "point")


class InjectedFault(RuntimeError):
    """Base of every exception the seam raises."""


class WorkerKilled(InjectedFault):
    """In-process stand-in for a worker death (soft ``kill``)."""


class TransientIOError(OSError, InjectedFault):
    """An injected transient I/O failure — retriable by policy."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault.

    kind            one of ``FAULT_KINDS``.
    site            where it fires (``FAULT_SITES``).
    at              fire when the site's counter equals this (round
                    index for "round"/"save", point index for "point");
                    None = fire at every visit (until ``times`` runs out).
    times           how many firings before the event is spent (an
                    ``io_error`` with times=1 is transient: the retry
                    sails through).
    delay_s         stall duration ("stall").
    truncate_bytes  bytes chopped off the payload ("ckpt_truncate").
    """

    kind: str
    site: str = "round"
    at: int | None = None
    times: int = 1
    delay_s: float = 0.05
    truncate_bytes: int = 128

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {FAULT_KINDS}")
        if self.site not in FAULT_SITES:
            raise ValueError(f"site={self.site!r} not in {FAULT_SITES}")
        if self.times < 1:
            raise ValueError(f"times={self.times} must be ≥ 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic list of faults for one run."""

    events: tuple[FaultEvent, ...] = ()

    def __init__(self, events=()):
        object.__setattr__(self, "events", tuple(events))

    @classmethod
    def from_seed(
        cls,
        seed: int | str,
        rounds: int,
        kinds: tuple[str, ...] = ("stall", "io_error"),
        n_faults: int = 2,
        delay_s: float = 0.05,
    ) -> "FaultPlan":
        """Generate a reproducible plan. ``seed`` may be an int or any
        string (pass a spec's ``content_hash()`` to key the chaos to the
        experiment); identical seeds always produce identical plans."""
        if isinstance(seed, str):
            seed = int(hashlib.sha256(seed.encode()).hexdigest()[:12], 16)
        rng = np.random.default_rng(int(seed))
        events = []
        for _ in range(int(n_faults)):
            kind = kinds[int(rng.integers(len(kinds)))]
            at = int(rng.integers(1, max(int(rounds), 2)))
            site = "save" if kind == "ckpt_truncate" else "round"
            events.append(FaultEvent(kind=kind, site=site, at=at, delay_s=delay_s))
        events.sort(key=lambda e: (e.at if e.at is not None else -1, e.kind))
        return cls(events)


class FaultInjector:
    """The live seam: matches ``poke`` calls against the plan's
    remaining events and fires them. ``fired`` is the audit log —
    (kind, site, at) per firing — so tests can assert what the chaos
    actually did."""

    def __init__(self, plan: FaultPlan, hard_kill: bool = False):
        self.plan = plan
        self.hard_kill = hard_kill
        self._remaining = [e.times for e in plan.events]
        self.fired: list[tuple[str, str, int]] = []

    def poke(self, site: str, at: int, path=None) -> None:
        for i, ev in enumerate(self.plan.events):
            if self._remaining[i] < 1 or ev.site != site:
                continue
            if ev.at is not None and ev.at != at:
                continue
            self._remaining[i] -= 1
            self.fired.append((ev.kind, site, int(at)))
            self._fire(ev, path)

    def _fire(self, ev: FaultEvent, path) -> None:
        if ev.kind == "stall":
            time.sleep(ev.delay_s)
        elif ev.kind == "io_error":
            raise TransientIOError(
                f"injected transient I/O error at {ev.site}:{ev.at}"
            )
        elif ev.kind == "kill":
            if self.hard_kill:
                os.kill(os.getpid(), signal.SIGKILL)  # nothing runs after this
            raise WorkerKilled(f"injected worker kill at {ev.site}:{ev.at}")
        elif ev.kind == "ckpt_truncate":
            if path is None:
                return  # site passed no file — nothing to tear
            size = os.path.getsize(path)
            os.truncate(path, max(0, size - ev.truncate_bytes))


_ACTIVE: ContextVar[FaultInjector | None] = ContextVar("fault_injector", default=None)


def active() -> FaultInjector | None:
    """The installed injector, or None (the normal, fault-free case)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def install(plan: FaultPlan, hard_kill: bool = False):
    """Install ``plan`` for the dynamic extent of the with-block and
    yield the live ``FaultInjector`` (its ``fired`` log is the test
    oracle)."""
    inj = FaultInjector(plan, hard_kill=hard_kill)
    token = _ACTIVE.set(inj)
    try:
        yield inj
    finally:
        _ACTIVE.reset(token)


def poke(site: str, at: int, path=None) -> None:
    """Consult the seam at an instrumented site — no-op unless a plan
    is installed."""
    inj = _ACTIVE.get()
    if inj is not None:
        inj.poke(site, at, path=path)
