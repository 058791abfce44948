"""Token data pipeline — a numpy copy of the reference's
(``repro.train.data``): batch k of a stream is the reference's, bit for bit.

No corpus ships with the repo: the pipeline synthesizes a
deterministic, learnable token stream (a Zipf-distributed k-th order
Markov chain) with the same interface a file-backed loader would have:
``batches(batch, seq_len)`` yields (tokens, targets) int32 arrays.
A Markov stream has real structure (bigram statistics), so training
loss decreasing is meaningful, unlike i.i.d. noise.

The stream also conforms to the serving plane's ``StreamSource``
protocol (``micro_batches(start)`` — repro_torch.serve.stream): batches carry
their stream index and replay deterministically, so the token pipeline
can ride the same ingest/feed machinery as the sparse-example streams
(its batches carry tokens, not sparse rows — consumers differ).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenMicroBatch:
    """One indexed (tokens, targets) pair — the token stream's
    ``StreamSource`` element (``index`` is the replay key)."""

    index: int
    tokens: np.ndarray  # (batch, seq_len) int32
    targets: np.ndarray  # (batch, seq_len) int32

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class MarkovTextStream:
    vocab_size: int
    seed: int = 0
    branching: int = 32  # successors per token (Zipf-weighted)
    batch: int = 8  # micro_batches() shape (the batches() args, as fields)
    seq_len: int = 32

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self.succ = rng.integers(0, v, size=(v, self.branching))
        w = 1.0 / np.arange(1, self.branching + 1)
        self.succ_p = w / w.sum()

    def batches(self, batch: int, seq_len: int, start_seed: int = 0):
        """Infinite iterator of (tokens, targets)."""
        rng = np.random.default_rng(self.seed + 1000 + start_seed)
        state = rng.integers(0, self.vocab_size, size=batch)
        while True:
            toks = np.empty((batch, seq_len + 1), dtype=np.int32)
            toks[:, 0] = state
            for t in range(seq_len):
                choice = rng.choice(self.branching, size=batch, p=self.succ_p)
                toks[:, t + 1] = self.succ[toks[:, t], choice]
            state = toks[:, -1]
            yield toks[:, :-1], toks[:, 1:]

    def micro_batches(self, start: int = 0) -> Iterator[TokenMicroBatch]:
        """``StreamSource`` conformance: indexed, deterministic batches
        of shape (``self.batch``, ``self.seq_len``).

        The chain carries state batch-to-batch, so batch k is a function
        of the whole prefix — replay-from-k is implemented by walking
        the chain from 0 and discarding (O(start); fine for the resume
        depths tests and demos use, unlike the sparse streams whose
        batch k is O(1) pure in k)."""
        it = self.batches(self.batch, self.seq_len)
        for _ in range(int(start)):
            next(it)
        k = int(start)
        for toks, targs in it:
            yield TokenMicroBatch(index=k, tokens=toks, targets=targs)
            k += 1


def bigram_entropy_floor(
    stream: MarkovTextStream, sample_states: int | None = 64
) -> float:
    """The stream's conditional entropy (nats) — the loss floor a
    perfect model reaches; used by tests to check learning headroom.

    The floor is averaged over the first ``min(vocab_size,
    sample_states)`` states rather than the whole vocabulary — every
    state's successor table is drawn from the same Zipf recipe, so a
    sample estimates the mean to well within test tolerances while
    keeping the call O(sample·branching). Pass ``sample_states=None``
    for the exact all-states average (O(vocab·branching)).
    """
    p = stream.succ_p
    n_states = (
        stream.vocab_size
        if sample_states is None
        else min(stream.vocab_size, int(sample_states))
    )
    if n_states < 1:
        raise ValueError(f"sample_states={sample_states} must be ≥ 1 (or None)")
    # successors may repeat; account per-state, averaged
    ent = 0.0
    for s in range(n_states):
        agg: dict[int, float] = {}
        for j, t in enumerate(stream.succ[s]):
            agg[int(t)] = agg.get(int(t), 0.0) + p[j]
        ent += -sum(q * np.log(q) for q in agg.values())
    return ent / n_states
