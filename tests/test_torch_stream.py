"""The port's streaming data plane (``repro_torch.serve.stream``) and its
ingest (``repro_torch.serve.ingest``), modelled on the reference's
tests/test_stream.py: its 13 tests of the sparse sources and the feed, one
for one (the token stream belongs to the NN side, which the port does not
have). On top, parity with the live reference: micro-batches of both
sources, the per-round team problem and the mesh's column-local shards are
**bitwise** the reference's for the same (configuration, seed, k) — sources
replay, and resume in either package depends on it.
"""

import threading

import numpy as np
import pytest
import torch

from repro.serve import ingest as J_ingest
from repro.serve import stream as J_stream
from repro.sparse.partition import partition_columns as j_partition_columns
from repro.sparse.synthetic import make_dataset as j_make_dataset
from repro_torch.core.objective import LOGISTIC
from repro_torch.serve import ingest as T_ingest
from repro_torch.serve.stream import (
    DriftStream,
    MicroBatch,
    ReplayStream,
    StreamFeed,
    StreamSource,
)
from repro_torch.sparse.partition import partition_columns
from repro_torch.sparse.synthetic import make_dataset


def batches_equal(a, b) -> bool:
    return (
        a.index == b.index
        and np.array_equal(a.indices, b.indices)
        and np.array_equal(a.values, b.values)
        and np.array_equal(a.y, b.y)
    )


def bitwise(got, want) -> bool:
    """Same index, and arrays equal in dtype, shape and bits."""
    arrays = [(got.indices, want.indices), (got.values, want.values), (got.y, want.y)]
    return got.index == want.index and all(
        g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes() for g, w in arrays
    )


# ---------------- DriftStream ----------------


def test_drift_stream_is_deterministic_and_pure_in_k():
    s1 = DriftStream(n=500, rows=16, width=8, seed=7, drift_at=5)
    s2 = DriftStream(n=500, rows=16, width=8, seed=7, drift_at=5)
    for k in (0, 3, 5, 11):
        assert batches_equal(s1.batch(k), s2.batch(k))
    # drawing batches out of order changes nothing (pure in k)
    b3 = s1.batch(3)
    s1.batch(9), s1.batch(0)
    assert batches_equal(b3, s1.batch(3))


def test_drift_stream_replay_from_k():
    src = DriftStream(n=300, rows=8, width=4, seed=1)
    full = [b for b, _ in zip(src.micro_batches(0), range(10))]
    tail = [b for b, _ in zip(src.micro_batches(6), range(4))]
    for got, want in zip(tail, full[6:]):
        assert batches_equal(got, want)
    assert [b.index for b in full] == list(range(10))


def test_drift_stream_shapes_and_labels():
    src = DriftStream(n=400, rows=12, width=6, seed=2)
    b = src.batch(0)
    assert b.indices.shape == b.values.shape == (12, 6)
    assert b.indices.dtype == np.int32 and b.values.dtype == np.float32
    assert set(np.unique(b.y)) <= {-1.0, 1.0}
    assert b.indices.min() >= 0 and b.indices.max() < 400
    # label folding: ya = diag(y)·values
    assert np.array_equal(b.ya_values(), b.values * b.y[:, None])


def test_drift_flips_the_concept_at_drift_at():
    src = DriftStream(n=500, rows=16, width=8, seed=7, drift_at=5)
    w_pre, w_post = src.truth(4), src.truth(5)
    assert np.array_equal(w_post, -w_pre)  # "flip" mode inverts exactly
    # no drift configured → the concept never moves
    still = DriftStream(n=500, rows=16, width=8, seed=7)
    assert np.array_equal(still.truth(0), still.truth(10_000))


def test_drift_stream_labels_are_learnable():
    """The hidden concept predicts the labels (the support is
    frequency-aligned)."""
    src = DriftStream(n=1000, rows=256, width=16, seed=4)
    b = src.batch(0)
    w = src.truth(0)
    margins = np.einsum("rw,rw->r", b.values.astype(np.float64), w[b.indices])
    bayes = np.mean(np.where(margins >= 0, 1.0, -1.0) == b.y)
    assert bayes > 0.6


def test_drift_stream_validates():
    with pytest.raises(ValueError):
        DriftStream(n=0, rows=4)
    with pytest.raises(ValueError):
        DriftStream(n=10, rows=4, drift_mode="teleport")


# ---------------- ReplayStream ----------------


def test_replay_stream_cycles_dataset_rows():
    src = ReplayStream(dataset="rcv1-sm", rows=32, seed=0)
    b0, b1 = src.batch(0), src.batch(1)
    assert b0.rows == b1.rows == 32
    assert not np.array_equal(b0.indices, b1.indices)
    # pure in k + cyclic: batch k repeats after m/rows batches
    assert batches_equal(b0, ReplayStream(dataset="rcv1-sm", rows=32, seed=0).batch(0))
    from repro_torch.sparse.synthetic import dataset_stats

    period = dataset_stats("rcv1-sm").m // 32
    wrapped = src.batch(period)
    assert np.array_equal(wrapped.indices, b0.indices)


def test_sources_conform_to_protocol():
    assert isinstance(DriftStream(n=10, rows=2), StreamSource)
    assert isinstance(ReplayStream(dataset="rcv1-sm", rows=8), StreamSource)


# ---------------- StreamFeed ----------------


def test_feed_preserves_order_and_counts():
    src = DriftStream(n=200, rows=8, width=4, seed=9)
    want = [b for b, _ in zip(src.micro_batches(0), range(12))]
    with StreamFeed(src, capacity=3) as feed:
        got = [feed.get() for _ in range(12)]
        assert feed.consumed == 12
        assert feed.produced >= 12
        stats = feed.stats()
    for g, w in zip(got, want):
        assert batches_equal(g, w)
    assert stats["ingest_lag"] == stats["produced"] - stats["consumed"]
    assert stats["queue_depth"] <= 3


def test_feed_starts_mid_stream():
    src = DriftStream(n=200, rows=8, width=4, seed=9)
    with StreamFeed(src, start=7, capacity=2) as feed:
        assert feed.get().index == 7
        assert feed.get().index == 8


def test_feed_backpressure_is_bounded():
    src = DriftStream(n=100, rows=4, width=2, seed=0)
    with StreamFeed(src, capacity=2) as feed:
        # the producer runs without a consumer: it must park at the bound
        threading.Event().wait(0.3)
        assert feed.queue_depth <= 2
        assert feed.produced <= 3  # capacity + the one in-flight put


def test_feed_surfaces_producer_errors():
    class Exploding:
        def micro_batches(self, start=0):
            raise RuntimeError("boom at construction")
            yield  # pragma: no cover

    with StreamFeed(Exploding(), capacity=2) as feed:
        with pytest.raises(RuntimeError, match="stream producer failed"):
            feed.get(timeout=2.0)


def test_feed_rejects_bad_capacity():
    with pytest.raises(ValueError):
        StreamFeed(DriftStream(n=10, rows=2), capacity=0)


# ---------------- parity with the reference, bitwise ----------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_drift_batches_are_bitwise_the_reference(seed):
    """Several (seed, k), with and without column skew and drift — the
    Zipf draws repeat ids within a row, which both keep."""
    for kw in (dict(n=4736, rows=64, width=16, drift_at=3), dict(n=300, rows=8, width=4, alpha=0.0),
               dict(n=47236, rows=32, width=16, drift_at=2, drift_mode="rotate")):
        t, j = DriftStream(seed=seed, **kw), J_stream.DriftStream(seed=seed, **kw)
        assert np.array_equal(t.truth(5), j.truth(5))
        for k in (0, 1, 2, 7, 50):
            assert bitwise(t.batch(k), j.batch(k)), (kw, k)


@pytest.mark.parametrize("dataset,width", [("rcv1-sm", None), ("rcv1-sm", 8), ("news20-sm", None)])
def test_replay_batches_are_bitwise_the_reference(dataset, width):
    """Batches across the dataset's wrap, with the row width the dataset's
    own and cut short (rows longer than ``width`` keep their first
    entries)."""
    t = ReplayStream(dataset=dataset, rows=96, seed=1, width=width)
    j = J_stream.ReplayStream(dataset=dataset, rows=96, seed=1, width=width)
    m = make_dataset(dataset, seed=1).A.m
    for k in (0, 1, m // 96, m // 96 + 1, 3 * m // 96):
        assert bitwise(t.batch(k), j.batch(k)), k


@pytest.mark.parametrize("seed", [0, 5])
def test_stream_team_problem_is_bitwise_the_reference(seed):
    batch = DriftStream(n=4736, rows=64, width=16, seed=seed, drift_at=2).batch(3)
    tp = T_ingest.stream_team_problem(batch, 2, 4736, LOGISTIC, device="cpu")
    jp = J_ingest.stream_team_problem(batch, 2, 4736, LOGISTIC)
    assert tp.indices.dtype == torch.int32 and tp.values.dtype == torch.float32
    assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    assert tp.values.numpy().tobytes() == np.asarray(jp.values).tobytes()
    assert np.array_equal(tp.rows_valid.numpy(), np.asarray(jp.rows_valid))
    assert (tp.p, tp.m, tp.n, tp.objective) == (jp.p, jp.m, jp.n, LOGISTIC)
    with pytest.raises(ValueError, match="not divisible"):
        T_ingest.stream_team_problem(batch, 3, 4736, LOGISTIC, device="cpu")


@pytest.mark.parametrize("kind", ["cyclic", "rows", "nnz"])
@pytest.mark.parametrize("p_r,p_c", [(2, 2), (2, 4)])
def test_stream_shard_arrays_are_bitwise_the_reference(kind, p_r, p_c):
    """Column-local shards of drift rows (repeated ids) and of replay rows
    (pads at the end of short rows), element for element the reference's,
    padding rule included (a pad is shard 0, id 0, value 0)."""
    a = make_dataset("rcv1-sm", seed=0).A
    cp = partition_columns(a, p_c, kind)
    jcp = j_partition_columns(j_make_dataset("rcv1-sm", seed=0).A, p_c, kind)
    loc = T_ingest.ColumnLocalizer.from_partition(cp)
    jloc = J_ingest.ColumnLocalizer.from_partition(jcp)
    assert np.array_equal(loc.owner, jloc.owner) and np.array_equal(loc.local, jloc.local)
    for batch in (DriftStream(n=a.n, rows=32, width=16, seed=p_c).batch(4),
                  ReplayStream(dataset="rcv1-sm", rows=32).batch(5)):
        idx, val = T_ingest.stream_shard_arrays(batch, loc, p_r, batch.width)
        jidx, jval = J_ingest.stream_shard_arrays(batch, jloc, p_r, batch.width)
        assert idx.dtype == jidx.dtype and val.dtype == jval.dtype
        assert np.array_equal(idx, jidx) and val.tobytes() == jval.tobytes()
    assert (val == 0).any()  # the replay rows' pads were routed
