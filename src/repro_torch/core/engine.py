"""The unified parallel-SGD engine — one inner loop for the whole
(p_r, p_c, s, τ) family.

The paper's four algorithms are corners of a single 2D-parallel method:
p_r row teams each run τ inner iterations of s-step SGD (τ/s s-bundles)
between parameter averagings. One engine therefore subsumes them all:

  corner                      schedule
  ------------------------    ------------------------------------
  mini-batch SGD (Alg. 1)     p_r = 1, s = 1, τ = 1
  s-step SGD     (Alg. 3)     p_r = 1, τ = s         (no averaging)
  FedAvg         (Alg. 2)     s = 1                  (no Gram work)
  HybridSGD      (§4.1)       general (p_r, s, τ)

p_c is a *communication* knob, not a numerical one: it decides where
columns live (and hence what is Allreduced), never what is computed.
The engine here implements the exact simulated-rank semantics on one
device: the device the problem's tensors live on.

Per s-bundle the round body slices s·b ELL rows, computes
(G, v) = (tril(Y Yᵀ, −1), Y x) (``bundle_gram_v`` →
repro_torch.kernels.ell_gram), runs the s sequential corrections
(``inner_corrections`` → repro_torch.kernels.sstep_inner where it
applies) and adds (η/b)·Yᵀu. The ``lax.scan`` / ``lax.map`` / ``vmap``
loops of the JAX engine are Python loops of launches here; the round
index and the bundle offsets are host integers, and nothing inside the
round loop reads a value back from the device. On the card a resident
problem's rounds are replayed from CUDA graphs, one a round residue
(``_run_rounds`` → repro_torch.core.round_graph).

The *loss* is pluggable (repro_torch.core.objective): the engine reads
the residual map u(z) = −ℓ′(z), the pointwise loss, and the optional L2
decay from the problem's ``objective``; λ > 0 is exact via the
decay-aware correction recurrence.

*Communication* is explicit (repro_torch.core.comm): the round body
issues its two collectives — the per-bundle row-team (G, v) Allreduce
and the per-round p_r-team average — through the counting collectives,
so ``engine_comm_ledger`` can capture exactly what a run communicates
(on meta tensors: no data, no arithmetic).

``delay = D ≥ 1`` runs the bundle loop as ``delayed_bundle_scan``: the
(G, v) of bundle t is issued at t and consumed at t + D, through a
D-deep FIFO that drains before the team average. ``precision="bf16"``
runs the Gram kernel's bf16 mode and ships (G, v) as bf16 words: the
payload is cast to bf16 before the Allreduce and back to float32 after
it (``wire_gv`` / ``unwire_gv``), so the corrections run in float32.

repro_torch.core.{sgd,sstep,fedavg,hybrid} hold configured engine calls.
"""

from __future__ import annotations

import collections
import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.core import round_graph
from repro_torch.core.comm import COUNTING, Collectives, CommLedger, capture_rates, recording
from repro_torch.core.objective import LOGISTIC, LogisticObjective, Objective
from repro_torch.core.problem import Problem, problem_loss
from repro_torch.core.teams import TeamProblem, global_problem
from repro_torch.kernels.ell_gram import ell_gram_and_v, ell_gram_and_v_blocked
from repro_torch.kernels.ref import ell_gram_and_v_ref
from repro_torch.kernels.sstep_inner import eta_over_b, sstep_inner
from repro_torch.sparse.ell import EllBlock, ell_matvec, ell_rmatvec

GRAM_METHODS = ("kernel", "blocked", "dense")


@dataclasses.dataclass(frozen=True)
class ParallelSGDSchedule:
    """The knobs of the 2D-parallel SGD family (paper Table 3 row
    "HybridSGD").

    p_r     row teams (FedAvg axis); must equal the TeamProblem's p.
    s       bundle depth — SGD steps fused per Gram round-trip.
    b       mini-batch rows per SGD step (bundle = s·b rows).
    tau     inner iterations between row-team averagings; s | τ.
    eta     step size.
    rounds  outer rounds (total SGD-equivalent iterations = rounds·τ).
    loss_every   sample the full objective every this many rounds
                 (0 = never; the returned loss trace is then empty).
    gram    bundle (G, v) backend: "kernel" (the hand-written ELL-Gram
            kernel on CUDA tensors, its plain version on CPU tensors —
            the production path), "blocked" (the plain panel walk on
            either device), "dense" (the densify oracle, kernels/ref.py
            — tests only).
    bk      column-panel width of the plain blocked walk; ``None`` falls
            back to the static 512. The CUDA kernel does not walk
            panels and ignores it.
    bm      optional row tile for the blocked walk's panel expansion;
            any ``bm`` gives the same result. Ignored by the CUDA kernel.
    interpret   the reference's Pallas interpret-mode flag. Nothing in
            the port reads it: it is carried, with the reference's
            default, only so that an experiment spec written by either
            package reads back and content-hashes the same in both.
    precision   "fp32" (default) or "bf16": the (G, v) kernel rounds its
            operands to bf16 and accumulates in float32, and the
            per-bundle (G, v) Allreduce ships bf16 words (half the
            β·bytes payload; word counts, and hence the Table 2–3
            closed forms, are unchanged).
    p_c     column shards. Communication-only: it never changes the
            numerics (kept here so one object describes the full mesh).
    delay   DaSGD-style staleness D (0 = synchronous, the default). With
            D ≥ 1 the (G, v) collective of bundle t is *issued* at t but
            *consumed* at bundle t+D — it rides a D-deep staging buffer
            and overlaps the next D bundles' Gram compute; the last D
            bundles drain before the round's parameter average, so round
            boundaries (chunking, averaging cadence) are unchanged. A
            numerical knob: D ≥ 1 changes the iterates (each bundle's
            gradient is D bundles stale), not the communication volume.
            Must satisfy D ≤ τ/s (the per-round bundle count).
    """

    p_r: int = 1
    s: int = 1
    b: int = 8
    tau: int = 1
    eta: float = 0.05
    rounds: int = 1
    loss_every: int = 0
    gram: str = "kernel"
    bk: int | None = 512
    interpret: bool = True
    p_c: int = 1
    delay: int = 0
    bm: int | None = None
    precision: str = "fp32"

    def __post_init__(self):
        # NOTE: s | τ is required by the *solver* (checked in
        # run_parallel_sgd), not here. Likewise η > 0 is a solver-entry
        # check: only η < 0 is nonsense here.
        for knob in ("p_r", "s", "b", "tau", "rounds", "p_c"):
            v = getattr(self, knob)
            if v < 1:
                raise ValueError(f"{knob}={v!r} must be a positive integer")
        for knob in ("bk", "bm"):
            v = getattr(self, knob)
            if v is not None and v < 1:
                raise ValueError(f"{knob}={v!r} must be a positive integer or None")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(
                f"precision={self.precision!r} must be 'fp32' or 'bf16'"
            )
        if self.loss_every < 0:
            raise ValueError(f"loss_every={self.loss_every} must be ≥ 0")
        if self.delay < 0:
            raise ValueError(f"delay={self.delay} must be ≥ 0")
        if self.eta < 0:
            raise ValueError(f"eta={self.eta} must be ≥ 0")
        if self.loss_every and self.rounds % self.loss_every:
            raise ValueError(
                f"rounds={self.rounds} must be divisible by loss_every={self.loss_every}"
            )
        if self.gram not in GRAM_METHODS:
            raise ValueError(f"gram={self.gram!r} not in {GRAM_METHODS}")

    # ---- the paper's corners, by name ----

    @classmethod
    def mb_sgd(cls, b: int, eta: float, iters: int, loss_every: int = 0, **kw):
        """Algorithm 1: synchronous mini-batch SGD."""
        return cls(p_r=1, s=1, b=b, tau=1, eta=eta, rounds=iters, loss_every=loss_every, **kw)

    @classmethod
    def sstep(cls, s: int, b: int, eta: float, iters: int, loss_every: int = 0, **kw):
        """Algorithm 3: 1D s-step SGD — iters/s bundles, one bundle per
        round, no averaging (p_r = 1).

        ``loss_every`` counts SGD-equivalent iterations (like ``iters``)
        and must be a multiple of s: one round = s iterations, so any
        other cadence cannot be sampled exactly.
        """
        if iters % s:
            raise ValueError(f"iters={iters} must be divisible by s={s}")
        if loss_every and loss_every % s:
            raise ValueError(
                f"loss_every={loss_every} must be divisible by s={s}: the loss is "
                f"sampled on round (= s-iteration) boundaries"
            )
        return cls(
            p_r=1, s=s, b=b, tau=s, eta=eta, rounds=iters // s,
            loss_every=loss_every // s, **kw,
        )

    @classmethod
    def fedavg(cls, p: int, b: int, eta: float, tau: int, rounds: int,
               loss_every: int = 0, **kw):
        """Algorithm 2: FedAvg / local SGD — s = 1, so no Gram work."""
        return cls(p_r=p, s=1, b=b, tau=tau, eta=eta, rounds=rounds,
                   loss_every=loss_every, **kw)

    @classmethod
    def hybrid(cls, p_r: int, s: int, b: int, eta: float, tau: int, rounds: int,
               loss_every: int = 0, **kw):
        """HybridSGD (§4.1): the general 2D point."""
        return cls(p_r=p_r, s=s, b=b, tau=tau, eta=eta, rounds=rounds,
                   loss_every=loss_every, **kw)


def bundle_gram_v(
    indices, values, x, n: int, *, gram: str = "kernel", bk: int | None = 512,
    bm: int | None = None, precision: str = "fp32", geometry: tuple[int, int] | None = None,
):
    """The shared s-bundle primitive: local (G, v) = (tril(YYᵀ,-1), Yx)
    for the ELL bundle Y, without densifying Y to (sb, n).

    ``bk=None`` falls back to the static 512. ``geometry`` is the CUDA
    kernel's tuned (tile, ks) (``repro_torch.kernels.tune``; None: its
    default), read only by ``gram="kernel"`` on CUDA tensors. The dense
    oracle has no panels, so bk/bm/precision do not apply to it — its
    (G, v) is always the fp32 reference."""
    bk = 512 if bk is None else bk
    if gram == "kernel":
        return ell_gram_and_v(indices, values, x, n=n, bk=bk, bm=bm, precision=precision,
                              geometry=geometry)
    if gram == "blocked":
        return ell_gram_and_v_blocked(
            indices, values, x, n=n, bk=bk, bm=bm, precision=precision
        )
    if gram == "dense":
        return ell_gram_and_v_ref(indices, values, x, n)
    raise ValueError(f"gram={gram!r} not in {GRAM_METHODS}")


def _tree_map(fn, tree):
    """``fn`` on a tensor, or on each tensor of a tuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tuple(fn(t) for t in tree)


def wire_gv(tree, precision: str):
    """Cast a (G, v) payload to its on-wire dtype: bf16 under the bf16
    precision knob (half the collective's bytes), untouched at fp32."""
    if precision != "bf16":
        return tree
    return _tree_map(lambda t: t.to(torch.bfloat16), tree)


def unwire_gv(tree, precision: str, dtype=torch.float32):
    """Undo ``wire_gv`` after the collective: corrections and updates
    accumulate in ``dtype`` (float32) whatever the wire dtype."""
    if precision != "bf16":
        return tree
    return _tree_map(lambda t: t.to(dtype), tree)


def _decay(eta, lam: float) -> np.float32:
    """ρ = 1 − ηλ formed in float32, as the JAX engine forms it."""
    return np.float32(1.0) - np.float32(eta) * np.float32(lam)


def _integer_pow(x: np.float32, y: int) -> np.float32:
    """x**y for a static y ≥ 1 by repeated squaring in float32 — the
    multiplication order XLA uses for an integer power."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else np.float32(acc * x)
        y >>= 1
        if y > 0:
            x = np.float32(x * x)
    return np.float32(1.0) if acc is None else acc


def inner_corrections_loop(
    g, v, s: int, b: int, eta: float, objective: Objective = LOGISTIC
) -> torch.Tensor:
    """The corrections as a plain PyTorch loop over the s blocks, for
    any objective and any λ — what ``inner_corrections`` runs for every
    case its CUDA kernel does not cover."""
    lam = objective.l2
    scale = eta_over_b(eta, b)
    u_acc = torch.zeros(s * b, dtype=v.dtype, device=v.device)

    if lam == 0.0:
        for j in range(s):
            zj = v[j * b : (j + 1) * b] + scale * (g[j * b : (j + 1) * b] @ u_acc)
            u_acc[j * b : (j + 1) * b] = objective.residual(zj)
        return u_acc

    rho = _decay(eta, lam)
    rho_j = np.float32(1.0)  # ρ^j; u_acc_l = ρ^{j-1-l}·u_l for l < j
    for j in range(s):
        zj = float(rho_j) * v[j * b : (j + 1) * b] + scale * (g[j * b : (j + 1) * b] @ u_acc)
        uj = objective.residual(zj)
        u_acc = float(rho) * u_acc
        u_acc[j * b : (j + 1) * b] = uj
        rho_j = np.float32(rho_j * rho)
    return u_acc


def inner_corrections(
    g, v, s: int, b: int, eta: float, objective: Objective = LOGISTIC
) -> torch.Tensor:
    """Algorithm 3 lines 9-14: the s deferred-update corrections under
    any registered objective.

    Unregularized (objective.l2 == 0):

        u_j = residual(v_j + (η/b) Σ_{l<j} G_{jl} u_l)

    G is strictly lower so in-block terms multiply zeros. With L2 decay
    λ > 0 and ρ = 1 - ηλ the exact unrolled recurrence is

        z_j = ρ^j·v_j + (η/b) Σ_{l<j} ρ^{j-1-l}·G_{jl}·u_l

    implemented by carrying the ρ-rescaled residual vector: after step
    j the carry holds [ρ^{j-l}·u_l]_{l≤j}, so the returned vector is
    exactly the ρ^{s-1-l}-weighted u the caller's Yᵀ apply (and ρ^s·x
    decay-fold) needs.

    Dispatch is on the arguments, never on a failure: CUDA tensors with
    the logistic objective and λ = 0 go to the ``sstep_inner`` kernel
    (one launch for the whole loop; a failed build or launch raises);
    every other case runs ``inner_corrections_loop``."""
    if g.is_cuda and isinstance(objective, LogisticObjective) and objective.l2 == 0.0:
        return sstep_inner(g, v, s, b, eta)
    return inner_corrections_loop(g, v, s, b, eta, objective)


# ``_team_inner_iterations`` and ``delayed_bundle_scan`` look
# ``bundle_gram_v`` and ``inner_corrections`` up in this module when they
# run: ``chip_smoke.py`` rebinds them (the plain loop for its all-plain run,
# a skewed Gram to show that its limits can fail). Keep the calls late-bound;
# ``_run_rounds`` keys a round's CUDA graph by the two as bound when it runs.
def delayed_bundle_scan(x, *, slice_bundle, bundles: int, n: int,
                        sched: ParallelSGDSchedule, eta,
                        objective: Objective = LOGISTIC,
                        comm: Collectives = COUNTING,
                        geometry: tuple[int, int] | None = None):
    """The delay-D software pipeline over one round's τ/s bundles, for
    ``sched.delay ≥ 1`` (DaSGD, arXiv:2006.00441).

    At step t the body computes bundle t's (G, v) at the current
    (D-bundle-stale) iterate and *issues* its row-team Allreduce
    (``comm.issue_allreduce_cols``); the staged result waits in a D-deep
    FIFO and is *consumed* (``comm.await_allreduce`` → corrections →
    weight update) at step t+D. After the loop the last D staged entries
    drain, *before* the caller's parameter average: every round boundary
    carries only ``x``, so chunking and the τ-cadence averaging are
    where the synchronous schedule puts them.

    The reference runs its first D steps on zero entries and masks their
    updates out (a scan has a fixed body); here those steps consume
    nothing, which is the same result — the mask returns x unchanged.
    Exactly ``bundles`` updates (and, under L2, ``bundles`` decay folds)
    are applied per round, as in the synchronous path.

    ``slice_bundle(t) -> (idx, val)`` supplies the (s·b, width) ELL
    bundle (views of the team's tensors). Under bf16 the FIFO stages the
    bf16 wire payload — exactly what the in-flight Allreduce carries.
    At s = 1 the pipeline still computes the full (G, v) (its
    distributed twin reduces the dense block), so a delayed FedAvg runs
    both kernels.

    ``comm`` is the collectives the two backends issue through: the
    simulated engine passes nothing (``COUNTING``), the 2D mesh its bound
    mesh collectives (the issue then starts an asynchronous Allreduce
    over the "cols" group and the await waits on it). ``geometry`` is the
    Gram kernel's tuned (tile, ks), passed to ``bundle_gram_v``."""
    s, b = sched.s, sched.b
    lam = objective.l2
    scale = eta_over_b(eta, b)
    rho_s = float(_integer_pow(_decay(eta, lam), s)) if lam != 0.0 else None

    def compute_issue(x, t):
        idx, val = slice_bundle(t)
        g, v = bundle_gram_v(idx, val, x, n, gram=sched.gram, bk=sched.bk,
                             bm=sched.bm, precision=sched.precision, geometry=geometry)
        issued = comm.issue_allreduce_cols(
            wire_gv((g, v), sched.precision), calls_per_round=bundles
        )
        return idx, val, issued

    def consume_apply(x, entry):
        idx, val, issued = entry
        g, v = unwire_gv(comm.await_allreduce(issued), sched.precision)
        u = inner_corrections(g, v, s, b, eta, objective)
        upd = scale * ell_rmatvec(EllBlock(indices=idx, values=val, n=n), u).to(x.dtype)
        return x + upd if lam == 0.0 else rho_s * x + upd

    fifo = collections.deque()
    for t in range(bundles):
        fifo.append(compute_issue(x, t))
        if t >= sched.delay:
            x = consume_apply(x, fifo.popleft())
    while fifo:  # drain the last D entries before the team average
        x = consume_apply(x, fifo.popleft())
    return x


def bundle_start(k0: int, sb: int, m_local: int) -> int:
    """First row of the k0-th s-bundle of a team with ``m_local`` rows:
    cyclic rows [start, start + sb), clamped like a dynamic slice."""
    return min((k0 * sb) % m_local, max(m_local - sb, 0))


def _team_inner_iterations(indices, values, n: int, x, round_idx: int, eta,
                           sched: ParallelSGDSchedule,
                           objective: Objective = LOGISTIC,
                           geometry: tuple[int, int] | None = None):
    """τ inner iterations (= τ/s s-bundles) on one row team's ELL rows.
    ``round_idx`` is a host integer and ``eta`` a float32 scalar;
    ``objective`` supplies the residual and (when l2 > 0) the decay
    fold — exact on every corner, since the s-bundle recurrence in
    ``inner_corrections`` is decay-aware."""
    m_local = indices.shape[0]
    bundles = sched.tau // sched.s
    s, b = sched.s, sched.b
    sb = s * b
    lam = objective.l2
    scale = eta_over_b(eta, b)
    rho_s = float(_integer_pow(_decay(eta, lam), s)) if lam != 0.0 else None

    def slice_bundle(t):
        start = bundle_start(round_idx * bundles + t, sb, m_local)
        return indices[start : start + sb], values[start : start + sb]

    if sched.delay:
        return delayed_bundle_scan(
            x, slice_bundle=slice_bundle, bundles=bundles, n=n, sched=sched,
            eta=eta, objective=objective, geometry=geometry,
        )

    for t in range(bundles):
        idx, val = slice_bundle(t)
        bundle = EllBlock(indices=idx, values=val, n=n)
        if s == 1:
            # FedAvg/MB-SGD corner: the Gram is empty (no deferred
            # updates to correct) — one SpMV + one SpMVᵀ, exactly
            # Algorithm 2's local step. The distributed corner sums the
            # full (G, v) bundle even at s = 1, so the counted payload
            # is pinned to the same sb² + sb words.
            yx = COUNTING.allreduce_cols(
                wire_gv(ell_matvec(bundle, x), sched.precision),
                calls_per_round=bundles,
                words_per_call=sb * sb + sb,
            )
            u = objective.residual(unwire_gv(yx, sched.precision, x.dtype))
        else:
            g, v = bundle_gram_v(idx, val, x, n, gram=sched.gram, bk=sched.bk,
                                 bm=sched.bm, precision=sched.precision, geometry=geometry)
            # row-team Allreduce of the bundle (G, v) — identity here
            # (the simulated rank computes the full reduction), the
            # recorded payload when the round body is captured.
            g, v = COUNTING.allreduce_cols(
                wire_gv((g, v), sched.precision), calls_per_round=bundles
            )
            g, v = unwire_gv((g, v), sched.precision)
            u = inner_corrections(g, v, s, b, eta, objective)
        upd = scale * ell_rmatvec(bundle, u).to(x.dtype)
        if lam == 0.0:
            x = x + upd
        else:
            # decay-folded update: x_s = ρ^s·x + (η/b)·Yᵀ·[ρ^{s-1-l}·u_l]
            # (inner_corrections already returns the ρ-weighted u; for
            # s = 1 the weight is ρ^0 = 1).
            x = rho_s * x + upd
    return x


def _one_round(tp: TeamProblem, x, r: int, eta, sched: ParallelSGDSchedule,
               geometry: tuple[int, int] | None = None, streams=None):
    """One outer round: τ inner iterations per row team + the p_r-team
    average. The single shared round body — eager or captured into a
    round's CUDA graph (``_run_rounds``), the monolithic loop and the
    chunked path run exactly this function, so they cannot drift. Teams
    run one after another on the one device (the JAX engine's
    batched-vs-sequential team branch is a memory choice of its
    compiler, not semantics) — or, given CUDA ``streams`` (one a team,
    while a round is captured), each on its own stream, forked from the
    current one and joined before the average."""
    def team(i):
        return _team_inner_iterations(
            tp.indices[i], tp.values[i], tp.n, x, r, eta, sched, tp.objective, geometry
        )

    if streams is None:
        parts = [team(i) for i in range(tp.p)]
    else:
        main = torch.cuda.current_stream()
        parts = []
        for i, stream in enumerate(streams):
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                parts.append(team(i))
        for stream in streams:
            main.wait_stream(stream)
    xs = torch.stack(parts)
    # column Allreduce: the p_r-team average, issued through the comm
    # plane (the per-rank payload is the balanced ⌈n/p_c⌉-word shard).
    return COUNTING.allmean_teams(xs, words_per_call=-(-tp.n // sched.p_c))


def check_delay(sched: ParallelSGDSchedule) -> None:
    """Solver-entry validation of the delay knob: the staging buffer
    drains inside the round, so D cannot exceed the per-round bundle
    count (entries past it would never be issued)."""
    bundles = sched.tau // sched.s
    if sched.delay > bundles:
        raise ValueError(
            f"delay={sched.delay} must be ≤ τ/s={bundles} (the per-round "
            f"bundle count): the staging buffer drains before each round's "
            f"parameter average"
        )


def _run_rounds(tp: TeamProblem, x: torch.Tensor, rounds: range, eta,
                sched: ParallelSGDSchedule, geometry: tuple[int, int] | None = None) -> torch.Tensor:
    """The round dispatcher of ``run_engine_chunk`` and ``run_parallel_sgd``:
    ``rounds`` of ``_one_round`` from ``x``. On CUDA tensors with
    ``gram="kernel"`` and no comm recorder installed, a round whose bundle
    offsets repeat within ``round_graph.CYCLE_CAP`` rounds is replayed from
    the problem's CUDA graph of its residue (``core/round_graph.py``);
    every other round, and the first sight of each residue, runs eagerly.
    ``bundle_gram_v`` and ``inner_corrections`` are looked up here, and a
    rebinding captures anew. Returns a tensor the caller owns."""
    graphs = None
    if sched.gram == "kernel" and not recording():
        graphs = round_graph.graphs_for(tp, x, sched, geometry)
    if graphs is None:
        for r in rounds:
            x = _one_round(tp, x, r, eta, sched, geometry)
        return x
    bindings = (bundle_gram_v, inner_corrections)
    for r in rounds:
        x = graphs.round(x, r, bindings,
                         lambda xin, streams, r=r: _one_round(tp, xin, r, eta, sched, geometry, streams))
    return graphs.release(x)


def engine_loss(gp: Problem, x: torch.Tensor) -> torch.Tensor:
    """The loss probe — the same ``problem_loss`` (under ``gp``'s
    objective) the monolithic loop samples at chunk boundaries."""
    return problem_loss(gp, x)


def run_engine_chunk(
    tp: TeamProblem,
    x: torch.Tensor,
    round_offset: int,
    k: int,
    sched: ParallelSGDSchedule,
    geometry: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Run ``k`` rounds starting at global round ``round_offset`` and
    return the new weights (on the problem's device; no host sync).
    ``geometry``: the Gram kernel's tuned (tile, ks), or None. ``x`` is
    left as it was, and the result is the caller's to keep.

    Calling it with offsets 0, k, 2k, … reproduces
    ``run_parallel_sgd``'s iterate sequence exactly, because both paths
    go through the same dispatcher (``_run_rounds``) over the same round
    indices."""
    if sched.eta <= 0:
        raise ValueError(f"eta={sched.eta} must be > 0 to run the solver")
    check_delay(sched)
    start = int(round_offset)
    return _run_rounds(tp, x, range(start, start + int(k)), np.float32(sched.eta), sched, geometry)


def run_parallel_sgd(
    tp: TeamProblem,
    x0: torch.Tensor,
    sched: ParallelSGDSchedule,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the full 2D family point described by ``sched`` on the
    stacked row teams ``tp`` (exact simulated-rank semantics), on the
    device ``tp``'s tensors live on.

    Each of ``sched.rounds`` outer rounds = τ inner s-step iterations
    per row team + one averaging across the p_r teams (identity when
    p_r = 1). Returns (x, losses) with the full global objective
    sampled every ``loss_every`` rounds; ``losses`` stays a device
    tensor and nothing is read back inside the loop.
    """
    if sched.eta <= 0:
        raise ValueError(f"eta={sched.eta} must be > 0 to run the solver")
    if sched.tau % sched.s:
        raise ValueError(
            f"tau={sched.tau} must be divisible by s={sched.s} (paper requires s ≤ τ)"
        )
    check_delay(sched)
    if tp.p != sched.p_r:
        raise ValueError(f"TeamProblem has p={tp.p} teams but schedule p_r={sched.p_r}")
    if tp.rows_local % (sched.s * sched.b):
        raise ValueError(
            f"local rows {tp.rows_local} must be divisible by s·b={sched.s * sched.b}"
        )
    eta = np.float32(sched.eta)
    gp = global_problem(tp)

    chunk = sched.loss_every if sched.loss_every else sched.rounds
    n_chunks = max(sched.rounds // chunk, 1)

    x = x0
    losses = []
    for c in range(n_chunks):
        x = _run_rounds(tp, x, range(c * chunk, (c + 1) * chunk), eta, sched)
        if sched.loss_every:
            losses.append(problem_loss(gp, x))
    if losses:
        return x, torch.stack(losses)
    return x, torch.zeros((0,), dtype=x0.dtype, device=x0.device)


def engine_comm_ledger(
    sched: ParallelSGDSchedule,
    n: int,
    tp: TeamProblem | None = None,
    width: int = 2,
) -> CommLedger:
    """The simulated engine's per-rank ``CommLedger``: every collective
    the round body issues, captured by running ``_one_round`` once on
    ``device="meta"`` tensors (no data, no arithmetic, no dataset).

    With ``tp`` given the capture uses the real problem's shapes;
    without it a shape-only stand-in is made (``width`` nonzeros per
    row, one bundle of rows per team) — the communication structure
    depends only on the schedule and n, never on the data, so both
    forms record identical rates. Spans come from the schedule's
    (p_r, p_c): the ledger of the simulated run is the ledger of the
    mesh execution it simulates."""
    if tp is None:
        shape = (sched.p_r, sched.s * sched.b, width)
        tp = TeamProblem(
            indices=torch.empty(shape, dtype=torch.int32, device="meta"),
            values=torch.empty(shape, dtype=torch.float32, device="meta"),
            rows_valid=torch.empty(shape[:2], dtype=torch.bool, device="meta"),
            p=sched.p_r,
            m=sched.p_r * shape[1],
            n=n,
        )
    else:
        tp = dataclasses.replace(
            tp, indices=tp.indices.to("meta"), values=tp.values.to("meta"),
            rows_valid=tp.rows_valid.to("meta"),
        )
    rates = capture_rates(
        partial(_one_round, sched=sched),
        tp,
        torch.empty((n,), dtype=torch.float32, device="meta"),
        0,
        np.float32(sched.eta),
        spans={"cols": sched.p_c, "rows": sched.p_r},
    )
    return CommLedger(rates=rates, delay=sched.delay)


def engine_phase_probes(tp: TeamProblem, sched: ParallelSGDSchedule,
                        geometry: tuple[int, int] | None = None) -> dict:
    """Per-phase probes for the simulated engine — the §6.5 phase split
    (compute vs. the two comm phases) on the round body's real payload
    shapes, *outside* the training step (which they never touch).

    Returns ``{phase: (fn, args, calls_per_round)}`` for ``time_phase``.
    On this engine the Gram "allreduce" is the identity (the simulated
    ranks already hold globally reduced values) and the parameter
    average is a real mean over the stacked team iterates — so the
    probed comm phases measure what the one-device simulation pays, not
    what a mesh would."""
    sb = sched.s * sched.b
    bundles = sched.tau // sched.s
    reps = -(-sb // tp.rows_local)
    bi = tp.indices[0].repeat(reps, 1)[:sb].contiguous()
    bv = tp.values[0].repeat(reps, 1)[:sb].contiguous()
    dev = tp.values.device
    x0 = torch.zeros((tp.n,), dtype=torch.float32, device=dev)

    def compute(i, v, x):
        return bundle_gram_v(i, v, x, tp.n, gram=sched.gram, bk=sched.bk, bm=sched.bm,
                             precision=sched.precision, geometry=geometry)

    g0 = torch.zeros((sb, sb), dtype=torch.float32, device=dev)
    v0 = torch.zeros((sb,), dtype=torch.float32, device=dev)
    xs = torch.zeros((sched.p_r, tp.n), dtype=torch.float32, device=dev)
    return {
        "bundle_compute": (compute, (bi, bv, x0), bundles),
        "allreduce_gv": (lambda g, v: (g + 0.0, v + 0.0), (g0, v0), bundles),
        "param_avg": (lambda t: torch.mean(t, dim=0), (xs,), 1),
    }


def single_team(problem: Problem) -> TeamProblem:
    """View a Problem as a 1-team TeamProblem (p_r = 1 corners); the
    objective rides along."""
    return TeamProblem(
        indices=problem.ya.indices[None],
        values=problem.ya.values[None],
        rows_valid=problem.rows_valid[None],
        p=1,
        m=problem.m,
        n=problem.n,
        objective=problem.objective,
    )
