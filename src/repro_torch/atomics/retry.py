"""`execute_until`: bounded-retry combinator for CAS loops, both tiers.

Port of `repro.atomics.retry`.  A failed CAS already *fetched* the winning
value — that pre-image is exactly the next attempt's ``expected``, so a
retry round never needs a separate read.  This module is that loop:

* each round executes one batched `atomics.execute`, on the local engine
  tier or, for a sharded table, on the sharded exchange tier (every rank
  of the table's mesh calls `execute_until` with the same ``make_ops``;
  each round's ops are scattered contiguously over the ranks in arrival
  order, and the round's fetched and success values gathered back, so
  every rank holds the same round history);
* only the **failed** ops are re-batched, their fetched pre-images becoming
  the next round's per-op ``expected`` and their payloads recomputed by
  the caller's ``make_ops`` (the ``F`` in the lock-free ``CAS(x, v, F(v))``);
* a pluggable :class:`RetryPolicy` shapes the retry stream (arxiv
  1305.5800): retry everything at once (``immediate``), shrink the
  per-round batch (``shrink``), or space rounds with exponentially growing
  idle time (``exponential``);
* the result carries **per-op round counts**.

Convergence: a fully contended batch (every op on one slot) resolves
exactly one op per round — each round's first pending op sees its
expected value and wins — so ``n`` ops need ``<= n`` rounds on both
tiers.  Within a round, ops execute in batch order (on a mesh, the rank
concatenation re-creates it), so the local and sharded tiers produce
identical round histories.

Telemetry: with the stream on, every round records ``atomics.retry.round``
(pending, issued and resolved counts, the tier's choice and its
``predicted_s``, the round's ``measured_s`` — its fetched and success
reads wait for the device — and round 0's observed distinct slots), and
every call ends with ``atomics.retry.done`` and its round-count histogram,
the contention signal.

Contention estimator: while a `repro_torch.tuning.SpecController` runs, each
call feeds its site's EWMA (`tuning.estimator`, keyed by op, tier and the
power-of-two buckets of the table's *global* slots and the batch) with
round 0's distinct slots — from the round-0 device pass
(`ContentionStats`, the ``slot_counts`` kernel on the card) by default, or
from the host's ``np.unique`` — and, for CAS, with the ops resolved on
their first attempt; a sharded call without a ``distinct_slots`` hint
takes the estimator's.  Without a controller nothing of this runs.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.atomics import contracts as _contracts
from repro_torch.atomics import stats as _cstats
from repro_torch.atomics.layout import norm_axes
from repro_torch.atomics.ops import OP_KINDS, AtomicOp, Cas
from repro_torch.atomics.table import AtomicTable
from repro_torch.telemetry import core as _tcore

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Retry policies (arxiv 1305.5800: contention management as explicit policy)
# ---------------------------------------------------------------------------

class RetryPolicy:
    """How failures are re-offered: batch sizing + inter-round spacing.

    ``batch_size(n_pending, rnd)`` says how many of the pending ops round
    ``rnd`` may issue; ``delay_s(rnd)`` is idle time *before* round
    ``rnd`` (0 for the first round).
    """

    name = "custom"

    def batch_size(self, n_pending: int, rnd: int) -> int:
        return n_pending

    def delay_s(self, rnd: int) -> float:
        return 0.0

    def __repr__(self):
        return f"{type(self).__name__}()"


class ImmediateRetry(RetryPolicy):
    """Re-offer every failed op next round, no spacing."""

    name = "immediate"


class ShrinkBatch(RetryPolicy):
    """Shrink the retry batch by ``factor`` each round after the first:
    losers that were going to fail anyway never hit the exchange."""

    name = "shrink"

    def __init__(self, factor: float = 0.5, min_batch: int = 1):
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"factor must be in (0, 1], got {factor}")
        self.factor = factor
        self.min_batch = max(1, int(min_batch))

    def batch_size(self, n_pending: int, rnd: int) -> int:
        if rnd == 0:
            return n_pending
        return max(self.min_batch, math.ceil(n_pending * self.factor))


class ExponentialBackoff(RetryPolicy):
    """Full retry batches spaced by exponentially growing idle time."""

    name = "exponential"

    def __init__(self, base_s: float = 1e-4, factor: float = 2.0,
                 max_s: float = 0.1):
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)

    def delay_s(self, rnd: int) -> float:
        if rnd <= 0:
            return 0.0
        return min(self.max_s, self.base_s * self.factor ** (rnd - 1))


POLICIES: Dict[str, Callable[[], RetryPolicy]] = {
    "immediate": ImmediateRetry,
    "shrink": ShrinkBatch,
    "exponential": ExponentialBackoff,
}


def _resolve_policy(policy: Union[str, RetryPolicy]) -> RetryPolicy:
    if isinstance(policy, RetryPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown retry policy {policy!r}; have "
                         f"{tuple(POLICIES)} or a RetryPolicy instance")


class RetryResult(NamedTuple):
    """Outcome of :func:`execute_until` (host arrays, original batch order).

    ``fetched[i]`` is op i's *last observed pre-image*; ``success[i]``
    whether it resolved within the round budget; ``rounds[i]`` how many
    attempts it took (1 = first try); ``pending`` the original positions
    still unresolved.  ``stats`` is round 0's
    :class:`~repro_torch.atomics.stats.ContentionStats` when the loop ran
    the device pass (``collect_stats=True``, or by default while a tuning
    controller runs), else None.
    """

    table: AtomicTable
    fetched: np.ndarray
    success: np.ndarray
    rounds: np.ndarray
    n_rounds: int
    pending: np.ndarray
    stats: Any = None


# ---------------------------------------------------------------------------
# One round on either tier
# ---------------------------------------------------------------------------

def _op(kind: str, idx: Tensor, vals: Tensor, exp: Optional[Tensor]):
    if kind == "cas":
        return Cas(idx, vals, expected=exp)
    return OP_KINDS[kind](idx, vals)


def _exec_round_sharded(table: AtomicTable, kind: str, idx, vals, exp, *,
                        backend: str, strategy: str, spec, distinct_slots,
                        collect_stats: bool):
    """One round on a sharded table: the round's ops padded to ``per``
    (a power of two) times the ranks, rank r taking the r-th slice in
    arrival order; fetched and success gathered back to every rank."""
    from repro_torch.atomics.execute import execute
    mesh = table.mesh
    axes = norm_axes(table.replica_axes) + norm_axes(table.axis)
    n_dev = mesh.size(axes)
    m_global = _global_m(table)
    dev = table.device
    k = len(idx)
    # a power of two a rank bounds the distinct shapes as the pending set
    # drains; padding ops target slot m_global (dropped: no table effect)
    per = 1 << max(0, (max(1, -(-k // n_dev)) - 1)).bit_length()
    total = per * n_dev
    idx_p = np.full(total, m_global, np.int64)
    idx_p[:k] = idx
    vals_p = np.zeros(total, vals.dtype)
    vals_p[:k] = vals
    exp_p = np.zeros(total, vals.dtype)
    if exp is not None:
        exp_p[:k] = exp
    me = slice(mesh.index(axes) * per, (mesh.index(axes) + 1) * per)
    t = lambda a, dt=None: torch.as_tensor(a[me], device=dev).to(
        dt or table.dtype)
    op = _op(kind, t(idx_p, torch.int32), t(vals_p),
             t(exp_p) if kind == "cas" else None)
    res = execute(table, op, need_fetched=True, backend=backend,
                  strategy=strategy, spec=spec,
                  distinct_slots=distinct_slots,
                  collect_stats=collect_stats)
    rows = torch.stack([res.fetched.contiguous().view(torch.int32),
                        res.success.to(torch.int32)], -1)
    rows = mesh.all_gather(rows, axes).cpu()
    fetched = rows[:k, 0].contiguous().view(table.dtype).numpy()
    info = None
    if telemetry.enabled():
        # the prediction half of the round event: per-op CAS routes to the
        # owner-oracle pass (unpriced); everything else is a combinable
        # exchange the selector can price per strategy
        shard_axes = norm_axes(table.axis)
        info = {"tier": "sharded", "n_exec": per, "m": m_global,
                "n_shards": mesh.size(shard_axes),
                "strategy": "perop_oracle", "predicted_s": None}
        if kind != "cas":
            try:
                from repro_torch.core import rmw_sharded as rs
                if strategy == "auto":
                    sel = rs.select_exchange_with_cost(
                        kind, per, m_global, rs._mesh_axes(
                            shard_axes, [mesh.size(a) for a in shard_axes],
                            None),
                        spec=spec, need_fetched=True,
                        distinct_slots=distinct_slots, device=dev)
                    info.update(strategy=sel.choice,
                                predicted_s=sel.predicted_s)
                else:
                    info.update(strategy=strategy)
            except Exception:  # noqa: BLE001 — never break the round
                pass
    return (res.table, fetched, rows[:k, 1].numpy().astype(bool), info,
            res.stats)


def _exec_round(table: AtomicTable, kind: str, idx, vals, exp, *,
                backend: str, strategy: str, spec, distinct_slots,
                collect_stats: bool):
    if table.is_sharded:
        return _exec_round_sharded(
            table, kind, idx, vals, exp, backend=backend, strategy=strategy,
            spec=spec, distinct_slots=distinct_slots,
            collect_stats=collect_stats)
    from repro_torch.atomics.execute import execute
    dev = table.device
    t = lambda a, dt=None: torch.as_tensor(a, device=dev).to(
        dt or table.dtype)
    op = _op(kind, t(idx, torch.int32), t(vals),
             t(exp) if kind == "cas" else None)
    info = None
    if telemetry.enabled():
        from repro_torch.core import rmw_engine
        m = int(table.data.shape[0])
        info = {"tier": "local", "n_exec": len(idx), "m": m,
                "strategy": None, "predicted_s": None}
        try:
            if backend == "auto":
                sel = rmw_engine.select_backend_with_cost(
                    kind, len(idx), m, spec, uniform_expected=kind != "cas",
                    dtype=table.dtype, device=dev)
                info.update(backend=sel.choice, predicted_s=sel.predicted_s)
            else:
                info.update(backend=backend)
        except Exception:  # noqa: BLE001 — never break the round
            pass
    res = execute(table, op, need_fetched=True, backend=backend, spec=spec,
                  collect_stats=collect_stats)
    return (res.table, res.fetched.cpu().numpy(),
            res.success.cpu().numpy().astype(bool), info, res.stats)


# ---------------------------------------------------------------------------
# The combinator
# ---------------------------------------------------------------------------

def _host(x, dtype) -> np.ndarray:
    if isinstance(x, Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype)


def _host_distinct(x: np.ndarray) -> int:
    """Round 0's distinct slots counted on the host — the estimator's
    observation when the device pass is off (a seam tests patch to show
    the default path skips it)."""
    return int(np.unique(x).size)


def _active_estimator():
    """The running tuning controller's contention estimator, or None.
    Probing ``sys.modules`` (not importing) keeps `repro_torch.atomics`
    free of the tuning package unless a controller was started."""
    import sys
    mod = sys.modules.get("repro_torch.tuning.controller")
    if mod is None:
        return None
    return mod.active_estimator()


def _global_m(table: AtomicTable) -> int:
    """The table's slots over the whole mesh (a sharded table's ``data``
    is this rank's shard)."""
    m = int(table.data.shape[0])
    if table.is_sharded:
        m *= table.mesh.size(table.axis)
    return m


def execute_until(table: Union[AtomicTable, Tensor],
                  make_ops: Callable, *,
                  max_rounds: int = 16,
                  policy: Union[str, RetryPolicy] = "immediate",
                  backend: str = "auto", strategy: str = "auto",
                  spec=None, distinct_slots: Optional[int] = None,
                  collect_stats: Optional[bool] = None,
                  sleep_fn: Callable[[float], None] = time.sleep
                  ) -> RetryResult:
    """Drive a batch of CAS loops to convergence in ``<= max_rounds`` rounds.

    * ``make_ops(None, None)`` (round 0) returns the initial
      :class:`~repro_torch.atomics.ops.AtomicOp` batch — typically a
      ``Cas`` (scalar or per-op ``expected``); any other op kind resolves
      in one round.
    * ``make_ops(slots, observed)`` (later rounds) receives the pending
      ops' slots and latest fetched pre-images (tensors on the table's
      device) and returns the new *values* for exactly those ops, or a full
      ``AtomicOp`` over them to also override ``expected``, or ``None`` to
      give up.  The combinator supplies ``expected = observed``.

    The table may be local or sharded; on a sharded table every rank of
    its mesh calls `execute_until` with the same ``make_ops`` and gets the
    same result.  ``strategy`` and ``distinct_slots`` apply to the sharded
    tier.

    ``distinct_slots`` (the exchange selector's contention hint) is
    estimator-backed: when a `repro_torch.tuning.SpecController` is running
    and the caller passes None on a sharded table, the hint is the
    contention estimator's EWMA over this call site's observed counts
    (round-0 distinct slots and CAS first-attempt winners).  An explicit
    value overrides it; without a controller None means no hint.

    ``collect_stats`` controls the round-0 device pass
    (:class:`~repro_torch.atomics.stats.ContentionStats`, returned in
    ``result.stats``): True forces it, False forces it off, and the default
    None turns it on exactly when an estimator is active, which then reads
    ``distinct_slots`` from the device pass and skips the host count.
    Results are identical in every mode.
    """
    pol = _resolve_policy(policy)
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    if _contracts._observer is not None:
        _contracts.notify("execute_until", table=table,
                          max_rounds=max_rounds, policy=pol.name)
    if not isinstance(table, AtomicTable):
        table = AtomicTable(table)
    op0 = make_ops(None, None)
    if not isinstance(op0, AtomicOp):
        raise TypeError(
            f"make_ops(None, None) must return an atomics op batch "
            f"(got {type(op0).__name__}) — e.g. "
            f"atomics.Cas(indices, values, expected=...)")
    kind = op0.kind
    n = int(op0.indices.shape[0])
    # the contention estimator, when a controller runs: the site's hint
    # for a sharded call that passed none (selection only, like the hint)
    est = _active_estimator()
    est_key = None
    if est is not None:
        from repro_torch.tuning.estimator import site_key
        est_key = site_key(kind, "sharded" if table.is_sharded else "local",
                           _global_m(table), n)
        if distinct_slots is None and table.is_sharded:
            distinct_slots = est.hint(est_key)
    # the device pass by default exactly when an estimator consumes it
    use_device = collect_stats if collect_stats is not None \
        else est is not None
    dt = torch.empty((), dtype=table.dtype).numpy().dtype
    slots = _host(op0.indices, np.int64).copy()
    values = _host(op0.values, dt).copy()
    is_cas = kind == "cas"
    expected = (np.broadcast_to(_host(op0.expected, dt), (n,)).copy()
                if is_cas else None)
    observed = expected.copy() if is_cas else np.zeros(n, dt)
    success = np.zeros(n, bool)
    rounds = np.zeros(n, np.int64)
    pending = np.arange(n)
    stats0 = None
    dev = table.device

    n_rounds = 0
    while len(pending) and n_rounds < max_rounds:
        rnd = n_rounds
        if rnd > 0:
            d = pol.delay_s(rnd)
            if d > 0:
                sleep_fn(d)
            made = make_ops(torch.as_tensor(slots[pending], device=dev),
                            torch.as_tensor(observed[pending], device=dev))
            if made is None:
                break
            if isinstance(made, AtomicOp):
                if made.kind != kind or \
                        int(made.indices.shape[0]) != len(pending):
                    raise ValueError(
                        f"make_ops must re-batch exactly the pending ops: "
                        f"wanted {len(pending)} {kind!r} ops, got "
                        f"{int(made.indices.shape[0])} {made.kind!r}")
                slots[pending] = _host(made.indices, np.int64)
                values[pending] = _host(made.values, dt)
                if is_cas:
                    expected[pending] = np.broadcast_to(
                        _host(made.expected, dt), (len(pending),))
            else:
                vals_new = _host(made, dt)
                if vals_new.shape != (len(pending),):
                    raise ValueError(
                        f"make_ops returned values of shape "
                        f"{vals_new.shape}; want ({len(pending)},) — one "
                        f"value per pending op")
                values[pending] = vals_new
                if is_cas:
                    # the feedback loop: pre-image becomes next expected
                    expected[pending] = observed[pending]
        k = max(1, min(pol.batch_size(len(pending), rnd), len(pending)))
        issue, defer = pending[:k], pending[k:]
        collect_now = use_device and rnd == 0
        distinct_obs = None
        if rnd == 0 and not use_device and (est is not None
                                            or telemetry.enabled()):
            # round 0's distinct slots from the host copy of the slots;
            # the device pass supersedes it when stats are collected
            distinct_obs = _host_distinct(slots[issue])
            if est is not None:
                est.update(est_key, distinct_obs)
        t0 = time.perf_counter()
        table, fetched, ok, info, st = _exec_round(
            table, kind, slots[issue], values[issue],
            expected[issue] if is_cas else None, backend=backend,
            strategy=strategy, spec=spec, distinct_slots=distinct_slots,
            collect_stats=collect_now)
        if st is not None:
            stats0 = st
            # the round's fetched and success reads waited for the device:
            # this is one scalar copy
            distinct_obs = int(st.distinct_slots)
            if est is not None:
                est.update(est_key, distinct_obs, source="device")
        if info is not None:
            if distinct_obs is not None:
                info["distinct_observed"] = distinct_obs
            # one event per round: the pending-count trajectory is the
            # contention signal, and (predicted_s, measured_s) feed the
            # drift tracker (the round's fetched and success reads wait for
            # the device, so the wall covers dispatch and execution)
            telemetry.record(
                "atomics.retry.round", op=kind, policy=pol.name, round=rnd,
                pending=len(pending), issued=int(k),
                resolved=int(ok.sum()),
                measured_s=time.perf_counter() - t0, **info)
        observed[issue] = fetched
        rounds[issue] += 1
        success[issue] = ok
        # freshly failed ops lead the next round: their pre-images are
        # current, so a round issuing any of them always makes progress;
        # deferred ops (stale pre-images under a shrinking policy) trail
        pending = np.concatenate([issue[~ok], defer])
        n_rounds += 1
    if est is not None and is_cas and n_rounds >= 1:
        # the round histogram's view of the same quantity: ops resolved on
        # their first attempt = one winner per contended slot + every
        # uncontended op (CAS only: other ops resolve in one round anyway)
        est.update(est_key, int(((rounds == 1) & success).sum()))
    if telemetry.enabled():
        tier = "sharded" if table.is_sharded else "local"
        # rounds[i] = attempts op i took; bincount over it is the per-call
        # contention histogram (index = attempt count, 0 = never issued)
        hist = np.bincount(rounds, minlength=n_rounds + 1).tolist()
        telemetry.record("atomics.retry.done", op=kind, policy=pol.name,
                         n=n, n_rounds=n_rounds, tier=tier,
                         resolved=int(success.sum()),
                         unresolved=int(len(pending)),
                         attempts=int(rounds.sum()), round_histogram=hist)
        if stats0 is not None and (table.is_sharded or not _tcore._sync):
            # the loop's own sync boundary; a local batch under sync is the
            # one case `execute` already recorded: one event per batch
            telemetry.record_event(_cstats.stats_to_fields(
                stats0, tier=tier, op=kind, n=n, m=_global_m(table),
                round=0))
    return RetryResult(table=table, fetched=observed, success=success,
                       rounds=rounds, n_rounds=n_rounds,
                       pending=np.sort(pending), stats=stats0)
