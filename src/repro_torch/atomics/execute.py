"""`execute`: one entry point over both RMW execution tiers.

Port of `repro.atomics.execute`.  Dispatch:

1. **Tier** — an :class:`~repro_torch.atomics.table.AtomicTable` sharded
   over mesh axes (``table.axis``, with its ``table.mesh``) routes to the
   sharded tier (`core.rmw_sharded.execute_sharded`; every rank of the
   mesh calls `execute` together); a local table routes to the engine
   registry (`core.rmw_engine`).  A sharded table without a mesh, and the
   sharded-only arguments on a local table, raise with guidance.
2. **Strategy/backend** — the cost models pick the implementation:
   `select_backend` over the engine backends for the table's device,
   `select_exchange` over the exchange strategies; ``backend=`` and
   ``strategy=`` override them.  Both price with `rmw_engine.default_spec`
   when no ``spec`` is passed, so a tuning controller's live spec steers
   them; ``distinct_slots`` feeds the exchange selector's contention
   hint, estimator-backed under a running controller (`execute_until`).
3. **Semantics** — per-op-expected CAS runs on the serialized oracle
   locally, and across shards through the owner-side oracle pass.

Every path returns results equal to `core.rmw.rmw_serialized` on the same
batch (sharded: on the rank-ordered concatenation).

Telemetry: with the stream on, each op batch records one
``atomics.execute`` event — tier, the backend or strategy the selectors
pick, op, n, m, and the selector's ``predicted_s`` — and, under ``sync``,
``measured_s`` on the local tier: on the card, on the calls the stream's
sampling period picks (`telemetry.core.sync_due`), the device time
between two CUDA events (a pair of the device's
`telemetry.events.EventRing`) recorded around the dispatch on the current
stream, pending (`telemetry.DeviceSeconds`) until the stream resolves it
after the fact, with no synchronisation in the call; on the CPU, every
call, the host clock.  A call that collects stats is always measured,
between two synchronisations of the card, since its
``contention.stats`` event reads the stats then.
A sharded batch's time is measured by `execute_until`'s round event, as
in the reference.  The decision
fields are cached per shape, spec and spec epoch.  ``traced`` is always False
(eager torch has no trace time; the field keeps one schema with the
reference's events).  A local batch that collected stats also records
``contention.stats`` under ``sync``.
"""

from __future__ import annotations

import math
import time
from typing import Any, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import telemetry
from repro_torch.atomics import contracts as _contracts
from repro_torch.atomics import stats as _cstats
from repro_torch.atomics.layout import norm_axes
from repro_torch.atomics.ops import AtomicOp
from repro_torch.atomics.table import AtomicTable
from repro_torch.core import rmw as rmw_mod
from repro_torch.core import rmw_engine
from repro_torch.telemetry import core as _tcore
from repro_torch.telemetry import events as _tevents

Tensor = torch.Tensor


class AtomicResult(NamedTuple):
    """Result of `execute`: the updated table handle + per-op outputs.

    ``fetched[i]`` is the value op ``i`` observed *before* executing
    (serialized order), ``success[i]`` its CAS outcome (always True for
    non-CAS ops).  With ``need_fetched=False`` both are placeholders — only
    ``table`` is meaningful.  When `execute` was given a *sequence* of op
    batches, ``fetched``/``success`` are tuples, one entry per batch.

    ``stats`` is ``None`` unless the call passed ``collect_stats=True``, in
    which case it holds the batch's
    :class:`~repro_torch.atomics.stats.ContentionStats` (a tuple of them for
    a sequence of op batches).
    """

    table: AtomicTable
    fetched: Any
    success: Any
    stats: Any = None


def _local_exec_stats(table: Tensor, indices: Tensor, values: Tensor,
                      expected, *, op: str, backend: str, need_fetched: bool):
    """Local execution + contention stats.  ``backend`` arrives resolved.
    On a card the occupancy comes from the counters kernel (``slot_counts``)
    whichever backend ran the batch — it is the tuning estimator's device
    feed — and on the CPU from the engine's bincount pass."""
    res = rmw_engine.execute_backend(table, indices, values, op, expected,
                                     backend=backend,
                                     need_fetched=need_fetched)
    m = table.shape[0]
    if table.is_cuda:
        from repro_torch.kernels.rmw import ops as _kops
        occ = _kops.slot_occupancy(indices, m)
    else:
        occ = rmw_engine.slot_occupancy(indices, m)
    n_ops = ((indices >= 0) & (indices < m)).sum().to(torch.int32)
    return res, _cstats.stats_from_occupancy(occ, n_ops)


def _dispatch_one(table: AtomicTable, op: AtomicOp, *, need_fetched: bool,
                  backend: str, strategy: str, spec,
                  distinct_slots: Optional[int], reverse_ranks: bool,
                  collect_stats: bool):
    stats = None
    if table.is_sharded:
        if table.mesh is None or not table.mesh.can_exchange():
            raise ValueError(
                f"AtomicTable is sharded over mesh axes {table.axis!r} but "
                f"has no process group: build it with make_table(..., "
                f"mesh=Mesh(...)) on every rank of an initialised "
                f"torch.distributed world (the sharded tier uses "
                f"collectives), or build a local table")
        # deferred: core.rmw_sharded imports this package's layout and
        # stats, so binding it here keeps the package import acyclic
        from repro_torch.core.rmw_sharded import execute_sharded
        res = execute_sharded(
            table.data, op.indices, op.values, op.kind, op.expected,
            mesh=table.mesh, axis=table.axis,
            replica_axes=table.replica_axes, strategy=strategy,
            backend=backend, spec=spec, need_fetched=need_fetched,
            distinct_slots=distinct_slots, reverse_ranks=reverse_ranks,
            collect_stats=collect_stats)
        if collect_stats:
            res, stats = res
        return table.with_data(res.table), res.fetched, res.success, stats
    if reverse_ranks:
        # on one device the caller owns the whole order: reversing is just
        # flipping the batch
        raise ValueError(
            "reverse_ranks reverses the rank arrival order of the sharded "
            "tier; for a local table reverse the batch itself "
            "(indices.flip(0), values.flip(0))")
    if strategy != "auto" or distinct_slots is not None:
        # exchange strategies and hints exist only on the sharded tier:
        # running locally would silently skip the exchange
        raise ValueError(
            f"strategy={strategy!r} / distinct_slots apply to the sharded "
            f"tier only, but the table is local — build it sharded "
            f"(make_table(..., mesh=..., axis=...)) or drop the "
            f"sharded-tier arguments")
    if collect_stats:
        resolved = backend
        if resolved == "auto":
            resolved = rmw_engine.select_backend(
                op.kind, int(op.indices.shape[0]), int(table.data.shape[0]),
                spec, uniform_expected=op.uniform_expected,
                dtype=table.dtype, need_fetched=need_fetched,
                device=table.device)
        res, stats = _local_exec_stats(
            table.data, op.indices, op.values, op.expected, op=op.kind,
            backend=resolved, need_fetched=need_fetched)
    else:
        res = rmw_engine.execute_backend(
            table.data, op.indices, op.values, op.kind, op.expected,
            backend=backend, spec=spec, need_fetched=need_fetched)
    return table.with_data(res.table), res.fetched, res.success, stats


# ---------------------------------------------------------------------------
# Telemetry: one decision event per executed op batch
# ---------------------------------------------------------------------------

def _decision_fields(table: AtomicTable, op: AtomicOp, *, need_fetched: bool,
                     backend: str, strategy: str, spec,
                     distinct_slots: Optional[int]) -> dict:
    """Mirror the dispatch ladder's selection (same deterministic inputs ->
    same choice) into one flat event record: tier, choice, and the
    selector's predicted cost — the prediction half of the drift tracker.
    Never raises: a selection that cannot be priced records ``None``."""
    n = int(op.indices.shape[0])
    perop_cas = op.kind == "cas" and not op.uniform_expected
    fields = dict(op=op.kind, n=n, need_fetched=need_fetched,
                  distinct_slots=distinct_slots)
    dev = table.device
    try:
        if table.is_sharded:
            from repro_torch.core import rmw_sharded as rs
            shard_axes = norm_axes(table.axis)
            sizes = [table.mesh.size(a) for a in shard_axes]
            m_global = int(table.data.shape[0]) * math.prod(sizes)
            axes = rs._mesh_axes(shard_axes, sizes, None)
            fields.update(tier="sharded", m=m_global,
                          n_shards=math.prod(sizes), backend=backend)
            if perop_cas:
                # un-combined owner-oracle path: strategy does not apply
                # and the exchange cost model declines to price it
                fields.update(strategy="perop_oracle", predicted_s=None)
            elif strategy == "auto":
                rep = norm_axes(table.replica_axes)
                sel = rs.select_exchange_with_cost(
                    op.kind, n, m_global, axes, spec=spec,
                    need_fetched=need_fetched, uniform_expected=True,
                    replicas=table.mesh.size(rep) if rep else 1,
                    distinct_slots=distinct_slots, device=dev)
                fields.update(strategy=sel.choice,
                              predicted_s=sel.predicted_s)
            else:
                used = strategy
                if strategy == "hierarchical" and len(shard_axes) < 2:
                    used = "oneshot"    # the executor's documented demotion
                fields.update(strategy=used, predicted_s=rs.EXCHANGE_COSTS[
                    used](spec or rmw_engine.default_spec(dev), op.kind, n,
                          m_global, axes, need_fetched,
                          distinct_slots=distinct_slots,
                          device_type=dev.type))
        else:
            m = int(table.data.shape[0])
            fields.update(tier="local", m=m, strategy=None)
            if backend == "auto":
                sel = rmw_engine.select_backend_with_cost(
                    op.kind, n, m, spec, uniform_expected=not perop_cas,
                    dtype=table.dtype, need_fetched=need_fetched,
                    device=dev)
                fields.update(backend=sel.choice, predicted_s=sel.predicted_s)
            else:
                b = rmw_engine.BACKENDS.get(backend)
                fields.update(backend=backend, predicted_s=(
                    b.cost(spec or rmw_engine.default_spec(dev), op.kind, n,
                           m, need_fetched, dev.type)
                    if b is not None else None))
    except Exception:  # noqa: BLE001 — observability must not break dispatch
        fields.setdefault("tier", "sharded" if table.is_sharded else "local")
        fields.setdefault("predicted_s", None)
    return fields


#: measure every eager call on the card between two synchronisations
#: instead of by CUDA events (what `tools/tuning_probe.py` compares)
_SYNC_MEASURE = False

_raw_stream = _tevents.raw_stream

#: decision-field templates by (op, shapes, choice inputs, spec, epoch);
#: cleared when full
_DECISION_CACHE: dict = {}
_DECISION_CACHE_MAX = 1024


def _measured(table: AtomicTable, op: AtomicOp, kw: dict, synced: bool):
    """(`_dispatch_one`'s result, its time): on the card a pending
    `telemetry.DeviceSeconds` between two events of the device's
    `telemetry.events.EventRing` on the current stream, or with
    ``synced`` the host seconds between two synchronisations of the card;
    on the CPU the host seconds."""
    data = table.data
    if data.is_cuda and not synced:
        dev = data.get_device()
        ring = _tevents.ring(dev)
        stream = _raw_stream(dev)
        k = ring.take()
        if ring.record(ring.handle, 2 * k, stream):
            raise RuntimeError("cudaEventRecord failed")
        out = _dispatch_one(table, op, **kw)
        if ring.record(ring.handle, 2 * k + 1, stream):
            raise RuntimeError("cudaEventRecord failed")
        return out, _tcore.DeviceSeconds(k, ring=ring)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    t0 = time.perf_counter()
    out = _dispatch_one(table, op, **kw)
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    return out, time.perf_counter() - t0


def _axes_bound(table: AtomicTable) -> bool:
    """The reference's "mesh axes bound" in the port's terms: the table is
    local, or its mesh can exchange and carries every axis it names."""
    if not table.is_sharded:
        return True
    mesh = table.mesh
    if mesh is None or not mesh.can_exchange():
        return False
    return all(a in mesh.axis_names for a in norm_axes(table.axis)
               + norm_axes(table.replica_axes))


def _execute_one(table: AtomicTable, op: AtomicOp, *, need_fetched: bool,
                 backend: str, strategy: str, spec,
                 distinct_slots: Optional[int], reverse_ranks: bool,
                 collect_stats: bool):
    if not isinstance(op, AtomicOp):
        raise TypeError(
            f"ops must be atomics.Faa/Swp/Min/Max/Cas instances, "
            f"got {type(op).__name__}")
    kw = dict(need_fetched=need_fetched, backend=backend, strategy=strategy,
              spec=spec, distinct_slots=distinct_slots,
              reverse_ranks=reverse_ranks, collect_stats=collect_stats)
    if _contracts._observer is None:
        return _recorded(table, op, kw)
    # static analysis in progress: report this call site's contract before
    # dispatch (a sharded table without a mesh raises below, and the
    # analyzer turns the recorded site into the finding), and mark the
    # op's operands with the site's id, as the reference does
    sid = _contracts.next_site()
    for role, x in (("op_indices", op.indices), ("op_values", op.values),
                    ("op_expected", op.expected)):
        _contracts.mark(x, role, kind=op.kind, site=sid)
    _contracts.notify(
        "execute", table=table, op=op, site_id=sid,
        need_fetched=need_fetched, backend=backend, strategy=strategy,
        distinct_slots=distinct_slots, reverse_ranks=reverse_ranks,
        axes_bound=_axes_bound(table))
    out = _recorded(table, op, kw)
    # the result's data is the table's too (the reference's lineage follows
    # the sanctioned write's output)
    _contracts.mark(out[0].data, "table")
    return out


def _recorded(table: AtomicTable, op: AtomicOp, kw: dict):
    """`_dispatch_one`, measured and recorded as the stream asks."""
    collect_stats = kw["collect_stats"]
    # _tcore flag reads instead of the telemetry.*_enabled() accessors:
    # this is the hottest record site
    if not _tcore._enabled or (table.is_sharded and (
            table.mesh is None or not table.mesh.can_exchange())):
        # off, or a dispatch that raises its guidance un-instrumented
        return _dispatch_one(table, op, **kw)
    sharded = table.axis is not None
    # a sharded batch is measured by the caller that owns the round
    # (`execute_until`), as in the reference, whose sharded events are
    # trace-time ones; on the card the calls `sync_due` samples are
    # measured, and every call that collects stats (between two
    # synchronisations: its contention event needs them)
    measure = _tcore._sync and not sharded and (
        collect_stats or not table.data.is_cuda or _tcore.sync_due())
    measured_s = None
    synced = collect_stats or _SYNC_MEASURE
    # the batch is launched before the event is built, so the instrument's
    # host work overlaps the card's
    if _tcore._annotate:
        with telemetry.annotation(
                f"atomics.execute/{'sharded' if sharded else 'local'}"):
            if measure:
                out, measured_s = _measured(table, op, kw, synced)
            else:
                out = _dispatch_one(table, op, **kw)
    elif measure:
        out, measured_s = _measured(table, op, kw, synced)
    else:
        out = _dispatch_one(table, op, **kw)
    if measured_s is None and not _tcore._every_event:
        # only measured-only sinks listen (the tuning controller's tap):
        # an unmeasured decision event would carry nothing they read
        return out
    # a copy: the cached template stays pristine
    fields = _fields(table, op, kw, sharded).copy()
    if measured_s is not None:
        fields["measured_s"] = measured_s
        if type(measured_s) is _tcore.DeviceSeconds:
            _tcore.pend(fields)
    # the copy becomes the event itself (record_event skips the kwargs
    # rebuild that `record` pays)
    telemetry.record_event(fields)
    if out[3] is not None and measure:
        # contention.* events only at sync boundaries: the stats leaves
        # are ready, so the host readout costs no extra wait
        telemetry.record_event(_cstats.stats_to_fields(
            out[3], tier=fields.get("tier"), op=op.kind,
            n=fields.get("n"), m=fields.get("m"), traced=False))
    return out


def _fields(table: AtomicTable, op: AtomicOp, kw: dict, sharded: bool
            ) -> dict:
    """The call's decision-event template (`_decision_fields`), cached by
    the inputs that fix it."""
    need_fetched, backend, strategy = (kw["need_fetched"], kw["backend"],
                                       kw["strategy"])
    spec, distinct_slots = kw["spec"], kw["distinct_slots"]
    data = table.data
    # the cheapest reads that fix the decision: numel of the 1-D indices
    # and table (faster than shape[0]), the raw dtype object and
    # ``is_cuda`` (``data.device`` builds an object per call)
    kind = op.kind
    key = (kind, op.indices.numel(), data.numel(), backend, strategy,
           need_fetched, id(spec), distinct_slots, data.dtype, data.is_cuda,
           rmw_engine._SPEC_EPOCH)
    if kind == "cas":
        key += (op.uniform_expected,)
    if sharded:
        key += (table.axis, table.replica_axes, id(table.mesh))
    fields = _DECISION_CACHE.get(key)
    if fields is None:
        fields = _decision_fields(
            table, op, need_fetched=need_fetched, backend=backend,
            strategy=strategy, spec=spec, distinct_slots=distinct_slots)
        # a pre-stamped template
        fields.update(event="atomics.execute", traced=False)
        if len(_DECISION_CACHE) >= _DECISION_CACHE_MAX:
            _DECISION_CACHE.clear()
        _DECISION_CACHE[key] = fields
    return fields


def execute(table: Union[AtomicTable, Tensor],
            ops: Union[AtomicOp, Sequence[AtomicOp]], *,
            need_fetched: bool = True, backend: str = "auto",
            strategy: str = "auto", spec=None,
            distinct_slots: Optional[int] = None,
            reverse_ranks: bool = False,
            collect_stats: bool = False) -> AtomicResult:
    """Execute typed RMW op batches against a table, cost-model-routed.

    Args:
      table: an :class:`AtomicTable` (or a bare 1-D tensor, a local
        table).  The ops' tensors live on the table's device.  A sharded
        table's ``data`` is this rank's shard and ``indices`` are *global*
        slot ids; every rank of its mesh calls `execute` together.
      ops: one op batch (``atomics.Faa(idx, vals)`` ...) or a sequence,
        applied in order against the running table.
      need_fetched: False lets backends skip the per-op fetch machinery
        (table-only fast paths); ``fetched``/``success`` are then
        placeholders.
      backend: engine backend for local execution and the pre-combine /
        resolve passes of the sharded tier ("auto" =
        `rmw_engine.select_backend` for the table's device; or
        "serialized", "sort", "onehot", "cuda").
      strategy: exchange strategy of the sharded tier ("auto" =
        `rmw_sharded.select_exchange`).
      spec: `perf_model.HardwareSpec` override for the cost models.
      distinct_slots: sharded tier only — an observed estimate of the
        distinct slots a batch touches, the exchange selector's contention
        hint (selection only).  Optional: while a
        `repro_torch.tuning.SpecController` runs, repeated `execute_until`
        call sites get it from the contention estimator (an EWMA over
        their observed collision counts); pass it only to override that.
      reverse_ranks: sharded tier only — serialize ranks in *descending*
        order (the arrival order reversed at every exchange level).
      collect_stats: True additionally computes the batch's
        :class:`~repro_torch.atomics.stats.ContentionStats` — returned as
        ``result.stats`` (sharded: mesh-global, with per-level combining
        counts).  Results are identical either way.

    Returns:
      :class:`AtomicResult`, equal to the serialized oracle.
    """
    if not isinstance(table, AtomicTable):
        table = AtomicTable(table)
    kw = dict(need_fetched=need_fetched, backend=backend, strategy=strategy,
              spec=spec, distinct_slots=distinct_slots,
              reverse_ranks=reverse_ranks, collect_stats=collect_stats)
    if isinstance(ops, AtomicOp):
        table, fetched, success, stats = _execute_one(table, ops, **kw)
        return AtomicResult(table, fetched, success, stats)
    ops = tuple(ops)
    if not ops:
        raise ValueError("ops is empty")
    fetched_l, success_l, stats_l = [], [], []
    for op in ops:
        table, fetched, success, stats = _execute_one(table, op, **kw)
        fetched_l.append(fetched)
        success_l.append(success)
        stats_l.append(stats)
    return AtomicResult(table, tuple(fetched_l), tuple(success_l),
                        tuple(stats_l) if collect_stats else None)


def arrival_rank(keys: Tensor, num_keys: Optional[int] = None, *,
                 block: int = rmw_engine.DEFAULT_ONEHOT_BLOCK) -> Tensor:
    """Per-element arrival order among equal keys (0-based).

    ``rank[i]`` equals the fetched value of ``FAA(counter[key[i]], 1)``
    executed in element order.  With ``num_keys`` it is computed sort-free;
    without it, by stable sort + segmented scan.
    """
    if num_keys is None:
        return rmw_mod._arrival_rank_argsort(keys)
    return rmw_engine._arrival_rank_sortfree(keys, num_keys, block=block)
