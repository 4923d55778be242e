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
   ``strategy=`` override them.
3. **Semantics** — per-op-expected CAS runs on the serialized oracle
   locally, and across shards through the owner-side oracle pass.

Every path returns results equal to `core.rmw.rmw_serialized` on the same
batch (sharded: on the rank-ordered concatenation).  (The reference's
telemetry branch comes with its own slice.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.atomics import contracts as _contracts
from repro_torch.atomics import stats as _cstats
from repro_torch.atomics.ops import AtomicOp
from repro_torch.atomics.table import AtomicTable
from repro_torch.core import rmw as rmw_mod
from repro_torch.core import rmw_engine

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
    """Local execution + contention stats.  ``backend`` arrives resolved:
    when the kernels ran the batch, the occupancy comes from the counters
    kernel, else from the engine's bincount pass."""
    res = rmw_engine.execute_backend(table, indices, values, op, expected,
                                     backend=backend,
                                     need_fetched=need_fetched)
    m = table.shape[0]
    if backend == "cuda":
        from repro_torch.kernels.rmw import ops as _kops
        occ = _kops.slot_occupancy(indices, m)
    else:
        occ = rmw_engine.slot_occupancy(indices, m)
    n_ops = ((indices >= 0) & (indices < m)).sum().to(torch.int32)
    return res, _cstats.stats_from_occupancy(occ, n_ops)


def _execute_one(table: AtomicTable, op: AtomicOp, *, need_fetched: bool,
                 backend: str, strategy: str, spec,
                 distinct_slots: Optional[int], reverse_ranks: bool,
                 collect_stats: bool):
    if not isinstance(op, AtomicOp):
        raise TypeError(
            f"ops must be atomics.Faa/Swp/Min/Max/Cas instances, "
            f"got {type(op).__name__}")
    if _contracts._observer is not None:
        _contracts.notify(
            "execute", table=table, op=op, need_fetched=need_fetched,
            backend=backend, strategy=strategy,
            distinct_slots=distinct_slots, reverse_ranks=reverse_ranks)
    stats = None
    if table.is_sharded:
        if table.mesh is None or not dist.is_initialized():
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
        hint (selection only).
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
