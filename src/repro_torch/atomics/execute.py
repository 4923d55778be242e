"""`execute`: the one entry point of the local RMW tier.

Port of `repro.atomics.execute`, local tier.  A typed op batch against an
:class:`~repro_torch.atomics.table.AtomicTable` runs on the engine backend
the cost model picks for the table's device (`core.rmw_engine`), or the one
named by ``backend=``.  Per-op-expected CAS runs on the serialized oracle.
Every path returns results equal to `core.rmw.rmw_serialized` on the same
batch.  (The reference's telemetry branch and sharded tier come with their
own slices.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Union

import torch

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
                 backend: str, spec, collect_stats: bool):
    if not isinstance(op, AtomicOp):
        raise TypeError(
            f"ops must be atomics.Faa/Swp/Min/Max/Cas instances, "
            f"got {type(op).__name__}")
    stats = None
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
            need_fetched: bool = True, backend: str = "auto", spec=None,
            collect_stats: bool = False) -> AtomicResult:
    """Execute typed RMW op batches against a local table, cost-model-routed.

    Args:
      table: an :class:`AtomicTable` (or a bare 1-D tensor).  The ops'
        tensors live on the table's device.
      ops: one op batch (``atomics.Faa(idx, vals)`` ...) or a sequence,
        applied in order against the running table.
      need_fetched: False lets backends skip the per-op fetch machinery
        (table-only fast paths); ``fetched``/``success`` are then
        placeholders.
      backend: engine backend ("auto" = `rmw_engine.select_backend` for the
        table's device; or "serialized", "sort", "onehot", "cuda").
      spec: `perf_model.HardwareSpec` override for the cost model.
      collect_stats: True additionally computes the batch's
        :class:`~repro_torch.atomics.stats.ContentionStats` — returned as
        ``result.stats``.  Results are identical either way.

    Returns:
      :class:`AtomicResult`, equal to the serialized oracle.
    """
    if not isinstance(table, AtomicTable):
        table = AtomicTable(table)
    if isinstance(ops, AtomicOp):
        table, fetched, success, stats = _execute_one(
            table, ops, need_fetched=need_fetched, backend=backend,
            spec=spec, collect_stats=collect_stats)
        return AtomicResult(table, fetched, success, stats)
    ops = tuple(ops)
    if not ops:
        raise ValueError("ops is empty")
    fetched_l, success_l, stats_l = [], [], []
    for op in ops:
        table, fetched, success, stats = _execute_one(
            table, op, need_fetched=need_fetched, backend=backend,
            spec=spec, collect_stats=collect_stats)
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
