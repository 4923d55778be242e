"""Atomics front-end of the port: one typed API over both RMW tiers.

Port of `repro.atomics`.  Callers declare **what** they want
done (a typed op batch against a typed table) and the engine's cost model
decides **how**::

    from repro_torch import atomics

    table = atomics.make_table(4096, torch.int32)          # on "cuda"
    res = atomics.execute(table, atomics.Faa(idx, vals))
    res.table          # AtomicTable with the updated tensor in .data
    res.fetched        # per-op value observed before the op (serialized order)
    res.success        # per-op bool (CAS: expected matched)

    atomics.execute(table, atomics.Cas(idx, vals, expected=-1),
                    need_fetched=False)                    # table-only path
    atomics.arrival_rank(keys, num_keys)                   # FAA-fetch rank

    # every rank of an initialised torch.distributed world:
    mesh = Mesh((2, 4), ("pod", "dev"))
    shard = atomics.make_table(1 << 20, torch.int32, mesh=mesh,
                               axis=("pod", "dev"))        # this rank's
    atomics.execute(shard, atomics.Faa(global_idx, vals))  # shard

    atomics.execute_until(table, make_ops, max_rounds=8,
                          policy="immediate")    # bounded CAS-loop retry

Every result equals `core.rmw.rmw_serialized` applied to the same batch (on
a mesh: to the rank-ordered concatenation of the per-rank batches,
`layout.TableLayout`).  The migration half (`reshard`) moves a sharded
table onto another mesh by re-deriving that contract under the new
extents — one ``all_to_all`` slot exchange when both meshes hold the same
ranks, a gather when they do not — so every later `execute` equals a run
that was never resharded::

    atomics.migrate(shard, survivors)           # every rank of the world
"""

from repro_torch.atomics.ops import (  # noqa: F401
    OP_KINDS, AtomicOp, Cas, Faa, Max, Min, Swp)
from repro_torch.atomics.table import AtomicTable, make_table  # noqa: F401
from repro_torch.atomics.layout import TableLayout  # noqa: F401
from repro_torch.atomics.stats import ContentionStats  # noqa: F401
from repro_torch.atomics.execute import (  # noqa: F401
    AtomicResult, arrival_rank, execute)
from repro_torch.atomics.retry import (  # noqa: F401
    POLICIES, ExponentialBackoff, ImmediateRetry, RetryPolicy, RetryResult,
    ShrinkBatch, execute_until)
from repro_torch.atomics.reshard import (  # noqa: F401
    ReshardPlan, cost_replay, migrate, plan_reshard, restore_table,
    select_migration)

__all__ = [
    "AtomicOp", "Faa", "Swp", "Min", "Max", "Cas", "OP_KINDS",
    "AtomicTable", "make_table", "TableLayout",
    "AtomicResult", "ContentionStats", "execute", "arrival_rank",
    "RetryPolicy", "RetryResult", "execute_until", "POLICIES",
    "ImmediateRetry", "ShrinkBatch", "ExponentialBackoff",
    "ReshardPlan", "plan_reshard", "migrate", "restore_table",
    "select_migration", "cost_replay",
]
