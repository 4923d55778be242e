"""Atomics front-end of the port: one typed API over the local RMW tier.

Port of `repro.atomics`, local tier.  Callers declare **what** they want
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

Every result equals `core.rmw.rmw_serialized` applied to the same batch.
The sharded tier, `execute_until`, the layout and resharding come with later
slices.
"""

from repro_torch.atomics.ops import (  # noqa: F401
    OP_KINDS, AtomicOp, Cas, Faa, Max, Min, Swp)
from repro_torch.atomics.table import AtomicTable, make_table  # noqa: F401
from repro_torch.atomics.stats import ContentionStats  # noqa: F401
from repro_torch.atomics.execute import (  # noqa: F401
    AtomicResult, arrival_rank, execute)

__all__ = [
    "AtomicOp", "Faa", "Swp", "Min", "Max", "Cas", "OP_KINDS",
    "AtomicTable", "make_table", "AtomicResult", "ContentionStats",
    "execute", "arrival_rank",
]
