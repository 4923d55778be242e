"""Public wrappers for the combining-RMW kernels.

Port of `repro.kernels.rmw.ops`.  The Hopper kernels take any table and
batch size, so there is no tile or block padding to do: these functions
cast the operands to what the kernels take (int32 indices, values of the
table's type) and map the per-op outputs to :class:`RmwResult`.

`rmw_apply` returns the updated table only; `rmw_apply_fetched` additionally
returns per-op serialized-order fetch results and CAS success flags — the
entry the engine's ``cuda`` backend (`core.rmw_engine`) calls.
"""

from __future__ import annotations

import torch

from repro_torch.core.rmw import RmwResult
from repro_torch.kernels.rmw import kernel as _k

Tensor = torch.Tensor


def _operands(table: Tensor, indices: Tensor, values: Tensor):
    return (indices.to(torch.int32).contiguous(),
            values.to(table.dtype).contiguous())


def rmw_apply(table: Tensor, indices: Tensor, values: Tensor,
              op: str = "faa") -> Tensor:
    """Combining-RMW a batch into a 1-D table.  Returns the updated table.

    Out-of-range indices are dropped (padding / masked tokens use index = n).
    """
    idx, val = _operands(table, indices, values)
    return _k.rmw_table(table.contiguous(), idx, val, op)


def rmw_apply_fetched(table: Tensor, indices: Tensor, values: Tensor,
                      op: str = "faa", *, expected=None) -> RmwResult:
    """Combining RMW with per-op fetched values (and CAS success flags).

    Out-of-range indices are dropped (fetched 0, success False).  CAS takes
    one uniform ``expected`` value.
    """
    idx, val = _operands(table, indices, values)
    return RmwResult(*_k.rmw_table_fetched(table.contiguous(), idx, val, op,
                                           expected=expected))


def histogram(indices: Tensor, num_bins: int) -> Tensor:
    """Expert-load histogram — FAA with unit values (MoE routing's counter)."""
    dev = indices.device
    return rmw_apply(torch.zeros((num_bins,), dtype=torch.float32, device=dev),
                     indices, torch.ones(indices.shape, dtype=torch.float32,
                                         device=dev), "faa")


def slot_occupancy(indices: Tensor, m: int) -> Tensor:
    """(m,) int32 exact per-slot occupancy via the counters kernel.

    The contention observatory's occupancy source when the ``cuda`` backend
    executed the batch.  Out-of-range indices are dropped.
    """
    return _k.slot_counts(indices.to(torch.int32).contiguous(), m)
