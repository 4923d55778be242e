"""AtomicTable: the typed table handle the atomics executor operates on.

Port of `repro.atomics.table`, local tables only.  A table sharded over
devices (``axis=``) belongs to the sharded tier, which a later slice ports
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_SHARDED_TODO = ("sharded AtomicTables (axis=/replica_axes=) belong to the "
                 "sharded tier, not ported yet (ROADMAP queue 1 item 6)")


class AtomicTable:
    """A 1-D table of atomic slots on one device."""

    __slots__ = ("data",)

    def __init__(self, data: Tensor, *, axis=None, replica_axes=()):
        if axis is not None or replica_axes:
            raise NotImplementedError(_SHARDED_TODO)
        data = torch.as_tensor(data)
        if data.dim() != 1:
            raise ValueError(f"AtomicTable data must be 1-D, "
                             f"got shape {tuple(data.shape)}")
        self.data = data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def with_data(self, data: Tensor) -> "AtomicTable":
        """Same handle, new contents."""
        return AtomicTable(data)

    def __repr__(self):
        return (f"AtomicTable({self.data.shape[0]} x {self.data.dtype}, "
                f"local on {self.data.device})")


def make_table(num_slots: int, dtype=torch.int32, *, fill=0,
               device="cuda") -> AtomicTable:
    """A local table of ``num_slots`` slots holding ``fill``."""
    return AtomicTable(torch.full((num_slots,), fill, dtype=dtype,
                                  device=device))
