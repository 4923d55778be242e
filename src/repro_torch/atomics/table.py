"""AtomicTable: the typed table handle the atomics executor operates on.

Port of `repro.atomics.table`.  An :class:`AtomicTable` bundles the table
tensor with its *distribution contract*: which mesh axes shard it
(owner-major: global slot ``g`` lives on shard ``g // m_local``), which
axes replicate it (every replica holds the same shard; writers on all
replicas serialize replica-major), and the
:class:`~repro_torch.launch.mesh.Mesh` whose process groups carry the
exchange.  ``axis=None`` means a local table.  On a sharded table ``data``
is this rank's shard.  `repro_torch.atomics.layout.TableLayout` reifies
the contract (:meth:`AtomicTable.layout`).

:func:`make_table` builds a local table, or with ``mesh=`` this rank's
shard of a sharded one (empty on a rank outside a mesh that covers part
of the world).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.atomics import contracts as _contracts
from repro_torch.atomics.layout import norm_axes

Tensor = torch.Tensor
AxisNames = Union[str, Tuple[str, ...]]


def _norm_axis(axis) -> Optional[AxisNames]:
    if axis is None or isinstance(axis, str):
        return axis
    return tuple(axis)


class AtomicTable:
    """A 1-D table of atomic slots plus its mesh-distribution contract.

    Attributes:
      data:          the table tensor (sharded: this rank's shard).
      axis:          mesh axis name(s) the table is sharded over, or None
                     for a local table.
      replica_axes:  mesh axes over which the table is *replicated*.
      mesh:          the `Mesh` of a sharded table (None for a local one).
    """

    __slots__ = ("data", "axis", "replica_axes", "mesh")

    def __init__(self, data: Tensor, *, axis: Optional[AxisNames] = None,
                 replica_axes: AxisNames = (), mesh=None):
        data = torch.as_tensor(data)
        if data.dim() != 1:
            raise ValueError(f"AtomicTable data must be 1-D, "
                             f"got shape {tuple(data.shape)}")
        self.data = data
        self.axis = _norm_axis(axis)
        self.replica_axes = _norm_axis(replica_axes) or ()
        self.mesh = mesh
        if _contracts._observer is not None:
            _contracts.notify("table", table=self)
        if self.replica_axes and self.axis is None:
            # replica serialization belongs to the sharded executor: on a
            # local table each replica would just apply its own batch
            raise ValueError(
                "replica_axes requires axis: a table replicated over mesh "
                "axes must also name the axes it is sharded over (use "
                "axis=... ; for a purely local table drop replica_axes)")

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_sharded(self) -> bool:
        return self.axis is not None

    def with_data(self, data: Tensor) -> "AtomicTable":
        """Same distribution contract, new contents."""
        new = object.__new__(AtomicTable)
        new.data = data
        new.axis = self.axis
        new.replica_axes = self.replica_axes
        new.mesh = self.mesh
        return new

    def layout(self, mesh=None):
        """The table's :class:`~repro_torch.atomics.layout.TableLayout`."""
        from repro_torch.atomics.layout import TableLayout
        return TableLayout.from_table(self, mesh=mesh)

    def __repr__(self):
        where = (f"sharded over {self.axis!r}" if self.axis
                 else f"local on {self.data.device}")
        rep = (f", replicated over {self.replica_axes!r}"
               if self.replica_axes else "")
        return (f"AtomicTable({self.data.shape[0]} x {self.data.dtype}, "
                f"{where}{rep})")


def make_table(num_slots: int, dtype=torch.int32, *, fill=0, device="cuda",
               mesh=None, axis: Optional[AxisNames] = None,
               replica_axes: AxisNames = ()) -> AtomicTable:
    """A table of ``num_slots`` slots holding ``fill``.

    Without ``mesh``, a local table.  With ``mesh``, this rank's shard of a
    table of ``num_slots`` global slots, sharded owner-major over ``axis``
    (default: every mesh axis not in ``replica_axes``) and replicated over
    ``replica_axes``.
    """
    if mesh is None:
        if axis is not None or replica_axes:
            raise ValueError(
                f"axis={axis!r} / replica_axes={replica_axes!r} cannot be "
                f"honoured without a mesh: pass mesh=... (the table would "
                f"be local and the replica-major write contract lost)")
        return AtomicTable(torch.full((num_slots,), fill, dtype=dtype,
                                      device=device))
    rep = norm_axes(replica_axes)
    if axis is None:
        axis = tuple(a for a in mesh.axis_names if a not in rep)
    n_shards = math.prod(mesh.size(a) for a in norm_axes(axis))
    if num_slots % n_shards:
        raise ValueError(f"{num_slots} slots do not divide over "
                         f"{n_shards} shards of {axis!r}")
    # a rank outside a mesh that covers part of the world holds no shard
    rows = num_slots // n_shards if mesh.is_member else 0
    data = torch.full((rows,), fill, dtype=dtype, device=device)
    return AtomicTable(data, axis=axis, replica_axes=rep, mesh=mesh)
