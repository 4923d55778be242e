"""TableLayout: the owner-major slot->shard contract as a first-class object.

Port of `repro.atomics.layout`.  The contract of a sharded table:

* **owner-major layout**: global slot ``g`` lives on shard ``g // m_local``
  at local row ``g % m_local``; shards are laid out major-to-minor over the
  table's ``axis`` tuple (:func:`owner_shard`, :func:`local_row` are the
  single home for that arithmetic — the sharded executor imports them).
* **replica contract**: ranks along ``replica_axes`` hold identical copies
  of their shard; writers on every replica serialize replica-major.
* **rank arrival order**: `atomics.execute` results equal the serialized
  oracle applied to the concatenation of per-rank batches ordered by rank
  — lexicographic over ``replica_axes + axis`` (major to minor), each
  rank's ops in local order (:meth:`TableLayout.arrival_rank_of_device`).

A :class:`TableLayout` is derived from a table and the port's
:class:`~repro_torch.launch.mesh.Mesh` (:meth:`TableLayout.from_mesh`,
:meth:`TableLayout.from_table`) and is JSON-serializable
(:meth:`~TableLayout.to_dict` / :meth:`~TableLayout.from_dict`), in the
reference's format.  Devices are the mesh's ranks, numbered row-major over
its axes as `jax.make_mesh` numbers devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor
AxisNames = Union[str, Tuple[str, ...], None]


def norm_axes(axis: AxisNames) -> Tuple[str, ...]:
    """Normalize an axis spec (None / str / tuple) to a tuple of names."""
    if axis is None:
        return ()
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def dtype_name(dtype) -> str:
    """``torch.int32`` -> ``"int32"``: the reference's dtype strings."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Owner-major arithmetic (the single home; rmw_sharded imports these)
# ---------------------------------------------------------------------------

def owner_shard(gidx: Tensor, m_local: int, n_shards: int) -> Tensor:
    """Destination shard of each global slot id under owner-major layout.

    Valid ids map to ``g // m_local``; anything else (already remapped to
    ``>= m_global`` by the caller's OOR pass) clamps to the last shard,
    whose resolve pass drops it via the scratch row.
    """
    return torch.clamp(torch.div(gidx, m_local, rounding_mode="floor"),
                       max=n_shards - 1)


def local_row(gidx: Tensor, shard: int, m_local: int, m_global: int
              ) -> Tensor:
    """Local row of a global slot on its owner; OOR ids -> the scratch row
    (``m_local``), matching the engine's drop convention."""
    return torch.where(gidx < m_global, gidx - shard * m_local, m_local)


# ---------------------------------------------------------------------------
# The layout record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableLayout:
    """One table's distribution contract, independent of live buffers.

    Attributes:
      num_slots:    global table length (slots are dense ``0..num_slots-1``).
      dtype:        slot dtype, as a string (JSON-safe, ``"int32"``).
      axis:         mesh axis name(s) the table shards over, major-to-minor
                    (empty tuple = local table).
      replica_axes: mesh axes holding identical shard copies.
      mesh_axes:    the full mesh shape as ``((name, size), ...)`` in mesh
                    order — the extents the owner-major layout was derived
                    under.
    """

    num_slots: int
    dtype: str
    axis: Tuple[str, ...] = ()
    replica_axes: Tuple[str, ...] = ()
    mesh_axes: Tuple[Tuple[str, int], ...] = ()

    # --- derived extents --------------------------------------------------
    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.mesh_axes)

    def _size(self, names: Sequence[str]) -> int:
        sizes = self.axis_sizes
        return math.prod(sizes.get(n, 1) for n in names)

    @property
    def n_shards(self) -> int:
        return self._size(self.axis)

    @property
    def n_replicas(self) -> int:
        return self._size(self.replica_axes)

    @property
    def m_local(self) -> int:
        if self.num_slots % max(self.n_shards, 1):
            raise ValueError(
                f"{self.num_slots} slots do not divide over "
                f"{self.n_shards} shards ({self.axis!r} x {self.mesh_axes!r})")
        return self.num_slots // max(self.n_shards, 1)

    @property
    def is_sharded(self) -> bool:
        return bool(self.axis)

    # --- per-device derivations (device order = mesh C-order) -------------
    def _coords(self, flat: int) -> Dict[str, int]:
        names = [n for n, _ in self.mesh_axes]
        sizes = [s for _, s in self.mesh_axes]
        return dict(zip(names, (int(c) for c in
                                np.unravel_index(flat, sizes))))

    def _rank_over(self, names: Sequence[str], coords: Dict[str, int]) -> int:
        rank = 0
        for n in names:
            rank = rank * self.axis_sizes[n] + coords[n]
        return rank

    def shard_of_device(self, flat: int) -> int:
        """Owner-major shard id held by the device at mesh flat index."""
        return self._rank_over(self.axis, self._coords(flat))

    def replica_rank_of_device(self, flat: int) -> int:
        return self._rank_over(self.replica_axes, self._coords(flat))

    def arrival_rank_of_device(self, flat: int) -> int:
        """The rank arrival order: lexicographic over ``replica_axes +
        axis`` (major to minor) — the rank at which this device's local
        batch lands in the serialized-oracle concatenation."""
        return self._rank_over(self.replica_axes + self.axis,
                               self._coords(flat))

    def arrival_order(self) -> np.ndarray:
        """Mesh flat device indices sorted by arrival rank (the order a
        serialized oracle must concatenate per-device batches in)."""
        n = self._size([n for n, _ in self.mesh_axes])
        ranks = [self.arrival_rank_of_device(i) for i in range(n)]
        return np.argsort(np.asarray(ranks), kind="stable")

    def rows_of_shard(self, shard: int) -> Tuple[int, int]:
        """[start, end) global row range owned by a shard."""
        return shard * self.m_local, (shard + 1) * self.m_local

    # --- constructors / serialization -------------------------------------
    @classmethod
    def from_mesh(cls, mesh, *, num_slots: int, dtype,
                  axis: AxisNames, replica_axes: AxisNames = ()
                  ) -> "TableLayout":
        """The layout over a :class:`~repro_torch.launch.mesh.Mesh` (or
        anything with ``axis_names`` and a name -> size ``shape``)."""
        mesh_axes = tuple((str(n), int(mesh.shape[n]))
                          for n in mesh.axis_names)
        lay = cls(num_slots=int(num_slots), dtype=dtype_name(dtype),
                  axis=norm_axes(axis), replica_axes=norm_axes(replica_axes),
                  mesh_axes=mesh_axes)
        known = lay.axis_sizes
        for name in lay.axis + lay.replica_axes:
            if name not in known:
                raise ValueError(f"axis {name!r} not on mesh "
                                 f"{list(known)!r}")
        lay.m_local  # divisibility check
        return lay

    @classmethod
    def from_table(cls, table, mesh=None) -> "TableLayout":
        """The layout of a live `AtomicTable` handle.  A sharded table's
        ``data`` is this rank's shard, so ``num_slots`` is its length times
        the shard count; ``mesh`` defaults to the table's own."""
        axis = norm_axes(table.axis)
        if not axis:
            return cls(num_slots=int(table.data.shape[0]),
                       dtype=dtype_name(table.data.dtype))
        mesh = mesh if mesh is not None else table.mesh
        if mesh is None:
            raise ValueError("cannot derive the layout of a sharded table "
                             "without a mesh: pass mesh=...")
        n_shards = math.prod(mesh.shape[a] for a in axis)
        return cls.from_mesh(mesh, num_slots=int(table.data.shape[0])
                             * n_shards, dtype=table.data.dtype, axis=axis,
                             replica_axes=table.replica_axes)

    def to_dict(self) -> Dict:
        return {"num_slots": self.num_slots, "dtype": self.dtype,
                "axis": list(self.axis),
                "replica_axes": list(self.replica_axes),
                "mesh_axes": [[n, s] for n, s in self.mesh_axes]}

    @classmethod
    def from_dict(cls, d: Dict) -> "TableLayout":
        return cls(num_slots=int(d["num_slots"]), dtype=str(d["dtype"]),
                   axis=tuple(d.get("axis") or ()),
                   replica_axes=tuple(d.get("replica_axes") or ()),
                   mesh_axes=tuple((str(n), int(s))
                                   for n, s in d.get("mesh_axes") or ()))

    def __repr__(self):
        where = (f"sharded over {self.axis!r}" if self.axis else "local")
        rep = (f", replicated over {self.replica_axes!r}"
               if self.replica_axes else "")
        return (f"TableLayout({self.num_slots} x {self.dtype}, {where}{rep}, "
                f"mesh={dict(self.mesh_axes)!r})")
