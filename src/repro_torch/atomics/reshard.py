"""Elastic table migration: reshard live `AtomicTable`s across mesh changes.

Port of `repro.atomics.reshard`.  Ownership is a pure function of (slot,
extent) — global slot ``g`` lives on shard ``g // m_local`` — so changing
the mesh never needs the RMW history that built a table: re-derive the
layout under the new extents, move each slot to its new owner once, and
every later `atomics.execute` equals a run that was never resharded (the
arrival order is a property of the *current* mesh, re-derived the same
way).

Two paths, chosen by the migration tier of the `HardwareSpec` cost model
(`select_migration`, the sibling of `select_backend` / `select_exchange`):

``"exchange"``     both meshes are live over the SAME member ranks (axis
                   re-arrangement, replica-contract change, shard-count
                   change across a fixed fleet).  Each rank sends the
                   contiguous run of its old shard that each new shard
                   owns, one lane of ``min(m_a, m_b)`` slots per
                   destination, in ONE ``Mesh.all_to_all`` over the
                   destination mesh, and writes what it receives at its
                   global offset.
``"device_put"``   gather the global table from its owners with one
                   world-level collective (`Mesh.all_gather_world`), then
                   keep the new shard: the only path when the member ranks
                   changed or the source is host data (a checkpoint).

A mesh may cover part of the world (`Mesh(..., ranks=...)`).  On a rank
outside a table's mesh the handle's ``data`` is empty: the rank holds no
shard, but it still calls every function here with the others (SPMD),
since the world-level gather needs it.

Entry points: :func:`plan_reshard` (a :class:`ReshardPlan`, path and
predicted costs, touching no data), :meth:`ReshardPlan.execute`,
:func:`migrate` (both in one call; what `runtime.elastic` uses),
:func:`restore_table` (the checkpoint half, under `launch.mesh.active_mesh`)
and :func:`cost_replay` (what migration is priced against).  With the
telemetry stream on, `migrate` records one ``atomics.reshard.migrate``
event — the path, every path's prediction and the measured seconds (the
card synchronised on both sides) — inside an ``atomics.reshard.migrate/
<path>`` annotation.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.atomics.layout import TableLayout, norm_axes
from repro_torch.atomics.table import AtomicTable

Tensor = torch.Tensor

PATHS = ("exchange", "device_put")


# ---------------------------------------------------------------------------
# Cost model: the migration tier (HardwareSpec constants, like the others)
# ---------------------------------------------------------------------------

def _mesh_axes_of(layout: TableLayout):
    """Price the layout's mesh with the default topology heuristic
    (outermost axis crosses pods when there is more than one level)."""
    from repro_torch.core.rmw_sharded import _mesh_axes
    names = [n for n, _ in layout.mesh_axes]
    sizes = [s for _, s in layout.mesh_axes]
    return _mesh_axes(names, sizes, None)


def _itemsize(layout: TableLayout) -> int:
    return getattr(torch, layout.dtype).itemsize


def cost_migrate_exchange(spec, src: TableLayout, dst: TableLayout) -> float:
    """One padded all_to_all over the destination mesh: per-rank payload is
    ``n_dev`` lanes of ``min(m_local_src, m_local_dst)`` slots."""
    from repro_torch.core.rmw_sharded import _a2a_s
    n_dev = math.prod(s for _, s in dst.mesh_axes) or 1
    cap = min(src.m_local, dst.m_local)
    return _a2a_s(spec, n_dev * cap * _itemsize(dst), _mesh_axes_of(dst))


def cost_migrate_device_put(spec, src: TableLayout,
                            dst: TableLayout) -> float:
    """Host roundtrip: the whole table crosses the host link twice (gather
    down, scatter up) plus one placement dispatch per shard copy."""
    from repro_torch.core.placement import Tier
    nbytes = dst.num_slots * _itemsize(dst)
    host_bw = getattr(spec, "host_roundtrip_Bps", 0.0) \
        or spec.tier_bandwidth_Bps[Tier.HOST]
    launch = getattr(spec, "device_put_launch_s", 0.0) or 1e-4
    copies = max(1, dst.n_shards * dst.n_replicas)
    return 2.0 * nbytes / host_bw + launch * (1 + math.log2(max(2, copies)))


MIGRATION_COSTS = {
    "exchange": cost_migrate_exchange,
    "device_put": cost_migrate_device_put,
}


def cost_replay(spec, dst: TableLayout, n_ops_total: int, *,
                op: str = "faa", n_batches: int = 1,
                need_fetched: bool = True,
                device_type: str = "cuda") -> float:
    """Price of the alternative: start from the initial table on the new
    mesh and re-execute the recorded op history through the sharded tier
    (one-shot exchange per batch, its engine passes priced for
    ``device_type``).  Migration must beat this for any history that
    touched the table more than trivially."""
    from repro_torch.core.rmw_sharded import cost_exchange_oneshot
    axes = _mesh_axes_of(dst)
    n_dev = math.prod(s for _, s in dst.mesh_axes) or 1
    n_per = max(1, -(-n_ops_total // max(1, n_batches) // n_dev))
    per_batch = cost_exchange_oneshot(spec, op, n_per, dst.num_slots, axes,
                                      need_fetched, device_type=device_type)
    return n_batches * per_batch


def select_migration(src: TableLayout, dst: TableLayout, *,
                     exchange_feasible: bool, spec=None) -> str:
    """Cheapest feasible migration path.  ``exchange_feasible`` is
    topology truth (both meshes live over the same ranks), not a
    preference; the model only arbitrates when both paths can run."""
    if not exchange_feasible:
        return "device_put"
    from repro_torch.core import rmw_engine
    spec = spec or rmw_engine.default_spec()
    return min(MIGRATION_COSTS,
               key=lambda p: MIGRATION_COSTS[p](spec, src, dst))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """One planned migration: layouts, chosen path, predicted costs.

    Build with :func:`plan_reshard`; run with :meth:`execute`.  The plan is
    data-independent: one plan migrates any table matching ``src``.
    """

    src: TableLayout
    dst: TableLayout
    path: str                      # "exchange" | "device_put"
    predicted_s: Dict[str, float]  # per path; inf = infeasible
    dst_mesh: object = dataclasses.field(repr=False, default=None)
    src_mesh: object = dataclasses.field(repr=False, default=None)

    def execute(self, table, *, device=None) -> AtomicTable:
        """Migrate ``table`` onto the destination mesh.  ``table`` is a
        live `AtomicTable` in the ``src`` layout (sharded: this rank's
        shard, empty outside its mesh), or the whole table (a tensor or a
        host array) when ``src`` is local; host data lands on ``device``
        (default: the card).  Returns this rank's handle under the
        re-derived contract; contents are bit-identical slot for slot."""
        data = table.data if isinstance(table, AtomicTable) else table
        if device is None:
            device = data.device if isinstance(data, Tensor) else "cuda"
        if not isinstance(data, Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        member = (not self.src.is_sharded or self.src_mesh is None
                  or self.src_mesh.is_member)
        want = (self.src.m_local if self.src.is_sharded else
                self.src.num_slots) if member else 0
        if int(data.shape[0]) != want:
            raise ValueError(f"table holds {data.shape[0]} slots here; plan "
                             f"expects {want} ({self.src})")
        if self.path == "exchange":
            out = _exchange_slots(data, self.src, self.dst, self.src_mesh,
                                  self.dst_mesh)
        else:
            out = _device_put_slots(data, self.src, self.dst, self.src_mesh,
                                    self.dst_mesh, device)
        if not self.dst.is_sharded:
            return AtomicTable(out)
        return AtomicTable(out, axis=self.dst.axis,
                           replica_axes=self.dst.replica_axes,
                           mesh=self.dst_mesh)


def _same_members(mesh_a, mesh_b) -> bool:
    if mesh_a is None or mesh_b is None:
        return False
    return set(mesh_a.ranks) == set(mesh_b.ranks)


def plan_reshard(src: TableLayout, dst: TableLayout, *, dst_mesh,
                 src_mesh=None, live: bool = True, path: str = "auto",
                 spec=None, device="cuda") -> ReshardPlan:
    """Plan a migration from layout ``src`` to layout ``dst``.

    ``live`` says the source table still exists on the ranks of
    ``src_mesh`` (False for checkpointed host data — only ``device_put``
    can run).  ``path`` forces a specific path ("auto" = the cheaper of the
    feasible ones); ``spec`` defaults to the engine's spec for ``device``.
    """
    if src.num_slots != dst.num_slots:
        raise ValueError(
            f"slot-count changes are not migrations ({src.num_slots} -> "
            f"{dst.num_slots}); grow the table first, then reshard")
    feasible = bool(live and dst.is_sharded and src.is_sharded
                    and _same_members(src_mesh, dst_mesh))
    from repro_torch.core import rmw_engine
    spec = spec or rmw_engine.default_spec(device)
    predicted = {
        "exchange": (cost_migrate_exchange(spec, src, dst)
                     if feasible else float("inf")),
        "device_put": cost_migrate_device_put(spec, src, dst),
    }
    if path == "auto":
        # the plan's choice IS its stored predictions (infeasible = inf)
        path = min(predicted, key=predicted.get)
    elif path not in PATHS:
        raise ValueError(f"unknown path {path!r}; have {PATHS}")
    elif path == "exchange" and not feasible:
        raise ValueError(
            "path='exchange' needs both meshes live on the same device set "
            "(the same member ranks; use 'device_put' when the fleet "
            "changed or the source is a checkpoint)")
    return ReshardPlan(src=src, dst=dst, path=path, predicted_s=predicted,
                       dst_mesh=dst_mesh, src_mesh=src_mesh)


def live_layout(table: AtomicTable, mesh=None) -> TableLayout:
    """The layout of a live table, its global slot count agreed by every
    rank of the world when the table's mesh covers only part of it (a rank
    outside holds no shard to count; one world-level gather of an int)."""
    mesh = mesh if mesh is not None else table.mesh
    lay = TableLayout.from_table(table, mesh=mesh)
    if not lay.is_sharded or len(mesh.ranks) == dist.get_world_size():
        return lay
    n = mesh.all_gather_world(torch.tensor([lay.num_slots],
                                           dtype=torch.int64,
                                           device=table.device))
    return dataclasses.replace(lay, num_slots=int(n.max()))


def _first_holders(layout: TableLayout, mesh) -> Dict[int, int]:
    """Shard -> the lowest mesh flat index holding it (a replicated
    shard's one sender)."""
    first: Dict[int, int] = {}
    for f in range(len(mesh.ranks)):
        first.setdefault(layout.shard_of_device(f), f)
    return first


def gather_table(data: Tensor, layout: TableLayout, mesh) -> Tensor:
    """The whole table on every rank of the world, from a sharded table's
    shards (``data``: this rank's, empty outside ``mesh``): one
    world-level gather of one lane a rank, in which each shard's lowest
    holder sends it.  Every rank of the world calls it."""
    first = _first_holders(layout, mesh)
    m_a = layout.m_local
    sends = mesh.is_member and first[
        layout.shard_of_device(mesh.flat)] == mesh.flat
    lanes = mesh.all_gather_world(data if sends else data.new_zeros(m_a))
    return torch.cat([lanes[mesh.ranks[first[s]]]
                      for s in range(layout.n_shards)])


# ---------------------------------------------------------------------------
# Path 1: in-collective slot exchange (same member ranks, both meshes live)
# ---------------------------------------------------------------------------

def _run_between(r: int, s: int, m_a: int, m_b: int) -> Tuple[int, int]:
    """(global offset, length) of the slots old shard ``r`` and new shard
    ``s`` share: one contiguous run, since both layouts split ``[0, m)``
    owner-major."""
    o = max(r * m_a, s * m_b)
    return o, max(0, min((r + 1) * m_a, (s + 1) * m_b) - o)


def _exchange_slots(data: Tensor, src: TableLayout, dst: TableLayout,
                    src_mesh, dst_mesh) -> Tensor:
    """Move every slot to its new owner with ONE padded all_to_all over the
    destination mesh.  Lane ``k`` of a rank's send buffer carries the run
    of its old shard that the rank of flat index ``k`` on the new mesh
    owns, padded to ``cap = min(m_a, m_b)``; a replicated source shard is
    sent by its lowest old holder only, and every replicated destination
    receives its own copy.  Validity comes from the run lengths, never
    from the values (a zero is a valid slot value)."""
    if not dst_mesh.is_member:
        return data.new_empty((0,))
    n_dev = len(dst_mesh.ranks)
    m_a, m_b = src.m_local, dst.m_local
    cap = min(m_a, m_b)
    # per new flat index: the old shard held there and whether it sends
    old_flat = [src_mesh.ranks.index(r) for r in dst_mesh.ranks]
    src_shard = [src.shard_of_device(f) for f in old_flat]
    first = _first_holders(src, src_mesh)
    src_primary = [first[s] == f for s, f in zip(src_shard, old_flat)]
    dst_shard = [dst.shard_of_device(j) for j in range(n_dev)]

    j = dst_mesh.flat
    r_me, s_me = src_shard[j], dst_shard[j]
    send = data.new_zeros((n_dev, cap))
    if src_primary[j]:
        for k in range(n_dev):
            o, ln = _run_between(r_me, dst_shard[k], m_a, m_b)
            if ln:
                send[k, :ln] = data[o - r_me * m_a:o - r_me * m_a + ln]
    recv = dst_mesh.all_to_all(send, dst_mesh.axis_names)
    out = data.new_empty((m_b,))
    covered = 0
    for i in range(n_dev):
        if not src_primary[i]:
            continue
        o, ln = _run_between(src_shard[i], s_me, m_a, m_b)
        if ln:
            out[o - s_me * m_b:o - s_me * m_b + ln] = recv[i, :ln]
            covered += ln
    if covered != m_b:
        raise RuntimeError(f"exchange covered {covered} of {m_b} slots of "
                           f"shard {s_me}: the layouts do not partition "
                           f"the table ({src} -> {dst})")
    return out


# ---------------------------------------------------------------------------
# Path 2: gather, then keep the new shard (the elastic.reshard_restore route)
# ---------------------------------------------------------------------------

def _device_put_slots(data: Tensor, src: TableLayout, dst: TableLayout,
                      src_mesh, dst_mesh, device) -> Tensor:
    """The new shard on ``device`` from the whole table: gathered from a
    live sharded source, or sliced from whole-table data."""
    full = gather_table(data, src, src_mesh) if src.is_sharded else data
    if not dst.is_sharded or dst_mesh is None:
        return full.to(device, copy=True)
    if not dst_mesh.is_member:
        return full.new_empty((0,)).to(device)
    lo, hi = dst.rows_of_shard(dst.shard_of_device(dst_mesh.flat))
    return full[lo:hi].to(device, copy=True)


# ---------------------------------------------------------------------------
# Front doors
# ---------------------------------------------------------------------------

def migrate(table: AtomicTable, dst_mesh, *, axis: object = "auto",
            replica_axes=None, path: str = "auto", spec=None,
            src_mesh=None) -> AtomicTable:
    """Reshard a live table onto ``dst_mesh`` (every rank of the world
    calls it), re-deriving the owner-major layout, replica contract and
    arrival order under the new extents.

    ``axis="auto"`` keeps the table's axis names that still exist on the
    new mesh (grow/shrink: same names, new extents); pass ``axis=`` /
    ``replica_axes=`` to change the contract itself.  Every later
    `atomics.execute` on the returned handle equals a run that was never
    resharded.  When the re-derived layout cannot be hosted (the slot
    count does not divide the new extents, or every sharding axis
    vanished), the table becomes a *local* handle holding the whole table
    on the rank's device, as `make_table` and `restore_table` degrade.
    """
    src_mesh = src_mesh if src_mesh is not None else table.mesh
    src = live_layout(table, src_mesh)
    names = set(dst_mesh.axis_names)
    if axis == "auto":
        axis = tuple(a for a in src.axis if a in names)
    rep = norm_axes(table.replica_axes if replica_axes is None
                    else replica_axes)
    rep = tuple(a for a in rep if a in names)
    try:
        dst = TableLayout.from_mesh(dst_mesh, num_slots=src.num_slots,
                                    dtype=src.dtype, axis=axis,
                                    replica_axes=rep)
    except ValueError:               # non-divisible extents -> local
        dst = TableLayout(num_slots=src.num_slots, dtype=src.dtype)
    plan = plan_reshard(src, dst, dst_mesh=dst_mesh, src_mesh=src_mesh,
                        live=True, path=path, spec=spec,
                        device=table.device)
    if not telemetry.enabled():
        return plan.execute(table)
    cuda = table.device.type == "cuda"
    with telemetry.annotation(f"atomics.reshard.migrate/{plan.path}"):
        if cuda:
            torch.cuda.synchronize(table.device)
        t0 = time.perf_counter()
        out = plan.execute(table)
        if cuda:
            torch.cuda.synchronize(table.device)
        dt = time.perf_counter() - t0
    telemetry.record(
        "atomics.reshard.migrate", path=plan.path,
        tier="migration", n_slots=src.num_slots,
        src_shards=src.n_shards, dst_shards=dst.n_shards,
        src_replicas=src.n_replicas, dst_replicas=dst.n_replicas,
        predicted_s=plan.predicted_s.get(plan.path),
        predicted_all={k: v for k, v in plan.predicted_s.items()
                       if math.isfinite(v)},
        measured_s=dt)
    return out


def restore_table(host_data, *, like: Optional[AtomicTable] = None,
                  meta: Optional[Dict] = None, device=None) -> AtomicTable:
    """Rebuild an `AtomicTable` from the whole table's data on every rank —
    the old-mesh-is-gone route.

    The target contract comes from ``like`` (the handle in the caller's
    ``like`` tree, built under the new mesh) when given, else from the
    checkpointed layout ``meta`` (axis names re-resolved against
    `launch.mesh.active_mesh()`: extents are re-derived, never trusted
    from the writer).  With no active mesh, or axes that no longer exist
    or divide, the table restores local.  It lands on ``device``, else on
    ``like``'s device, else on the card.
    """
    from repro_torch.launch.mesh import active_mesh
    axis = norm_axes(like.axis if like is not None
                     else tuple((meta or {}).get("axis") or ()))
    rep = norm_axes(like.replica_axes if like is not None
                    else tuple((meta or {}).get("replica_axes") or ()))
    if device is None:
        device = like.device if like is not None else "cuda"
    data = host_data if isinstance(host_data, Tensor) else \
        torch.from_numpy(np.ascontiguousarray(host_data))
    mesh = active_mesh()
    if axis and mesh is not None:
        try:
            dst = TableLayout.from_mesh(mesh, num_slots=int(data.shape[0]),
                                        dtype=data.dtype, axis=axis,
                                        replica_axes=rep)
        except ValueError:           # axis gone or non-divisible -> local
            return AtomicTable(data.to(device, copy=True))
        plan = plan_reshard(
            TableLayout(num_slots=dst.num_slots, dtype=dst.dtype),
            dst, dst_mesh=mesh, live=False, path="device_put",
            device=device)
        return plan.execute(data, device=device)
    return AtomicTable(data.to(device, copy=True))
