"""Mesh-wide sharded atomics: distributed RMW with hierarchical combining.

Port of `repro.core.rmw_sharded` onto ``torch.distributed``.  A batch of
FAA/SWP/MIN/MAX/uniform-CAS ops, issued by every rank of a
:class:`~repro_torch.launch.mesh.Mesh` against a table **sharded over mesh
axes**, executes as a two-phase *local-combine-then-owner-resolve*
protocol whose results equal a single-device serialized oracle under a
documented cross-rank arrival order.

Protocol (one exchange level)::

    phase 1 — pre-combine   each rank sorts its local batch by global slot
                            (a stable sort) and collapses every same-slot
                            group into ONE combined op with one engine pass
                            (`rmw_engine.execute_backend` on an identity
                            table indexed by group id: on the card, the
                            fetched kernel, or the table-only kernel when
                            no fetched values are needed);
    route                   combined reps are packed into a padded buffer,
                            one lane of `cap` rows per destination, and
                            exchanged with ONE ``all_to_all_single``;
    phase 2 — resolve       the owner shard applies the received groups (in
                            source-rank order) with a second engine pass;
                            its fetched values are the *bases*;
    return                  bases flow back through the same all-to-all and
                            each rank rebuilds exact per-op fetched/success
                            values from (base, local chain).

**Arrival-order contract**: results equal `rmw_serialized` applied to the
concatenation of per-rank batches ordered by rank — lexicographic over
``replica_axes + axis`` (major to minor), each rank's ops in local order.
Every strategy realizes the same order.  ``reverse_ranks=True`` flips it
to descending rank.  `repro_torch.atomics.layout.TableLayout` reifies the
contract.

Strategies (`strategy=`): ``"oneshot"`` (one exchange over the flattened
``axis`` tuple), ``"hierarchical"`` (for ``axis=(outer, inner...)``: to a
per-pod deputy over the inner axes, then over the outer axis),
``"naive"`` (no pre-combining: every op routed on its own), ``"dense"``
(table-only FAA: a local combine into a global-size table and one
``reduce_scatter_tensor``), and ``"auto"`` (`select_exchange`).

Collectives, as the reference's map onto the mesh's
(`repro_torch.launch.mesh.Mesh`): ``lax.all_to_all`` → ``all_to_all``
(``all_to_all_single``, equal splits), ``psum_scatter`` →
``reduce_scatter`` (``reduce_scatter_tensor``), ``all_gather`` →
``all_gather`` (``all_gather_into_tensor``), ``psum`` / ``pmax`` →
``all_reduce`` (SUM / MAX).  4-byte values ride in the int32 rows as their
bits (``Tensor.view``), so fp32 −0 and NaN payloads survive the trip.

Replicated tables: every replica routes its combined ops to replica 0,
which resolves them; replica 0's updated shard is then broadcast over the
replica group (the reference adds ``psum(new - old)`` instead, which is
exact for integers only).

Out-of-range indices are dropped (fetched 0 / success False).  CAS takes a
uniform scalar ``expected`` (every strategy) or **per-op expected
arrays**, which route every op raw to its owner for a serialized-oracle
pass (`_execute_cas_perop`; on the card the one-thread ``serial_rmw``).

Every rank of the mesh calls these functions together (SPMD), with its
own batch of *global* slot ids and its local shard (owner-major: global
slot ``g`` lives on shard ``g // m_local`` at row ``g % m_local``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.atomics import stats as _cstats
from repro_torch.atomics.layout import local_row, norm_axes, owner_shard
from repro_torch.core import collective_model, perf_model, rmw_engine
from repro_torch.core.collective_model import MeshAxis
from repro_torch.core.placement import Tier
from repro_torch.core.rmw import OPS, RmwResult, _identity, minmax

Tensor = torch.Tensor
AxisNames = Union[str, Tuple[str, ...]]

STRATEGIES = ("auto", "oneshot", "hierarchical", "naive", "dense")

#: bytes moved per routed op on the wire (int32 slot id + 4-byte value)
ROW_BYTES = 8


# ---------------------------------------------------------------------------
# Phase 1 machinery: sort, pre-combine, pack, reconstruct
# ---------------------------------------------------------------------------

class _Combined(NamedTuple):
    """Bookkeeping of one local pre-combine (all tensors in sorted order)."""

    order: Tensor       # the stable sort of the batch by global slot
    inv: Tensor         # its inverse permutation
    sidx: Tensor        # sorted global slot ids (invalid == m_global)
    seg_start: Tensor   # True at the first op of each same-slot group
    seg_id: Tensor      # compressed group index per op
    combined: Tensor    # (n,) combined value per group, dense by seg_id
    loc_fetched: Tensor  # per-op fetched vs the identity base
    loc_success: Tensor  # per-op success vs the identity base


def _identity_base(op: str, dtype, expected, device) -> Tensor:
    if op == "cas":
        return torch.as_tensor(expected, device=device).to(dtype)
    if op in ("min", "max"):
        return torch.tensor(_identity(op, dtype), dtype=dtype, device=device)
    return torch.zeros((), dtype=dtype, device=device)  # faa, swp


def _combine(gidx: Tensor, vals: Tensor, op: str, expected, *,
             need_fetched: bool, backend: str, spec) -> _Combined:
    """Collapse a flat batch into one combined op per distinct slot.

    The per-group combine *and* the per-op local chain (fetched/success
    relative to an identity base) come from one engine pass against a
    dense identity table indexed by compressed group id — group combination
    is closed under every supported op, which makes the hierarchy
    self-similar.
    """
    n = gidx.shape[0]
    dev = gidx.device
    sidx, order = torch.sort(gidx, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    sval = vals[order]
    seg_start = torch.ones((n,), dtype=torch.bool, device=dev)
    seg_start[1:] = sidx[1:] != sidx[:-1]
    seg_id = torch.cumsum(seg_start, 0, dtype=torch.int32) - 1
    ident = _identity_base(op, vals.dtype, expected, dev).expand(n).clone()
    exp = None if op != "cas" else _identity_base(op, vals.dtype, expected,
                                                  dev)
    res = rmw_engine.execute_backend(ident, seg_id, sval, op, exp,
                                     backend=backend, spec=spec,
                                     need_fetched=need_fetched)
    return _Combined(order=order, inv=inv, sidx=sidx, seg_start=seg_start,
                     seg_id=seg_id, combined=res.table,
                     loc_fetched=res.fetched, loc_success=res.success)


class _Stage(NamedTuple):
    """One routed exchange level (pack state kept for the return path)."""

    axis: Tuple[str, ...]
    n_dest: int
    cap: int
    comb: _Combined
    slotpos: Tensor     # per-op packed buffer position (scratch if not rep)
    m_global: int
    reverse: bool = False


def _flip_lanes(x: Tensor, n_dest: int, cap: int) -> Tensor:
    """Reverse the per-source blocks of a routed flat buffer: the receiver
    processes sources in *descending* rank.  Involutive, so the return path
    applies the same flip to undo it."""
    return x.reshape(n_dest, cap).flip(0).reshape(-1)


def _rank_slotpos(dest: Tensor, valid: Tensor, n_dest: int, cap: int
                  ) -> Tensor:
    """Packed-exchange position per op: lane = destination rank, row = the
    op's arrival rank among same-destination valid ops (the engine's
    sort-free FAA-fetch rank, so lanes fill densely in local order),
    scratch (= n_dest * cap) for invalid ops.  The one home of this packing
    for the combined, naive and per-op-CAS paths."""
    key = torch.where(valid, dest, n_dest)
    rank = rmw_engine._arrival_rank_sortfree(key, n_dest + 1)
    return torch.where(valid, dest * cap + rank, n_dest * cap).long()


def _scatter_padded(fill, dtype, slotpos: Tensor, x: Tensor,
                    size: int) -> Tensor:
    """Scatter ``x`` to ``slotpos`` in a ``fill``-initialized (size,)
    buffer; position ``size`` is the dropped scratch row (the only position
    written twice, so unordered duplicate writes do no harm)."""
    buf = torch.full((size + 1,), fill, dtype=dtype, device=x.device)
    buf.index_put_((slotpos,), x.to(dtype))
    return buf[:-1]


def _route_cols(cols, mesh, axis, n_dest: int, cap: int):
    """Move same-length columns over ONE all-to-all: 4-byte columns ride
    as their bits in one (n_dest, cap, k) int32 buffer; any wider dtype
    falls back to one collective per column."""
    if all(c.element_size() == 4 for c in cols):
        packed = torch.stack([c.view(torch.int32) for c in cols], -1)
        recv = mesh.all_to_all(packed.reshape(n_dest, cap, len(cols)), axis)
        recv = recv.reshape(-1, len(cols))
        return tuple(recv[:, j].contiguous().view(c.dtype)
                     for j, c in enumerate(cols))
    return tuple(mesh.all_to_all(c.reshape(n_dest, cap), axis).reshape(-1)
                 for c in cols)


def _push(gidx: Tensor, vals: Tensor, op: str, expected, *, mesh,
          axis: Tuple[str, ...], n_dest: int, dest: Tensor, cap: int,
          m_global: int, need_fetched: bool, backend: str, spec,
          reverse: bool = False) -> Tuple[_Stage, Tensor, Tensor]:
    """Pre-combine + route one level.  `dest` gives, per op, the destination
    index on `axis` (the same for every op of a group).  Returns the stage
    record and the received flat batch (source-rank-major — the arrival
    order; descending source rank when ``reverse``)."""
    st = _combine(gidx, vals, op, expected, need_fetched=need_fetched,
                  backend=backend, spec=spec)
    dest_s = dest[st.order]
    valid = st.sidx < m_global
    is_rep = st.seg_start & valid
    scratch = n_dest * cap
    slotpos = _rank_slotpos(dest_s, is_rep, n_dest, cap)
    send_idx = _scatter_padded(m_global, torch.int32, slotpos,
                               torch.where(is_rep, st.sidx, m_global),
                               scratch)
    send_val = _scatter_padded(0, vals.dtype, slotpos,
                               st.combined[st.seg_id.long()], scratch)
    recv_idx, recv_val = _route_cols((send_idx, send_val), mesh, axis,
                                     n_dest, cap)
    if reverse:
        recv_idx = _flip_lanes(recv_idx, n_dest, cap)
        recv_val = _flip_lanes(recv_val, n_dest, cap)
    stage = _Stage(axis=axis, n_dest=n_dest, cap=cap, comb=st,
                   slotpos=slotpos, m_global=m_global, reverse=reverse)
    return stage, recv_idx, recv_val


def _pop(stage: _Stage, bases_recv: Tensor, op: str, expected, mesh
         ) -> Tuple[Tensor, Tensor]:
    """Return one level: route the resolver's bases back to the sources and
    rebuild exact per-op fetched/success from (base, local chain)."""
    st = stage.comb
    n = st.sidx.shape[0]
    dev = st.sidx.device
    if stage.reverse:       # undo the receive-side flip before routing back
        bases_recv = _flip_lanes(bases_recv, stage.n_dest, stage.cap)
    ret = mesh.all_to_all(bases_recv.reshape(stage.n_dest, stage.cap),
                          stage.axis).reshape(-1)
    ret = torch.cat([ret, ret.new_zeros(1)])
    base_rep = ret[stage.slotpos]                     # scratch -> 0
    base_seg = ret.new_zeros(n + 1)
    base_seg.index_put_((torch.where(st.seg_start, st.seg_id, n).long(),),
                        base_rep)
    base = base_seg[st.seg_id.long()]                 # per sorted op
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    if op == "faa":
        fetched, success = base + st.loc_fetched, ones
    elif op in ("min", "max"):
        fetched, success = minmax(op, base, st.loc_fetched), ones
    elif op == "swp":
        fetched = torch.where(st.seg_start, base, st.loc_fetched)
        success = ones
    else:  # cas (uniform): the local chain assumed base == expected
        exp = _identity_base(op, base.dtype, expected, dev)
        live = base == exp
        # a group's first op sees the base itself (its bits: ±0)
        fetched = torch.where(live & ~st.seg_start, st.loc_fetched, base)
        success = live & st.loc_success
    valid = st.sidx < stage.m_global
    fetched = torch.where(valid, fetched, torch.zeros_like(fetched))
    success = success & valid
    return fetched[st.inv], success[st.inv]


# ---------------------------------------------------------------------------
# Contention stats from inside the combine passes
# ---------------------------------------------------------------------------

def _stage_level_counts(stages, m_global: int, all_axes, mesh):
    """Per-exchange-level ops in / combined reps out, summed over every
    participating rank (each op lives on one rank at any level)."""
    level_in, level_out = [], []
    for st_ in stages:
        v = st_.comb.sidx < m_global
        level_in.append(mesh.all_reduce(v.sum().to(torch.int32), all_axes))
        level_out.append(mesh.all_reduce(
            (st_.comb.seg_start & v).sum().to(torch.int32), all_axes))
    return level_in, level_out


def _occupancy(gidx: Tensor, m: int) -> Tensor:
    """(m,) int32 per-slot writers; out-of-range ids drop.  On the card the
    counters kernel (`slot_counts`), else the engine's bincount pass."""
    if gidx.is_cuda:
        from repro_torch.kernels.rmw import ops as _kops
        return _kops.slot_occupancy(gidx, m)
    return rmw_engine.slot_occupancy(gidx, m)


def _level_array(levels, device) -> Tensor:
    if not levels:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return torch.stack([lv.to(torch.int32) for lv in levels])


def _contention_stats(gidx: Tensor, *, mesh, m_loc: int, m_global: int,
                      shard_axes, rep_axes, level_in, level_out):
    """Mesh-global `ContentionStats`, the same on every rank.  The
    occupancy reduction is the dense strategy's reduce-scatter run on unit
    values: each owner ends up with the exact writer count of its rows."""
    dev = gidx.device
    occ_own = mesh.reduce_scatter(_occupancy(gidx, m_global), shard_axes)
    if rep_axes:
        occ_own = mesh.all_reduce(occ_own, rep_axes)
    all_axes = shard_axes + rep_axes
    n_ops = mesh.all_reduce((gidx < m_global).sum().to(torch.int32),
                            all_axes)
    distinct = mesh.all_reduce((occ_own > 0).sum().to(torch.int32),
                               shard_axes)
    max_occ = mesh.all_reduce(occ_own.max().to(torch.int32), shard_axes,
                              "max")
    hist = mesh.all_reduce(_cstats.occupancy_hist(occ_own), shard_axes)
    # top-k: local candidates with global slot ids, re-ranked after a gather
    shard = mesh.index(shard_axes)
    ids = shard * m_loc + torch.arange(m_loc, dtype=torch.int32, device=dev)
    slots_l, counts_l = _cstats.topk_hot(occ_own, ids)
    slots_g = mesh.all_gather(slots_l, shard_axes)
    counts_g = mesh.all_gather(counts_l, shard_axes)
    slots_k, counts_k = _cstats.topk_hot(counts_g, slots_g)
    return _cstats.ContentionStats(
        n_ops=n_ops, distinct_slots=distinct, max_occupancy=max_occ,
        occupancy_hist=hist, topk_slots=slots_k, topk_counts=counts_k,
        level_ops_in=_level_array(level_in, dev),
        level_ops_out=_level_array(level_out, dev))


# ---------------------------------------------------------------------------
# The distributed executor
# ---------------------------------------------------------------------------

def execute_sharded(table: Tensor, indices: Tensor, values: Tensor, op: str,
                    expected=None, *, mesh, axis: AxisNames,
                    replica_axes: AxisNames = (), strategy: str = "auto",
                    backend: str = "auto",
                    spec: Optional[perf_model.HardwareSpec] = None,
                    axis_tiers: Optional[Sequence[Tier]] = None,
                    need_fetched: bool = True,
                    distinct_slots: Optional[int] = None,
                    reverse_ranks: bool = False,
                    collect_stats: bool = False):
    """Execute an RMW batch against a mesh-sharded table (every rank of
    ``mesh`` calls it together).

    The distributed tier of `repro_torch.atomics.execute`; this raw-tensor
    spelling is the internal entry.  `table` is this rank's shard (global
    slot ``g`` owned by shard ``g // m_local``, shards laid out
    major-to-minor over the ``axis`` tuple); `indices` are global.  With
    `replica_axes`, the table is replicated over those axes and writers on
    all replicas serialize replica-major; the updated shard is broadcast
    from replica 0 so replicas stay identical.

    CAS accepts a scalar ``expected`` (uniform — pre-combinable, every
    strategy) or a per-op tensor, which routes every op *un-combined* to
    its owner for the serialized oracle; there ``strategy`` is ignored and
    ``backend`` must be "auto" or "serialized".  ``distinct_slots`` is the
    selector's contention hint (selection only).  ``reverse_ranks`` flips
    the arrival order to descending rank.

    Returns :class:`RmwResult`, equal to `rmw_serialized` on the
    rank-ordered concatenated batch; ``need_fetched=False`` skips the return
    path (fetched/success are zero placeholders).  ``collect_stats=True``
    returns ``(RmwResult, ContentionStats)``, the stats mesh-global.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")

    shard_axes = norm_axes(axis)
    rep_axes = norm_axes(replica_axes)
    sizes = [mesh.size(a) for a in shard_axes]
    n_shards = math.prod(sizes)
    n_rep = mesh.size(rep_axes) if rep_axes else 1
    m_loc = int(table.shape[0])
    m_global = m_loc * n_shards
    n = int(indices.shape[0])
    dev = table.device

    if op == "cas" and torch.as_tensor(expected).dim() != 0:
        # the owner resolve is a serialized-oracle pass by construction
        if backend not in ("auto", "serialized"):
            raise ValueError(
                f"backend {backend!r} supports CAS only with a scalar "
                f"(uniform) `expected`; per-op expected arrays execute on "
                f"the serialized oracle at the owner shard")
        return _execute_cas_perop(
            table, indices, values, expected, mesh=mesh,
            shard_axes=shard_axes, rep_axes=rep_axes, n_shards=n_shards,
            n_rep=n_rep, m_loc=m_loc, m_global=m_global,
            need_fetched=need_fetched, spec=spec, reverse=reverse_ranks,
            collect_stats=collect_stats)

    if strategy == "auto":
        strategy = select_exchange(
            op, n, m_global, _mesh_axes(shard_axes, sizes, axis_tiers),
            spec=spec, need_fetched=need_fetched, uniform_expected=True,
            replicas=n_rep, distinct_slots=distinct_slots, device=dev)
    if strategy == "hierarchical" and len(shard_axes) < 2:
        strategy = "oneshot"
    if strategy == "dense" and not (op == "faa" and not need_fetched):
        raise ValueError("strategy='dense' is the pure-FAA table-only path")
    # dense is commutative FAA — every arrival order gives the same table,
    # so reverse_ranks holds there trivially

    values = values.to(table.dtype)
    gidx = indices.to(device=dev, dtype=torch.int32)
    gidx = torch.where((gidx < 0) | (gidx >= m_global), m_global, gidx)
    zero_f = torch.zeros((n,), dtype=values.dtype, device=dev)
    zero_s = torch.zeros((n,), dtype=torch.bool, device=dev)

    if strategy == "dense":
        dense = rmw_engine.execute_backend(
            torch.zeros((m_global,), dtype=values.dtype, device=dev), gidx,
            values, "faa", backend=backend, spec=spec,
            need_fetched=False).table
        delta = mesh.reduce_scatter(dense, shard_axes)
        if rep_axes:
            delta = mesh.all_reduce(delta, rep_axes)
        result = RmwResult(table + delta, zero_f, zero_s)
        if collect_stats:  # dense has no exchange levels: L = 0
            return result, _contention_stats(
                gidx, mesh=mesh, m_loc=m_loc, m_global=m_global,
                shard_axes=shard_axes, rep_axes=rep_axes, level_in=(),
                level_out=())
        return result

    # --- build the exchange pipeline (innermost level first) --------------
    stages = []
    cur_idx, cur_vals = gidx, values
    common = dict(mesh=mesh, m_global=m_global, need_fetched=need_fetched,
                  backend=backend, spec=spec, reverse=reverse_ranks)
    if strategy == "naive":
        cur_idx, cur_vals, stages = _push_naive(
            gidx, values, op, expected, mesh=mesh, axis=shard_axes,
            n_shards=n_shards, m_loc=m_loc, m_global=m_global,
            reverse=reverse_ranks)
    elif strategy == "oneshot" or len(shard_axes) == 1:
        dest = owner_shard(cur_idx, m_loc, n_shards)
        stage, cur_idx, cur_vals = _push(
            cur_idx, cur_vals, op, expected, axis=shard_axes,
            n_dest=n_shards, dest=dest, cap=min(n, m_loc), **common)
        stages.append(stage)
    else:  # hierarchical: inner axes to the deputy, outer axis to the owner
        n_inner = math.prod(sizes[1:])
        n_outer = sizes[0]
        dest1 = owner_shard(cur_idx, m_loc, n_shards) % n_inner
        cap1 = min(n, m_loc * n_outer)
        stage, cur_idx, cur_vals = _push(
            cur_idx, cur_vals, op, expected, axis=shard_axes[1:],
            n_dest=n_inner, dest=dest1, cap=cap1, **common)
        stages.append(stage)
        dest2 = owner_shard(cur_idx, m_loc * n_inner, n_outer)
        stage, cur_idx, cur_vals = _push(
            cur_idx, cur_vals, op, expected, axis=shard_axes[:1],
            n_dest=n_outer, dest=dest2, cap=min(n_inner * cap1, m_loc),
            **common)
        stages.append(stage)

    if rep_axes:  # serialize replica groups at replica rank 0
        stage, cur_idx, cur_vals = _push(
            cur_idx, cur_vals, op, expected, axis=rep_axes, n_dest=n_rep,
            dest=torch.zeros_like(cur_idx),
            cap=min(int(cur_idx.shape[0]), m_loc), **common)
        stages.append(stage)

    # --- resolve at the owner ---------------------------------------------
    row = local_row(cur_idx, mesh.index(shard_axes), m_loc, m_global)
    res = rmw_engine.execute_backend(
        table, row, cur_vals, op,
        None if op != "cas" else _identity_base(op, table.dtype, expected,
                                                dev),
        backend=backend, spec=spec, need_fetched=need_fetched)
    new_table = res.table
    if rep_axes:  # only replica rank 0 received real ops
        new_table = mesh.broadcast(new_table, rep_axes, src=0)

    stats = None
    if collect_stats:
        level_in, level_out = _stage_level_counts(
            stages, m_global, shard_axes + rep_axes, mesh)
        stats = _contention_stats(
            gidx, mesh=mesh, m_loc=m_loc, m_global=m_global,
            shard_axes=shard_axes, rep_axes=rep_axes, level_in=level_in,
            level_out=level_out)

    if not need_fetched:
        result = RmwResult(new_table, zero_f, zero_s)
        return (result, stats) if collect_stats else result

    # --- unwind: bases flow back down the tree ----------------------------
    bases = res.fetched.to(values.dtype)
    for stage in reversed(stages):
        bases, success = _pop(stage, bases, op, expected, mesh)
    result = RmwResult(new_table, bases, success)
    return (result, stats) if collect_stats else result


def _push_naive(gidx, vals, op, expected, *, mesh, axis, n_shards, m_loc,
                m_global, reverse=False):
    """The no-combining baseline: each op is its own routed group, packed
    by per-destination arrival rank over *all* ops (cap = n), so the owner
    sees every op in source-rank-then-local order."""
    n = gidx.shape[0]
    dev = gidx.device
    dest = owner_shard(gidx, m_loc, n_shards)
    valid = gidx < m_global
    cap = n
    scratch = n_shards * cap
    slotpos = _rank_slotpos(dest, valid, n_shards, cap)
    send_idx = _scatter_padded(m_global, torch.int32, slotpos, gidx, scratch)
    send_val = _scatter_padded(0, vals.dtype, slotpos, vals, scratch)
    recv_idx, recv_val = _route_cols((send_idx, send_val), mesh, axis,
                                     n_shards, cap)
    if reverse:
        recv_idx = _flip_lanes(recv_idx, n_shards, cap)
        recv_val = _flip_lanes(recv_val, n_shards, cap)
    arange = torch.arange(n, device=dev)
    comb = _Combined(order=arange, inv=arange, sidx=gidx,
                     seg_start=torch.ones((n,), dtype=torch.bool, device=dev),
                     seg_id=arange.to(torch.int32), combined=vals,
                     loc_fetched=_identity_base(op, vals.dtype, expected,
                                                dev).expand(n),
                     loc_success=torch.ones((n,), dtype=torch.bool,
                                            device=dev))
    stage = _Stage(axis=axis, n_dest=n_shards, cap=cap, comb=comb,
                   slotpos=slotpos, m_global=m_global, reverse=reverse)
    return recv_idx, recv_val, [stage]


# ---------------------------------------------------------------------------
# Per-op-expected CAS: owner-side oracle pass over un-combined ops
# ---------------------------------------------------------------------------

def _push_uncombined(gidx, vals, exps, *, mesh, axis, n_dest: int,
                     dest: Tensor, m_global: int, reverse: bool = False):
    """Route (slot id, value, expected) rows with NO pre-combining, packed
    by per-destination arrival rank over all valid ops (cap = n), so the
    receiver sees every op in source-rank-then-local order.  Returns
    (slotpos, recv_idx, recv_val, recv_exp)."""
    n = gidx.shape[0]
    valid = gidx < m_global
    cap = n
    slotpos = _rank_slotpos(dest, valid, n_dest, cap)
    scratch = n_dest * cap
    cols = (_scatter_padded(m_global, torch.int32, slotpos, gidx, scratch),
            _scatter_padded(0, vals.dtype, slotpos, vals, scratch),
            _scatter_padded(0, exps.dtype, slotpos, exps, scratch))
    recv = _route_cols(cols, mesh, axis, n_dest, cap)
    if reverse:
        recv = tuple(_flip_lanes(c, n_dest, cap) for c in recv)
    return (slotpos, *recv)


def _execute_cas_perop(table, indices, values, expected, *, mesh,
                       shard_axes, rep_axes, n_shards: int, n_rep: int,
                       m_loc: int, m_global: int, need_fetched: bool, spec,
                       reverse: bool = False, collect_stats: bool = False):
    """Cross-shard CAS with per-op expected values.

    Per-op expected CAS chains do not compose (a group's effect depends on
    each op's own expected value), so nothing is pre-combined: every op is
    routed raw to its owner (replica stage included), which applies the
    serialized oracle over the received batch in rank order.  The owner's
    fetched values are the final ones; success is recomputed at the source
    as ``fetched == expected``.
    """
    n = int(indices.shape[0])
    dev = table.device
    values = values.to(table.dtype)
    gidx = indices.to(device=dev, dtype=torch.int32)
    gidx = torch.where((gidx < 0) | (gidx >= m_global), m_global, gidx)
    exp = torch.as_tensor(expected, device=dev).to(table.dtype)

    stages = []                     # (axis, n_dest, cap, slotpos)
    slotpos, cur_idx, cur_val, cur_exp = _push_uncombined(
        gidx, values, exp, mesh=mesh, axis=shard_axes, n_dest=n_shards,
        dest=owner_shard(gidx, m_loc, n_shards), m_global=m_global,
        reverse=reverse)
    stages.append((shard_axes, n_shards, n, slotpos))
    if rep_axes:                    # serialize replica groups at rank 0
        n2 = int(cur_idx.shape[0])
        slotpos, cur_idx, cur_val, cur_exp = _push_uncombined(
            cur_idx, cur_val, cur_exp, mesh=mesh, axis=rep_axes,
            n_dest=n_rep, dest=torch.zeros_like(cur_idx), m_global=m_global,
            reverse=reverse)
        stages.append((rep_axes, n_rep, n2, slotpos))

    # the oracle steps through the received rows that hold ops (in arrival
    # order); the padding rows would each cost it a step and change nothing
    keep = cur_idx < m_global
    row = local_row(cur_idx[keep], mesh.index(shard_axes), m_loc, m_global)
    res = rmw_engine.execute_backend(table, row, cur_val[keep], "cas",
                                     cur_exp[keep], backend="serialized",
                                     spec=spec, need_fetched=need_fetched)
    new_table = res.table
    if rep_axes:                    # broadcast replica rank 0's shard
        new_table = mesh.broadcast(new_table, rep_axes, src=0)

    stats = None
    if collect_stats:
        # un-combinable: every level moves each op raw, ops in == ops out
        n_valid = mesh.all_reduce((gidx < m_global).sum().to(torch.int32),
                                  shard_axes + rep_axes)
        levels = [n_valid] * len(stages)
        stats = _contention_stats(
            gidx, mesh=mesh, m_loc=m_loc, m_global=m_global,
            shard_axes=shard_axes, rep_axes=rep_axes, level_in=levels,
            level_out=levels)

    zero_f = torch.zeros((n,), dtype=values.dtype, device=dev)
    if not need_fetched:
        result = RmwResult(new_table, zero_f,
                           torch.zeros((n,), dtype=torch.bool, device=dev))
        return (result, stats) if collect_stats else result

    bases = torch.zeros_like(cur_val)
    bases[keep] = res.fetched.to(values.dtype)
    for axis, n_dest, cap, slotpos in reversed(stages):
        if reverse:                 # undo the receive-side flip per level
            bases = _flip_lanes(bases, n_dest, cap)
        ret = mesh.all_to_all(bases.reshape(n_dest, cap), axis).reshape(-1)
        bases = torch.cat([ret, ret.new_zeros(1)])[slotpos]  # scratch -> 0
    valid = gidx < m_global
    fetched = torch.where(valid, bases, zero_f)
    success = valid & (bases == exp)
    result = RmwResult(new_table, fetched, success)
    return (result, stats) if collect_stats else result


# ---------------------------------------------------------------------------
# Cost model: the distributed tier of the paper's L(A, S) decision procedure
# ---------------------------------------------------------------------------

def _mesh_axes(names: Sequence[str], sizes: Sequence[int],
               tiers: Optional[Sequence[Tier]]) -> Tuple[MeshAxis, ...]:
    """Default topology: the outermost axis crosses pods (DCN) when there
    is more than one level; everything else rides the ICI links."""
    if tiers is None:
        tiers = [Tier.DCN_REMOTE_POD if (i == 0 and len(names) > 1)
                 else Tier.ICI_NEIGHBOR for i in range(len(names))]
    return tuple(MeshAxis(name=n, size=s, tier=t)
                 for n, s, t in zip(names, sizes, tiers))


def _cost_engine(spec, op: str, n: int, m: int, need_fetched: bool,
                 device_type: str) -> float:
    """Cheapest local-backend prediction — phase-1/phase-2 engine passes
    on ``device_type`` (the card prices the kernels in)."""
    cands = [b for b in rmw_engine.BACKENDS.values()
             if b.supports(op, uniform_expected=True)]
    return min(b.cost(spec, op, max(n, 1), max(m, 1), need_fetched,
                      device_type) for b in cands)


def _level_sharing(axes: Sequence[MeshAxis], i: int, senders: int) -> int:
    """Concurrent senders squeezing through one link of level ``i``: ICI
    links are per-device; the DCN uplink is one pipe per pod, shared by
    every in-pod device in the exchange (times ``senders``)."""
    if axes[i].tier is not Tier.DCN_REMOTE_POD:
        return 1
    return senders * math.prod(a.size for a in axes[i + 1:])


def _a2a_s(spec, nbytes: int, axes: Sequence[MeshAxis],
           senders: int = 1) -> float:
    """One padded all-to-all over (possibly flattened) axes: one transpose
    step per mesh axis, each carrying the full per-device payload; one
    software launch in all."""
    t = spec.collective_launch_s
    for i, ax in enumerate(axes):
        if ax.size > 1:
            t += collective_model.collective_time_s(
                spec, "all_to_all", nbytes * _level_sharing(axes, i, senders),
                ax)
    return t


def _rs_s(spec, nbytes: int, axes: Sequence[MeshAxis]) -> float:
    """Hierarchical reduce-scatter over flattened axes: the inner level
    carries the full payload, each outer level 1/size of the previous."""
    t = spec.collective_launch_s
    share = float(nbytes)
    for i in reversed(range(len(axes))):  # inner (fast) first
        ax = axes[i]
        if ax.size > 1:
            t += collective_model.collective_time_s(
                spec, "reduce_scatter",
                int(share) * _level_sharing(axes, i, 1), ax)
            share /= ax.size
    return t


def _cap_hint(cap: int, distinct_slots: Optional[int]) -> int:
    """Tighten a worst-case exchange cap with an observed distinct-slot
    estimate (selection only; the executor's caps stay worst-case)."""
    if distinct_slots is None:
        return cap
    return max(1, min(cap, int(distinct_slots)))


def cost_exchange_oneshot(spec, op: str, n: int, m_global: int,
                          axes: Sequence[MeshAxis],
                          need_fetched: bool = True,
                          distinct_slots: Optional[int] = None,
                          device_type: str = "cuda") -> float:
    n_shards = math.prod(a.size for a in axes)
    m_loc = max(1, m_global // n_shards)
    cap = _cap_hint(min(n, m_loc), distinct_slots)
    eng = lambda nn, mm: _cost_engine(spec, op, nn, mm, need_fetched,
                                      device_type)
    t = eng(n, n)                                            # pre-combine
    t += _a2a_s(spec, n_shards * cap * ROW_BYTES, axes)      # route
    t += eng(n_shards * cap, m_loc)
    if need_fetched:
        t += _a2a_s(spec, n_shards * cap * 4, axes)          # bases back
        t += 3 * n * (spec.gather_elem_s or 2e-9)            # reconstruct
    return t


def cost_exchange_hierarchical(spec, op: str, n: int, m_global: int,
                               axes: Sequence[MeshAxis],
                               need_fetched: bool = True,
                               distinct_slots: Optional[int] = None,
                               device_type: str = "cuda") -> float:
    if len(axes) < 2:
        return float("inf")
    n_shards = math.prod(a.size for a in axes)
    n_outer = axes[0].size
    n_inner = n_shards // n_outer
    m_loc = max(1, m_global // n_shards)
    cap1 = _cap_hint(min(n, m_loc * n_outer), distinct_slots)
    cap2 = _cap_hint(min(n_inner * cap1, m_loc), distinct_slots)
    eng = lambda nn, mm: _cost_engine(spec, op, nn, mm, need_fetched,
                                      device_type)
    t = eng(n, n)                                            # pre-combine
    t += _a2a_s(spec, n_inner * cap1 * ROW_BYTES, axes[1:])  # ICI to deputy
    t += eng(n_inner * cap1, n_inner * cap1)
    t += _a2a_s(spec, n_outer * cap2 * ROW_BYTES, axes[:1],  # DCN to owner
                senders=n_inner)
    t += eng(n_outer * cap2, m_loc)
    if need_fetched:
        t += _a2a_s(spec, n_outer * cap2 * 4, axes[:1], senders=n_inner)
        t += _a2a_s(spec, n_inner * cap1 * 4, axes[1:])
        t += 3 * (n + n_inner * cap1) * (spec.gather_elem_s or 2e-9)
    return t


def cost_exchange_naive(spec, op: str, n: int, m_global: int,
                        axes: Sequence[MeshAxis],
                        need_fetched: bool = True,
                        distinct_slots: Optional[int] = None,
                        device_type: str = "cuda") -> float:
    del distinct_slots              # no combining: every op ships regardless
    n_shards = math.prod(a.size for a in axes)
    m_loc = max(1, m_global // n_shards)
    t = _a2a_s(spec, n_shards * n * ROW_BYTES, axes)
    t += _cost_engine(spec, op, n_shards * n, m_loc, need_fetched,
                      device_type)
    if need_fetched:
        t += _a2a_s(spec, n_shards * n * 4, axes)
    return t


def cost_exchange_dense(spec, op: str, n: int, m_global: int,
                        axes: Sequence[MeshAxis],
                        need_fetched: bool = True,
                        distinct_slots: Optional[int] = None,
                        device_type: str = "cuda") -> float:
    del distinct_slots, device_type  # the full table moves regardless
    if op != "faa" or need_fetched:
        return float("inf")
    gather = spec.gather_elem_s or 2e-9
    return (n + m_global) * gather + _rs_s(spec, 4 * m_global, axes)


EXCHANGE_COSTS = {
    "oneshot": cost_exchange_oneshot,
    "hierarchical": cost_exchange_hierarchical,
    "naive": cost_exchange_naive,
    "dense": cost_exchange_dense,
}


def select_exchange(op: str, n: int, m_global: int,
                    axes: Sequence[MeshAxis], *,
                    spec: Optional[perf_model.HardwareSpec] = None,
                    need_fetched: bool = True, uniform_expected: bool = True,
                    replicas: int = 1, include_naive: bool = False,
                    distinct_slots: Optional[int] = None,
                    device="cuda") -> str:
    """Cheapest distributed strategy for (op, n per rank, table, topology)
    on ``device``: `select_backend`'s distributed tier, the paper's Fig. 8
    crossover as a decision procedure.  ``naive`` is priced but left out of
    auto selection unless ``include_naive`` (its padded buffer is
    ``n_shards * n`` rows).  ``distinct_slots`` is the dynamic contention
    hint (selection only)."""
    return select_exchange_with_cost(
        op, n, m_global, axes, spec=spec, need_fetched=need_fetched,
        uniform_expected=uniform_expected, replicas=replicas,
        include_naive=include_naive, distinct_slots=distinct_slots,
        device=device).choice


def select_exchange_with_cost(op: str, n: int, m_global: int,
                              axes: Sequence[MeshAxis], *,
                              spec: Optional[perf_model.HardwareSpec] = None,
                              need_fetched: bool = True,
                              uniform_expected: bool = True,
                              replicas: int = 1,
                              include_naive: bool = False,
                              distinct_slots: Optional[int] = None,
                              device="cuda") -> rmw_engine.Selection:
    """`select_exchange` returning the full predicted-cost record."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and not uniform_expected:
        raise ValueError(
            "select_exchange prices pre-combined exchanges; per-op expected "
            "CAS always executes on the un-combined owner-oracle path")
    spec = spec or rmw_engine.default_spec(device)
    dev_type = torch.device(device).type
    del replicas  # the replica stage cost is identical across strategies
    costs = {name: fn(spec, op, n, m_global, axes, need_fetched,
                      distinct_slots=distinct_slots, device_type=dev_type)
             for name, fn in EXCHANGE_COSTS.items()
             if name != "naive" or include_naive}
    best = min(costs, key=costs.get)   # ties: EXCHANGE_COSTS order
    return rmw_engine.Selection(best, costs[best], costs)
