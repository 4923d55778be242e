"""Graph500-style BFS with selectable RMW combiner semantics (paper §6.1).

Port of `repro.core.bfs`.  The paper's point: CAS/SWP/FAA
cost the same, so pick the primitive whose *semantics* fit — for the
bfs_tree parent array, CAS (set-if-unvisited) and SWP (swap + revert) give
simple protocols while FAA needs a revert scheme.  Per BFS level, all
frontier edges issue parent updates through the chosen typed op
(`repro_torch.atomics.execute`), on the cost-model auto-selected backend by
default — on the card, the hand-written kernels.

The level loop is eager: one host check of ``frontier.any()`` per level, at
most ``max_levels`` levels, as the reference's ``lax.while_loop``.
`bfs_sharded` runs the same search with the parent table sharded over a
mesh axis of `repro_torch.launch.mesh.Mesh` (every rank calls it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import atomics

Tensor = torch.Tensor

_IMAX = torch.iinfo(torch.int32).max


def kronecker_graph(scale: int, edgefactor: int = 8, seed: int = 0,
                    a=0.57, b=0.19, c=0.19) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT edge list (Graph500 generator), n = 2**scale nodes.  The same
    numpy generator as the reference, so both packages get the same edges."""
    n_edges = edgefactor * (1 << scale)
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for level in range(scale):
        r = rng.random(n_edges)
        bit_src = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        r2 = rng.random(n_edges)
        bit_dst = ((r < a + b) & (r >= a)) | (r >= a + b + c)
        del r2
        src |= bit_src.astype(np.int64) << level
        dst |= bit_dst.astype(np.int64) << level
    perm = rng.permutation(1 << scale)       # shuffle vertex labels
    return perm[src], perm[dst]


@dataclasses.dataclass
class BfsResult:
    parent: Tensor
    levels: int
    edges_traversed: int


def _edges(x, dev) -> Tensor:
    """int32 edge endpoints on ``dev``.  A host array goes over as it is and
    is narrowed there: a host pass over every edge costs more than the
    wider copy."""
    return torch.as_tensor(x).to(dev).to(torch.int32)


def bfs(src, dst, n: int, root: int = 0, op: str = "cas",
        backend: str = "auto", *, device="cuda",
        max_levels: int = 64) -> BfsResult:
    """Level-synchronous BFS; op ∈ {cas, swp, faa} picks the combiner and
    ``backend`` the RMW engine implementation ("auto" = cost-model pick).
    ``src``/``dst`` are host arrays or tensors (on ``device`` they are used
    as they are)."""
    if op not in ("cas", "swp", "faa"):
        raise ValueError(f"bfs op must be cas, swp or faa, got {op!r}")
    dev = torch.device(device)
    s, d = _edges(src, dev), _edges(dst, dev)
    s_long = s.long()
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parent[root] = root
    frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier[root] = True
    edges = torch.zeros((), dtype=torch.int64, device=dev)
    lvl = 0
    while lvl < max_levels and bool(frontier.any()):
        active = frontier[s_long]                 # edge's src in frontier
        cand_dst = torch.where(active, d, n)      # OOR -> dropped
        cand_par = s
        if op == "cas":
            new_parent = atomics.execute(
                parent, atomics.Cas(cand_dst, cand_par, expected=-1),
                backend=backend, need_fetched=False).table.data
        elif op == "swp":
            # swap unconditionally, then revert overwrites of visited nodes.
            # The restore value is the FIRST collider's fetched (the original
            # parent), so the revert stream runs reversed (last-wins of the
            # reversed order == first in program order).
            res = atomics.execute(parent, atomics.Swp(cand_dst, cand_par),
                                  backend=backend)
            revert_idx = torch.where(res.fetched != -1, cand_dst, n)
            new_parent = atomics.execute(
                res.table, atomics.Swp(torch.flip(revert_idx, (0,)),
                                       torch.flip(res.fetched, (0,))),
                backend=backend, need_fetched=False).table.data
        else:  # faa with revert (the paper's "complex scheme")
            unvisited = parent[cand_dst.clamp(0, n - 1).long()] == -1
            delta = torch.where(unvisited, cand_par + 1, 0)
            # the FAA pass itself: -1 + sum(deltas) per vertex; the revert
            # below keeps the first contributor, so its table is not read
            atomics.execute(parent, atomics.Faa(cand_dst, delta),
                            backend=backend, need_fetched=False)
            # revert: recompute the exact winner via a min-combine
            first = atomics.execute(
                torch.full((n,), _IMAX, dtype=torch.int32, device=dev),
                atomics.Min(cand_dst, torch.where(delta > 0, cand_par, _IMAX)),
                backend=backend, need_fetched=False).table.data
            new_parent = torch.where((parent == -1) & (first != _IMAX),
                                     first, parent)
        frontier = (new_parent != -1) & (parent == -1)
        edges += active.sum()
        parent = new_parent
        lvl += 1
    return BfsResult(parent=parent, levels=lvl, edges_traversed=int(edges))


def bfs_sharded(src, dst, n: int, root: int = 0, *, mesh, axis="dev",
                strategy: str = "auto", op: str = "cas",
                backend: str = "auto", device="cuda",
                max_levels: int = 64) -> BfsResult:
    """Level-synchronous BFS with the **parent table sharded over a mesh**.

    Every rank of ``mesh`` calls it with the same edge list.  The parent
    array is sharded over ``axis`` (vertex ``v`` owned by shard
    ``v // n_local``); the edges are padded to a multiple of the ranks
    (with the drop row ``n_pad`` as both ends) and split over the same
    ranks, contiguously in rank order.  Each level gathers the frontier
    (``all_gather_into_tensor``) and issues every frontier edge's parent
    update through the sharded tier of `repro_torch.atomics.execute`; one
    ``all_reduce`` per level carries the edge count and the "more" flag.
    Parents equal the single-device `bfs`: the arrival-order contract
    serializes edges in (rank, local) order, the unsharded edge order.

    ``op`` picks the combiner protocol, as in `bfs`: ``"cas"``
    (set-if-unvisited, table-only) or ``"swp"`` (swap, then replay the
    revert stream **globally reversed**: locally reversed batches under
    ``reverse_ranks=True``).  Returns the whole parent array on every rank.
    """
    if op not in ("cas", "swp"):
        raise ValueError(f"bfs_sharded supports op 'cas' or 'swp', "
                         f"got {op!r}")
    dev = torch.device(device)
    ndev = mesh.size(axis)
    me = mesh.index(axis)
    n_pad = -(-n // ndev) * ndev
    n_loc = n_pad // ndev
    src, dst = np.asarray(src), np.asarray(dst)
    e_loc = -(-len(src) // ndev)
    lo, hi = me * e_loc, min((me + 1) * e_loc, len(src))
    s = torch.full((e_loc,), n_pad, dtype=torch.int32, device=dev)
    d = torch.full((e_loc,), n_pad, dtype=torch.int32, device=dev)
    if hi > lo:
        s[:hi - lo] = _edges(np.array(src[lo:hi]), dev)   # a copy: the
        d[:hi - lo] = _edges(np.array(dst[lo:hi]), dev)   # edges may be
        #                                                   a read-only map
    s_long = s.long().clamp(max=n_pad - 1)
    parent = torch.full((n_loc,), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros((n_loc,), dtype=torch.uint8, device=dev)
    if root // n_loc == me:
        parent[root % n_loc] = root
        frontier[root % n_loc] = 1
    edges, lvl, more = 0, 0, True
    kw = dict(strategy=strategy, backend=backend)
    while more and lvl < max_levels:
        fg = mesh.all_gather(frontier, axis).bool()          # (n_pad,)
        active = fg[s_long] & (s < n_pad)
        cand = torch.where(active, d, n_pad)                 # OOR drops
        tbl = atomics.AtomicTable(parent, axis=axis, mesh=mesh)
        if op == "cas":
            new_parent = atomics.execute(
                tbl, atomics.Cas(cand, s, expected=-1), need_fetched=False,
                **kw).table.data
        else:  # swp + revert (see `bfs`)
            res = atomics.execute(tbl, atomics.Swp(cand, s), **kw)
            revert_idx = torch.where(res.fetched != -1, cand, n_pad)
            new_parent = atomics.execute(
                res.table, atomics.Swp(revert_idx.flip(0),
                                       res.fetched.flip(0)),
                need_fetched=False, reverse_ranks=True, **kw).table.data
        newf = (new_parent != -1) & (parent == -1)
        counts = mesh.all_reduce(torch.stack(
            [active.sum(), newf.sum()]).to(torch.int64), axis).tolist()
        edges += counts[0]
        more = counts[1] > 0
        parent, frontier = new_parent, newf.to(torch.uint8)
        lvl += 1
    full = mesh.all_gather(parent, axis)[:n]
    return BfsResult(parent=full, levels=lvl, edges_traversed=int(edges))


def validate_parents(src, dst, parent, root: int) -> bool:
    """Every reached vertex's parent edge must exist; root is its own parent.

    Vectorised on the parent array's device: each edge becomes one int64
    key ``src * base + dst``, and the parent edges are looked up in the
    sorted keys.
    """
    dev = parent.device if isinstance(parent, Tensor) else torch.device("cpu")
    parent, src, dst = (torch.as_tensor(x).to(dev, torch.int64)
                        for x in (parent, src, dst))
    if int(parent[root]) != root:
        return False
    v = torch.nonzero(parent >= 0).flatten()
    v = v[v != root]
    if v.numel() == 0:
        return True
    if src.numel() == 0:
        return False
    base = max(int(src.max()), int(dst.max()), int(parent.max()),
               parent.shape[0] - 1) + 1
    keys = torch.unique(src * base + dst)
    want = parent[v] * base + v
    at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    return bool((keys[at] == want).all())
