"""Graph500-style BFS with selectable RMW combiner semantics (paper §6.1).

Port of `repro.core.bfs` (single device).  The paper's point: CAS/SWP/FAA
cost the same, so pick the primitive whose *semantics* fit — for the
bfs_tree parent array, CAS (set-if-unvisited) and SWP (swap + revert) give
simple protocols while FAA needs a revert scheme.  Per BFS level, all
frontier edges issue parent updates through the chosen typed op
(`repro_torch.atomics.execute`), on the cost-model auto-selected backend by
default — on the card, the hand-written kernels.

The level loop is eager: one host check of ``frontier.any()`` per level, at
most ``max_levels`` levels, as the reference's ``lax.while_loop``.
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


def bfs(src, dst, n: int, root: int = 0, op: str = "cas",
        backend: str = "auto", *, device="cuda",
        max_levels: int = 64) -> BfsResult:
    """Level-synchronous BFS; op ∈ {cas, swp, faa} picks the combiner and
    ``backend`` the RMW engine implementation ("auto" = cost-model pick)."""
    if op not in ("cas", "swp", "faa"):
        raise ValueError(f"bfs op must be cas, swp or faa, got {op!r}")
    dev = torch.device(device)
    s = torch.as_tensor(np.asarray(src, np.int32), device=dev)
    d = torch.as_tensor(np.asarray(dst, np.int32), device=dev)
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


def validate_parents(src, dst, parent, root: int) -> bool:
    """Every reached vertex's parent edge must exist; root is its own parent.

    Vectorised: each edge becomes one int64 key ``src * base + dst``, and
    the parent edges are looked up in the sorted keys.
    """
    if isinstance(parent, Tensor):
        parent = parent.cpu().numpy()
    parent = np.asarray(parent).astype(np.int64)
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    if parent[root] != root:
        return False
    v = np.nonzero(parent >= 0)[0]
    v = v[v != root]
    if v.size == 0:
        return True
    if src.size == 0:
        return False
    base = max(int(src.max()), int(dst.max()), int(parent.max()),
               parent.shape[0] - 1) + 1
    keys = np.unique(src * base + dst)
    want = parent[v] * base + v
    at = np.minimum(np.searchsorted(keys, want), keys.size - 1)
    return bool(np.all(keys[at] == want))
