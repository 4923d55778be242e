"""BFS benchmark — paper Fig. 10b (CAS vs SWP vs FAA on Kronecker graphs).

Port of `benchmarks/bfs.py`: traversed edges per second per combiner, on
Graph500 Kronecker graphs of scale 12 (10 with ``fast``), edgefactor 8,
each traversal checked by `core.bfs.validate_parents`.  `core.bfs.bfs`
takes the host edge arrays, as the reference's does; on the card it
routes each level's batch to the hand-written kernels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.benchmarks.common import Csv, time_s
from repro_torch.core.bfs import bfs, kronecker_graph, validate_parents

SCALE = 12
EDGEFACTOR = 8


def run(csv: Csv, scale: int = SCALE, device="cuda") -> Dict[str, float]:
    src, dst = kronecker_graph(scale=scale, edgefactor=EDGEFACTOR, seed=0)
    n = 1 << scale
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    root = int(s2[0])
    out: Dict[str, float] = {}
    for op in ("cas", "swp", "faa"):
        r = bfs(s2, d2, n, root=root, op=op, device=device)
        if not validate_parents(s2, d2, r.parent, root):
            raise AssertionError(f"bfs {op}: invalid parents")
        t = time_s(lambda op=op: bfs(s2, d2, n, root=root, op=op,
                                     device=device).parent,
                   reps=3, warmup=1, device=device)
        teps = r.edges_traversed / t
        out[op] = teps
        csv.add(f"bfs.{op}.scale{scale}", t * 1e6,
                f"TEPS={teps:.3g} levels={r.levels} "
                f"edges={r.edges_traversed}")
    return out
