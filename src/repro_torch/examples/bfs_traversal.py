"""The paper's §6.1 application: BFS over Kronecker graphs with CAS/SWP/FAA.

Port of the reference's ``examples/bfs_traversal.py``::

    PYTHONPATH=src python -m repro_torch.examples.bfs_traversal \
        [--scale 13] [--edgefactor 8] [--device cuda|cpu]

The three combiners traverse the same graph; their TEPS are close (the
paper's "primitives cost the same" result) and the semantics determine
protocol complexity — CAS is the natural fit, SWP needs the revert trick,
FAA a full revert scheme.  Every combiner must reach the same vertex count
with ``valid=True``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.bfs import bfs, kronecker_graph, validate_parents


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--edgefactor", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = 1 << args.scale
    src, dst = kronecker_graph(args.scale, args.edgefactor, seed=0)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    root = int(s[0])
    print(f"Kronecker graph: scale={args.scale} n={n} edges={len(s)} "
          f"on {args.device}")
    sync = (torch.cuda.synchronize if torch.device(args.device).type
            == "cuda" else lambda: None)
    reached_all, ok_all = set(), True
    for op in ("cas", "swp", "faa"):
        r = bfs(s, d, n, root=root, op=op, device=args.device)   # warm-up
        ok = validate_parents(s, d, r.parent, root)
        sync()
        t0 = time.perf_counter()
        r = bfs(s, d, n, root=root, op=op, device=args.device)
        sync()
        dt = time.perf_counter() - t0
        reached = int((r.parent >= 0).sum())
        reached_all.add(reached)
        ok_all &= ok
        print(f"{op:4s}: levels={r.levels:2d} reached={reached:7d} "
              f"valid={ok}  TEPS={r.edges_traversed / dt:.3g}")
    print("\npaper's conclusion: pick the combiner by SEMANTICS — the costs "
          "match (repro_torch.benchmarks.bfs has the measured table)")
    return 0 if ok_all and len(reached_all) == 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
