"""Mesh-wide sharded atomics demo: the `repro_torch.atomics` API on ranks.

Port of the reference's ``examples/sharded_atomics.py``::

    PYTHONPATH=src python -m repro_torch.examples.sharded_atomics \
        --device cpu --ranks 8 --mesh 2x4 [--n-per-device 8192]

Starts ``--ranks`` processes as a ``--mesh`` (pods x devices) gloo group
(on ``--device cuda`` every rank shares the current card), hammers one hot
table shard with FAA batches from every rank (the paper's §5.4 contention
workload: 95% of each rank's ops on 8 slots of shard 0), and runs the same
typed op batch through every exchange strategy — each must agree bit for
bit with the single-device serialized oracle over the batches in rank
order — timing the naive per-op exchange against one-shot and hierarchical
combining.  Then per-op-expected CAS across shards (the owner-side oracle
pass), the contention hint of `select_exchange` on the cost model, and a
sharded-frontier BFS whose parents must match the single-device run.
Exits 1 if any check fails.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.core import perf_model
from repro_torch.core.bfs import bfs, bfs_sharded, kronecker_graph
from repro_torch.core.collective_model import MeshAxis
from repro_torch.core.placement import Tier
from repro_torch.core.rmw import rmw_serialized
from repro_torch.core.rmw_sharded import select_exchange
from repro_torch.launch import ranks

AXES = ("pod", "dev")
STRATEGIES = ("naive", "oneshot", "hierarchical")


def hot_batches(ndev: int, n: int, m: int, seed: int = 0):
    """Every rank's FAA batch: 95% of ops on 8 slots of shard 0."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, (ndev, n))
    uni = rng.integers(0, m, (ndev, n))
    idx = np.where(rng.random((ndev, n)) < 0.95, hot, uni).astype(np.int32)
    vals = rng.integers(-5, 6, (ndev, n)).astype(np.int32)
    return idx, vals


def cas_batches(ndev: int, n: int, m: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(lo, hi, (ndev, n)).astype(np.int32)
                 for lo, hi in ((0, m), (-1, 2), (-1, 2)))


def _rank_main(mesh, device, n, m, reps, graph):
    """One rank: every strategy, per-op CAS, then the sharded BFS."""
    dev = torch.device(device)
    if dev.type == "cuda" and mesh.backend == "gloo":
        mesh.probe(dev)
    r = mesh.rank
    idx, vals = hot_batches(mesh.size(AXES), n, m)
    i, v = (torch.from_numpy(a[r]).to(dev) for a in (idx, vals))
    out = {"table_repr": repr(atomics.make_table(
        m, torch.int32, device=dev, mesh=mesh, axis=AXES))}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for strategy in STRATEGIES:
        table = atomics.make_table(m, torch.int32, device=dev, mesh=mesh,
                                   axis=AXES)
        res = atomics.execute(table, atomics.Faa(i, v), strategy=strategy)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            atomics.execute(table, atomics.Faa(i, v), strategy=strategy)
        sync()
        out[strategy] = dict(ms=(time.perf_counter() - t0) / reps * 1e3,
                             table=res.table.data.cpu(),
                             fetched=res.fetched.cpu())
    ci, cv, ce = (torch.from_numpy(a[r]).to(dev)
                  for a in cas_batches(mesh.size(AXES), min(n, 2048), m))
    table = atomics.make_table(m, torch.int32, device=dev, mesh=mesh,
                               axis=AXES)
    res = atomics.execute(table, atomics.Cas(ci, cv, expected=ce))
    out["cas"] = dict(table=res.table.data.cpu(), fetched=res.fetched.cpu(),
                      success=res.success.cpu())
    s, d, nv, root = graph
    out["bfs"] = bfs_sharded(s, d, nv, root=root, mesh=mesh, axis="dev",
                             device=dev)
    out["bfs"].parent = out["bfs"].parent.cpu()
    out["host_staged"] = sorted(mesh.host_staged)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--mesh", default="2x4", help="pods x devices")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-per-device", type=int, default=8192)
    ap.add_argument("--table", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    shape = tuple(int(x) for x in args.mesh.split("x"))
    if len(shape) != 2 or shape[0] * shape[1] != args.ranks:
        raise SystemExit(f"--mesh {args.mesh} must be PODSxDEVS covering "
                         f"--ranks {args.ranks}")
    n, m, ndev = args.n_per_device, args.table, args.ranks
    src, dst = kronecker_graph(scale=10, edgefactor=8, seed=1)
    s, d = np.concatenate([src, dst]), np.concatenate([dst, src])
    graph = (s, d, 1 << 10, int(s[0]))
    out = ranks.launch("repro_torch.examples.sharded_atomics:_rank_main",
                       ndev, mesh=(shape, AXES), device=args.device,
                       args=(args.device, n, m, args.reps, graph))
    print(f"make_table on the mesh -> {out[0]['table_repr']} (rank 0)")

    dev = torch.device(args.device)
    idx, vals = hot_batches(ndev, n, m)
    ref = rmw_serialized(torch.zeros((m,), dtype=torch.int32, device=dev),
                         torch.from_numpy(idx.reshape(-1)).to(dev),
                         torch.from_numpy(vals.reshape(-1)).to(dev), "faa")
    axes = (MeshAxis("pod", shape[0], Tier.DCN_REMOTE_POD),
            MeshAxis("dev", shape[1], Tier.ICI_NEIGHBOR))
    pick = select_exchange("faa", n, m, axes, device=dev)
    print(f"{ndev} ranks ({shape[0]} pods x {shape[1]}) on {args.device}, "
          f"{n} ops/rank, table {m} ({m // ndev}/shard), hot shard 0 — "
          f"cost model picks: {pick}\n")
    ok_all = True
    for strategy in STRATEGIES:
        tab = torch.cat([o[strategy]["table"] for o in out])
        fetched = torch.cat([o[strategy]["fetched"] for o in out])
        exact = (torch.equal(tab, ref.table.cpu())
                 and torch.equal(fetched, ref.fetched.cpu()))
        ok_all &= exact
        ms = max(o[strategy]["ms"] for o in out)
        print(f"{strategy:13s}: {ms:8.2f} ms/batch   "
              f"bit-identical-to-oracle={exact}")

    ci, cv, ce = cas_batches(ndev, min(n, 2048), m)
    cref = rmw_serialized(torch.zeros((m,), dtype=torch.int32, device=dev),
                          *(torch.from_numpy(a.reshape(-1)).to(dev)
                            for a in (ci, cv)), "cas",
                          torch.from_numpy(ce.reshape(-1)).to(dev))
    exact = all(torch.equal(torch.cat([o["cas"][k] for o in out]),
                            getattr(cref, k).cpu())
                for k in ("table", "fetched", "success"))
    ok_all &= exact
    print(f"\nper-op-expected CAS across shards ({min(n, 2048)}/rank): "
          f"bit-identical-to-oracle={exact}")

    # the contention hint on the cost model at multi-pod scale (a slow
    # shared DCN uplink): the crossover lives in the model, not on a host
    base = perf_model.cpu_default_spec()
    geo = dataclasses.replace(
        base, tier_bandwidth_Bps={**base.tier_bandwidth_Bps,
                                  Tier.DCN_REMOTE_POD: 1e8},
        collective_launch_s=1e-4)
    stat = select_exchange("faa", 65536, 1 << 19, axes, spec=geo,
                           device="cpu")
    hint = select_exchange("faa", 65536, 1 << 19, axes, spec=geo,
                           distinct_slots=16, device="cpu")
    print(f"contention hint (slow-DCN spec, 64k ops/rank, 512k table): "
          f"static caps pick {stat!r}; distinct_slots=16 (skewed batch) "
          f"picks {hint!r}")

    s, d, nv, root = graph
    local = bfs(s, d, nv, root=root, op="cas", device=dev)
    same = all(torch.equal(o["bfs"].parent, local.parent.cpu()) for o in out)
    ok_all &= same
    print(f"\nsharded-frontier BFS over 'dev' ({shape[1]} ranks a pod): "
          f"levels={out[0]['bfs'].levels} "
          f"edges={out[0]['bfs'].edges_traversed} "
          f"parents match single-device: {same}")
    if out[0]["host_staged"]:
        print(f"collectives staged through the host: "
              f"{out[0]['host_staged']}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
