"""Sharded-RMW shoot-out: naive vs one-shot vs hierarchical combining.

Port of `benchmarks/rmw_sharded.py`, the distributed analogue of
`rmw_backends`.  One world of 8 ranks (`launch.ranks`; on the card, 8
ranks sharing it over gloo, their collectives staged through the host)
laid out as a (2 pods x 4 devices) ``("pod", "dev")`` mesh runs the same
RMW workload through every exchange strategy of `core.rmw_sharded`:

  naive         per-op exchange, no pre-combining — the paper's measured
                serialized/ping-pong regime (§5.4)
  oneshot       local pre-combine + one all_to_all over the flat mesh
  hierarchical  per-pod pre-combine, deputies re-combine, cross-pod
                exchange — the paper's §6.2 combining tree
  dense         pure-FAA table-only reduce-scatter path

The grid, its seeded inputs and the acceptance row are the reference's:
on contended hot-shard batches the hierarchical tree must beat the naive
per-op exchange at the largest per-device batch
(``acceptance_hierarchical_beats_naive_on_hot``; reported, it does not
fail the suite).  A call's time is the slowest rank's (the ranks meet at
a barrier before each rep), the median of the reps.  Writes
``rmw_sharded.json`` (`build/repro_torch/`, or ``out_path``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import atomics
from repro_torch.benchmarks.common import Csv
from repro_torch.kernels.build import BUILD_DIR

NDEV, MESH = 8, ((2, 4), ("pod", "dev"))
AXES = ("pod", "dev")
M = 4096
RESULT_PATH = str(BUILD_DIR / "rmw_sharded.json")


def grid(fast: bool) -> List[Tuple[str, str, int, int, str, bool]]:
    """The reference's cells in its order: (op, strategy, n_per_device, m,
    dist, need_fetched)."""
    grid_n = (1024,) if fast else (8192, 32768)
    cells = []
    for n_per in grid_n:
        for dist_ in ("hot", "uniform"):
            for strategy in ("naive", "oneshot", "hierarchical"):
                cells.append(("faa", strategy, n_per, M, dist_, True))
    for dist_ in ("hot", "uniform"):
        for strategy in (("oneshot", "dense") if fast else
                         ("naive", "oneshot", "hierarchical", "dense")):
            cells.append(("faa", strategy, grid_n[-1], M, dist_, False))
    if not fast:
        for op in ("swp", "cas"):
            for strategy in ("naive", "oneshot", "hierarchical"):
                cells.append((op, strategy, grid_n[-1], M, "hot", True))
    return cells


def _median_time(fn, reps: int, warmup: int, dev) -> float:
    """Median over reps of the slowest rank's seconds for one call."""
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        out.append(float(dt))
    return float(np.median(out))


def _rank(mesh, device: str, fast: bool) -> List[Dict]:
    """One rank of the suite's world; every rank returns the same rows."""
    dev = torch.device(device)
    mesh.probe(dev)
    rng = np.random.default_rng(42)      # the same inputs on every rank
    me = mesh.index(AXES)
    cells = grid(fast)
    n_gate = max(c[2] for c in cells)
    rows = []
    for op, strategy, n_per, m, dist_, need_fetched in cells:
        m_loc = m // NDEV
        if dist_ == "hot":     # 95% of ops hammer 8 slots of ONE shard
            hot = rng.integers(0, 8, (NDEV, n_per))
            uni = rng.integers(0, m, (NDEV, n_per))
            idx = np.where(rng.random((NDEV, n_per)) < 0.95, hot, uni)
        else:
            idx = rng.integers(0, m, (NDEV, n_per))
        vals = rng.normal(size=(NDEV, n_per)).astype(np.float32)
        if op == "cas":
            vals = rng.integers(-1, 2, (NDEV, n_per)).astype(np.float32)
        i = torch.as_tensor(idx[me].astype(np.int32), device=dev)
        v = torch.as_tensor(vals[me], device=dev)
        table = atomics.AtomicTable(
            torch.zeros((m_loc,), dtype=torch.float32, device=dev),
            axis=AXES, mesh=mesh)
        aop = (atomics.Cas(i, v, expected=0.0) if op == "cas"
               else atomics.OP_KINDS[op](i, v))
        t = _median_time(
            lambda: atomics.execute(table, aop, strategy=strategy,
                                    need_fetched=need_fetched),
            reps=9 if n_per == n_gate else 5, warmup=2, dev=dev)
        rows.append({"suite": "fetched" if need_fetched else "table_only",
                     "op": op, "strategy": strategy, "n_per_device": n_per,
                     "m": m, "dist": dist_, "us_per_call": t * 1e6,
                     "ns_per_op": t / (NDEV * n_per) * 1e9})
    return rows


def acceptance(rows) -> Tuple[Dict[str, float], bool]:
    """(naive / hierarchical per cell, whether hierarchical beats naive on
    every hot cell at the largest batch): the reference's gate."""
    by_cell: Dict[tuple, Dict[str, float]] = {}
    for r in rows:
        by_cell.setdefault(
            (r["suite"], r["op"], r["n_per_device"], r["m"], r["dist"]),
            {})[r["strategy"]] = r["us_per_call"]
    speedups = {}
    ok = True
    n_gate = max(r["n_per_device"] for r in rows)
    for (suite, op, n, m, dist_), cells in sorted(by_cell.items()):
        if "naive" in cells and "hierarchical" in cells:
            sp = cells["naive"] / cells["hierarchical"]
            speedups[f"{suite}/{op}/n{n}/m{m}/{dist_}"] = round(sp, 3)
            if dist_ == "hot" and n == n_gate and sp <= 1.0:
                ok = False
    return speedups, ok


def run(csv: Csv, fast: bool = False, device="cuda",
        out_path: str = RESULT_PATH) -> Dict[str, object]:
    from repro_torch.launch import ranks
    dev = torch.device(device)
    rows = ranks.launch("repro_torch.benchmarks.rmw_sharded:_rank", NDEV,
                        mesh=MESH, args=(str(dev), fast),
                        device=dev.type, timeout=900)[0]
    for r in rows:
        csv.add(f"rmw_sharded.{r['suite']}.{r['op']}.{r['strategy']}"
                f".n{r['n_per_device']}.m{r['m']}.{r['dist']}",
                r["us_per_call"], f"{r['ns_per_op']:.1f} ns/op")
    speedups, ok = acceptance(rows)
    if fast and out_path == RESULT_PATH:
        out_path = RESULT_PATH.replace(".json", "_fast.json")
    out = {
        "host": {"device": str(dev) if dev.type == "cpu" else
                 f"cuda:{torch.cuda.get_device_name(0)}",
                 "ranks": NDEV, "mesh": "2x4 pod*dev", "transport": "gloo"},
        "fast": fast,
        "rows": rows,
        "hierarchical_speedup_over_naive": speedups,
        "acceptance_hierarchical_beats_naive_on_hot": ok,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    csv.add("rmw_sharded.acceptance", 0.0,
            f"hierarchical_beats_naive_on_hot={ok} json={out_path}")
    return out
