"""RMW backend shoot-out: every engine backend across batch/table sizes.

Port of `benchmarks/rmw_backends.py`: the same grid, suites and acceptance
row, over the port's engine (`core.rmw_engine`) through
`repro_torch.atomics.execute`.  Backends: ``sort``, ``onehot``,
``serialized`` (the smallest batch only) and, on the card, ``cuda`` (the
hand-written kernels), each the median of 5 reps.  Writes its rows and the
onehot-over-sort speedups as JSON to ``out_path`` (default
`build/repro_torch/rmw_backends.json`, ``*_fast.json`` with ``fast``;
``build/`` is not committed).

Suites:
  fetched     the full RmwResult (table + per-op fetched + success).  The
              reference's acceptance row: ``onehot`` beats ``sort`` for FAA
              batches >= 4k against tables <= 64k.
  table_only  ``need_fetched=False``.
Plus the MoE hot path: argsort `arrival_rank` against the sort-free one.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core import rmw_engine

RESULT_PATH = os.path.join(
    os.path.dirname(rmw_engine.DEFAULT_CALIBRATED_SPEC), "rmw_backends.json")

GRID_N = (4096, 16384, 65536)
GRID_M = (256, 4096, 65536)
GRID_N_FAST = (4096,)
GRID_M_FAST = (256, 4096)

#: the serialized oracle is n dependent steps — keep it to the smallest batch
SERIALIZED_MAX_N = 4096


def grid(fast: bool):
    """The (n, m) cells of the fetched and table-only suites."""
    return [(n, m) for n in (GRID_N_FAST if fast else GRID_N)
            for m in (GRID_M_FAST if fast else GRID_M)]


def backends(device) -> tuple:
    """The combining backends timed at every cell on ``device``."""
    cuda = torch.device(device).type == "cuda"
    return ("sort", "onehot") + (("cuda",) if cuda else ())


def _inputs(rng, n: int, m: int, device):
    table = on_device(rng.normal(size=m), device, torch.float32)
    idx = on_device(rng.integers(0, m, n), device, torch.int32)
    vals = on_device(rng.normal(size=n), device, torch.float32)
    return table, idx, vals


def _bench_backend(backend: str, op: str, table, idx, vals,
                   need_fetched: bool, device) -> float:
    def fn():
        res = atomics.execute(table, atomics.OP_KINDS[op](idx, vals),
                              backend=backend, need_fetched=need_fetched)
        if need_fetched:
            return res.table.data, res.fetched, res.success
        return res.table.data

    return time_s(fn, reps=5, warmup=2, device=device)


def run(csv: Csv, fast: bool = False, out_path: str = RESULT_PATH,
        device="cuda") -> Dict[str, object]:
    if fast and out_path == RESULT_PATH:
        out_path = RESULT_PATH.replace(".json", "_fast.json")
    rng = np.random.default_rng(42)
    cells = grid(fast)
    names = backends(device)
    rows = []

    def record(suite, op, n, m, backend, t):
        rows.append({"suite": suite, "op": op, "n": n, "m": m,
                     "backend": backend, "us_per_call": t * 1e6,
                     "ns_per_op": t / n * 1e9})
        csv.add(f"rmw_backends.{suite}.{op}.{backend}.n{n}.m{m}",
                t * 1e6, f"{t / n * 1e9:.1f} ns/op")

    # -- fetched suite: the acceptance table ------------------------------
    for n, m in cells:
        table, idx, vals = _inputs(rng, n, m, device)
        for backend in names:
            t = _bench_backend(backend, "faa", table, idx, vals, True, device)
            record("fetched", "faa", n, m, backend, t)
        if n <= SERIALIZED_MAX_N:
            t = _bench_backend("serialized", "faa", table, idx, vals, True,
                               device)
            record("fetched", "faa", n, m, "serialized", t)

    # one non-FAA sample per suite keeps min/swp honest
    n_s, m_s = cells[0][0], cells[-1][1]
    table, idx, vals = _inputs(rng, n_s, m_s, device)
    for op in ("min", "swp"):
        for backend in names:
            t = _bench_backend(backend, op, table, idx, vals, True, device)
            record("fetched", op, n_s, m_s, backend, t)

    # -- table_only suite -------------------------------------------------
    for n, m in cells:
        table, idx, vals = _inputs(rng, n, m, device)
        for backend in names:
            t = _bench_backend(backend, "faa", table, idx, vals, False,
                               device)
            record("table_only", "faa", n, m, backend, t)

    # -- MoE hot path: arrival_rank argsort vs sort-free ------------------
    n_tok, n_exp = 8192, 64
    keys = on_device(rng.integers(0, n_exp, n_tok), device, torch.int32)
    t_sortrank = time_s(lambda: atomics.arrival_rank(keys), reps=3,
                        warmup=2, device=device)
    t_sfrank = time_s(lambda: atomics.arrival_rank(keys, n_exp), reps=3,
                      warmup=2, device=device)
    csv.add("rmw_backends.arrival_rank.argsort", t_sortrank * 1e6,
            f"{t_sortrank / n_tok * 1e9:.1f} ns/key")
    csv.add("rmw_backends.arrival_rank.sortfree", t_sfrank * 1e6,
            f"{t_sfrank / n_tok * 1e9:.1f} ns/key "
            f"speedup={t_sortrank / t_sfrank:.2f}x")

    # -- summarize: onehot-vs-sort speedups + acceptance gate -------------
    speedups: Dict[str, float] = {}
    by_cell: Dict[tuple, Dict[str, float]] = {}
    for r in rows:
        by_cell.setdefault((r["suite"], r["op"], r["n"], r["m"]), {})[
            r["backend"]] = r["us_per_call"]
    acceptance = True
    for (suite, op, n, m), times in sorted(by_cell.items()):
        if "sort" in times and "onehot" in times:
            sp = times["sort"] / times["onehot"]
            speedups[f"{suite}/{op}/n{n}/m{m}"] = round(sp, 3)
            if suite == "fetched" and op == "faa" and n >= 4096 \
                    and m <= 65536 and sp <= 1.0:
                acceptance = False

    out = {
        "host": {"device": rmw_engine.device_key(device),
                 "spec": rmw_engine.default_spec(device).name},
        "onehot_block": rmw_engine.DEFAULT_ONEHOT_BLOCK,
        "fast": fast,
        "rows": rows,
        "onehot_speedup_over_sort": speedups,
        "arrival_rank": {
            "n_tokens": n_tok, "n_experts": n_exp,
            "argsort_us": t_sortrank * 1e6,
            "sortfree_us": t_sfrank * 1e6,
            "speedup": round(t_sortrank / t_sfrank, 3),
        },
        "acceptance_onehot_beats_sort_faa_n>=4k_m<=64k": acceptance,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    csv.add("rmw_backends.acceptance", 0.0,
            f"onehot_beats_sort={acceptance} json={out_path}")
    return out
