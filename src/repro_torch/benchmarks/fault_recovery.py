"""Recovery time and bounded retry.

Port of `benchmarks/fault_recovery.py`.  Three experiments:

  recovery/p<rate>     wall clock and overhead of a checkpointed run under
                       a seeded chaos plan firing step faults at the given
                       probability, against a temporary directory; each
                       cell's final state must be bit-equal to the run with
                       no faults (recovery costs time, never correctness).
  retry/<policy>/n<n>  `atomics.execute_until` on a fully contended CAS
                       batch (n ops on one slot): rounds, attempts, wall
                       clock.  Immediate and exponential resolve in <= n
                       rounds; shrink trades rounds for fewer attempts.
  retry/sharded/n16    the same batch through the sharded tier, on a world
                       of 4 ranks on a 2x2 ``("pod", "dev")`` mesh (on the
                       card, 4 ranks sharing it), held to the same bound.

`FaultConfig(backoff_base_s=0)` keeps configured sleeps out of the
recovery rows.  Times are the host's clock around whole runs (the card
synchronised at their end): the loop is host work around small batches.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def contended_make_ops(n, device):
    """n CAS increments of one slot: ``CAS(x, v, v + 1)``."""
    from repro_torch.atomics import Cas

    def make_ops(slots, observed):
        if slots is None:
            zeros = torch.zeros((n,), dtype=torch.int32, device=device)
            return Cas(zeros, zeros + 1, expected=zeros)
        return Cas(slots, observed + 1, expected=observed)
    return make_ops


def _recovery_grid(csv: Csv, fast: bool, device) -> List[Dict]:
    from repro_torch import atomics
    from repro_torch.checkpoint import ckpt
    from repro_torch.runtime.chaos import FaultPlan, SiteSpec
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     run_with_recovery)
    n_steps, m = (20 if fast else 40), 32

    def step_fn(step, state):
        table, acc = state
        idx = torch.from_numpy((np.arange(8) * (step + 3)) % m).to(
            device=device, dtype=torch.int32)
        res = atomics.execute(table, atomics.Faa(
            idx, torch.arange(8, dtype=torch.int32, device=device) + step))
        return res.table, acc + res.fetched.sum().to(torch.int32)

    def fresh():
        return (atomics.make_table(m, torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def run_once(root, prob):
        ckpt_dir = os.path.join(root, f"p{prob}")
        table, acc = fresh()
        like = {"table": table, "acc": acc}

        def restore_fn():
            got = ckpt.restore_latest_valid(ckpt_dir, like)
            if got is None:
                return None
            s, tree, _ = got
            return s, (tree["table"], tree["acc"])

        plan = (FaultPlan.null() if prob == 0.0 else
                FaultPlan(7, {"step": SiteSpec(prob=prob, count=6)}))
        cfg = FaultConfig(max_failures=20, checkpoint_every=5,
                          backoff_base_s=0.0)
        _sync(device)
        t0 = time.perf_counter()
        res = run_with_recovery(
            step_fn, fresh(), n_steps, cfg,
            lambda s, st: ckpt.save(ckpt_dir, s,
                                    {"table": st[0], "acc": st[1]}),
            restore_fn, chaos=plan, sleep_fn=lambda d: None)
        _sync(device)
        dt = time.perf_counter() - t0
        final = restore_fn()
        return {"seconds": dt, "failures": res.failures,
                "final_step": final[0],
                "table": final[1][0].data.cpu().tolist(),
                "acc": int(final[1][1])}

    rows = []
    root = tempfile.mkdtemp(prefix="fault_recovery_")
    try:
        run_once(os.path.join(root, "warm"), 0.0)
        base = run_once(root, 0.0)
        for prob in (0.0, 0.05, 0.2):
            cell = base if prob == 0.0 else run_once(root, prob)
            bit_equal = (cell["table"] == base["table"]
                         and cell["acc"] == base["acc"]
                         and cell["final_step"] == n_steps)
            if not bit_equal:
                raise AssertionError(f"recovery at fault rate {prob} "
                                     f"diverged from the fault-free run")
            row = {"name": f"recovery/p{prob}", "seconds": cell["seconds"],
                   "failures": cell["failures"],
                   "overhead_x": cell["seconds"] / base["seconds"],
                   "bit_equal": True}
            rows.append(row)
            csv.add(f"fault_recovery.{row['name']}",
                    cell["seconds"] / n_steps * 1e6,
                    f"failures={cell['failures']} "
                    f"overhead={row['overhead_x']:.2f}x bit_equal=True")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


def _retry_grid(csv: Csv, fast: bool, device) -> List[Dict]:
    from repro_torch import atomics
    sizes = (8, 32) if fast else (8, 32, 128)
    rows = []
    for n in sizes:
        for pol in ("immediate", "shrink", "exponential"):
            budget = n if pol != "shrink" else 8 * n
            t = atomics.make_table(8, torch.int32, device=device)
            _sync(device)
            t0 = time.perf_counter()
            res = atomics.execute_until(t, contended_make_ops(n, device),
                                        max_rounds=budget, policy=pol,
                                        sleep_fn=lambda d: None)
            _sync(device)
            dt = time.perf_counter() - t0
            if res.pending.size or int(res.table.data[0]) != n:
                raise AssertionError(f"{pol}/n{n}: unresolved ops")
            if pol != "shrink" and res.n_rounds > n:
                raise AssertionError(f"{pol}/n{n}: {res.n_rounds} rounds "
                                     f"> n")
            row = {"name": f"retry/{pol}/n{n}", "n": n, "policy": pol,
                   "rounds": int(res.n_rounds),
                   "attempts": int(res.rounds.sum()), "seconds": dt,
                   "le_n_rounds": bool(res.n_rounds <= n)}
            rows.append(row)
            csv.add(f"fault_recovery.{row['name']}",
                    dt / max(1, res.n_rounds) * 1e6,
                    f"rounds={res.n_rounds} attempts={row['attempts']} "
                    f"le_n={row['le_n_rounds']}")
    top = max(sizes)
    att = {r["policy"]: r["attempts"] for r in rows if r["n"] == top}
    if not att["shrink"] < att["immediate"]:
        raise AssertionError("shrink-batch spent no fewer attempts than "
                             "immediate retry")
    return rows


def _sharded_rank(mesh, device: str) -> Dict:
    from repro_torch import atomics
    n = 16
    mesh.probe(torch.device(device))

    def table():
        return atomics.make_table(32, torch.int32, device=device, mesh=mesh,
                                  axis=("pod", "dev"))
    atomics.execute_until(table(), contended_make_ops(n, device),
                          max_rounds=n)             # warm
    _sync(device)
    t0 = time.perf_counter()
    res = atomics.execute_until(table(), contended_make_ops(n, device),
                                max_rounds=n)
    _sync(device)
    dt = time.perf_counter() - t0
    full = mesh.all_gather(res.table.data, ("pod", "dev"))
    return {"n": n, "n_rounds": int(res.n_rounds),
            "pending": int(res.pending.size),
            "attempts": int(res.rounds.sum()), "final": int(full[0]),
            "seconds": dt}


def _sharded_row(csv: Csv, device) -> Dict:
    from repro_torch.launch import ranks
    dev = str(torch.device(device).type)
    out = ranks.launch("repro_torch.benchmarks.fault_recovery:_sharded_rank",
                       4, mesh=((2, 2), ("pod", "dev")), args=(dev,),
                       device=dev, timeout=600)[0]
    out["mesh"] = "(2,2) 4 ranks"
    if not (out["pending"] == 0 and out["n_rounds"] <= out["n"]
            and out["final"] == out["n"]):
        raise AssertionError(f"sharded tier violated the <= n bound: {out}")
    row = {"name": f"retry/sharded/n{out['n']}", **out}
    csv.add(f"fault_recovery.{row['name']}",
            out["seconds"] / max(1, out["n_rounds"]) * 1e6,
            f"rounds={out['n_rounds']} mesh={out['mesh']} le_n=True")
    return row


def run(csv: Csv, fast: bool = False, device="cuda") -> Dict[str, object]:
    return {"fast": fast,
            "recovery": _recovery_grid(csv, fast, device),
            "retry": _retry_grid(csv, fast, device),
            "sharded": _sharded_row(csv, device)}
