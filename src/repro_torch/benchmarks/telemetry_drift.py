"""Telemetry drift: the observability layer measuring itself.

Port of `benchmarks/telemetry_drift.py`.  Two deliverables:

  drift ratios   real instrumented traffic through all three selector
                 tiers, folded by `telemetry.drift.aggregate` into
                 per-(tier, choice, op, size-bucket) measured / predicted
                 ratios and the `fit_spec_update` HardwareSpec proposal:
                 * local: eager `atomics.execute` under ``sync=True`` on
                   every engine backend of the device (``serialized``,
                   ``sort``, ``onehot``, and ``cuda`` on the card), each
                   forced and as the selector picks, over a spread FAA, an
                   8-slot FAA and an 8-slot uniform CAS;
                 * sharded: one-round `execute_until` FAA on a world of 4
                   ranks on a 2x2 ``("pod", "dev")`` mesh (on the card, 4
                   ranks sharing it, over gloo);
                 * migration: both `migrate` paths on the same ranks,
                   (pod, dev)-sharded -> dev-sharded with pod replicas.
  overhead gate  eager `execute` with the stream on (a ring sink, no sync)
                 against the stream off: under 5% at n = 4096 (the
                 reference's gate), as the median over interleaved pairs
                 of batches of the enabled / disabled ratio (`_timed_pair`
                 says why not the reference's ratio of minima, which is
                 reported beside it).  An eager size sweep is reported
                 too.  Eager torch has no trace time, so the reference's
                 second gate, on jit steady state, has no counterpart.

``("local", "cuda")`` has no `SPEC_FIELD_OF` entry: its drift is reported,
not fitted.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import atomics, telemetry
from repro_torch.benchmarks.common import Csv, paired_ratio
from repro_torch.core import rmw_engine
from repro_torch.telemetry import drift as drift_lib

#: enabled-stream overhead on eager execute, the acceptance bound
OVERHEAD_GATE = 0.05
#: the gate's batch: the local capture's largest
GATE_N = 4096
#: (pairs, calls a batch) at the gate's size and at the sweep's other
#: sizes: a pair's ratio spreads by about 10% on the card's shared host, so
#: the gate takes enough pairs of long enough batches that its median's
#: error is a fraction of a percent
GATE_PAIRS, SWEEP_PAIRS = (200, 50), (40, 20)
#: local table slots; the sharded table's global slots
LOCAL_M, SHARDED_M = 1024, 4096


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _backends(device) -> Tuple[str, ...]:
    base = ("auto", "serialized", "sort", "onehot")
    return base + ("cuda",) if torch.device(device).type == "cuda" else base


def _local_batches(n: int, device, rng) -> List:
    dup = torch.as_tensor(rng.integers(0, 8, (n,)), dtype=torch.int32,
                          device=device)
    spread = torch.as_tensor(rng.integers(0, LOCAL_M, (n,)),
                             dtype=torch.int32, device=device)
    ones = torch.ones((n,), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return [atomics.Faa(spread, ones),               # spread: onehot/sort
            atomics.Faa(dup, ones),                  # 8 hot slots
            atomics.Cas(dup, ones, expected=zero)]   # uniform CAS


def local_capture(device, fast: bool) -> List[Dict]:
    """Eager instrumented traffic on every local backend, under sync."""
    sizes = (4, 64, 512) if fast else (4, 64, 512, GATE_N)
    reps = 3 if fast else 5
    rng = np.random.default_rng(0)
    tbl = atomics.make_table(LOCAL_M, torch.int32, device=device)
    work = [(n, b, op) for n in sizes for op in _local_batches(n, device, rng)
            for b in _backends(device)]
    for _, b, op in work:            # warm: kernels built, caches hot
        atomics.execute(tbl, op, backend=b)
    _sync(device)
    with telemetry.capture(sync=True) as buf:
        for _ in range(reps):
            for _, b, op in work:
                atomics.execute(tbl, op, backend=b)
    return buf.events


def _faa_ops(n: int, device):
    rng = np.random.default_rng(n)

    def make_ops(slots, observed):
        if slots is None:
            return atomics.Faa(
                torch.as_tensor(rng.integers(0, SHARDED_M, (n,)),
                                dtype=torch.int32, device=device),
                torch.ones((n,), dtype=torch.int32, device=device))
        return None
    return make_ops


def _sharded_rank(mesh, device: str, fast: bool) -> List[Dict]:
    """One rank of the sharded and migration captures (every rank runs
    it; each returns the events it recorded)."""
    mesh.probe(torch.device(device))
    sizes = (64, 512) if fast else (64, 512, 4096)
    reps = 3 if fast else 5

    def table():
        return atomics.make_table(SHARDED_M, torch.int32, device=device,
                                  mesh=mesh, axis=("pod", "dev"))

    for n in sizes:                  # warm every round shape
        atomics.execute_until(table(), _faa_ops(n, device), max_rounds=1)
    events: List[Dict] = []
    with telemetry.capture(sync=True) as buf:
        for n in sizes:
            for _ in range(reps):
                # FAA resolves in one round: each call is one sharded
                # exchange with a (predicted_s, measured_s) pair
                atomics.execute_until(table(), _faa_ops(n, device),
                                      max_rounds=1)
    events += buf.events
    built = table()

    def both():
        for path in ("exchange", "device_put"):
            atomics.reshard.migrate(built, mesh, axis=("dev",),
                                    replica_axes=("pod",), path=path)
    both()                           # warm both paths
    with telemetry.capture(sync=True) as buf:
        for _ in range(reps):
            both()
    events += buf.events
    _sync(device)
    return events


def sharded_capture(device, fast: bool) -> List[Dict]:
    from repro_torch.launch import ranks
    dev = torch.device(device).type
    out = ranks.launch("repro_torch.benchmarks.telemetry_drift:_sharded_rank",
                       4, mesh=((2, 2), ("pod", "dev")), args=(dev, fast),
                       device=dev, timeout=900)
    return out[0]                    # every rank decides alike; rank 0's


def _timed_pair(call, *, batch: int, n_batches: int) -> Dict[str, float]:
    """Per-call seconds with the stream enabled and disabled: ``n_batches``
    pairs of batches of ``batch`` calls, the two halves of a pair back to
    back and which runs first alternating, so load drift and order hit
    both alike.  ``overhead`` is the median over pairs of enabled /
    disabled - 1: host time on a machine that shares its cores wanders by
    tens of percent between pairs, far more than the instrument costs,
    and a ratio within a pair cancels that; the least batch mean of each
    side is reported beside it.  Raw ``perf_counter``: a span would put
    the instrument inside its own measurement."""
    for _ in range(batch):           # warm
        call()
    ring = telemetry.RingBuffer(capacity=16)
    pair = paired_ratio(call, call, batch=batch, n_batches=n_batches,
                        setup_a=lambda: telemetry.enable(ring),
                        teardown_a=telemetry.disable)
    return {"enabled_us": pair["a_us"], "disabled_us": pair["b_us"],
            "overhead": pair["overhead"],
            "overhead_of_minima": pair["overhead_of_minima"]}


def overhead(device, fast: bool) -> Dict[str, object]:
    """Eager `execute` (the backend the selector picks, the device
    synchronised after each call, as the reference's gate blocks on each
    result) with the stream on (ring, no sync) against off; the gate is
    the n = `GATE_N` row.  ``host_only`` is the same call at `GATE_N`
    without the synchronisation: what a caller that never waits pays,
    reported, not gated."""
    rng = np.random.default_rng(1)
    tbl = atomics.make_table(LOCAL_M, torch.int32, device=device)
    sweep = {}
    for n in ((4, 512, GATE_N) if fast else (4, 64, 512, GATE_N)):
        op = atomics.Faa(torch.as_tensor(rng.integers(0, LOCAL_M, (n,)),
                                         dtype=torch.int32, device=device),
                         torch.ones((n,), dtype=torch.int32, device=device))

        def call(op=op):
            atomics.execute(tbl, op)
            _sync(device)

        pairs, batch = GATE_PAIRS if n == GATE_N else SWEEP_PAIRS
        sweep[n] = _timed_pair(call, batch=batch,
                               n_batches=10 if fast else pairs)
    gate = sweep[GATE_N]
    host_only = _timed_pair(lambda: atomics.execute(tbl, op),
                            batch=SWEEP_PAIRS[1],
                            n_batches=10 if fast else SWEEP_PAIRS[0])
    _sync(device)
    return {"gate_n": GATE_N, **gate,
            "eager_sweep": {str(k): v for k, v in sweep.items()},
            "host_only": host_only}


def run(csv: Csv, fast: bool = False, device="cuda",
        out_path: Optional[str] = None) -> Dict[str, object]:
    local = local_capture(device, fast)
    events = local + sharded_capture(device, fast)
    stats = drift_lib.aggregate(events)
    rows = drift_lib.summarize(stats)
    # the proposal scales the spec the selectors priced these events with
    fitted = drift_lib.fit_spec_update(stats, rmw_engine.default_spec(device))
    ovh = overhead(device, fast)
    execs = [e for e in local if e["event"] == "atomics.execute"]
    tiers = {r["tier"] for r in rows}
    for r in rows:
        csv.add(f"telemetry.drift.{r['tier']}.{r['choice']}."
                f"{r['op']}.{r['size_bucket']}",
                r["mean_measured_s"] * 1e6,
                f"pred={r['mean_predicted_s'] * 1e6:.3g}us "
                f"ratio={r['ratio']:.3g} n={r['n']}")
    csv.add("telemetry.overhead", ovh["enabled_us"],
            f"n={ovh['gate_n']} disabled={ovh['disabled_us']:.1f}us "
            f"overhead={ovh['overhead'] * 100:.2f}pct "
            f"gate<{OVERHEAD_GATE * 100:.0f}pct")
    acceptance = (ovh["overhead"] < OVERHEAD_GATE
                  and {"local", "sharded", "migration"} <= tiers)
    out = {
        "fast": fast, "device": str(device),
        "n_events": len(events),
        "local_executes": len(execs),
        "local_backends": sorted({e["backend"] for e in execs}),
        "local_all_measured": all(
            isinstance(e.get("measured_s"), float) and e["measured_s"] > 0
            for e in execs),
        "drift": rows,
        "spec_update": fitted["fields"],
        "spec_update_skipped": fitted["skipped"],
        "overhead": {**ovh, "gate": OVERHEAD_GATE},
        "tiers_covered": sorted(tiers),
        "acceptance_overhead_lt_gate_and_all_tiers": bool(acceptance),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if not acceptance:
        raise AssertionError(
            f"telemetry drift acceptance failed: overhead "
            f"{ovh['overhead']:.4f} (gate {OVERHEAD_GATE}), tiers "
            f"{sorted(tiers)}")
    return out
