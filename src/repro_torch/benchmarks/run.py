"""The paper's measurement suites on the port — one function per table or
figure, in the reference's order (`benchmarks/run.py`):

  latency           Fig 2/3/4/6 + Figs 11-13   (per-op latency by tier)
  bandwidth         Fig 5 / Fig 15             (ILP gap: serialized vs comb.)
  contention        Fig 8a-c                   (n writers -> one slot)
  operand_size      Fig 7                      (wide-operand CAS)
  operands_fetched  Fig 8d / §5.5              (two-operand CAS)
  unaligned         Fig 10a / Fig 14           (the table kernel's L2
                                                window on and off the
                                                128-byte line)
  prefetcher        Fig 9                      (the table kernel's load
                                                depth, random and
                                                sequential slots)
  bfs               Fig 10b / §6.1             (CAS vs SWP vs FAA TEPS)
  rmw_backends      RMW-engine shoot-out       (writes build/repro_torch/
                                                rmw_backends.json)
  calibrate         HardwareSpec persistence   (writes build/repro_torch/
                                                calibrated_spec.json)
  model_validation  Tables 2-3 + §5 NRMSE gate (calibration + validation)
  roofline          §Roofline deliverable      (from `launch.dryrun`'s
                                                records; none, no rows)
  rmw_sharded       distributed-RMW shoot-out  (naive vs one-shot vs
                                                hierarchical, 8 ranks;
                                                writes rmw_sharded.json)
  reshard           elastic migration against full replay (4 ranks)
  fault_recovery    recovery under seeded faults + bounded retry
  telemetry_drift   predicted vs measured per selector tier, the spec
                    proposal, the <5% overhead gate (writes
                    telemetry_drift.json under --out only)
  contention_observe  `collect_stats=` end to end: bit identity local and
                    on 4 ranks, the <3% noise and <5% retry overhead gates,
                    the estimator's device feed, writers per slot against
                    the contention model (writes contention_observe.json
                    under --out only)
  analysis          the atomics contract linter over every registered
                    entry point (wall µs, findings, suppressed a row;
                    raises on an unsuppressed error)
  tuning            the guarded spec controller: convergence, rollback and
                    quarantine, the <5% live-controller overhead gate,
                    tuned-vs-untuned bit identity local and (full runs) on
                    4 ranks (writes tuning.json under --out only)

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only a,b]
        [--fast] [--device cuda|cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV rows.  The latency rows feed
`model_validation` and `calibrate`.  A suite that raises is reported as
``<name>,FAILED,<error>`` and the run goes on, then exits 1.  The device is
the card unless ``--device cpu`` asks for the CPU (the kernels' plain
versions; the tests' mode).  ``--out`` names the directory that
`rmw_backends`, `calibrate` and `rmw_sharded` write their JSON to (default:
`build/repro_torch/`, where the CPU's selection looks for the fit).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.benchmarks import (analysis_sweep, bandwidth, bfs,
                                    calibrate, contention,
                                    contention_observe, fault_recovery,
                                    latency, model_validation, operand_size,
                                    operands_fetched, prefetcher, reshard,
                                    rmw_backends, rmw_sharded, roofline,
                                    telemetry_drift, tuning, unaligned)
from repro_torch.benchmarks.common import Csv

SUITES = ("latency", "bandwidth", "contention", "operand_size",
          "operands_fetched", "unaligned", "prefetcher", "bfs",
          "rmw_backends", "calibrate", "model_validation", "roofline",
          "rmw_sharded", "reshard", "fault_recovery", "telemetry_drift",
          "contention_observe", "analysis", "tuning")


def run_suites(only: Optional[Sequence[str]] = None, fast: bool = False,
               device="cuda", csv: Optional[Csv] = None,
               out_dir: Optional[str] = None
               ) -> Tuple[Csv, Dict[str, object], List[Tuple[str, str]]]:
    """Run the suites (all, or those in ``only``) in order; returns the
    rows, each suite's result and the failures as (suite, error).  JSON
    goes to ``out_dir`` when given, else to each suite's default."""
    unknown = set(only or ()) - set(SUITES)
    if unknown:
        raise ValueError(f"unknown suites {sorted(unknown)}; have {SUITES}")
    csv = csv or Csv()
    results: Dict[str, object] = {}
    suite = {
        "latency": lambda: latency.run(csv, device=device, fast=fast),
        "bandwidth": lambda: bandwidth.run(csv, device=device),
        "contention": lambda: contention.run(csv, device=device),
        "operand_size": lambda: operand_size.run(csv, device=device),
        "operands_fetched": lambda: operands_fetched.run(csv, device=device),
        "unaligned": lambda: unaligned.run(csv, device=device),
        "prefetcher": lambda: prefetcher.run(csv, device=device),
        "bfs": lambda: bfs.run(csv, scale=10 if fast else 12, device=device),
        "rmw_backends": lambda: rmw_backends.run(
            csv, fast=fast, device=device, **({} if out_dir is None else {
                "out_path": os.path.join(out_dir, "rmw_backends.json")})),
        "calibrate": lambda: calibrate.run(
            csv, fast=fast, device=device, measured=results.get("latency"),
            out_path=None if out_dir is None else os.path.join(
                out_dir, "calibrated_spec.json")),
        "model_validation": lambda: model_validation.run(
            csv, results.get("latency"), device=device, fast=fast),
        "roofline": lambda: roofline.run(csv),
        "rmw_sharded": lambda: rmw_sharded.run(
            csv, fast=fast, device=device, **({} if out_dir is None else {
                "out_path": os.path.join(out_dir, "rmw_sharded.json")})),
        "reshard": lambda: reshard.run(csv, fast=fast, device=device),
        "fault_recovery": lambda: fault_recovery.run(csv, fast=fast,
                                                     device=device),
        "telemetry_drift": lambda: telemetry_drift.run(
            csv, fast=fast, device=device, out_path=None if out_dir is None
            else os.path.join(out_dir, "telemetry_drift.json")),
        "contention_observe": lambda: contention_observe.run(
            csv, fast=fast, device=device, out_path=None if out_dir is None
            else os.path.join(out_dir, "contention_observe.json")),
        "analysis": lambda: analysis_sweep.run(csv, device=device),
        "tuning": lambda: tuning.run(
            csv, fast=fast, device=device, out_path=None if out_dir is None
            else os.path.join(out_dir, "tuning.json")),
    }
    failures = []
    for name in SUITES:
        if only and name not in only:
            continue
        try:
            results[name] = suite[name]()
        except Exception as e:  # noqa: BLE001
            failures.append((name, repr(e)))
            print(f"{name},FAILED,{e!r}", flush=True)
    return csv, results, failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated suite names")
    ap.add_argument("--fast", action="store_true",
                    help="smaller problem sizes (CI)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="directory for the suites' JSON (default: "
                         "build/repro_torch/)")
    args = ap.parse_args(argv)
    csv = Csv()
    csv.header()
    _, _, failures = run_suites(args.only.split(",") if args.only else None,
                                args.fast, args.device, csv, args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
