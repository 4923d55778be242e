"""CLI sweep: ``python -m repro_torch.analysis.lint``.

Port of `repro.analysis.lint`.  Runs every registered entry point
(`repro_torch.analysis.entries`) on the device asked for (the card unless
``--device cpu``) and prints the findings.  Exit status is 1 iff any
**unsuppressed error-severity** finding exists — warnings and suppressed
findings are printed (and counted) but do not fail the sweep.

    python -m repro_torch.analysis.lint                # sweep everything
    python -m repro_torch.analysis.lint --entries moe.local,bfs.local
    python -m repro_torch.analysis.lint --json         # machine-readable
    python -m repro_torch.analysis.lint --list         # registered entries
    python -m repro_torch.analysis.lint --device cpu   # on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.entries import ENTRY_POINTS
from repro_torch.analysis.findings import ERROR, Finding, make_finding


def sweep(entries: Optional[Sequence[str]] = None, device="cuda"
          ) -> Dict[str, List[Finding]]:
    """Run the named entries (default: all) on ``device``; a crashing
    entry yields a single A000 error finding instead of aborting the
    sweep."""
    names = list(entries) if entries else list(ENTRY_POINTS)
    out: Dict[str, List[Finding]] = {}
    for name in names:
        fn = ENTRY_POINTS.get(name)
        if fn is None:
            out[name] = [make_finding(
                "A000", f"unknown entry point {name!r} (registered: "
                        f"{', '.join(ENTRY_POINTS)})",
                provenance="lint.sweep")]
            continue
        try:
            out[name] = fn(device=device)
        except Exception as e:  # noqa: BLE001 — a crash is a finding
            tb = traceback.extract_tb(e.__traceback__)
            last = tb[-1] if tb else None
            f = make_finding(
                "A000", f"entry point crashed: {type(e).__name__}: {e}",
                file=last.filename if last else None,
                line=last.lineno if last else None,
                provenance="lint.sweep")
            f.entry = name
            out[name] = [f]
    return out


def summary(results: Dict[str, List[Finding]]) -> Dict[str, int]:
    flat = [f for fs in results.values() for f in fs]
    return {
        "entries": len(results),
        "findings": len(flat),
        "errors": sum(1 for f in flat
                      if f.severity == ERROR and not f.suppressed),
        "warnings": sum(1 for f in flat
                        if f.severity != ERROR and not f.suppressed),
        "suppressed": sum(1 for f in flat if f.suppressed),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="atomics contract linter (over a recorded eager run)")
    ap.add_argument("--entries", default=None,
                    help="comma-separated entry names (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON on stdout")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entries run (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in ENTRY_POINTS:
            print(name)
        return 0

    names = ([s.strip() for s in args.entries.split(",") if s.strip()]
             if args.entries else None)
    results = sweep(names, device=args.device)
    totals = summary(results)

    if args.json:
        payload = {
            "summary": totals,
            "findings": [dataclasses.asdict(f)
                         for fs in results.values() for f in fs],
        }
        print(json.dumps(payload, indent=2, default=str))
    else:
        for name, findings in results.items():
            mark = "clean" if not findings else \
                f"{len(findings)} finding(s)"
            print(f"[{name}] {mark}")
            for f in findings:
                print(f"  {f.format()}")
        print(f"swept {totals['entries']} entries: "
              f"{totals['errors']} error(s), "
              f"{totals['warnings']} warning(s), "
              f"{totals['suppressed']} suppressed")
    return 1 if totals["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
