"""The lint sweep as a measurement suite (port of
`benchmarks/analysis_sweep.py`).

Runs `repro_torch.analysis` over every registered entry point (the same
sweep as ``python -m repro_torch.analysis.lint``) on ``device`` and emits
one CSV row per entry: the wall µs of its recorded run and rules pass,
its findings and its suppressed findings.  Each entry runs its function
once, so on the card the sweep drives the entries' kernels too.

Raises on unsuppressed error-severity findings: a red sweep fails the
harness like any other broken suite.
"""

from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.benchmarks.common import Csv


def run(csv: Csv, device="cuda") -> List[Dict[str, object]]:
    from repro_torch.analysis.entries import ENTRY_POINTS
    from repro_torch.analysis.findings import ERROR
    from repro_torch.analysis.lint import sweep

    errors, rows = [], []
    for entry in ENTRY_POINTS:
        t0 = time.perf_counter()
        findings = [f for fs in sweep([entry], device).values() for f in fs]
        wall_us = (time.perf_counter() - t0) * 1e6
        n_sup = sum(1 for f in findings if f.suppressed)
        csv.add(f"analysis.{entry}", wall_us,
                f"findings={len(findings)};suppressed={n_sup}")
        rows.append({"entry": entry, "wall_us": wall_us,
                     "findings": len(findings), "suppressed": n_sup})
        errors += [f for f in findings
                   if f.severity == ERROR and not f.suppressed]
    if errors:
        raise AssertionError(
            "analysis sweep found unsuppressed errors:\n"
            + "\n".join(f.format() for f in errors))
    return rows
