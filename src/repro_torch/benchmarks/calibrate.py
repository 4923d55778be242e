"""HardwareSpec calibration persistence — fit, write, reload.

Port of `benchmarks/calibrate.py`.  The engine's backend selection
(`core.rmw_engine`) reads constants from `perf_model.HardwareSpec`; this
fits them on the device it runs on and writes the result:

  1. tier latencies + execute costs + residuals — the paper's §5 procedure
     (`perf_model.calibrate`) over the latency suite's rows, from the
     device's priors (`rmw_engine.platform_spec`),
  2. `gather_elem_s`   — from the one-hot backend's table-only scatter pass
     (t / (n + m) over a small grid),
  3. `loop_step_s`     — from the slope of the blocked one-hot backend's
     fetched-mode time over the block count (two batch sizes),
  4. `sort_elem_pass_s`— from the argsort backend's fetched-mode time after
     subtracting the fitted scan + gather terms.

Writes JSON (``device``: `rmw_engine.device_key`, e.g. ``"cuda:NVIDIA H100
80GB HBM3"`` or ``"cpu"``; ``spec``: `perf_model.spec_to_dict`) to
``out_path``, by default `rmw_engine.calibrated_spec_path()` (under
``build/``, not committed), and reads it back through
`rmw_engine.load_calibration`.  The CPU's selection loads a ``"cpu"``
file; the card's stays on the `H100` priors whatever the file says.

Guard: a fitted engine constant that would change a selection this run's
backend shoot-out measured (`rmw_backends`: its grid's FAA cells, fetched
and table-only, and the fetched MIN/SWP cell) is not kept: the priors'
value stays.  On the CPU the priors pick ``onehot`` in every fetched FAA
cell, so this is the reference's onehot-over-sort condition.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.benchmarks import latency as latency_bench
from repro_torch.benchmarks import model_validation
from repro_torch.benchmarks import rmw_backends
from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core import perf_model, rmw_engine

#: the engine constants this fits (the rest of the spec is Table 2/3's)
ENGINE_CONSTANTS = ("gather_elem_s", "loop_step_s", "sort_elem_pass_s")


def _bench_engine(backend: str, n: int, m: int, need_fetched: bool, rng,
                  device) -> float:
    table = on_device(rng.normal(size=m), device, torch.float32)
    idx = on_device(rng.integers(0, m, n), device, torch.int32)
    vals = on_device(rng.normal(size=n), device, torch.float32)

    def fn():
        res = atomics.execute(table, atomics.Faa(idx, vals), backend=backend,
                              need_fetched=need_fetched)
        if need_fetched:
            return res.table.data, res.fetched, res.success
        return res.table.data

    return time_s(fn, reps=5, warmup=2, device=device)


def fit_engine_constants(spec: perf_model.HardwareSpec, rng,
                         device) -> Dict[str, float]:
    """Fit gather/loop-step/sort-pass from the backend suites themselves."""
    # gather_elem_s: the table-only scatter pass is (n + m) gathers by model
    samples = []
    for n, m in ((16384, 4096), (65536, 4096), (65536, 65536)):
        t = _bench_engine("onehot", n, m, False, rng, device)
        samples.append(t / (n + m))
    gather = float(np.median(samples))

    # loop_step_s: fetched-mode time grows ~linearly in the block count
    b = rmw_engine.DEFAULT_ONEHOT_BLOCK
    n1, n2, m = 4096, 32768, 4096
    t1 = _bench_engine("onehot", n1, m, True, rng, device)
    t2 = _bench_engine("onehot", n2, m, True, rng, device)
    blocks1, blocks2 = n1 // b, n2 // b
    mac = 2.0 * b * b / max(spec.peak_flops, 1.0)
    per_block = (t2 - t1) / max(1, blocks2 - blocks1)
    loop_step = max(1e-8, per_block - mac)  # carry bundled into the step

    # sort_elem_pass_s: subtract the fitted scan+gather terms from the
    # argsort backend and attribute the rest to log2(n) sort passes
    n, m = 16384, 4096
    t_sort = _bench_engine("sort", n, m, True, rng, device)
    passes = max(1.0, math.log2(n))
    scan = passes / max(spec.combine_ops_per_s, 1.0)
    resid = t_sort - n * scan - 4 * n * gather
    sort_pass = max(1e-10, resid / (n * passes))
    return {"gather_elem_s": gather, "loop_step_s": loop_step,
            "sort_elem_pass_s": sort_pass}


def selections(spec: perf_model.HardwareSpec, fast: bool,
               device) -> Dict[tuple, str]:
    """The backend `select_backend` picks with ``spec`` in each cell the
    backend shoot-out measures (`rmw_backends.grid`)."""
    cells = rmw_backends.grid(fast)
    picks = {}
    for n, m in cells:
        for need in (True, False):
            picks[("faa", n, m, need)] = rmw_engine.select_backend(
                "faa", n, m, spec, dtype=torch.float32, need_fetched=need,
                device=device)
    n_s, m_s = cells[0][0], cells[-1][1]
    for op in ("min", "swp"):
        picks[(op, n_s, m_s, True)] = rmw_engine.select_backend(
            op, n_s, m_s, spec, dtype=torch.float32, device=device)
    return picks


def guard(spec: perf_model.HardwareSpec, fitted: Dict[str, float],
          fast: bool, device):
    """``spec`` with each fitted constant that leaves every measured
    selection as the priors make it (see the module docstring); returns
    the spec and the constants kept at their priors."""
    want = selections(spec, fast, device)
    kept = [c for c in ENGINE_CONSTANTS
            if selections(replace(spec, **{c: fitted[c]}), fast,
                          device) != want]
    out = replace(spec, **{c: fitted[c] for c in ENGINE_CONSTANTS
                           if c not in kept})
    if selections(out, fast, device) != want:   # the fits only clash jointly
        kept, out = list(ENGINE_CONSTANTS), spec
    return out, kept


def run(csv: Csv, fast: bool = False, out_path: Optional[str] = None,
        device="cuda", measured=None) -> Dict:
    """Fit, write and reload.  ``measured``: the latency suite's rows when
    they were already taken in this run (else the suite runs here)."""
    if out_path is None:
        out_path = rmw_engine.calibrated_spec_path()
    rng = np.random.default_rng(23)
    # 1. the paper's Table 2/3 calibration from the latency suite
    if measured is None:
        measured = latency_bench.run(csv, device=device, fast=fast)
    base = rmw_engine.platform_spec(device)
    spec = perf_model.calibrate(base, *model_validation.samples(measured))
    # 2-4. engine constants, guarded
    fitted = fit_engine_constants(spec, rng, device)
    spec, kept = guard(spec, fitted, fast, device)

    key = rmw_engine.device_key(device)
    payload = {
        "device": key,
        "kept_priors": kept,
        "fitted_engine_constants": fitted,
        "spec": perf_model.spec_to_dict(spec),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    for k, v in fitted.items():
        csv.add(f"calibrate.{k}", v * 1e6, "fitted engine constant"
                + (" (prior kept)" if k in kept else ""))
    csv.add("calibrate.spec", 0.0,
            f"device={key} kept_priors={kept} json={out_path}")

    # reload: the file must round-trip through the engine's loader
    loaded = rmw_engine.load_calibration(out_path, key, base)
    if loaded is None or perf_model.spec_to_dict(loaded) \
            != perf_model.spec_to_dict(spec):
        raise AssertionError(f"calibrate: {out_path} does not round-trip")
    payload["spec"] = spec
    return payload
