#!/usr/bin/env python3
"""The tuning slice's phase of `chip_smoke.py`, alone, and what a live
controller costs eager `execute` on one card, part by part.

    python3 tools/tuning_probe.py phase   # build, then the `tuning` phase
                                          # (both suites and the live probe)
    python3 tools/tuning_probe.py parts   # per-call µs of each layer
    python3 tools/tuning_probe.py pairs   # paired overhead per variant
    python3 tools/tuning_probe.py sampling  # the live probe, every call
                                            # measured against 1 in 64

Run from the repository root on a machine with one CUDA card.  The calls
are the `tuning` suite's overhead workload: FAA of n = 4,096 ops over
1,024 int32 slots on the ``cuda`` backend, the card synchronised after
each.  ``parts`` prints, as one JSON object, the least mean µs over 5
blocks of: an idle `torch.cuda.synchronize` (with and without a device),
a stream query, the call with the stream off, with a ring sink (no sync,
and sync on every call), with a controller started (no step, and
stepped), and one controller tap, `drift.aggregate`, `fit_spec_update`
and update cycle on a 32-event window.  ``pairs`` prints one JSON line
per variant, its paired overhead against the stream off
(`benchmarks.common.paired_ratio`, 60 pairs of 32-call batches): a ring
sink without and with sync one call in 32, a controller measuring one
call in 32, 64 and never, each without and with `step()`, a controller
without sync, and the call against itself (the protocol's noise).
``sampling`` builds the kernels, then runs `chip_smoke.py`'s live probe
(a default controller over the drift traffic for 12 windows) six times,
its sink measuring every call (``SYNC_EVERY`` 1) or one in 64, in the
order 1, 64, 64, 1, 1, 64: one JSON line per run with its windows, the
fields quarantined and applied, the active tuned fields at the end, what
auto picks after, the measured calls, the distinct (op, n, backend) among
them, and its seconds.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import atomics, telemetry  # noqa: E402
from repro_torch.benchmarks.common import paired_ratio  # noqa: E402
from repro_torch.core import rmw_engine  # noqa: E402
from repro_torch.telemetry import drift  # noqa: E402
from repro_torch.tuning import SpecController, TuningConfig  # noqa: E402
from repro_torch.tuning import controller as tc  # noqa: E402


def _workload():
    m, n = 1024, 4096
    rng = np.random.default_rng(2)
    tbl = atomics.make_table(m, torch.int32)
    op = atomics.Faa(torch.as_tensor(rng.integers(0, m, n),
                                     dtype=torch.int32).cuda(),
                     torch.ones(n, dtype=torch.int32).cuda())

    def call():
        atomics.execute(tbl, op, backend="cuda")
        torch.cuda.synchronize()
    for _ in range(200):
        call()
    return call


def _per_us(fn, reps=1000):
    for _ in range(50):
        fn()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps // 5):
            fn()
        best = min(best, (time.perf_counter() - t0) / (reps // 5))
    return best * 1e6


def parts() -> dict:
    call = _workload()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"sync_idle_us": _per_us(torch.cuda.synchronize),
           "sync_dev_idle_us": _per_us(lambda: torch.cuda.synchronize(dev)),
           "query_us": _per_us(lambda: torch.cuda.current_stream().query())}
    tc.SYNC_EVERY = 1
    ctrl = SpecController(device="cuda")
    for rnd in range(3):
        r = {"base": _per_us(call)}
        for name, sync in (("ring_nosync", False), ("ring_sync", True)):
            telemetry.enable(telemetry.RingBuffer(16), sync=sync)
            r[name] = _per_us(call)
            telemetry.disable()
        ctrl.start()
        r["ctrl_nostep"] = _per_us(call)
        r["ctrl_step"] = _per_us(lambda: (call(), ctrl.step()))
        ctrl.stop()
        out[f"round{rnd}"] = r
    with telemetry.capture(sync=True) as buf:
        for _ in range(32):
            call()
    win = [e for e in buf.events if e["event"] == "atomics.execute"]
    out["observe_us"] = _per_us(lambda: ctrl._observe(win[0]), 100000)
    ctrl._window.clear()
    out["aggregate_us"] = _per_us(lambda: drift.aggregate(win), 2000)
    stats = drift.aggregate(win)
    out["fit_us"] = _per_us(lambda: drift.fit_spec_update(
        stats, ctrl.active, min_samples=4), 2000)
    probe = SpecController(device="cuda")
    out["update_us"] = _per_us(lambda: probe._update(list(win)), 2000)
    rmw_engine.clear_live_spec()
    tc.SYNC_EVERY = 64
    return out


def pairs() -> dict:
    call = _workload()
    out = {}

    def run(name, setup, teardown, step=None):
        fn = (lambda: (call(), step())) if step else call
        r = paired_ratio(fn, call, batch=32, n_batches=60, setup_a=setup,
                         teardown_a=teardown)
        out[name] = {k: r[k] for k in ("overhead", "overhead_of_minima",
                                       "a_us", "b_us")}
        print(name, json.dumps(out[name]), flush=True)

    ring = telemetry.RingBuffer(16)
    run("ring_nosync", lambda: telemetry.add_sink(ring),
        lambda: telemetry.remove_sink(ring))
    ring.sync_every = 32
    run("ring_sync32", lambda: telemetry.add_sink(ring, sync=True),
        lambda: telemetry.remove_sink(ring))
    for every in (32, 64, 10 ** 9):
        tc.SYNC_EVERY = every
        c = SpecController(device="cuda")
        run(f"ctrl{every}_nostep", c.start, c.stop)
        run(f"ctrl{every}_step", c.start, c.stop, c.step)
    tc.SYNC_EVERY = 64
    c = SpecController(TuningConfig(sync=False), device="cuda")
    run("ctrl_nosync_step", c.start, c.stop, c.step)
    run("base_vs_base", lambda: None, lambda: None)
    return out


def sampling() -> dict:
    import chip_smoke as C
    C.phase_device()
    C.phase_build()
    out = []
    for every in (1, 64, 64, 1, 1, 64):
        tc.SYNC_EVERY = every
        p = C._tuning_probe()
        row = {"sync_every": every, **{k: p[k] for k in (
            "windows", "quarantined", "applied", "tuned_fields",
            "auto_before_after", "batches", "measured_kinds", "seconds")}}
        print(json.dumps(row), flush=True)
        out.append(row)
    tc.SYNC_EVERY = 64
    return {"runs": len(out)}


def phase() -> dict:
    import chip_smoke as C
    C.phase_device()
    t0 = time.perf_counter()
    C.phase_build()
    t1 = time.perf_counter()
    launches = C.phase_tuning()
    return {"build_s": t1 - t0, "tuning_s": time.perf_counter() - t1,
            "launches": launches}


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "phase"
    fn = {"phase": phase, "parts": parts, "pairs": pairs,
          "sampling": sampling}[mode]
    print(json.dumps(fn(), indent=1), flush=True)
