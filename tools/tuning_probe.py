#!/usr/bin/env python3
"""The tuning slice's phase of `chip_smoke.py`, alone, and what a live
controller costs eager `execute` on one card, part by part.

    python3 tools/tuning_probe.py phase   # build, then the `tuning` phase
                                          # (both suites and the live probe)
    python3 tools/tuning_probe.py parts   # per-call µs of each layer
    python3 tools/tuning_probe.py pairs   # paired overhead per variant
    python3 tools/tuning_probe.py sampling  # the live probe, every call
                                            # measured by CUDA events,
                                            # every call synced, and 1 in
                                            # 64 by events
    python3 tools/tuning_probe.py gate    # the `tuning` suite's overhead
                                          # gate, 3 runs measuring every
                                          # call, then 1 run sampling
    python3 tools/tuning_probe.py stamps  # the RMW kernels' stamps: the
                                          # timer's resolution, µs to
                                          # record and read a pair, the
                                          # gate and the probe's windows
                                          # with every call stamped

Run from the repository root on a machine with one CUDA card.  The calls
are the `tuning` suite's overhead workload: FAA of n = 4,096 ops over
1,024 int32 slots on the ``cuda`` backend, the card synchronised after
each.  ``parts`` prints, as one JSON object, the least mean µs over 5
blocks of: an idle `torch.cuda.synchronize` (with and without a device),
a stream query, a pair of CUDA events made and recorded, a pair of
pooled ``torch.cuda.Event``s recorded on a stream looked up once (what
`atomics.execute` recorded before the event ring), the pair
`atomics.execute` records (two events of the device's
`telemetry.events.EventRing`, through the CUDA runtime), a window of 32
such pairs read back through ``torch.cuda.Event`` and through the ring
(µs a pair), the call with the stream
off, with a ring sink (no sync; sync, every call measured by events; and
every call synced), with a controller started (no step, and stepped),
and one controller tap, `drift.aggregate`, `fit_spec_update` and update
cycle on a 32-event window.  ``pairs`` prints one JSON line per variant,
its paired overhead against the stream off
(`benchmarks.common.paired_ratio`, 60 pairs of 32-call batches): a ring
sink without and with sync, a controller measuring every call by events,
every call synced (`atomics.execute._SYNC_MEASURE`) and one call in 64
(`tuning.controller.SYNC_EVERY`) each way, each without and with
`step()`, a controller without sync, and the call against itself (the
protocol's noise).  ``sampling [MODE ...]`` builds the kernels, then
runs `chip_smoke.py`'s live probe (a default controller over the drift
traffic for 12 windows) once per mode: every call measured by CUDA events
(``events``), every call between two synchronisations (``synced``), one
call in 64 by events (``sampled``, what the controller does), every call
or one in 64 timed by stamps (``stamps``, ``sampled_stamps``:
`stamped_timing`); by default events, synced, sampled, sampled, synced,
events: one JSON line per run with its windows, the fields quarantined
and applied, the active tuned fields at the end, what auto picks after,
the measured calls, the distinct (op, n, backend) among them, and its
seconds.  ``stamps`` builds the kernels and prints
`chip_smoke._stamp_figures` (``%globaltimer``'s resolution, the stamped
entries bit-equal with and without a pair armed, µs to arm a pair and to
read one back against the event ring's, stamped against event seconds on
1,024 calls at the gate's call and at 2^22 ops over 2^20 slots), then the
gate 3 times with every call stamped, once at 1 in 64 stamped and once
at 1 in 64 by events, then the live probe 3 times with every call
stamped: one JSON line each.  `atomics.execute` times its measured calls
by events; only `stamped_timing` here times them by stamps.
"""

import contextlib
import importlib
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
from repro_torch.telemetry import core as tcore  # noqa: E402
from repro_torch.telemetry import drift  # noqa: E402
from repro_torch.telemetry import events as tevents  # noqa: E402
from repro_torch.tuning import SpecController, TuningConfig  # noqa: E402
from repro_torch.tuning import controller as tc  # noqa: E402

#: the module (`repro_torch.atomics` exports its function of that name)
ex = importlib.import_module("repro_torch.atomics.execute")


#: the backends whose calls on the card reach a stamped C entry: ``cuda``
#: (`rmw_table`, `rmw_table_fetched`) and ``serialized`` (`serial_rmw`)
STAMPED_BACKENDS = ("cuda", "serialized")


@contextlib.contextmanager
def stamped_timing():
    """While entered, `atomics.execute`'s measured calls on the card whose
    backend runs the port's RMW kernels are timed by a pair of the
    device's `telemetry.events.StampRing` that the kernels stamp, not by
    the event ring; other calls keep events.  A stamped call that reaches
    no stamped entry raises."""
    by_events = ex._measured

    def measured(table, op, kw, synced):
        backend = kw["backend"]
        if backend == "auto":
            backend = ex._fields(table, op, kw, False).get("backend")
        if synced or not table.data.is_cuda or \
                backend not in STAMPED_BACKENDS:
            return by_events(table, op, kw, synced)
        ring = tevents.stamp_ring(table.data.get_device())
        used = tevents.STAMP.used
        out, k = ring.stamp(lambda: ex._dispatch_one(table, op, **kw))
        if tevents.STAMP.used == used:
            raise RuntimeError(f"a stamped call on backend {backend!r} "
                               f"reached no stamped kernel entry")
        return out, tcore.DeviceSeconds(k, ring=ring)

    ex._measured = measured
    try:
        yield
    finally:
        ex._measured = by_events


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
           "query_us": _per_us(lambda: torch.cuda.current_stream().query()),
           "event_pair_us": _per_us(_event_pair),
           "pooled_pair_us": _per_us(_pooled_pair()),
           "ring_pair_us": _per_us(_ring_pair),
           **_readback_us()}
    tc.SYNC_EVERY = 1
    ctrl = SpecController(device="cuda")
    for rnd in range(3):
        r = {"base": _per_us(call)}
        for name, sync, synced in (("ring_nosync", False, False),
                                   ("ring_events", True, False),
                                   ("ring_synced", True, True)):
            ex._SYNC_MEASURE = synced
            telemetry.enable(telemetry.RingBuffer(16), sync=sync)
            r[name] = _per_us(call)
            telemetry.disable()
            ex._SYNC_MEASURE = False
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


def _event_pair():
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    end.record()


def _pooled_pair():
    """Two ``torch.cuda.Event``s recorded through the base ``record`` on a
    stream object looked up once, and given back to a pool (what
    `execute` paid before the event ring)."""
    record = torch._C._CudaEventBase.record
    stream = torch.cuda.current_stream()
    pool = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def pair():
        start, end = pool.pop(), pool.pop()
        record(start, stream)
        record(end, stream)
        pool.extend((start, end))
    return pair


def _ring_pair():
    """What `execute` pays for its two events now: a pair of the device's
    `telemetry.events.EventRing`, recorded through the CUDA runtime."""
    dev = torch.cuda.current_device()
    ring = tevents.ring(dev)
    stream = tevents.raw_stream(dev)
    k = ring.take()
    ring.record(ring.handle, 2 * k, stream)
    ring.record(ring.handle, 2 * k + 1, stream)


def _readback_us(window=32, reps=200):
    """µs a pair to read a window of ``window`` recorded pairs back: as
    `telemetry.resolve` read ``torch.cuda.Event`` pairs (the newest end's
    wait, then each pair's synchronize and elapsed time), and as it reads
    the ring's (one call)."""
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(window)]
    ring = tevents.ring(torch.cuda.current_device())
    stream = tevents.raw_stream(torch.cuda.current_device())
    out = {"readback_torch_us": float("inf"), "readback_ring_us": float("inf")}
    for _ in range(reps):
        for a, b in evs:
            a.record()
            b.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in reversed(evs):
            b.synchronize()
            a.elapsed_time(b)
        out["readback_torch_us"] = min(out["readback_torch_us"],
                                       (time.perf_counter() - t0) / window)
        pairs = [ring.take() for _ in range(window)]
        for k in pairs:
            ring.record(ring.handle, 2 * k, stream)
            ring.record(ring.handle, 2 * k + 1, stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.read(pairs)
        out["readback_ring_us"] = min(out["readback_ring_us"],
                                      (time.perf_counter() - t0) / window)
    return {k: v * 1e6 for k, v in out.items()}


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
    run("ring_events", lambda: telemetry.add_sink(ring, sync=True),
        lambda: telemetry.remove_sink(ring))
    for every in (1, 64):
        tc.SYNC_EVERY = every
        for mode in ("events", "synced"):
            ex._SYNC_MEASURE = mode == "synced"
            c = SpecController(device="cuda")
            run(f"ctrl{every}_{mode}_nostep", c.start, c.stop)
            run(f"ctrl{every}_{mode}_step", c.start, c.stop, c.step)
    ex._SYNC_MEASURE = False
    tc.SYNC_EVERY = 64
    c = SpecController(TuningConfig(sync=False), device="cuda")
    run("ctrl_nosync_step", c.start, c.stop, c.step)
    run("base_vs_base", lambda: None, lambda: None)
    return out


def sampling(*modes) -> dict:
    import chip_smoke as C
    C.phase_device()
    C.phase_build()
    out = []
    for mode in modes or ("events", "synced", "sampled", "sampled",
                          "synced", "events"):
        ex._SYNC_MEASURE = mode == "synced"
        tc.SYNC_EVERY = 64 if mode.startswith("sampled") else 1
        with (stamped_timing() if mode.endswith("stamps")
              else contextlib.nullcontext()):
            p = C._tuning_probe()
        row = {"measure": mode, **{k: p[k] for k in (
            "windows", "quarantined", "applied", "tuned_fields",
            "auto_before_after", "batches", "measured_kinds", "seconds")}}
        print(json.dumps(row), flush=True)
        out.append(row)
    ex._SYNC_MEASURE = False
    tc.SYNC_EVERY = 64
    return {"runs": len(out)}


def gate() -> dict:
    """The `tuning` suite's overhead gate (`benchmarks.tuning.overhead`:
    a live controller on eager FAA of 4,096 against the stream off) three
    times with every call measured (`tuning.controller.SYNC_EVERY` = 1),
    then once at 1 in 64; one JSON line a run."""
    from repro_torch.benchmarks import tuning as suite
    _workload()
    out = []
    for every in (1, 1, 1, 64):
        tc.SYNC_EVERY = every
        r = suite.overhead("cuda", fast=False)
        row = {"sync_every": every, **{k: r[k] for k in (
            "overhead", "overhead_of_minima", "attempts", "disabled_us",
            "enabled_us", "update_cycle_us", "ok")}}
        print(json.dumps(row), flush=True)
        out.append(row)
    tc.SYNC_EVERY = 64
    return {"every_call_ok": sum(r["ok"] for r in out[:3]), "runs": out}


def stamps() -> dict:
    import chip_smoke as C
    C.phase_device()
    C.phase_build()
    fig = C._stamp_figures()
    print(json.dumps({"figures": fig}), flush=True)
    from repro_torch.benchmarks import tuning as suite
    _workload()
    gates = []
    for every, stamped in ((1, True), (1, True), (1, True), (64, True),
                           (64, False)):
        tc.SYNC_EVERY = every
        with (stamped_timing() if stamped else contextlib.nullcontext()):
            r = suite.overhead("cuda", fast=False)
        row = {"sync_every": every, "stamps": stamped, **{k: r[k] for k in (
            "overhead", "overhead_of_minima", "attempts", "disabled_us",
            "enabled_us", "update_cycle_us", "ok")}}
        print(json.dumps(row), flush=True)
        gates.append(row)
    probes = []
    tc.SYNC_EVERY = 1
    for _ in range(3):
        with stamped_timing():
            p = C._tuning_probe()
        row = {"measure": "stamps_every_call", **{k: p[k] for k in (
            "windows", "quarantined", "applied", "tuned_fields", "batches",
            "measured_kinds", "seconds")}}
        print(json.dumps(row), flush=True)
        probes.append(row)
    tc.SYNC_EVERY = 64
    return {"every_call_gate_ok": sum(r["ok"] for r in gates[:3]),
            "probe_windows": [[w for w in r["windows"]] for r in probes]}


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
          "sampling": sampling, "gate": gate, "stamps": stamps}[mode]
    print(json.dumps(fn(*sys.argv[2:]), indent=1), flush=True)
