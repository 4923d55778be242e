#!/usr/bin/env python3
"""The `telemetry_drift` suite's overhead gate on one card: repeated, in
parts, and inside the smoke's process.

    python3 tools/telemetry_probe.py gate [RUNS]          # the gate, RUNS
                                                          # times (3)
    python3 tools/telemetry_probe.py split [VARIANT ...]  # the protocol's
                                                          # own bias
    python3 tools/telemetry_probe.py variants [ROUNDS [VARIANT ...]]
                                                          # the event
                                                          # path in parts
    python3 tools/telemetry_probe.py smoke_context        # the gate after
                                                          # each group of
                                                          # the smoke's
                                                          # phases
    python3 tools/telemetry_probe.py precision [ROUNDS]   # one reading's
                                                          # spread at 200
                                                          # and 800 pairs

Run from the repository root on a machine with one CUDA card; each mode
builds the kernels first and prints one JSON line per reading.  The gate's
call is `benchmarks.telemetry_drift.overhead`'s: eager `atomics.execute`
of FAA over n = 4,096 ops on 1,024 int32 slots, the backend the selector
picks, the card synchronised after each; the stream on is a ring sink of
16 without sync.  A reading is the median over pairs of batches of the
on / off ratio, less 1 (`_pairs`: the gate's protocol, 200 pairs of 50
calls, with the ratios' quantiles kept).

``gate``: the suite's `overhead` (the gated median, the ratio of minima,
the host-only call) in this process.

``split``: `_pairs` for each variant in turn, ``PROBE_ROUNDS`` rounds (3):
``ring`` (the gate's), ``measured_only`` (a sink that reads only measured
events: `execute` builds no event), ``setup_only`` (the stream turned on
and off again before the batch, which runs with it off) and ``self`` (the
call against itself).

``variants``: `_pairs` with the stream on a ring and
`atomics.execute._recorded` swapped while on for `_recorded_variant`
``no_record`` (the event built, not recorded), ``direct`` (stamped and
appended to the ring's deque in place: no `telemetry.record_event`, lock
or sink loop) or ``no_event`` (none built), or `telemetry.record_event`
swapped for `_LOCKED_RECORD` (``locked_record``: every sink's ``emit``
under the module lock, as before sinks had emitters), beside the
unchanged ``ring``.

``smoke_context``: the gate twice after the build, then twice after each
group of `chip_smoke.main`'s phases up to and through `phase_suites` (the
dry run's children started beside them, as there).

``precision``: the suite's `_timed_pair` at n = 4,096 with 200 pairs and
with 800, in turn.
"""

import gc
import importlib
import inspect
import json
import os
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import atomics, telemetry  # noqa: E402
from repro_torch.benchmarks import telemetry_drift as td  # noqa: E402
from repro_torch.telemetry import core as tcore  # noqa: E402

#: the module (`repro_torch.atomics` exports its function of that name)
ex = importlib.import_module("repro_torch.atomics.execute")

PAIRS, BATCH = td.GATE_PAIRS


def _built():
    """`chip_smoke`, its kernels built and the card named."""
    import chip_smoke as C
    C.phase_device()
    C.phase_build()
    return C


def _call():
    """The gate's call, warmed."""
    rng = np.random.default_rng(1)
    tbl = atomics.make_table(td.LOCAL_M, torch.int32, device="cuda")
    op = atomics.Faa(torch.as_tensor(rng.integers(0, td.LOCAL_M, td.GATE_N),
                                     dtype=torch.int32, device="cuda"),
                     torch.ones(td.GATE_N, dtype=torch.int32, device="cuda"))

    def call():
        atomics.execute(tbl, op)
        torch.cuda.synchronize()
    for _ in range(BATCH):
        call()
    return call


def _pairs(call, on: bool, sink=None, setup=None, teardown=None) -> dict:
    """`benchmarks.common.paired_ratio`'s loop with the stream on (a ring
    of 16, or ``sink``) against off, or ``setup`` / ``teardown`` around
    the first half; the ratios' quantiles, the garbage collections by
    generation that started in each half."""
    if setup is None:
        sink = telemetry.RingBuffer(capacity=16) if sink is None else sink
        setup = (lambda: telemetry.enable(sink)) if on else (lambda: None)
        teardown = telemetry.disable if on else (lambda: None)
    times = {True: [], False: []}
    collections = {True: [0, 0, 0], False: [0, 0, 0]}
    side = [None]

    def count(phase, info):
        if phase == "start" and side[0] is not None:
            collections[side[0]][info["generation"]] += 1
    gc.callbacks.append(count)
    try:
        for i in range(PAIRS):
            for first in ((True, False) if i % 2 == 0 else (False, True)):
                if first:
                    setup()
                try:
                    side[0] = first
                    t0 = time.perf_counter()
                    for _ in range(BATCH):
                        call()
                    times[first].append((time.perf_counter() - t0) / BATCH)
                    side[0] = None
                finally:
                    if first:
                        teardown()
    finally:
        gc.callbacks.remove(count)
    r = np.array(times[True]) / np.array(times[False]) - 1.0
    q = np.quantile(r, (0.1, 0.25, 0.5, 0.75, 0.9))
    return {"median": float(q[2]),
            "q10_25_75_90": [float(x) for x in (q[0], q[1], q[3], q[4])],
            "a_min_us": min(times[True]) * 1e6,
            "b_min_us": min(times[False]) * 1e6,
            "gc_on_by_generation": collections[True],
            "gc_off_by_generation": collections[False]}


def _fresh(tag, runs):
    for i in range(runs):
        r = td.overhead("cuda", fast=False)
        print(json.dumps({"part": tag, "run": i, "overhead": r["overhead"],
                          "overhead_of_minima": r["overhead_of_minima"],
                          "enabled_us": r["enabled_us"],
                          "disabled_us": r["disabled_us"],
                          "host_only": r["host_only"]["overhead"]}),
              flush=True)


def gate(runs: int = 3):
    _built()
    _fresh("gate", runs)


class _MeasuredOnly(telemetry.RingBuffer):
    measured_only = True


def split(*names):
    _built()
    call = _call()
    for _ in range(int(os.environ.get("PROBE_ROUNDS", "3"))):
        for name in names or ("ring", "measured_only", "setup_only", "self"):
            if name == "setup_only":
                r = _pairs(call, True, setup=lambda: (
                    telemetry.enable(telemetry.RingBuffer(16)),
                    telemetry.disable()), teardown=lambda: None)
            else:
                r = _pairs(call, name != "self", _MeasuredOnly(16)
                           if name == "measured_only" else None)
            print(json.dumps({"part": "split", "variant": name, **r}),
                  flush=True)


def _recorded_variant(name: str):
    """`atomics.execute._recorded` with its event path changed (`variants`
    says how)."""
    src = textwrap.dedent(inspect.getsource(ex._recorded))
    record = "    telemetry.record_event(fields)\n"
    assert src.count(record) == 1
    if name == "no_record":
        src = src.replace(record, "")
    elif name == "direct":
        src = src.replace(record, "    fields[\"t\"] = _TIME()\n"
                                  "    _tcore._sinks[0]._buf.append(fields)\n")
    elif name == "no_event":
        guard = "    if measured_s is None and not _tcore._every_event:"
        assert guard in src
        src = src.replace(guard, "    if True:")
    else:
        raise ValueError(name)
    g = dict(ex.__dict__, _TIME=time.time)
    exec(compile(src, ex.__file__, "exec"), g)
    return g["_recorded"]


#: `telemetry.record_event` as it was before sinks had emitters: every
#: sink's ``emit`` called under the module lock
_LOCKED_RECORD = (
    "def record_event(ev):\n"
    "    if not _enabled:\n"
    "        return\n"
    "    if \"t\" not in ev:\n"
    "        ev[\"t\"] = time.time()\n"
    "    _lock.acquire()\n"
    "    try:\n"
    "        for s in _sinks:\n"
    "            try:\n"
    "                s.emit(ev)\n"
    "            except Exception:\n"
    "                pass\n"
    "    finally:\n"
    "        _lock.release()\n")


def variants(rounds: int = 4, *names):
    _built()
    call = _call()
    recorded, record = ex._recorded, telemetry.record_event
    ns = {}
    exec(compile(_LOCKED_RECORD, tcore.__file__, "exec"), tcore.__dict__, ns)
    names = names or ("no_record", "direct", "no_event", "locked_record")
    swaps = {"ring": (recorded, record)}
    for name in names:
        swaps[name] = ((recorded, ns["record_event"])
                       if name == "locked_record"
                       else (_recorded_variant(name), record))
    for _ in range(rounds):
        for name, (fn, rec) in swaps.items():
            ring = telemetry.RingBuffer(16)

            def on(fn=fn, rec=rec, ring=ring):
                ex._recorded, telemetry.record_event = fn, rec
                telemetry.enable(ring)

            def off():
                telemetry.disable()
                ex._recorded, telemetry.record_event = recorded, record
            r = _pairs(call, True, setup=on, teardown=off)
            print(json.dumps({"part": "variants", "variant": name, **r}),
                  flush=True)


def smoke_context():
    C = _built()
    started = C.start_dryrun()
    _fresh("fresh", 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"rmw_table": 0.0, "rmw_table_fetched": 0.0, "slot_counts": 0.0,
            "fetched_normal_faa": 0.0, "serial_rmw": 0.0}
    graph = []

    def kernels():
        C.phase_kernels(gen, errs)
        C.phase_serial_kernels(gen, errs)
        C.phase_ssd_kernel(gen)
        C.phase_flash_kernel(gen)
        C.phase_flash_dbrx(gen)
        C.phase_flash_mm(gen)

    def atomics_bfs():
        C.K.reset_launches()
        C.phase_atomics(gen)
        graph[:] = C.phase_bfs()
        C.phase_bfs_search(*graph)

    def serve():
        for phase in (C.phase_serve, C.phase_serve_gemma,
                      C.phase_serve_dbrx, C.phase_serve_jamba,
                      C.phase_serve_qwen2_vl, C.phase_serve_whisper):
            phase()

    def timing():
        C.phase_timing(gen, graph[0].shape[0], 1 << C.SCALE)

    def suites():
        try:
            C.phase_suites()
        except AssertionError as e:
            print(json.dumps({"part": "smoke_suites", "failed": str(e)}),
                  flush=True)
    try:
        for group in (kernels, atomics_bfs, serve, timing, suites):
            group()
            _fresh(f"after_{group.__name__}", 2)
    finally:
        C._stop([p for p, _ in started.values()])


def precision(rounds: int = 5):
    _built()
    call = _call()
    for _ in range(rounds):
        for pairs in (PAIRS, 4 * PAIRS):
            t0 = time.perf_counter()
            r = td._timed_pair(call, batch=BATCH, n_batches=pairs)
            print(json.dumps({"part": "precision", "pairs": pairs,
                              "seconds": time.perf_counter() - t0, **r}),
                  flush=True)


if __name__ == "__main__":
    mode, args = (sys.argv[1], sys.argv[2:]) if len(sys.argv) > 1 \
        else ("gate", [])
    if mode == "gate":
        gate(*map(int, args))
    elif mode == "split":
        split(*args)
    elif mode == "variants":
        variants(*([int(args[0])] + args[1:] if args else []))
    elif mode == "smoke_context":
        smoke_context()
    elif mode == "precision":
        precision(*map(int, args))
    else:
        raise SystemExit(__doc__)
