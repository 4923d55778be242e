"""Shared benchmark machinery (paper §2.1 methodology on the card).

Phases per benchmark: preparation (allocate and warm: the first calls also
build the kernels and warm the caches and TLB), synchronization,
measurement, result collection (median of k).  On a CUDA device each rep is
timed with CUDA events recorded around the call after a
`torch.cuda.synchronize()`, so the time is the device's from the call's
first enqueued work to its last, host enqueue included where the device
waits on it; on the CPU, with the host clock of a ``telemetry.span``
around the call.  Each rep runs inside a ``telemetry.span(name, rep=i)``,
so with the telemetry stream on it also lands there as a ``bench.rep``
event (its ``wall_s`` the host clock, the device synchronised at the end),
and a captured benchmark run feeds the same drift report as other traffic.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import telemetry

WARMUP = 2
REPS = 5


def time_s(fn: Callable[[], object], reps: int = REPS,
           warmup: int = WARMUP, name: str = "bench.rep", *,
           device="cuda") -> float:
    """Median seconds of one ``fn()`` call on ``device`` (see the module
    docstring for the clock).  A CUDA device that is missing raises."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    out: List[float] = []
    for rep in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with telemetry.span(name, rep=rep):
                start.record()
                fn()
                end.record()
                end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        else:
            with telemetry.span(name, rep=rep) as sp:
                fn()
            out.append(sp.wall_s)
    return float(np.median(out))


class Csv:
    """Collects `name,us_per_call,derived` rows (the run module's format)."""

    def __init__(self):
        self.rows: List[Dict] = []

    def add(self, name: str, us_per_call: float, derived: str = "") -> None:
        self.rows.append({"name": name, "us_per_call": us_per_call,
                          "derived": derived})
        print(f"{name},{us_per_call:.4g},{derived}", flush=True)

    def header(self) -> None:
        print("name,us_per_call,derived", flush=True)


def on_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array (the reference's seeded inputs) as a tensor on
    ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def kernel_us(fn: Callable[[], object], reps: int = REPS) -> float:
    """Device µs a ``fn()`` call spends in CUDA kernels: the sum of the
    kernels' durations in a `torch.profiler` trace of ``reps`` calls, over
    ``reps`` (the host's share left out, unlike `time_s`)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps


def paired_ratio(call_a: Callable[[], object], call_b: Callable[[], object],
                 *, batch: int, n_batches: int,
                 setup_a: Callable[[], object] = lambda: None,
                 teardown_a: Callable[[], object] = lambda: None
                 ) -> Dict[str, float]:
    """Per-call host seconds of ``call_a`` against ``call_b``:
    ``n_batches`` pairs of batches of ``batch`` calls, the two halves of a
    pair back to back and which runs first alternating, so load drift and
    order hit both alike.  ``overhead`` is the median over pairs of a / b
    - 1 (host time on a machine that shares its cores wanders by tens of
    percent between batches, far more than the costs these gates bound,
    and a ratio within a pair cancels that); the least batch mean of each
    side and their ratio are reported beside it.  ``setup_a`` /
    ``teardown_a`` run around each batch of ``call_a``, outside its clock
    (`telemetry_drift._timed_pair`'s protocol, for any two calls)."""
    times: Dict[bool, List[float]] = {True: [], False: []}
    for i in range(n_batches):
        for first in ((True, False) if i % 2 == 0 else (False, True)):
            call = call_a if first else call_b
            if first:
                setup_a()
            try:
                t0 = time.perf_counter()
                for _ in range(batch):
                    call()
                times[first].append((time.perf_counter() - t0) / batch)
            finally:
                if first:
                    teardown_a()
    ratios = [a / b for a, b in zip(times[True], times[False])]
    return {"a_us": min(times[True]) * 1e6, "b_us": min(times[False]) * 1e6,
            "overhead": float(np.median(ratios)) - 1.0,
            "overhead_of_minima": min(times[True]) / min(times[False]) - 1.0,
            "pairs": n_batches, "batch": batch}
