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
