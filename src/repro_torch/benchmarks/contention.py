"""Contention benchmark — paper Fig. 8a-c (n writers -> one cache line).

Port of `benchmarks/contention.py`, at its sizes.  The analogue of thread
count is *collision density*: a batch whose indices fall in a window of w
slots.  The combining mode (`core.rmw.rmw_combining`) absorbs contention;
the serialized hot row (`core.rmw.rmw_serialized`, one thread issuing the
card's atomics) runs every op on one slot, the paper's regime.  Modelled
columns are `core.contention` over the `perf_model.H100` priors
(``modelH100``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core import contention as cmodel
from repro_torch.core.perf_model import H100
from repro_torch.core.rmw import rmw_combining, rmw_serialized

TABLE = 65_536
N_OPS = 262_144
N_HOT = 2_048
WRITERS = (1, 2, 4, 8, 16, 61)


def run(csv: Csv, device="cuda") -> Dict[str, List]:
    rng = np.random.default_rng(2)
    table = torch.zeros((TABLE,), dtype=torch.float32, device=device)
    vals = on_device(rng.normal(size=N_OPS), device, torch.float32)
    out = {"writers": list(WRITERS), "combining_Bps": [],
           "modeled_serialized_Bps": [], "modeled_combining_Bps": []}
    for w in WRITERS:
        # w writers hammering one slot each within a w-slot window — the
        # collision density of w contending threads
        idx = on_device(rng.integers(0, w, N_OPS), device, torch.int32)
        t = time_s(lambda i=idx: rmw_combining(table, i, vals, "faa").table,
                   device=device) / N_OPS
        bw = 4 / t
        out["combining_Bps"].append(bw)
        m_ser = cmodel.contended_bandwidth_serialized(H100, "faa", w)
        m_comb = cmodel.contended_bandwidth_combining(H100, "faa", w)
        out["modeled_serialized_Bps"].append(m_ser)
        out["modeled_combining_Bps"].append(m_comb)
        csv.add(f"contention.faa.w{w}", t * 1e6,
                f"measured={bw / 1e6:.1f}MB/s modelH100 ser="
                f"{m_ser / 1e6:.1f} comb={m_comb / 1e6:.1f}MB/s")

    # serialized contended (small batch — one slot, every op in order)
    idx1 = torch.zeros((N_HOT,), dtype=torch.int32, device=device)
    t = time_s(lambda: rmw_serialized(table, idx1, vals[:N_HOT],
                                      "faa").table, device=device) / N_HOT
    out["serialized_hot_s"] = t
    csv.add("contention.faa.serialized_hot", t * 1e6,
            f"{4 / t / 1e6:.2f} MB/s (paper regime)")
    return out
