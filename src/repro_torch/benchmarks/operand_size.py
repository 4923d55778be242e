"""Operand-size benchmark — paper Fig. 7 (64- vs 128-bit CAS).

Port of `benchmarks/operand_size.py`, at its sizes.  Sweeps the RMW operand
width; wide operands are emulated the way the reference does (the paper's
cmpxchg16b): one op touching 2 or 4 adjacent int32 lanes, each lane a
serialized CAS batch (`core.rmw.rmw_serialized`: on the card one thread
issuing ``atom.cas``).  The model column is `perf_model.bandwidth` over the
`H100` priors at HBM (``modelH100``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core.perf_model import H100, bandwidth
from repro_torch.core.placement import PlacementState, Tier
from repro_torch.core.rmw import rmw_serialized

N_OPS = 2_048
TABLE = 65_536


def _measure(dtype, width: int, device) -> float:
    rng = np.random.default_rng(3)
    table = torch.zeros((TABLE,), dtype=dtype, device=device)
    idx0 = on_device(rng.integers(0, TABLE // width, N_OPS) * width, device,
                     torch.int32)
    vals = on_device(rng.integers(1, 100, N_OPS), device).to(dtype)
    exp = torch.zeros((N_OPS,), dtype=dtype, device=device)

    def run_once():
        r = rmw_serialized(table, idx0, vals, "cas", exp)
        for w in range(1, width):       # adjacent lanes of the wide operand
            r = rmw_serialized(r.table, idx0 + w, vals, "cas", exp)
        return r.table

    return time_s(run_once, device=device) / N_OPS


def run(csv: Csv, device="cuda") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, dtype, width, nbytes in (
            ("int32", torch.int32, 1, 4),
            ("float32", torch.float32, 1, 4),
            ("int64_pair", torch.int32, 2, 8),
            ("int128_quad", torch.int32, 4, 16)):
        t = _measure(dtype, width, device)
        out[name] = t
        model_bw = bandwidth(H100, "cas",
                             PlacementState(tier=Tier.HBM_LOCAL),
                             operand_bytes=nbytes)
        csv.add(f"operand_size.cas.{name}", t * 1e6,
                f"{nbytes}B/op modelH100 bw={model_bw / 1e9:.2f}GB/s")
    return out
