"""Two-operands-fetched CAS — paper §5.5 / Fig. 8d.

Port of `benchmarks/operands_fetched.py`, at its sizes.  The paper's CAS
variant fetches the expected value from memory too.  Here, as in the
reference, ``cas2``'s expected values are a gather from a second table,
made per call before the serialized CAS batch (`core.rmw.rmw_serialized`:
on the card one thread issuing ``atom.cas``, which reads each op's expected
value from memory in both rows).  The model column is `perf_model.latency`
over the `H100` priors at HBM (``modelH100``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core.perf_model import H100, latency
from repro_torch.core.placement import PlacementState, Tier
from repro_torch.core.rmw import rmw_serialized

N_OPS = 2_048
TABLE = 65_536


def run(csv: Csv, device="cuda") -> Dict[str, float]:
    rng = np.random.default_rng(4)
    table = torch.zeros((TABLE,), dtype=torch.int32, device=device)
    aux = on_device(rng.integers(0, 3, TABLE), device, torch.int32)
    idx = on_device(rng.integers(0, TABLE, N_OPS), device, torch.int32)
    vals = on_device(rng.integers(1, 100, N_OPS), device, torch.int32)
    exp_reg = torch.zeros((N_OPS,), dtype=torch.int32, device=device)
    idx_l = idx.long()

    t1 = time_s(lambda: rmw_serialized(table, idx, vals, "cas",
                                       exp_reg).table, device=device) / N_OPS
    # cas2: expected fetched from memory per op (second memory operand)
    t2 = time_s(lambda: rmw_serialized(table, idx, vals, "cas",
                                       aux[idx_l]).table,
                device=device) / N_OPS

    st = PlacementState(tier=Tier.HBM_LOCAL)
    m1 = latency(H100, "cas", st)
    m2 = latency(H100, "cas2", st)
    csv.add("operands_fetched.cas1", t1 * 1e6, f"modelH100={m1 * 1e9:.0f}ns")
    csv.add("operands_fetched.cas2", t2 * 1e6,
            f"delta={(t2 - t1) * 1e9:.1f}ns modelH100={m2 * 1e9:.0f}ns "
            f"(paper: +2-4ns local)")
    return {"cas1_s": t1, "cas2_s": t2}
