"""Bandwidth benchmark — paper Fig. 5 / Fig. 15 (atomics-vs-writes ILP gap).

Port of `benchmarks/bandwidth.py`, at its sizes.  Over the same stream of
independent ops:

  serialized — one RMW at a time: on the card one thread issues the batch
               with the card's atomics (`core.rmw.rmw_serialized` ->
               `kernels.serial.kernel.serial_rmw`), the paper's measured
               mode;
  combining  — the vectorized segmented combine (`core.rmw.rmw_combining`,
               eager PyTorch), the paper's proposed relaxed atomics;
  write      — plain scatter writes, the paper's baseline;
  kernel     — the hand-written combining kernel (`kernels.rmw.ops
               .rmw_apply`: `rmw_table` on the card, its plain version on
               the CPU) at 65,536 ops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core.rmw import rmw_combining, rmw_serialized
from repro_torch.kernels.rmw.ops import rmw_apply

N_OPS_SER = 4_096
N_OPS_COMB = 1_048_576
N_OPS_KERNEL = 65_536
TABLE = 262_144


def run(csv: Csv, device="cuda") -> Dict[str, float]:
    rng = np.random.default_rng(1)
    table = torch.zeros((TABLE,), dtype=torch.float32, device=device)
    out: Dict[str, float] = {}

    idx_s = on_device(rng.integers(0, TABLE, N_OPS_SER), device, torch.int32)
    val_s = on_device(rng.normal(size=N_OPS_SER), device, torch.float32)
    idx_c = on_device(rng.integers(0, TABLE, N_OPS_COMB), device,
                      torch.int32)
    val_c = on_device(rng.normal(size=N_OPS_COMB), device, torch.float32)

    for op in ("faa", "swp"):
        t_ser = time_s(lambda op=op: rmw_serialized(table, idx_s, val_s,
                                                    op).table,
                       device=device) / N_OPS_SER
        t_comb = time_s(lambda op=op: rmw_combining(table, idx_c, val_c,
                                                    op).table,
                        device=device) / N_OPS_COMB
        bw_ser = 4 / t_ser
        bw_comb = 4 / t_comb
        out[f"{op}_serialized_Bps"] = bw_ser
        out[f"{op}_combining_Bps"] = bw_comb
        out[f"{op}_ilp_gap"] = bw_comb / bw_ser
        csv.add(f"bandwidth.{op}.serialized", t_ser * 1e6,
                f"{bw_ser / 1e6:.2f} MB/s")
        csv.add(f"bandwidth.{op}.combining", t_comb * 1e6,
                f"{bw_comb / 1e6:.2f} MB/s gap={bw_comb / bw_ser:.1f}x")

    # plain writes (scatter, no read-modify) — the paper's baseline
    idx_w = idx_c.long()
    t_wr = time_s(lambda: table.index_put((idx_w,), val_c),
                  device=device) / N_OPS_COMB
    out["write_Bps"] = 4 / t_wr
    csv.add("bandwidth.write", t_wr * 1e6, f"{4 / t_wr / 1e6:.2f} MB/s")

    # the combining kernel
    idx_k, val_k = idx_c[:N_OPS_KERNEL], val_c[:N_OPS_KERNEL]
    t_k = time_s(lambda: rmw_apply(table, idx_k, val_k, "faa"), reps=3,
                 warmup=1, device=device) / N_OPS_KERNEL
    out["kernel_faa_Bps"] = 4 / t_k
    what = ("cuda rmw_table" if torch.device(device).type == "cuda"
            else "rmw_table plain version")
    csv.add("bandwidth.faa.kernel", t_k * 1e6,
            f"{4 / t_k / 1e6:.2f} MB/s ({what})")
    return out
