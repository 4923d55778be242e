"""Unaligned / line-spanning RMW — paper §5.7 / Fig. 10a / Fig. 14.

Port of `benchmarks/unaligned.py`.  The paper: an atomic that spans two
cache lines locks the bus (CAS up to about 750 ns, against at most 20% for
plain reads).  The reference's TPU analogue is a Pallas combine whose table
tile is off the 128-lane grid, so an op's tile touches two.

On the card:

* **A single atomic that spans two lines has no meaning.**  Hopper
  requires every atomic to be naturally aligned, and a misaligned address
  ends the CUDA context (``cudaErrorMisalignedAddress``).  This suite never
  launches such an access: every op is one aligned 4-byte word.
* **The tile's counterpart is the L2 window** of the table kernel's
  ``windows`` regime (`kernels.rmw.kernel.table_combine`'s ``window``):
  a table past the L2 is combined one window at a time, one pass over the
  batch a window.  A window whose width is not a multiple of the 128-byte
  L2 line (32 slots) makes each window boundary split a line between two
  passes.

Rows ``unaligned.faa.window_<slots>`` in µs per op: fp32 FAA with normal
values from the seed, n = 2^24 ops over m = 2^24 slots (64 MB, past one
window, so the ``windows`` regime), at three windows: 2^22 slots (on the
line grid, 4 passes), 2^22 + 8 (32 bytes off the grid, still 4 passes) and
3 * 2^20 + 8 (a three-quarter window off the grid, 6 passes: the
reference's 384 against 512).  The derived column gives ``line_aligned=``
and ``passes=``, so what alignment costs reads apart from what the passes
cost.  ``unaligned.model.cas``: `perf_model.unaligned_latency` over the
`H100` priors at local HBM, beside the aligned `latency`, as the reference
prints it.

On the CPU (``device="cpu"``, the tests) the plain version has no windows:
the reference's sizes (65,536 ops over 16,384 slots), the same rows, each
marked ``plain``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.core.perf_model import H100, latency, unaligned_latency
from repro_torch.core.placement import PlacementState, Tier
from repro_torch.kernels.rmw import kernel as K

#: ops and slots on the card, and on the CPU (the reference's)
N_OPS, TABLE = 1 << 24, 1 << 24
CPU_N_OPS, CPU_TABLE = 65_536, 16_384
#: slots of an L2 line (128 bytes of 4-byte words)
LINE_SLOTS = 32
WINDOWS = (1 << 22, (1 << 22) + 8, 3 * (1 << 20) + 8)


def passes(m: int, window: int) -> int:
    """Passes over the batch the windows regime makes at ``window``."""
    return -(-m // window)


def run(csv: Csv, device="cuda", seed: int = 5) -> Dict[str, float]:
    cuda = torch.device(device).type == "cuda"
    n, m = (N_OPS, TABLE) if cuda else (CPU_N_OPS, CPU_TABLE)
    rng = np.random.default_rng(seed)
    table = torch.zeros((m,), dtype=torch.float32, device=device)
    idx = on_device(rng.integers(0, m, n), device, torch.int32)
    vals = on_device(rng.normal(size=n), device, torch.float32)
    out: Dict[str, float] = {}
    for w in WINDOWS:
        aligned = w % LINE_SLOTS == 0
        if cuda:
            acc = table.clone()      # the kernel adds into it, call by call
            t = time_s(lambda w=w: K.table_combine(
                acc, idx, vals, "faa", "windows", window=w), device=device)
            derived = (f"line_aligned={aligned} passes={passes(m, w)} "
                       f"n={n} m={m}")
        else:
            t = time_s(lambda: K.rmw_table(table, idx, vals, "faa"),
                       device=device)
            derived = (f"plain (the CPU has no windows) "
                       f"line_aligned={aligned} n={n} m={m}")
        out[f"window_{w}"] = t / n
        csv.add(f"unaligned.faa.window_{w}", t / n * 1e6, derived)
    st = PlacementState(tier=Tier.HBM_LOCAL)
    m_al = latency(H100, "cas", st)
    m_un = unaligned_latency(H100, "cas", st)
    out["model_cas_s"] = m_un
    csv.add("unaligned.model.cas", m_un * 1e6,
            f"aligned={m_al * 1e9:.0f}ns spanning={m_un * 1e9:.0f}ns "
            f"({m_un / m_al:.1f}x; paper saw up to ~750ns; no launch: "
            f"the card refuses a spanning atomic)")
    return out
