"""Load depth — paper Fig. 9 (prefetchers and friends).

Port of `benchmarks/prefetcher.py`.  The paper toggles the hardware
prefetcher and the adjacent-line prefetcher and measures FAA bandwidth.
The reference's TPU analogue sweeps the Pallas kernel's block, the depth of
its DMA pipeline.  On the card the counterpart is how many ops a thread of
the table kernel loads before it combines any (`kernels.rmw.kernel.
table_combine`'s ``depth``, ``UNROLL`` = 8 in ``csrc/rmw.cu``): depth 1
keeps one load in flight, like a prefetcher that is off; deeper depths keep
more in flight.  The stream-detector prefetcher's split is the access
pattern: random slots against sequential ones (``i mod m``).

Rows ``prefetch.faa.<pattern>.depth<d>`` in µs per op: fp32 FAA with normal
values from the seed, n = 2^24 ops over m = 2^20 slots (4 MB, the
``global`` regime), at depths 1, 8 and 32; the derived column gives the
operands' bytes per second (4 bytes an op, the reference's measure).

On the CPU (``device="cpu"``, the tests) the plain version has no depth:
the reference's sizes (32,768 ops over 8,192 slots), the same rows, each
marked ``plain``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import Csv, on_device, time_s
from repro_torch.kernels.rmw import kernel as K

#: ops and slots on the card, and on the CPU (the reference's)
N_OPS, TABLE = 1 << 24, 1 << 20
CPU_N_OPS, CPU_TABLE = 32_768, 8_192


def run(csv: Csv, device="cuda", seed: int = 9) -> Dict[str, float]:
    cuda = torch.device(device).type == "cuda"
    n, m = (N_OPS, TABLE) if cuda else (CPU_N_OPS, CPU_TABLE)
    rng = np.random.default_rng(seed)
    table = torch.zeros((m,), dtype=torch.float32, device=device)
    vals = on_device(rng.normal(size=n), device, torch.float32)
    patterns = {
        "random": on_device(rng.integers(0, m, n), device, torch.int32),
        "sequential": on_device(np.arange(n) % m, device, torch.int32)}
    out: Dict[str, float] = {}
    for pattern, idx in patterns.items():
        for depth in K.DEPTHS:
            if cuda:
                acc = table.clone()  # the kernel adds into it, call by call
                t = time_s(lambda i=idx, d=depth: K.table_combine(
                    acc, i, vals, "faa", "global", depth=d), device=device)
                derived = f"{4 / t * n / 1e9:.2f} GB/s of operands"
            else:
                t = time_s(lambda i=idx: K.rmw_table(table, i, vals, "faa"),
                           reps=3, warmup=1, device=device)
                derived = (f"plain (the CPU has no depth) "
                           f"{4 / t * n / 1e6:.1f} MB/s of operands")
            out[f"{pattern}.depth{depth}"] = t / n
            csv.add(f"prefetch.faa.{pattern}.depth{depth}", t / n * 1e6,
                    derived)
    return out
