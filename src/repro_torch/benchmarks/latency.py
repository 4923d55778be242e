"""Latency benchmark — paper Fig. 2/3/4/6 (and appendix Figs. 11-13).

Port of `benchmarks/latency.py`: the serialized per-op latency of
read/FAA/SWP/CAS against tables that sit in each tier of the card's own
hierarchy, measured by a dependent pointer chase run by one thread on the
card (`kernels.serial.kernel.chase`): every step's address is the previous
step's load, or in the RMW modes the previous atomic's return (paper
§3.2), so no two steps overlap.  Per-op latency = one call's time / steps.

Tiers (32-bit words, a single-cycle permutation in each table):

- ``L1``:  8,192 slots, 32 KB, fits the SM's L1;
- ``L2``:  2^22 slots, 16 MB, inside the 50 MB L2;
- ``HBM``: 2^28 slots, 1 GB, past the L2 and the TLB's reach.

They map to the model's tiers in the reference's roles
(`model_validation.TIER_MAP`).  The cycle (`kernel.single_cycle`: slot p's
successor is (a p + c) mod m, a and c drawn from a seeded
`torch.Generator`) is built on the card; the reference's host permutation
would be 2 GB of int64 at 2^28 slots, and a random permutation would not
let the SWP chase write back the link it replaces (csrc/serial.cu).  Each
call of the L1 and L2 tables walks the same slots from slot 0, so the
warm-up call brings them into the cache; each HBM call starts at a fresh
slot, so the walk misses the L2 as the tier's name says.

Cut (the reference chases min(table, 4M) steps): 2^20 steps a call on the
card, so an HBM call costs about a third of a second.  On the CPU (the
tests; the plain host-loop chase) the tables are the host's test sizes
and the walks 2^12 steps (2^10 with ``fast``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.benchmarks.common import Csv, time_s
from repro_torch.kernels.serial import kernel as SK

#: table slots per tier on the card (bytes = slots * 4)
TABLE_SIZES = {"L1": 8_192, "L2": 1 << 22, "HBM": 1 << 28}
#: ... and on the CPU, where the chase is a host loop
CPU_TABLE_SIZES = {"L1": 2_048, "L2": 65_536, "HBM": 1 << 20}
MAX_STEPS = 1 << 20
CPU_STEPS, CPU_STEPS_FAST = 1 << 12, 1 << 10
#: tiers whose every call starts at a fresh slot (the table is past the L2)
COLD = ("HBM",)
MODES = ("faa", "swp", "cas")


def steps_for(device, fast: bool = False) -> int:
    if torch.device(device).type == "cuda":
        return MAX_STEPS
    return CPU_STEPS_FAST if fast else CPU_STEPS


def run(csv: Csv, device="cuda", fast: bool = False, seed: int = 0
        ) -> Dict[str, Dict[str, float]]:
    """Rows ``latency.{read,faa,swp,cas}.{tier}``; returns ns per op by
    tier and mode."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    host_gen = torch.Generator().manual_seed(seed)
    sizes = TABLE_SIZES if dev.type == "cuda" else CPU_TABLE_SIZES
    results: Dict[str, Dict[str, float]] = {}
    for tier, size in sizes.items():
        table = SK.single_cycle(size, gen, dev)
        steps = steps_for(dev, fast)
        per_tier = {}
        for mode in ("read",) + MODES:
            def fn(mode=mode, tier=tier, size=size):
                # a fresh random start past the L2, slot 0 in a cache
                start = (int(torch.randint(0, size, (1,),
                                           generator=host_gen))
                         if tier in COLD else 0)
                return SK.chase(table, steps, mode, start)
            t = time_s(fn, reps=3, warmup=1, device=dev) / steps
            per_tier[mode] = t * 1e9
            if mode != "read":
                csv.add(f"latency.{mode}.{tier}", t * 1e6,
                        f"table={size * 4}B rmw-chase ns/op={t * 1e9:.1f} "
                        f"steps={steps}")
        csv.add(f"latency.read.{tier}", per_tier["read"] * 1e-3,
                f"chase ns/op={per_tier['read']:.1f} steps={steps}")
        results[tier] = per_tier
        del table
    return results
