#!/usr/bin/env python3
"""Phases of `chip_smoke.py` alone, on a machine with one CUDA card.

    python3 tools/smoke_phase.py train_sharded_moe [PHASE ...]

Run from the repository root.  It runs `phase_device` and `phase_build`
(the kernels built in parallel, as the smoke run builds them), then each
named phase (`chip_smoke.phase_<name>`, which takes no argument) in the
order given, with TF32 off as the smoke run sets it, and prints one JSON
line with the build's and each phase's seconds and what each returned.
A phase that fails raises, and the script exits non-zero.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(names):
    if not names:
        raise SystemExit("usage: tools/smoke_phase.py PHASE [PHASE ...]")
    fns = [getattr(C, f"phase_{n}") for n in names]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.phase_device()
    t0 = time.perf_counter()
    C.phase_build()
    out = {"build_s": time.perf_counter() - t0}
    for name, fn in zip(names, fns):
        t0 = time.perf_counter()
        got = fn()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "returned": got if isinstance(got, dict) else None}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
