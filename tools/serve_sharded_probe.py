#!/usr/bin/env python3
"""`chip_smoke.phase_serve_sharded` on some of its runs, on a machine with
one CUDA card, keeping a failure's whole traceback.

    python3 tools/serve_sharded_probe.py [--tree DIR] [--out DIR] RUN [RUN ...]

Each RUN is the tag of an entry of `chip_smoke.SS_RUNS` (``deepseek_v3``,
``whisper_small``, ...).  ``--tree`` is the root of the tree whose
`chip_smoke.py` and ``src/`` run (default: this checkout), for instance a
parent commit unpacked with `git archive`, to compare the two on one
card.  It runs `phase_device` and `phase_build`, then the phase on those
runs alone, and prints one JSON line: the runs, the prompt length,
whether the phase passed and its seconds.  A rank's error reaches the
phase as the tail of the rank's stderr; the whole exception, traceback
first, goes to ``--out``/serve_sharded.err (default
``build/serve_sharded_probe`` in the tree).
"""

import argparse
import json
import os
import sys
import time
import traceback


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree)
    out_dir = os.path.abspath(args.out or os.path.join(
        root, "build", "serve_sharded_probe"))
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch
    import chip_smoke as C
    runs = tuple(r for r in C.SS_RUNS if r[0] in args.runs)
    unknown = set(args.runs) - {r[0] for r in runs}
    if unknown:
        raise SystemExit(f"unknown runs: {sorted(unknown)}")
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    C.phase_device()
    C.phase_build()
    C.SS_RUNS = runs
    res = {"tree": root, "runs": list(args.runs), "prompt": C.SS_PROMPT}
    t0 = time.perf_counter()
    try:
        C.phase_serve_sharded()
        res["ok"] = True
    except Exception as e:   # the probe's result is the failure's text
        res["ok"] = False
        res["error"] = type(e).__name__
        with open(os.path.join(out_dir, "serve_sharded.err"), "w") as f:
            f.write(traceback.format_exc())
            f.write("\n---- the exception's text ----\n" + str(e))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
