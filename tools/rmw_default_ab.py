#!/usr/bin/env python3
"""`rmw_table` at its default window and depth against a parent tree's
table kernel, in one process on one CUDA card.

    mkdir -p build/parent && git archive HEAD src | tar -x -C build/parent
    python3 tools/rmw_default_ab.py build/parent

Run from the repository root.  It builds the parent's
`kernels/rmw/csrc/rmw.cu` alone (its seconds printed) beside this tree's
library, checks that both give the same table on BFS's batch size
(uniform_bfs_n: n = 2^25 int32 FAA ops over m = 2^20 slots, every op
kept), then times one call of each (`chip_smoke.time_ms`, 20 calls) in
three rounds of parent, this tree, this tree, parent, and prints one
JSON line: every timing in order and each side's sorted.  The parent's
library is called through its own signature (no depth argument), on the
table's copy, as its `rmw_table` did.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rmw import kernel as K  # noqa: E402


def main(parent_tree: str) -> dict:
    C.phase_device()
    K.LIBRARY.load()
    sig = dict(K.LIBRARY.signatures)
    entry = sig["table_combine_launch"]
    sig["table_combine_launch"] = entry[:10] + entry[11:]  # no depth
    parent = build.NvccLibrary(
        "rmw_parent", Path(parent_tree, "src", "repro_torch", "kernels",
                           "rmw", "csrc", "rmw.cu").resolve(), sig)
    t0 = time.perf_counter()
    parent.load()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, m = 1 << 25, 1 << 20
    tab, idx, val = C._inputs(gen, n, m, torch.int32, drops=False)

    def change():
        return K.rmw_table(tab, idx, val, "faa")

    def par():
        out = tab.clone()
        with torch.cuda.device(out.device):
            parent.launch("table_combine_launch", out.data_ptr(),
                          idx.data_ptr(), val.data_ptr(), None, n, m, 0, 0,
                          K.REGIMES["global"], K.WINDOW_SLOTS,
                          K._stream(out))
        return out

    if not torch.equal(change(), par()):
        raise AssertionError("the two libraries' tables differ")
    rows = []
    for _ in range(3):
        for name, fn in (("parent", par), ("change", change),
                         ("change", change), ("parent", par)):
            rows.append((name, C.time_ms(fn, reps=20)))
    return {"parent_build_s": build_s, "regime": K.table_regime(
        "faa", torch.int32, n, m), "rows": rows,
        "parent": sorted(v for k, v in rows if k == "parent"),
        "change": sorted(v for k, v in rows if k == "change")}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: tools/rmw_default_ab.py PARENT_TREE")
    print(json.dumps(main(sys.argv[1])), flush=True)
