#!/usr/bin/env python3
"""`rmw_table` at its default window and depth, and `rmw_table_fetched`,
against a parent tree's kernels, in one process on one CUDA card.

    mkdir -p build/parent && git archive HEAD src | tar -x -C build/parent
    python3 tools/rmw_default_ab.py build/parent

Run from the repository root.  It builds the parent's
`kernels/rmw/csrc/rmw.cu` alone (its seconds printed) beside this tree's
library, checks that both give the same table on BFS's batch size
(uniform_bfs_n: n = 2^25 int32 FAA ops over m = 2^20 slots, every op
kept), then times one call of each (`chip_smoke.time_ms`, 20 calls) in
three rounds of parent, this tree, this tree, parent, and prints one
JSON line: every timing in order and each side's sorted; then the same
for the fetched kernel on uniform-expected CAS at that shape (tables,
fetched values and successes equal).  The parent's library is called
through its own signatures (no stamp pair), on the table's copy, as its
wrappers did.
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
    sig["table_combine_launch"] = entry[:11] + entry[12:]  # no stamp pair
    entry = sig["rmw_table_fetched_launch"]
    sig["rmw_table_fetched_launch"] = entry[:13] + entry[14:]
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
                          K.REGIMES["global"], K.WINDOW_SLOTS, K.UNROLL,
                          K._stream(out))
        return out

    def change_fetched():
        return K.rmw_table_fetched(tab, idx, val, "cas", expected=0)

    def par_fetched():
        nbytes, _ = K.fetched_layout(n)
        out = tab.clone()
        fetched = torch.empty_like(val)
        success = torch.empty((n,), dtype=torch.bool, device=tab.device)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=tab.device)
        with torch.cuda.device(out.device):
            parent.launch("rmw_table_fetched_launch", tab.data_ptr(),
                          out.data_ptr(), idx.data_ptr(), val.data_ptr(),
                          fetched.data_ptr(), success.data_ptr(),
                          scratch.data_ptr(), nbytes, n, m,
                          K.OP_CODES["cas"], 0, 0.0, K._stream(out))
        return out, fetched, success

    if not torch.equal(change(), par()):
        raise AssertionError("the two libraries' tables differ")
    if not all(torch.equal(a, b) for a, b in zip(change_fetched(),
                                                 par_fetched())):
        raise AssertionError("the two libraries' fetched results differ")
    out = {"parent_build_s": build_s, "regime": K.table_regime(
        "faa", torch.int32, n, m)}
    for kernel, ch, pa in (("rmw_table", change, par),
                           ("rmw_table_fetched", change_fetched,
                            par_fetched)):
        rows = []
        for _ in range(3):
            for name, fn in (("parent", pa), ("change", ch),
                             ("change", ch), ("parent", pa)):
                rows.append((name, C.time_ms(fn, reps=20)))
        out[kernel] = {
            "rows": rows,
            "parent": sorted(v for k, v in rows if k == "parent"),
            "change": sorted(v for k, v in rows if k == "change")}
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: tools/rmw_default_ab.py PARENT_TREE")
    print(json.dumps(main(sys.argv[1])), flush=True)
