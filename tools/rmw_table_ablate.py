#!/usr/bin/env python3
"""The cost of an int32 atomic on one CUDA card by where its word lives.

    python3 tools/rmw_table_ablate.py [port] [--out FILE]

Run from the repository root on a machine with a card and nvcc.  Builds
`tools/rmw_table_ablate.cu` (development variants the port never calls)
and times each variant with CUDA events, the table reset before each call
and outside the timed span, at n = 2^25 ops for int32 FAA, MIN and a count
(FAA of 1 with no values read):

- the loads alone, no atomic (the floor);
- a global atomic per op over m = 2^20 and 2^24 uniform slots, and on one
  hot slot; the same with 4-byte loads, one op a thread a step;
- a plain load that skips the atomic where the slot already orders at or
  past the operand (MIN), from the L2 and from the SM's L1;
- a shared-memory atomic per op into a CTA-private table of 48K slots;
- a distributed-shared-memory atomic per op into a table of 48K slots a CTA
  partitioned over a cluster of 8, and of 16 where the card can place one;
- warp aggregation (`__match_any_sync`) before a global atomic, on Graph500
  Kronecker slots (scale 20, BFS's skew), beside the plain global atomic;
- m = 2^24 applied in L2-sized windows of 2^22 and 2^23 slots, one pass
  over the batch a window.

Then (alone with ``port``) the port's own `rmw_table` (int32 faa, min, max,
swp; fp32 min) and `slot_counts`, in the regime `kernel.table_regime` picks
and forced into each other regime the shape allows, at uniform and at
BFS's Kronecker slots; int32 FAA and MIN and fp32 MIN forced into the smem
and the global regime over a grid of (n, m); and text variants of the
port's source (`VARIANTS`), each built as its own library and timed in
turns.  Prints the card's name and power limit, then one JSON line per
variant (ms, operations a second), which ``--out`` also writes to FILE.
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import ctypes  # noqa: E402

import torch  # noqa: E402

from repro_torch.kernels.build import NvccLibrary  # noqa: E402

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = NvccLibrary("rmw_table_ablate", ROOT / "tools" /
                      "rmw_table_ablate.cu", {
    # where, op, idx, vals, table, n, lo, hi, slots, cluster, stream, grid
    "ablate_launch": (_I, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _P,
                      ctypes.POINTER(_I)),
})
WHERE = {"stream": 0, "global": 1, "global_skip": 2, "warp_agg": 3,
         "scalar": 4, "smem": 5, "dsmem": 6, "skip_l1": 7}
OPS = {"faa": 0, "min": 1, "count": 2}
N = 1 << 25
SMEM_SLOTS = 48 * 1024


def kronecker_idx(gen, scale, n):
    """Graph500 RMAT destinations (A = 0.57, B = 0.19, C = 0.19), drawn on
    the card and permuted: BFS's slot skew."""
    a, b, c = 0.57, 0.19, 0.19
    idx = torch.zeros((n,), dtype=torch.int64, device="cuda")
    for level in range(scale):
        r = torch.rand((n,), generator=gen, device="cuda")
        bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        idx |= bit.long() << level
    perm = torch.randperm(1 << scale, generator=gen, device="cuda")
    return perm[idx].int()


def time_calls(run, reset=None, reps=5):
    """Mean device time of ``run()`` over ``reps`` calls, each after
    ``reset()`` (not timed), with CUDA events around the call alone; with
    no ``reset``, of ``4 * reps`` calls issued back to back between the
    events, so the host's launch work overlaps the device's."""
    if reset is None:
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4 * reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (4 * reps)
    reset()
    run()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def emit(fh, **row):
    line = json.dumps(row)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")


def ablations(fh, gen):
    lib = LIBRARY
    stream = torch.cuda.current_stream().cuda_stream
    vals = torch.randint(-8, 9, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)

    def uniform(m):
        return torch.randint(0, m, (N,), generator=gen, device="cuda",
                             dtype=torch.int32)

    slots8, slots16 = 8 * SMEM_SLOTS, 16 * SMEM_SLOTS
    idx = {"m2^20": uniform(1 << 20), "m2^24": uniform(1 << 24),
           "hot": torch.zeros((N,), dtype=torch.int32, device="cuda"),
           "smem48K": uniform(SMEM_SLOTS), "cluster8": uniform(slots8),
           "cluster16": uniform(slots16),
           "kronecker": kronecker_idx(gen, 20, N)}
    sizes = {"m2^20": 1 << 20, "m2^24": 1 << 24, "hot": 1,
             "smem48K": SMEM_SLOTS, "cluster8": slots8, "cluster16": slots16,
             "kronecker": 1 << 20}
    # (variant, where, slots, windows, cluster)
    plan = [("stream", "stream", "m2^20", 1, 0),
            ("global", "global", "m2^20", 1, 0),
            ("global", "global", "m2^24", 1, 0),
            ("global", "global", "hot", 1, 0),
            ("scalar_loads", "scalar", "m2^20", 1, 0),
            ("scalar_loads", "scalar", "m2^24", 1, 0),
            ("global_skip", "global_skip", "m2^20", 1, 0),
            ("global_skip", "global_skip", "m2^24", 1, 0),
            ("global_skip", "global_skip", "hot", 1, 0),
            ("smem", "smem", "smem48K", 1, 0),
            ("dsmem_cluster8", "dsmem", "cluster8", 1, 8),
            ("dsmem_cluster16", "dsmem", "cluster16", 1, 16),
            ("global", "global", "cluster8", 1, 0),
            ("global", "global", "kronecker", 1, 0),
            ("global_skip", "global_skip", "kronecker", 1, 0),
            ("skip_l1", "skip_l1", "kronecker", 1, 0),
            ("skip_l1", "skip_l1", "m2^20", 1, 0),
            ("skip_l1", "skip_l1", "hot", 1, 0),
            ("warp_agg", "warp_agg", "kronecker", 1, 0),
            ("warp_agg", "warp_agg", "m2^20", 1, 0),
            ("l2_windows_2^22", "global", "m2^24", 4, 0),
            ("l2_windows_2^23", "global", "m2^24", 2, 0)]
    for op, code in OPS.items():
        for variant, where, slots, windows, cluster in plan:
            m = sizes[slots]
            table = torch.empty((m,), dtype=torch.int32, device="cuda")
            init = torch.randint(-8, 9, (m,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            grid = ctypes.c_int()
            private = SMEM_SLOTS if where in ("smem", "dsmem") else 0
            step = -(-m // windows)

            def run():
                for w in range(windows):
                    lo, hi = w * step, min(m, (w + 1) * step)
                    lib.launch("ablate_launch", WHERE[where], code,
                               idx[slots].data_ptr(), vals.data_ptr(),
                               table.data_ptr(), N, lo, hi, private, cluster,
                               stream, ctypes.byref(grid))
            try:
                ms = time_calls(run, lambda: table.copy_(init))
            except RuntimeError as e:     # e.g. no cluster of 16 fits
                emit(fh, op=op, variant=variant, slots=slots, m=m,
                     error=str(e))
                continue
            emit(fh, op=op, variant=variant, slots=slots, m=m, n=N,
                 cluster=cluster or None, grid=grid.value, ms=ms,
                 gops_per_s=N / ms / 1e6)


def port_regimes(fh, gen):
    """The port's `rmw_table` and `slot_counts` (int32; fp32 MIN too) in the
    regime `kernel.table_regime` picks (``forced: null``) and forced into
    each other regime the shape allows, at uniform slots; BFS's Kronecker
    slots with every op kept and with 90% dropped."""
    from repro_torch.kernels.rmw import kernel as K
    shapes = {"uniform_bfs_n": (N, 1 << 20, "uniform"),
              "kronecker": (N, 1 << 20, "kronecker"),
              "kronecker_90pct_dropped": (N, 1 << 20, "dropped"),
              "uniform_2^24": (1 << 24, 1 << 24, "uniform"),
              "uniform_2^23": (N, 1 << 23, "uniform"),
              "uniform_3x2^21": (N, 3 << 21, "uniform"),
              "uniform_3x2^22": (N, 3 << 22, "uniform"),
              "contended": (1 << 22, 1024, "uniform"),
              "smem_range": (N, 40_000, "uniform")}
    for shape, (n, m, draw) in shapes.items():
        if draw == "uniform":
            idx = torch.randint(0, m, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
        else:
            idx = kronecker_idx(gen, 20, n)
            if draw == "dropped":
                drop = torch.rand((n,), generator=gen, device="cuda") < 0.9
                idx = torch.where(drop, m, idx)
        tab = torch.randint(-8, 9, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        val = torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        cases = [(op, torch.int32) for op in ("faa", "min", "max", "swp",
                                               "count")]
        cases.append(("min", torch.float32))
        for op, dtype in cases:
            t, v = tab.to(dtype), val.to(dtype)
            for forced in (None, *K.table_regimes(m)):
                if op == "count":
                    fn = (lambda: K.slot_counts(idx, m)) if forced is None \
                        else (lambda: K.table_combine(
                            torch.zeros_like(tab), idx, None, op, forced))
                else:
                    fn = (lambda: K.rmw_table(t, idx, v, op)) \
                        if forced is None else (lambda: K.table_combine(
                            t.clone(), idx, v, op, forced))
                ms = time_calls(fn)
                emit(fh, port=op, dtype=str(dtype).split(".")[1],
                     shape=shape, n=n, m=m,
                     picked=K.table_regime(op, dtype, n, m),
                     forced=forced, ms=ms, gops_per_s=n / ms / 1e6)


def smem_crossover(fh, gen):
    """Where the smem regime stops beating the global one: int32 FAA and
    MIN and fp32 MIN forced into each, uniform slots, over a grid of
    (n, m)."""
    from repro_torch.kernels.rmw import kernel as K
    for n in (1 << 20, 1 << 22, 1 << 25):
        for m in (1024, 8192, 16_384, 40_000, K.SMEM_SLOTS):
            idx = torch.randint(0, m, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            tab = torch.randint(-8, 9, (m,), generator=gen, device="cuda",
                                dtype=torch.int32)
            val = torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            for op, dtype in (("faa", torch.int32), ("min", torch.int32),
                              ("min", torch.float32)):
                t, v = tab.to(dtype), val.to(dtype)
                ms = {r: time_calls(lambda: K.table_combine(
                    t.clone(), idx, v, op, r)) for r in ("smem", "global")}
                emit(fh, crossover=op, dtype=str(dtype).split(".")[1], n=n,
                     m=m, picked=K.table_regime(op, dtype, n, m),
                     smem_ms=ms["smem"], global_ms=ms["global"])


# variants of the port's own source: (text in csrc/rmw.cu, replacement)
VARIANTS = {"as_is": [],
            # the skip reads from the L2 instead of the SM's L1
            "l2_reads": [("return __ldca(out_word", "return __ldcg(out_word")],
            # one op a thread a step, or four, instead of eight
            "unroll1": [("static const int UNROLL = 8;",
                         "static const int UNROLL = 1;")],
            "unroll4": [("static const int UNROLL = 8;",
                         "static const int UNROLL = 4;")],
            # fp32 MIN/MAX's compare-and-swap path on the resident CTAs
            # alone, and eight ops a step like the others
            "cas_one_wave": [("(u == 1 ? 4 : 1)", "1")],
            "cas_step8": [("? 1 : UNROLL;", "? UNROLL : UNROLL;")],
            # the smem regime on CTAs of 256 threads instead of 1,024
            "smem_256": [("constexpr int BLOCK = PRIVATE ? 1024 : THREADS;",
                          "constexpr int BLOCK = THREADS;")]}


def source_variants(fh, gen):
    """The port's table kernel built from text variants of its source
    (`VARIANTS`), each as its own library, timed in turns twice at BFS's n
    over 2^20 uniform and Kronecker slots and at the contended shape."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.rmw import kernel as K
    src = K.LIBRARY.source.read_text()
    out_dir = BUILD_DIR.parent / "rmw_table_ablate"
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"rmw_table_ablate: {name}: cut not found")
            text = text.replace(old, new)
        path = out_dir / f"rmw_{name}.cu"
        path.write_text(text)
        libs[name] = NvccLibrary(f"rmw_{name}", path, K.LIBRARY.signatures)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    stream = torch.cuda.current_stream().cuda_stream
    for shape, n, m in (("uniform_bfs_n", N, 1 << 20),
                        ("kronecker", N, 1 << 20),
                        ("contended", 1 << 22, 1024), ("smem_8192", N, 8192),
                        ("smem_40000", N, 40_000)):
        idx = (kronecker_idx(gen, 20, n) if shape == "kronecker" else
               torch.randint(0, m, (n,), generator=gen, device="cuda",
                             dtype=torch.int32))
        tab = torch.randint(-8, 9, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        val = torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        regime = "smem" if m <= K.SMEM_SLOTS else K.table_regime(
            "faa", torch.int32, n, m)
        for op, dtype in (("faa", torch.int32), ("min", torch.int32),
                          ("swp", torch.int32), ("min", torch.float32)):
            t, v = tab.to(dtype), val.to(dtype)
            ms = {}
            for _ in range(2):
                for name, lib in libs.items():
                    def run():
                        out = t.clone()
                        last = (torch.full((m,), -1, dtype=torch.int32,
                                           device="cuda")
                                if op == "swp" else None)
                        lib.launch("table_combine_launch", out.data_ptr(),
                                   idx.data_ptr(), v.data_ptr(),
                                   None if last is None else last.data_ptr(),
                                   n, m, K.OP_CODES[op],
                                   K.DTYPE_CODES[dtype], K.REGIMES[regime],
                                   K.WINDOW_SLOTS, K.UNROLL, None, stream)
                    ms.setdefault(name, []).append(time_calls(run))
            emit(fh, variants=op, dtype=str(dtype).split(".")[1],
                 shape=shape, n=n, m=m, regime=regime, ms=ms)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rmw_table_ablate: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    built = LIBRARY.load()
    print(json.dumps({"ptxas": [ln.strip() for ln in built.log.splitlines()
                                if "Used" in ln]}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    args = sys.argv[1:]
    path = args[args.index("--out") + 1] if "--out" in args else None
    with contextlib.ExitStack() as stack:
        fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            fh = stack.enter_context(open(path, "w"))
        if "port" not in args:
            ablations(fh, gen)
        port_regimes(fh, gen)
        smem_crossover(fh, gen)
        source_variants(fh, gen)


if __name__ == "__main__":
    main()
