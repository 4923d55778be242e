#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit.  It builds the three RMW kernels from `src/repro_torch/kernels/rmw/
csrc/rmw.cu`, holds each against its plain PyTorch version, drives the
port's main path — `atomics.execute` on CUDA tables and Graph500 BFS at
scale 20, edgefactor 16 — with the launch counters reset just before and
read just after, and times each kernel beside its byte bound, its plain
version and the PyTorch library call that computes the same function.

Phases print one JSON line each (`{"phase": ...}`); every phase raises on a
failure.  The line before the last is the per-kernel record, and the last
line is ``{"ok": true, "device": {...}}``.  Without a card the script exits
non-zero before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import atomics  # noqa: E402
from repro_torch.atomics.stats import stats_from_occupancy  # noqa: E402
from repro_torch.core import bfs as bfs_mod  # noqa: E402
from repro_torch.kernels.rmw import build  # noqa: E402
from repro_torch.kernels.rmw import kernel as K  # noqa: E402
from repro_torch.kernels.rmw import ref  # noqa: E402

OPS = ("faa", "swp", "min", "max", "cas")
HBM_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_OPS = 67e12         # H100 SXM fp32 outside the tensor cores
SCALE, EDGEFACTOR = 20, 16
SOURCE = "src/repro_torch/kernels/rmw/csrc/rmw.cu"
REPLACES = {"rmw_table": "src/repro/kernels/rmw/kernel.py:107",
            "rmw_table_fetched": "src/repro/kernels/rmw/kernel.py:306",
            "slot_counts": "src/repro/kernels/rmw/kernel.py:169"}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync():
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    built = build.load()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, library=built.path.name,
         ptxas=ptxas)


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(gen, n, m, dtype, normal=False, drops=True):
    dev = "cuda"
    idx = torch.randint(0, m, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    if drops:
        idx[::97] = m                    # every 97th op out of range: dropped
    if normal:
        tab = torch.randn((m,), generator=gen, device=dev)
        val = torch.randn((n,), generator=gen, device=dev)
    else:                                # integer-valued: every sum exact
        tab = torch.randint(-8, 9, (m,), generator=gen, device=dev).to(dtype)
        val = torch.randint(-8, 9, (n,), generator=gen, device=dev).to(dtype)
    return tab, idx, val


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels(gen, errs):
    shapes = {"uniform": (1 << 24, 1 << 24), "contended": (1 << 22, 1024)}
    checked = 0
    for shape, (n, m) in shapes.items():
        for dtype in (torch.int32, torch.float32):
            tab, idx, val = _inputs(gen, n, m, dtype)
            for op in OPS:
                exp = 0 if op == "cas" else None
                got = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
                want = K.rmw_table_fetched_plain(tab, idx, val, op, exp)
                sync()
                for g, w, what in zip(got, want,
                                      ("table", "fetched", "success")):
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"rmw_table_fetched {op} {dtype} {shape}: {what} "
                            f"differs in {int((g != w).sum())} places")
                checked += 1
                if op == "cas":
                    continue
                got_t = K.rmw_table(tab, idx, val, op)
                want_t = ref.rmw_table_ref(tab, idx, val, op)
                sync()
                if not torch.equal(got_t, want_t):
                    raise AssertionError(f"rmw_table {op} {dtype} {shape}: "
                                         f"table differs")
                checked += 1
        counts = K.slot_counts(idx, m)
        if not torch.equal(counts, K.slot_counts_plain(idx, m)):
            raise AssertionError(f"slot_counts {shape}: counts differ")
        checked += 1
        # fp32 normal() FAA: the order of the sums differs, so a tolerance
        tab, idx, val = _inputs(gen, n, m, torch.float32, normal=True)
        occ = int(K.slot_counts_plain(idx, m).max())
        atol = 1e-5 * math.sqrt(occ)
        fk = K.rmw_table_fetched(tab, idx, val, "faa")
        fp = K.rmw_table_fetched_plain(tab, idx, val, "faa")
        tables = {"rmw_table": (K.rmw_table(tab, idx, val, "faa"),
                                ref.rmw_table_ref(tab, idx, val, "faa")),
                  "rmw_table_fetched": (fk[0], fp[0])}
        for name, (got, want) in tables.items():
            if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"{name} fp32 normal FAA {shape}: table "
                                     f"off by {_max_err(got, want)}")
            errs[name] = max(errs[name], _max_err(got, want))
        # reported, not gated: per-op prefix sums in another order
        errs["fetched_normal_faa"] = max(errs["fetched_normal_faa"],
                                         _max_err(fk[1], fp[1]))
        emit("kernels", shape=shape, n=n, m=m, exact_checks=checked,
             normal_faa_rtol=1e-5, normal_faa_atol=atol, max_occupancy=occ,
             max_abs_err={k: v for k, v in errs.items()},
             launches=dict(K.LAUNCHES))


# ---------------------------------------------------------------------------
# 4. atomics.execute on CUDA tables (main path)
# ---------------------------------------------------------------------------

def _same_result(got, want, m, idx, what, fetched=True):
    if not torch.equal(got.table.data, want.table.data):
        raise AssertionError(f"{what}: table differs from the plain path")
    if fetched:
        live = (idx >= 0) & (idx < m)
        if not (torch.equal(got.fetched[live], want.fetched[live])
                and torch.equal(got.success[live], want.success[live])):
            raise AssertionError(f"{what}: fetched/success differ")


def phase_atomics(gen):
    m, n = 1 << 20, 1 << 22
    idx = torch.randint(0, m + 64, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    val = torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tab = atomics.make_table(m, torch.int32)
    steps = [("faa", atomics.Faa(idx, val), {}),
             ("swp", atomics.Swp(idx, val), {"need_fetched": False}),
             ("cas", atomics.Cas(idx, val, expected=0),
              {"collect_stats": True})]
    out = {}
    for name, op, kw in steps:
        got = atomics.execute(tab, op, **kw)
        want = atomics.execute(tab, op, backend="sort",
                               need_fetched=kw.get("need_fetched", True))
        sync()
        _same_result(got, want, m, idx, f"execute {name}",
                     fetched=kw.get("need_fetched", True))
        tab = got.table
        out[name] = dict(K.LAUNCHES)
    stats = got.stats
    plain = stats_from_occupancy(K.slot_counts_plain(idx, m),
                                 int(((idx >= 0) & (idx < m)).sum()))
    for field in stats._fields:
        if not torch.equal(getattr(stats, field), getattr(plain, field)):
            raise AssertionError(f"stats.{field} differs from the plain "
                                 f"occupancy")
    ftab = atomics.make_table(m, torch.float32, fill=1.0)
    fgot = atomics.execute(ftab, atomics.Max(idx, val.float()),
                           need_fetched=False)
    fwant = atomics.execute(ftab, atomics.Max(idx, val.float()),
                            backend="sort", need_fetched=False)
    sync()
    _same_result(fgot, fwant, m, idx, "execute fp32 max", fetched=False)
    if not all(v > 0 for v in K.LAUNCHES.values()):
        raise AssertionError(f"a kernel did not launch: {K.LAUNCHES}")
    emit("atomics", n=n, m=m, launches_after=out,
         stats=dict(distinct=int(stats.distinct_slots),
                    max_occupancy=int(stats.max_occupancy),
                    n_ops=int(stats.n_ops)))


# ---------------------------------------------------------------------------
# 5. Graph500 BFS at scale 20 (main path)
# ---------------------------------------------------------------------------

def phase_bfs():
    t0 = time.perf_counter()
    src, dst = bfs_mod.kronecker_graph(SCALE, EDGEFACTOR, seed=0)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    n = 1 << SCALE
    root = int(s[0])
    gen_s = time.perf_counter() - t0
    reached, runs = None, {}
    for op in ("cas", "swp", "faa"):
        before = dict(K.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        res = bfs_mod.bfs(s, d, n, root=root, op=op)
        sync()
        secs = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        plain = bfs_mod.bfs(s, d, n, root=root, op=op, backend="sort")
        sync()
        if not torch.equal(res.parent, plain.parent):
            raise AssertionError(f"bfs {op}: parents differ from the plain "
                                 f"path")
        if not bfs_mod.validate_parents(s, d, res.parent, root):
            raise AssertionError(f"bfs {op}: invalid parent array")
        r = int((res.parent >= 0).sum())
        if reached is not None and r != reached:
            raise AssertionError(f"bfs {op}: reached {r} != {reached}")
        reached = r
        runs[op] = dict(levels=res.levels, reached=r,
                        edges=res.edges_traversed, seconds=secs,
                        teps=res.edges_traversed / secs, launches=launches)
    emit("bfs", scale=SCALE, edgefactor=EDGEFACTOR, vertices=n,
         directed_edges=int(s.shape[0]), root=root, generator_s=gen_s,
         runs=runs)
    return int(s.shape[0]), n


# ---------------------------------------------------------------------------
# 6. timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps=5):
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(gen, bfs_n, bfs_m):
    rows = []
    for shape, (n, m) in {"bfs": (bfs_n, bfs_m),
                          "uniform": (1 << 24, 1 << 24)}.items():
        tab, idx, val = _inputs(gen, n, m, torch.int32, drops=False)
        idx_long = idx.long()
        for op in ("faa", "min", "max", "swp"):
            lib = {"faa": lambda: torch.index_add(tab, 0, idx, val),
                   "min": lambda: torch.scatter_reduce(tab, 0, idx_long, val,
                                                       "amin"),
                   "max": lambda: torch.scatter_reduce(tab, 0, idx_long, val,
                                                       "amax")}.get(op)
            b, by = bound(8 * n + 8 * m, n)
            rows.append(dict(
                kernel="rmw_table", op=op, shape=shape, n=n, m=m,
                ms=time_ms(lambda: K.rmw_table(tab, idx, val, op)),
                plain_ms=time_ms(lambda: ref.rmw_table_ref(tab, idx, val,
                                                           op)),
                library_ms=None if lib is None else time_ms(lib),
                bound_ms=b, bound_by=by))
        for op in OPS:
            exp = 0 if op == "cas" else None
            b, by = bound(13 * n + 8 * m, n)
            rows.append(dict(
                kernel="rmw_table_fetched", op=op, shape=shape, n=n, m=m,
                ms=time_ms(lambda: K.rmw_table_fetched(tab, idx, val, op,
                                                       expected=exp), 3),
                plain_ms=time_ms(lambda: K.rmw_table_fetched_plain(
                    tab, idx, val, op, exp), 3),
                library_ms=None, bound_ms=b, bound_by=by))
        b, by = bound(4 * n + 4 * m, n)
        rows.append(dict(
            kernel="slot_counts", op="count", shape=shape, n=n, m=m,
            ms=time_ms(lambda: K.slot_counts(idx, m)),
            plain_ms=time_ms(lambda: K.slot_counts_plain(idx, m)),
            library_ms=time_ms(lambda: torch.bincount(idx_long, minlength=m)),
            bound_ms=b, bound_by=by))
    for row in rows:
        emit("timing", **row)
    return rows


# ---------------------------------------------------------------------------

def main():
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"rmw_table": 0.0, "rmw_table_fetched": 0.0, "slot_counts": 0.0,
            "fetched_normal_faa": 0.0}
    phase_kernels(gen, errs)

    K.reset_launches()                   # the main path starts here
    phase_atomics(gen)
    bfs_n, bfs_m = phase_bfs()
    launches = dict(K.LAUNCHES)          # ... and ends here
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    rows = phase_timing(gen, bfs_n, bfs_m)
    headline = {"rmw_table": "faa", "rmw_table_fetched": "cas",
                "slot_counts": "count"}
    kernels = []
    for name, op in headline.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["op"] == op and r["shape"] == "bfs")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=errs[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
