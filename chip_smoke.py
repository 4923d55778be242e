#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit.  It builds the port's kernel libraries in parallel (the three RMW
kernels from `src/repro_torch/kernels/rmw/csrc/rmw.cu`, the Mamba-2 SSD
chunk kernel from `src/repro_torch/kernels/ssd/csrc/ssd.cu`, the flash
attention kernel from
`src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`), holds
each kernel against its plain PyTorch version, drives the port's three main
paths with the launch counters reset just before each and read just after
— `atomics.execute` on CUDA tables plus Graph500 BFS at scale 20,
edgefactor 16; `BatchServer` serving mamba2_780m; and `BatchServer`
serving gemma_2b, both at full width and depth in bf16 — and times each
kernel beside its bound, its plain version and the PyTorch library call
that computes the same function, where there is one.

Phases print one JSON line each (`{"phase": ...}`); every phase raises on a
failure.  The line before the last is the per-kernel record, and the last
line is ``{"ok": true, "device": {...}}``.  Without a card the script exits
non-zero before printing any result.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import atomics  # noqa: E402
from repro_torch.atomics.stats import stats_from_occupancy  # noqa: E402
from repro_torch.core import bfs as bfs_mod  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmw import kernel as K  # noqa: E402
from repro_torch.kernels.rmw import ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

OPS = ("faa", "swp", "min", "max", "cas")
HBM_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_OPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BF16 = 989e12       # H100 SXM bf16 tensor cores, dense
SCALE, EDGEFACTOR = 20, 16
SOURCE = "src/repro_torch/kernels/rmw/csrc/rmw.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SOURCES = {"ssd_chunk": SSD_SOURCE, "flash_attention": FA_SOURCE}
REPLACES = {"rmw_table": "src/repro/kernels/rmw/kernel.py:107",
            "rmw_table_fetched": "src/repro/kernels/rmw/kernel.py:306",
            "slot_counts": "src/repro/kernels/rmw/kernel.py:169",
            "ssd_chunk": "src/repro/kernels/ssd/kernel.py:57",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:84"}
# SSD: mamba2_780m's widths (configs/mamba2_780m.py): 48 heads of P = 64,
# N = 128, chunk Q = 256; the reference tests' rtol = atol (f32 sums in
# another order, tests/test_kernels_ssd.py:32)
ARCH, SSD_H, SSD_P, SSD_N, SSD_Q = "mamba2_780m", 48, 64, 128, 256
SSD_TOL = 3e-4
# serve: prefill logits, kernel path against the plain path on the same
# weights.  In bf16 a change of f32 summation order anywhere in the SSD
# flips roundings that then grow through 48 random-weight layers: the plain
# path itself at chunk 128 instead of 256 (the same function, sums in
# another order) moves these logits (std about 0.8) by about 0.2, measured
# as `bf16_floor` below.  The bf16 gate allows 0.5.  The strict check is the
# same comparison in f32 at full width and depth, where rounding stays near
# 1e-4 (the f32 floor is measured the same way): gate 1e-3.
SERVE_LOGIT_ATOL = 0.5
SERVE_F32_LOGIT_ATOL = 1e-3
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_NEW = 8, 4, 16
# flash attention: the reference tests' tolerances
# (tests/test_kernels_attention.py:31,41), f32 sums in another order and one
# bf16 rounding of the output
FA_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# ... and at gemma's shapes, where the outputs are averages over up to 4,096
# keys (typically 0.03-0.05, so 2e-2 would let a dropped tile pass), bf16 is
# held to what one rounding of two f32 results that differ only in the order
# of their sums can give: one bf16 ulp (2^-7 of the value), plus 1e-5 for
# outputs near zero, whose f32 sums cancel
FA_GEMMA_BF16 = dict(rtol=2.0 ** -7, atol=1e-5)
# ... and the bf16 prefill keeps p in f32 (p·v as three bf16 parts of p):
# at most this share of its bf16 outputs may differ from the plain
# version's, where f32 sums in another order flip a rounding now and then.
# The control, the plain version with p rounded to bf16 (SDPA's function),
# must exceed it and fail the one-ulp check, or the check tells nothing.
FA_P_F32_MISMATCH = 0.01
# gemma_2b's attention (configs/gemma_2b.py): 8 query heads over one KV
# head of 256; caches of 4096 + 16 rows; decode at 1,600 valid rows (about
# the served mix's mean context) and at 3,600 (its longest prompt)
GEMMA, G_HQ, G_HKV, G_D = "gemma_2b", 8, 1, 256
G_S_MAX, G_DECODE_VALID, G_DECODE_LONG = 4096 + SERVE_MAX_NEW, 1600, 3600
# the kernel's three bodies (decode, bf16 tensor-core prefill, f32 prefill),
# as the device trace names them
FA_KERNELS = ("flash_decode_kernel", "flash_tc_kernel", "flash_fma_kernel")
# serve gemma: the bf16 gate is a multiple of the floor measured in the same
# run (attention through the kernel's own f32 function, against `_sdpa`,
# which rounds p to bf16); f32 at full depth within 1e-3
GEMMA_FLOOR_FACTOR = 2.0


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

def _build_one(library):
    t0 = time.perf_counter()
    built = library.load()
    return built, time.perf_counter() - t0


def phase_build():
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    libraries = (K.LIBRARY, SK.LIBRARY, FK.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        done = list(pool.map(_build_one, libraries))
    for built, secs in done:
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        emit("build", seconds=secs, library=built.path.name, ptxas=ptxas)
    emit("build", total_seconds=time.perf_counter() - t0)


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
# 6. the SSD chunk kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(gen, b, s, h):
    """The reference tests' distributions (tests/test_kernels_ssd.py:14-20):
    x, B, C standard normal, dt in [0.01, 0.2], A in -[0.5, 2]."""
    dev = "cuda"
    x = torch.randn((b, s, h, SSD_P), generator=gen, device=dev)
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.19 + 0.01
    A = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
    B = torch.randn((b, s, h, SSD_N), generator=gen, device=dev)
    C = torch.randn((b, s, h, SSD_N), generator=gen, device=dev)
    return x, dt, A, B, C


def _chunk_inputs(gen, bh, s):
    """ssd_chunk's operands, made as `ops.ssd` makes them: (BH, S, ·) f32."""
    x, dt, A, B, C = _ssd_inputs(gen, 1, s, bh)

    def flat(t):
        return t.transpose(1, 2).reshape(bh, s, *t.shape[3:]).contiguous()

    return (flat(x * dt[..., None]), flat(dt * A), flat(B), flat(C))


def _check_close(got, want, what):
    err = _max_err(got, want)
    if not torch.allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL):
        raise AssertionError(f"{what}: off by {err} (rtol = atol = "
                             f"{SSD_TOL})")
    return err


def phase_ssd_kernel(gen):
    errs = {}
    for name, bh in (("serving", SSD_H), ("batch4", 4 * SSD_H)):
        args = _chunk_inputs(gen, bh, 4096)
        y, st = SK.ssd_chunk(*args, chunk=SSD_Q)
        y_p, st_p = SK.ssd_chunk_plain(*args, chunk=SSD_Q)
        sync()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_chunk {name}: non-finite output")
        errs[name] = {"y_intra": _check_close(y, y_p, f"ssd_chunk {name} y"),
                      "states": _check_close(st, st_p,
                                             f"ssd_chunk {name} states")}
        emit("ssd_kernel", shape=name, bh=bh, s=4096, p=SSD_P, n=SSD_N,
             chunk=SSD_Q, rtol=SSD_TOL, atol=SSD_TOL,
             max_abs_err=errs[name], launches=dict(SK.LAUNCHES))
    # a short prompt, 1000 = 3 * 256 + 232 steps, through the composition
    # (padding, flattening, cross-chunk recurrence) and the sequential oracle
    s = 1000
    args = _ssd_inputs(gen, 1, s, SSD_H)
    y, hf = ssd_ops.ssd(*args, chunk=SSD_Q, use_kernel=True,
                        return_final_state=True)
    y_p, hf_p = ssd_ops.ssd_chunked(*args, chunk=SSD_Q,
                                    return_final_state=True)
    y_o = ssd_ref.ssd_ref(*args)
    sync()
    errs["ops_ssd"] = {
        "y": _check_close(y, y_p, "ops.ssd y vs ssd_chunked"),
        "h_final": _check_close(hf, hf_p, "ops.ssd h_final vs ssd_chunked"),
        "y_vs_sequential_oracle": _check_close(y, y_o, "ops.ssd vs ssd_ref")}
    emit("ssd_kernel", shape="ops_ssd_short", b=1, s=s, h=SSD_H, p=SSD_P,
         n=SSD_N, chunk=SSD_Q, rtol=SSD_TOL, atol=SSD_TOL,
         max_abs_err=errs["ops_ssd"], launches=dict(SK.LAUNCHES))
    return max(v for e in errs.values() for v in e.values())


# ---------------------------------------------------------------------------
# 7. the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, causal): tests/test_kernels_attention.py:12-21
FA_CASES = [(2, 4, 2, 128, 128, 64, True), (1, 8, 1, 100, 100, 32, True),
            (2, 4, 4, 64, 192, 64, True), (1, 2, 2, 50, 70, 16, True),
            (1, 4, 2, 96, 96, 64, False), (1, 3, 3, 33, 47, 8, False),
            (1, 1, 1, 1, 64, 32, True)]


def _gemma_attention_args(gen, s, cached=0, dtype=torch.bfloat16):
    """One gemma_2b attention call as the model makes it: q (1, s, 8, 256)
    and a (1, 4112, 1, 256) KV cache, handed to the kernel as transposed
    views, ``cached`` rows before the ``s`` new ones; rows past them hold
    NaN, which the kernel must never read."""
    q = torch.randn((1, s, G_HQ, G_D), generator=gen, device="cuda")
    kc, vc = (torch.randn((1, G_S_MAX, G_HKV, G_D), generator=gen,
                          device="cuda") for _ in range(2))
    kc[:, cached + s:] = float("nan")
    vc[:, cached + s:] = float("nan")
    args = tuple(t.to(dtype).transpose(1, 2) for t in (q, kc, vc))
    return args, dict(causal=True, kv_valid=cached + s, kv_offset=cached)


def _check_fa(got, want, what, rtol, atol):
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {what}: non-finite output")
    err = _max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"flash_attention {what}: off by {err} "
                             f"(rtol {rtol}, atol {atol})")
    return err


def _p_in_f32(got, want, control, what):
    """The share of bf16 outputs that differ from the plain version's, for
    the kernel and for the control (p rounded to bf16); raise unless the
    kernel is within `FA_P_F32_MISMATCH` and the control is not, nor within
    one bf16 ulp."""
    share = float((got != want).float().mean())
    control_share = float((control != want).float().mean())
    if share > FA_P_F32_MISMATCH:
        raise AssertionError(f"flash_attention {what}: {share} of the bf16 "
                             f"outputs differ from the plain version's > "
                             f"{FA_P_F32_MISMATCH}: is p rounded to bf16?")
    if control_share <= FA_P_F32_MISMATCH or torch.allclose(
            control.float(), want.float(), **FA_GEMMA_BF16):
        raise AssertionError(f"flash_attention {what}: the check does not "
                             f"fail p rounded to bf16 ({control_share})")
    return dict(kernel=share, p_to_bf16=control_share)


def _split3_check(gen):
    """The prefill's device split of f32 p (``split3``) against
    `bf16_parts`, bit for bit, over p in [0, 1] and e^-x down to e^-60."""
    p = torch.cat([torch.rand(1 << 20, generator=gen, device="cuda"),
                   torch.exp(-60 * torch.rand(1 << 20, generator=gen,
                                              device="cuda"))])
    for a, b in zip(FK.kernel_bf16_parts(p), FK.bf16_parts(p)):
        if not torch.equal(a, b):
            raise AssertionError("flash_attention: the kernel's split of p "
                                 "into bf16 parts is not bf16_parts")
    return p.numel()


def phase_flash_kernel(gen):
    """The reference tests' seven cases through `ops.attention` (the two
    with D = 8 and 16 padded to 32), and gemma_2b's prefill (of 4,096 and
    17 tokens), cached-prefill and decode calls (at 1,600 and 3,600 rows,
    split across CTAs, and at 65, one row past a tile); each in f32 and
    bf16 against the plain version.  The bf16 prefill of 17 tokens and the
    cached prefill are also held to `FA_P_F32_MISMATCH` beside their
    control, and the kernel's split of p to `bf16_parts`."""
    errs, want_max, p_f32 = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        case_err = 0.0
        for b, hq, hkv, sq, skv, d, causal in FA_CASES:
            q = torch.randn((b, hq, sq, d), generator=gen, device="cuda")
            k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                                device="cuda") for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = fa_ops.attention(q, k, v, causal=causal)
            want = FK.flash_attention_plain(q, k, v, causal=causal)
            tol = FA_TOL[dtype]
            case_err = max(case_err, _check_fa(
                got, want, f"case {(b, hq, hkv, sq, skv, d)} {name}",
                rtol=tol, atol=tol))
        errs[f"reference_cases_{name}"] = case_err
        gemma_tol = FA_GEMMA_BF16 if dtype == torch.bfloat16 else \
            dict(rtol=FA_TOL[dtype], atol=FA_TOL[dtype])
        for shape, s, cached in (("prefill", 4096, 0),
                                 ("prefill_17", 17, 0),
                                 ("cached_prefill", 600, 1000),
                                 ("decode", 1, G_DECODE_VALID - 1),
                                 ("decode_3600", 1, G_DECODE_LONG - 1),
                                 ("decode_65", 1, 64)):
            args, kw = _gemma_attention_args(gen, s, cached, dtype)
            got = FK.flash_attention(*args, **kw)
            want = FK.flash_attention_plain(*args, **kw)
            errs[f"{shape}_{name}"] = _check_fa(got, want, f"{shape} {name}",
                                                **gemma_tol)
            want_max[f"{shape}_{name}"] = float(want.abs().max())
            if dtype == torch.bfloat16 and shape in ("prefill_17",
                                                     "cached_prefill"):
                p_f32[shape] = _p_in_f32(
                    got, want, FK.flash_attention_plain(*args, p_to_bf16=True,
                                                        **kw), shape)
    split3_n = _split3_check(gen)
    sync()
    emit("flash_kernel", tol={"f32": FA_TOL[torch.float32],
                              "bf16": FA_TOL[torch.bfloat16],
                              "gemma_bf16": FA_GEMMA_BF16,
                              "p_f32_mismatch": FA_P_F32_MISMATCH},
         cases=len(FA_CASES), max_abs_err=errs, max_abs_want=want_max,
         bf16_mismatch_share=p_f32, split3_equal_to_bf16_parts=split3_n,
         launches=dict(FK.LAUNCHES))
    return max(errs.values())


# ---------------------------------------------------------------------------
# 8. serving mamba2_780m at full width and depth (main path)
# ---------------------------------------------------------------------------

def _requests(prompts):
    return [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
            for i, p in enumerate(prompts)]


def _prefill_logits(model, prompt, s_max=None):
    toks = torch.tensor([prompt], device="cuda")
    return model.prefill({"tokens": toks}, s_max or len(prompt))[1][0]


def _f32_and_floor_checks(cfg, prompts, plain_logits):
    """Full width and depth in f32: prefill logits of the first two prompts
    through the kernel and the plain path, same weights (seed 0).  And the
    floors: the plain path at chunk 128 against chunk 256, in bf16 (against
    the served plain logits) and in f32."""
    q128 = dataclasses.replace(cfg.ssm, chunk=128)
    floor_bf16 = LM(cfg.replace(ssm=q128), seed=0, use_kernel=False)
    bf16_floor = max(_max_err(_prefill_logits(floor_bf16, p), want)
                     for p, want in zip(prompts[:2], plain_logits))
    del floor_bf16
    cfg32 = cfg.replace(dtype="float32")
    m32 = LM(cfg32, seed=0)
    kern = [_prefill_logits(m32, p) for p in prompts[:2]]
    m32.use_kernel = False
    plain = [_prefill_logits(m32, p) for p in prompts[:2]]
    del m32
    floor32 = LM(cfg32.replace(ssm=q128), seed=0, use_kernel=False)
    f32_floor = max(_max_err(_prefill_logits(floor32, p), want)
                    for p, want in zip(prompts[:2], plain))
    del floor32
    torch.cuda.empty_cache()
    f32_err = max(_max_err(a, b) for a, b in zip(kern, plain))
    if f32_err > SERVE_F32_LOGIT_ATOL:
        raise AssertionError(f"f32 prefill logits: kernel path off the "
                             f"plain path by {f32_err} > "
                             f"{SERVE_F32_LOGIT_ATOL}")
    return dict(f32_logit_max_abs_err=f32_err,
                f32_logit_atol=SERVE_F32_LOGIT_ATOL, f32_floor=f32_floor,
                bf16_floor=bf16_floor)


def _device_trace(fn, kernel, steps=1):
    """Kernels the card ran during ``fn()`` (torch.profiler's CUPTI trace):
    count, busy time, the span from the first kernel's start to the last's
    end, the idle share of that span, and the busy time of the kernels
    whose name holds ``kernel`` (a name, or a tuple of names); per step.
    All None where the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev:
        return dict(kernels=None, busy_ms=None, span_ms=None,
                    idle_share=None, kernel_ms=None)
    busy = sum(e.duration_ns() for e in dev) / 1e6
    span = (max(e.end_ns() for e in dev) - min(e.start_ns() for e in dev)) \
        / 1e6
    names = (kernel,) if isinstance(kernel, str) else kernel
    mine = sum(e.duration_ns() for e in dev
               if any(k in e.name() for k in names)) / 1e6
    return dict(kernels=len(dev) / steps, busy_ms=busy / steps,
                span_ms=span / steps, idle_share=1 - busy / span,
                kernel_ms=mine / steps)


def phase_serve():
    t0 = time.perf_counter()
    server = BatchServer(ARCH, reduced=False, slots=SERVE_SLOTS, s_max=4096,
                         seed=0, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in server.model.parameters())
    rng = np.random.default_rng(0)
    lengths = [int(v) for v in rng.integers(256, 4097, SERVE_REQUESTS)]
    if all(v % SSD_Q == 0 for v in lengths):
        raise AssertionError(f"every prompt length is a multiple of the "
                             f"chunk: {lengths}")
    prompts = [rng.integers(0, cfg.vocab_size, v).tolist() for v in lengths]
    # warm-up (cuBLAS handles, allocator): one short prefill, not counted
    server.model.prefill({"tokens": torch.tensor([prompts[0][:300]],
                                                 device="cuda")}, 4096)
    sync()

    reqs = _requests(prompts)
    SK.reset_launches()                  # the serving path starts here
    stats = server.run(reqs)
    launches = dict(SK.LAUNCHES)         # ... and ends here
    timing = dict(server.timing)
    want = cfg.n_layers * SERVE_REQUESTS
    if launches["ssd_chunk"] != want:
        raise AssertionError(f"ssd_chunk launched {launches['ssd_chunk']} "
                             f"times, want {cfg.n_layers} x "
                             f"{SERVE_REQUESTS} = {want}")
    if stats["completed"] != SERVE_REQUESTS or \
            stats["tokens"] != SERVE_REQUESTS * (SERVE_MAX_NEW - 1):
        raise AssertionError(f"serve stats {stats}")
    for r in reqs:
        lg = r.prefill_logits
        if lg.shape != (cfg.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"request {r.rid}: bad prefill logits")
        if len(r.out) != SERVE_MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid}: bad tokens {r.out}")

    # the same requests on the same weights through the plain SSD path
    server.model.use_kernel = False
    server.timing = {k: type(v)() for k, v in server.timing.items()}
    plain = _requests(prompts)
    plain_stats = server.run(plain)
    if SK.LAUNCHES["ssd_chunk"] != want:
        raise AssertionError("the plain path launched the kernel")
    server.model.use_kernel = None
    logit_err = max(_max_err(a.prefill_logits, b.prefill_logits)
                    for a, b in zip(reqs, plain))
    if logit_err > SERVE_LOGIT_ATOL:
        raise AssertionError(f"prefill logits: kernel path off the plain "
                             f"path by {logit_err} > {SERVE_LOGIT_ATOL}")
    logit_rms = max(float((a.prefill_logits - b.prefill_logits).pow(2)
                          .mean().sqrt()) for a, b in zip(reqs, plain))
    logit_std = float(plain[0].prefill_logits.std())
    checks = _f32_and_floor_checks(cfg, prompts,
                                   [r.prefill_logits for r in plain[:2]])
    same_tok = sum(x == y for a, b in zip(reqs, plain)
                   for x, y in zip(a.out, b.out))
    first_same = sum(a.out[0] == b.out[0] for a, b in zip(reqs, plain))

    # where the time goes: one prefill of the longest prompt, then eight
    # decode steps from its cache, on the kernel path, traced on the card
    longest = torch.tensor([prompts[0]], device="cuda")
    box = {}

    def prefill():
        box["cache"] = server.model.prefill({"tokens": longest}, 4096)[0]

    def decode(steps=8):
        tok = longest[:, -1:]
        for _ in range(steps):
            server.model.decode_step(box["cache"], {"tokens": tok})

    prefill_trace = _device_trace(prefill, "ssd_chunk_kernel")
    decode_trace = _device_trace(decode, "ssd_chunk_kernel", steps=8)

    # the SSD kernel's share of prefill: its time at each request's padded
    # length (CUDA events) x 48 layers, over the prefills' host time
    ssd_ms = 0.0
    for v in lengths:
        sp = -(-v // SSD_Q) * SSD_Q
        args = _chunk_inputs(torch.Generator(device="cuda").manual_seed(v),
                             SSD_H, sp)
        ssd_ms += cfg.n_layers * time_ms(
            lambda: SK.ssd_chunk(*args, chunk=SSD_Q))
    prefill_ms = 1e3 * timing["prefill_s"]
    emit("serve", arch=ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, weight_bytes=weight_bytes,
         init_s=init_s, prompt_lengths=lengths, slots=SERVE_SLOTS,
         max_new=SERVE_MAX_NEW, stats=stats, plain_stats=plain_stats,
         launches=launches,
         prefill_ms_per_request=prefill_ms / timing["prefills"],
         decode_ms_per_token=1e3 * timing["decode_s"]
         / timing["decode_steps"],
         plain_prefill_ms_per_request=1e3 * server.timing["prefill_s"]
         / server.timing["prefills"],
         plain_decode_ms_per_token=1e3 * server.timing["decode_s"]
         / server.timing["decode_steps"],
         prefill_s=timing["prefill_s"], decode_s=timing["decode_s"],
         ssd_kernel_ms_in_prefill=ssd_ms,
         ssd_share_of_prefill=ssd_ms / prefill_ms,
         prefill_trace=dict(prompt=lengths[0], **prefill_trace),
         decode_trace_per_token=decode_trace,
         prefill_logit_max_abs_err=logit_err,
         logit_atol=SERVE_LOGIT_ATOL, prefill_logit_max_rms_err=logit_rms,
         plain_logit_std=logit_std, **checks,
         greedy_tokens_equal=f"{same_tok}/{SERVE_REQUESTS * SERVE_MAX_NEW}",
         first_token_equal=f"{first_same}/{SERVE_REQUESTS}")
    return launches


# ---------------------------------------------------------------------------
# 9. serving gemma_2b at full width and depth (main path)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _attention_through_plain_version():
    """The model's attention runs `flash_attention_plain`, the kernel's own
    f32 function, where it would launch the kernel."""
    launch = FK.flash_attention
    FK.flash_attention = FK.flash_attention_plain
    try:
        yield
    finally:
        FK.flash_attention = launch


def _gemma_f32_checks(cfg, prompts):
    """Full width and depth in f32 (about 10 GB): prefill logits of the
    first two prompts through the kernel and the plain path (`_sdpa`), same
    weights (seed 0), within 1e-3; and the f32 floor, the kernel's f32
    function in the model against `_sdpa`."""
    m32 = LM(cfg.replace(dtype="float32"), seed=0, attn_impl="ref")
    kern = [_prefill_logits(m32, p, G_S_MAX) for p in prompts[:2]]
    with _attention_through_plain_version():
        fplain = [_prefill_logits(m32, p, G_S_MAX) for p in prompts[:2]]
    m32.use_kernel = False
    plain = [_prefill_logits(m32, p, G_S_MAX) for p in prompts[:2]]
    del m32
    torch.cuda.empty_cache()
    f32_err = max(_max_err(a, b) for a, b in zip(kern, plain))
    if f32_err > SERVE_F32_LOGIT_ATOL:
        raise AssertionError(f"gemma f32 prefill logits: kernel path off the "
                             f"plain path by {f32_err} > "
                             f"{SERVE_F32_LOGIT_ATOL}")
    return dict(f32_logit_max_abs_err=f32_err,
                f32_logit_atol=SERVE_F32_LOGIT_ATOL,
                f32_floor=max(_max_err(a, b) for a, b in zip(fplain, plain)),
                f32_kernel_vs_its_function=max(
                    _max_err(a, b) for a, b in zip(kern, fplain)))


def phase_serve_gemma():
    t0 = time.perf_counter()
    server = BatchServer(GEMMA, reduced=False, slots=SERVE_SLOTS,
                         s_max=G_S_MAX, seed=0, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.dtype) != \
            (18, 2048, 256_000, G_HQ, G_HKV, G_D, "bfloat16"):
        raise AssertionError(f"not gemma_2b at full width: {cfg}")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in server.model.parameters())
    rng = np.random.default_rng(0)
    lengths = [int(v) for v in rng.integers(256, 4097, SERVE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, v).tolist() for v in lengths]
    # warm-up (cuBLAS handles, allocator): one short prefill, not counted
    _prefill_logits(server.model, prompts[0][:300], G_S_MAX)
    sync()

    reqs = _requests(prompts)
    FK.reset_launches()                  # the serving path starts here
    stats = server.run(reqs)
    launches = dict(FK.LAUNCHES)         # ... and ends here
    timing = dict(server.timing)
    decode_tokens = SERVE_REQUESTS * (SERVE_MAX_NEW - 1)
    want = cfg.n_layers * (SERVE_REQUESTS + decode_tokens)
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, want "
                             f"{cfg.n_layers} x ({SERVE_REQUESTS} + "
                             f"{decode_tokens}) = {want}")
    if stats["completed"] != SERVE_REQUESTS or stats["tokens"] != \
            decode_tokens:
        raise AssertionError(f"serve stats {stats}")
    for r in reqs:
        lg = r.prefill_logits
        if lg.shape != (cfg.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"request {r.rid}: bad prefill logits")
        if len(r.out) != SERVE_MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid}: bad tokens {r.out}")

    # the same requests on the same weights through the plain attention
    server.model.use_kernel = False
    server.timing = {k: type(v)() for k, v in server.timing.items()}
    plain = _requests(prompts)
    plain_stats = server.run(plain)
    if FK.LAUNCHES["flash_attention"] != want:
        raise AssertionError("the plain path launched the kernel")
    server.model.use_kernel = None
    # the bf16 floor: the kernel's own f32 function in the model's place
    with _attention_through_plain_version():
        fplain = [_prefill_logits(server.model, p, G_S_MAX) for p in prompts]
    if FK.LAUNCHES["flash_attention"] != want:
        raise AssertionError("the floor's run launched the kernel")
    logit_err = max(_max_err(a.prefill_logits, b.prefill_logits)
                    for a, b in zip(reqs, plain))
    bf16_floor = max(_max_err(a, b.prefill_logits)
                     for a, b in zip(fplain, plain))
    if logit_err > GEMMA_FLOOR_FACTOR * bf16_floor:
        raise AssertionError(f"gemma bf16 prefill logits: kernel path off "
                             f"the plain path by {logit_err} > "
                             f"{GEMMA_FLOOR_FACTOR} x floor {bf16_floor}")
    kernel_vs_fn = max(_max_err(a.prefill_logits, b)
                       for a, b in zip(reqs, fplain))
    logit_std = float(plain[0].prefill_logits.std())
    checks = _gemma_f32_checks(cfg, prompts)
    same_tok = sum(x == y for a, b in zip(reqs, plain)
                   for x, y in zip(a.out, b.out))
    first_same = sum(a.out[0] == b.out[0] for a, b in zip(reqs, plain))

    # where the time goes: one prefill of the first prompt, then eight
    # decode steps from its cache, on the kernel path, traced on the card
    first = torch.tensor([prompts[0]], device="cuda")
    box = {}

    def prefill():
        box["cache"] = server.model.prefill({"tokens": first}, G_S_MAX)[0]

    def decode(steps=8):
        tok = first[:, -1:]
        for _ in range(steps):
            server.model.decode_step(box["cache"], {"tokens": tok})

    prefill_trace = _device_trace(prefill, FA_KERNELS)
    decode_trace = _device_trace(decode, FA_KERNELS, steps=8)

    # the kernel's share of prefill: its device time at each request's
    # length in the serving layout (`graph_ms`) x 18 layers, over the
    # prefills' host time
    fa_ms = 0.0
    for v in lengths:
        args, kw = _gemma_attention_args(
            torch.Generator(device="cuda").manual_seed(v), v)
        fa_ms += cfg.n_layers * graph_ms(lambda: FK.flash_attention(*args,
                                                                    **kw))
    # ... and of decode at the served mix: request i decodes its tokens
    # over lengths[i] + 1 ... lengths[i] + 15 cached rows, timed at the
    # middle one
    fa_decode_ms = 0.0
    for v in lengths:
        args, kw = _gemma_attention_args(
            torch.Generator(device="cuda").manual_seed(v), 1,
            cached=v + SERVE_MAX_NEW // 2 - 1)
        fa_decode_ms += (SERVE_MAX_NEW - 1) * cfg.n_layers * graph_ms(
            lambda: FK.flash_attention(*args, **kw), 50)
    prefill_ms = 1e3 * timing["prefill_s"]
    decode_ms = 1e3 * timing["decode_s"]
    emit("serve_gemma", arch=GEMMA, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
         weight_bytes=weight_bytes, init_s=init_s, prompt_lengths=lengths,
         slots=SERVE_SLOTS, max_new=SERVE_MAX_NEW, s_max=G_S_MAX,
         stats=stats, plain_stats=plain_stats, launches=launches,
         prefill_ms_per_request=prefill_ms / timing["prefills"],
         decode_ms_per_token=1e3 * timing["decode_s"]
         / timing["decode_steps"],
         plain_prefill_ms_per_request=1e3 * server.timing["prefill_s"]
         / server.timing["prefills"],
         plain_decode_ms_per_token=1e3 * server.timing["decode_s"]
         / server.timing["decode_steps"],
         prefill_s=timing["prefill_s"], decode_s=timing["decode_s"],
         fa_kernel_ms_in_prefill=fa_ms,
         fa_share_of_prefill=fa_ms / prefill_ms,
         fa_kernel_ms_in_decode=fa_decode_ms,
         fa_share_of_decode=fa_decode_ms / decode_ms,
         prefill_trace=dict(prompt=lengths[0], **prefill_trace),
         decode_trace_per_token=decode_trace,
         prefill_logit_max_abs_err=logit_err, bf16_floor=bf16_floor,
         logit_gate=GEMMA_FLOOR_FACTOR * bf16_floor,
         bf16_kernel_vs_its_function=kernel_vs_fn,
         plain_logit_std=logit_std, **checks,
         greedy_tokens_equal=f"{same_tok}/{SERVE_REQUESTS * SERVE_MAX_NEW}",
         first_token_equal=f"{first_same}/{SERVE_REQUESTS}")
    return launches


# ---------------------------------------------------------------------------
# 10. timing
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


def graph_ms(fn, reps=20):
    """Device time per call with the host out of the way: ``reps`` calls
    captured into one CUDA graph, replayed between CUDA events.  A call
    shorter than its own Python and launch overhead (a decode step's
    attention) is host-bound under `time_ms`; here it is not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                             # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    sync()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def host_us(fn, reps=200):
    """Host wall time per call, in µs, of ``reps`` calls issued back to back
    with no synchronisation between them: what the caller's thread pays per
    call while the card keeps up (a decode call's device time is shorter)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    sync()
    return us


def bound(nbytes, nops, nops_bf16=0):
    """The least time for the work: bytes over the memory rate, or the
    operations over the peak for their operands' type (``nops`` at f32's,
    ``nops_bf16`` at bf16's tensor-core rate), whichever is longer."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (nops / PEAK_OPS + nops_bf16 / PEAK_BF16) * 1e3
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
    for bh in (SSD_H, 4 * SSD_H):
        s, q, n, p = 4096, SSD_Q, SSD_N, SSD_P
        args = _chunk_inputs(gen, bh, s)
        nc = bh * s // q
        tri = q * (q + 1) // 2          # (t, s) pairs with s <= t
        nbytes = 4 * (bh * s * (p + 1 + 2 * n)          # xdt, adt, B, C in
                      + bh * s * p + nc * n * p)        # y, states out
        nops = nc * (tri * (2 * n + 2 * p + 1) + 2 * q * n * p)
        b, by = bound(nbytes, nops)
        rows.append(dict(
            kernel="ssd_chunk", op="serving" if bh == SSD_H else "batch4",
            shape=f"BH={bh} S={s} P={p} N={n} Q={q}", bytes=nbytes,
            ops=nops,
            ms=time_ms(lambda: SK.ssd_chunk(*args, chunk=q), 20),
            plain_ms=time_ms(lambda: SK.ssd_chunk_plain(*args, chunk=q), 5),
            library_ms=None, bound_ms=b, bound_by=by))
    rows += flash_timing(gen)
    for row in rows:
        emit("timing", **row)
    return rows


def flash_timing(gen):
    """flash_attention at gemma_2b's prefill call and its decode calls at
    1,600 and 3,600 rows, beside its bound, its plain version and SDPA.
    Times are device times (`graph_ms`); ``eager_ms`` adds the wrapper's
    host time per call as the model pays it (`time_ms`).  Decode rows also
    give the wrapper's host time per call (``host_us``) and, of it, what
    allocating the split partials' scratch takes (``scratch_alloc_us``: a
    cached buffer would save at most that)."""
    rows = []
    for shape, s, cached in (("prefill", 4096, 0),
                             ("decode", 1, G_DECODE_VALID - 1),
                             ("decode_3600", 1, G_DECODE_LONG - 1)):
        args, kw = _gemma_attention_args(gen, s, cached)
        valid = kw["kv_valid"]
        pairs = sum(min(i + cached + 1, valid) for i in range(s))
        # q k^T and p v, 2 operations per multiply-add each.  q k^T has
        # bf16 operands, and a bf16 product is exact in f32: the bf16 rate.
        # p v takes p in f32, as the TPU kernel keeps it.  p splits exactly
        # into three bf16 parts (hi = bf16(p), mid = bf16(p - hi), lo =
        # bf16(p - hi - mid)) whose products with bf16 v are exact in f32,
        # so the same function costs three bf16 products: 3 x ops_pv at the
        # bf16 rate.
        ops_qk = ops_pv = 2 * G_HQ * G_D * pairs
        nbytes = 2 * G_D * (2 * G_HQ * s + 2 * G_HKV * valid)  # bf16
        b, by = bound(nbytes, 0, nops_bf16=ops_qk + 3 * ops_pv)
        # the yardstick: SDPA on contiguous (B, H, S, D) copies of the
        # valid rows; top-left causal alignment is ours only when square
        lq, lk, lv = (t[:, :, :valid].contiguous() for t in args)
        lib = lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=shape == "prefill", enable_gqa=True)
        reps = 5 if shape == "prefill" else 50
        rows.append(dict(
            kernel="flash_attention", op=shape,
            shape=f"B=1 Hq={G_HQ} Hkv={G_HKV} Sq={s} kv_valid={valid} "
                  f"D={G_D} bf16 causal", bytes=nbytes, ops=ops_qk + ops_pv,
            ops_qk=ops_qk, ops_pv=ops_pv,
            bound_qk_ms=ops_qk / PEAK_BF16 * 1e3,
            bound_pv_ms=3 * ops_pv / PEAK_BF16 * 1e3,
            bound_bytes_ms=nbytes / HBM_BPS * 1e3,
            ms=graph_ms(lambda: FK.flash_attention(*args, **kw), reps),
            eager_ms=time_ms(lambda: FK.flash_attention(*args, **kw), reps),
            plain_ms=graph_ms(lambda: FK.flash_attention_plain(*args, **kw),
                              reps),
            library_ms=graph_ms(lib, reps),
            library_max_abs_err=_max_err(lib(), FK.flash_attention(*args,
                                                                   **kw)),
            bound_ms=b, bound_by=by))
        if s == 1:
            rows_max, max_splits = FK.decode_limits()
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits = FK.decode_splits(valid, G_HKV, sms, max_splits)
            floats = G_HKV * splits * rows_max * (G_D + 2)
            rows[-1].update(
                splits=splits,
                host_us=host_us(lambda: FK.flash_attention(*args, **kw)),
                scratch_alloc_us=host_us(lambda: torch.empty(
                    floats, dtype=torch.float32, device="cuda")))
    return rows


# ---------------------------------------------------------------------------

def main():
    # f32 products in full f32 on the card (the plain versions' matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"rmw_table": 0.0, "rmw_table_fetched": 0.0, "slot_counts": 0.0,
            "fetched_normal_faa": 0.0}
    phase_kernels(gen, errs)
    errs["ssd_chunk"] = phase_ssd_kernel(gen)
    errs["flash_attention"] = phase_flash_kernel(gen)

    K.reset_launches()                   # the main path starts here
    phase_atomics(gen)
    bfs_n, bfs_m = phase_bfs()
    launches = dict(K.LAUNCHES)          # ... and ends here
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    launches.update(phase_serve())       # resets and reads its own count
    launches.update(phase_serve_gemma())  # the same

    rows = phase_timing(gen, bfs_n, bfs_m)
    headline = {"rmw_table": ("faa", "bfs"),
                "rmw_table_fetched": ("cas", "bfs"),
                "slot_counts": ("count", "bfs"),
                "ssd_chunk": ("serving", None),
                "flash_attention": ("prefill", None)}
    kernels = []
    for name, (op, shape) in headline.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["op"] == op and shape in (None, r["shape"]))
        kernels.append(dict(
            name=name, route="cuda",
            source=SOURCES.get(name, SOURCE),
            replaces=REPLACES[name],
            launches=launches[name], max_abs_err=errs[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # flash_attention's headline is the prefill call; its decode call at
    # 1,600 rows goes beside it
    dec = next(r for r in rows if r["kernel"] == "flash_attention"
               and r["op"] == "decode")
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    fa["decode"] = {k: dec[k] for k in (
        "ms", "eager_ms", "host_us", "scratch_alloc_us", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
