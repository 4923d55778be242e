#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit.  It builds the port's kernel libraries in parallel (the three RMW
kernels from `src/repro_torch/kernels/rmw/csrc/rmw.cu`, the Mamba-2 SSD
chunk kernel from `src/repro_torch/kernels/ssd/csrc/ssd.cu`, the flash
attention kernel from
`src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`, the
one-thread serialized executor and pointer chase from
`src/repro_torch/kernels/serial/csrc/serial.cu`, whose SASS it writes
beside the library), holds each kernel against its plain PyTorch version
(`serial_rmw` bit for bit against the host loop on every op, int32 and
fp32, ±0, NaN and subnormals included; `chase` in its four modes; the
table-only RMW kernel
in every regime it can take, at each regime's shapes; the fetched RMW
kernel also at its edge shapes, twice; fp32 MIN/MAX also on ±0 and NaN; the
SSD kernel with B and C per group of heads and per head, beside a control
that rounds its products' operands to TF32 once), drives the port's three
main paths with the launch counters reset just before each and read just
after — `atomics.execute` on CUDA tables plus Graph500 BFS at scale 20,
edgefactor 16; `BatchServer` serving mamba2_780m; and `BatchServer`
serving gemma_2b, both at full width and depth in bf16 — times BFS's
search alone with the edges already on the card, and times each kernel
beside its bound, its plain version and the PyTorch library call that
computes the same function, where there is one.  Last, the paper's
measurement suites (`python -m repro_torch.benchmarks.run`: latency by
tier, bandwidth, contention, operand size, two fetched operands, BFS, the
backend shoot-out, calibration into `build/repro_torch/calibrated_spec.json`
and the Table 2/3 fit with its NRMSE), with the one-thread kernels'
launch counters reset before and read after.  Last, the sharded tier
(`sharded`): 4 ranks sharing the card on a 2x2 ``("pod", "dev")`` mesh
over gloo, 2^22 ops a rank over 2^24 int32 slots, every exchange strategy
and op (per-op CAS, dense, replicas, ``reverse_ranks``; int32 and fp32)
against the serialized oracle in rank order, `bfs_sharded` at the BFS
phase's scale against its parents, `execute_until` with every policy
against the local tier's round history, ms per batch split into the
exchange and the ranks' kernels, the kernels' launches inside the ranks;
then a world-size-1 NCCL run, and two NCCL ranks on the one card, whose
refusal it records.  Last, the elastic tier (`elastic`): on the same 4
ranks, a 2^24-slot table built by 4 FAA batches of 2^22 ops a rank moves
by the exchange path ((pod, dev)-sharded -> dev-sharded, pod replicas),
then by device_put onto `survivors_mesh` (2 ranks) and back, each bit for
bit; after each move three batches (fetched FAA with stats, per-op CAS,
SWP) are held against a table never resharded and against
`rmw_serialized`; two checkpoints are saved, and `run_with_recovery`
with `reshard_tables` as its hook runs under a seeded fault at each of
four sites, bit-equal to the run with none; a second world of 2 ranks
restores the checkpoint under its own mesh and walks back past a
corrupted step; no step down `reshard_tables`' ladder is allowed; ms for
each migration path and for replaying the history, beside the cost
model's predictions.  MoE: `flash_attention` at dbrx's and jamba's
shapes (3,523-row prefill, 1,600-row decode; 48 and 64 query heads over 8
KV heads of 128); `BatchServer` serving dbrx at full width cut to 4
layers (`serve_dbrx`) and jamba at full width cut to 5 layers, every
layer kind (`serve_jamba`), the same 8 requests, both with their launch
counts, routing flips between the kernel and plain paths reported, bf16
logits gated against the plain path routed to the kernel path's experts,
the strict check at 2 layers in f32; and expert parallelism (`moe_ep`): one full-width dbrx
MoE layer on 4 ranks sharing the card on a 2x2 ``("data", "model")``
mesh, held to the local path where nothing drops, its global arrival
ranks to a host recount, what it kept to its capacities, its aux loss to
the local one, its time split by the layer's profiler ranges (weight
gather, exchange, atomics, expert products), the RMW kernels' launches
inside the ranks counted.  The suites include `rmw_sharded` (8 ranks on
the card).  Last, training and MLA, which launch no kernel (each phase
fails if one launches; no kernel has a backward): `train_gemma` trains
gemma_2b at full width through `launch.train.train` (8 x 256 tokens, 30
steps, with deterministic algorithms and without: step ms, tokens/s,
MFU, peak memory, a profiled step's idle share and kernels by time);
`train_check` holds one step in f32 to f64 at full width cut to 2
layers; `train_recovery` finds which backward ops break replay and holds
train_100m's config under chaos bit for bit to a clean run;
`train_moe` trains deepseek_v3's reduced config; `serve_deepseek`
checks the full-width MLA layer in f32 against f64 and serves
deepseek_v3 at full width cut to its first 4 layers.  M-RoPE and the
encoder: `flash_mm` holds the flash kernel to its plain version at
qwen2_vl_2b's and whisper_small's calls (whisper's non-causal encoder,
cross-attention prefill and split-KV decode), with timing rows for each;
`serve_qwen2_vl` serves qwen2_vl_2b at full width and depth through
`BatchServer` and from ``embeds`` with distinct M-RoPE positions;
`serve_whisper` serves whisper_small at full width and depth with 1,500
frames through `LM.prefill` / `LM.decode_step`, its launches counted per
prefill and token; both gate their logits against the plain path;
`train_mm` trains both at full width (no kernel launched).  Telemetry:
the `telemetry_drift` suite runs among the suites, and `telemetry` checks
its tiers, measured events and overhead gate, then a recovery run under
chaos whose ring must hold each fired fault before its recovery event.
Tuning (`tuning`, its own main path, the launch counters reset before and
read after): the `contention_observe` and `tuning` suites on the card
(bit identity with stats on and off, locally and on 4 ranks; the noise,
retry and live-controller overhead gates; the estimator fed by the
``slot_counts`` kernel; writers per slot against the contention model;
convergence, rollback and quarantine; tuned int32 runs bit-equal to
untuned runs that took other backends, locally and on 4 ranks), then a
default controller over the telemetry suite's local traffic for 12
update windows (`tuning_probe`: each window's outcome, the fields tuned
at the end, and what auto picks before and after).  Last, sharded
training (`train_sharded`, no kernel launched): 4 ranks sharing the card
on a 2x2 ``("data", "model")`` mesh over gloo, gemma_2b at full width,
8 x 256 tokens; 3 sharded steps in f32 at 2 layers held to the local
step (losses and grad norms, every gathered parameter, clipping in a
step), one step on an unevenly masked batch beside a mean-of-means
control that must fail, `train(mesh=...)` in bf16 at 4 layers (step ms
by gather, compute and reduce; host-staged collectives; peak memory per
rank), and `train(mesh=...)` under chaos bit-equal to a clean sharded
run.
A `timeline` line gives each phase's seconds.

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
# the training phases run with deterministic algorithms, whose cuBLAS needs
# this workspace setting before its first handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import atomics  # noqa: E402
from repro_torch.atomics.stats import stats_from_occupancy  # noqa: E402
from repro_torch.benchmarks import bandwidth as bw_suite  # noqa: E402
from repro_torch.benchmarks import reshard as reshard_suite  # noqa: E402
from repro_torch.benchmarks import run as suites  # noqa: E402
from repro_torch.core import bfs as bfs_mod  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmw import kernel as K  # noqa: E402
from repro_torch.kernels.rmw import ref  # noqa: E402
from repro_torch.kernels.serial import kernel as XK  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

OPS = ("faa", "swp", "min", "max", "cas")
HBM_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_OPS = 67e12         # H100 SXM fp32 outside the tensor cores
PEAK_BF16 = 989e12       # H100 SXM bf16 tensor cores, dense
PEAK_TF32 = 494.7e12     # H100 SXM tf32 tensor cores, dense
SCALE, EDGEFACTOR = 20, 16
SOURCE = "src/repro_torch/kernels/rmw/csrc/rmw.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SERIAL_SOURCE = "src/repro_torch/kernels/serial/csrc/serial.cu"
SOURCES = {"ssd_chunk": SSD_SOURCE, "flash_attention": FA_SOURCE,
           "serial_rmw": SERIAL_SOURCE, "chase": SERIAL_SOURCE}
# the RMW kernels as the device trace names them
RMW_KERNELS = ("table_combine_kernel", "swp_write_kernel", "fetched_",
               "cas_success_kernel")
REPLACES = {"rmw_table": "src/repro/kernels/rmw/kernel.py:107",
            "rmw_table_fetched": "src/repro/kernels/rmw/kernel.py:306",
            "slot_counts": "src/repro/kernels/rmw/kernel.py:169",
            "ssd_chunk": "src/repro/kernels/ssd/kernel.py:57",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:84",
            # device loops, not TPU kernels: the reference's lax.scan and
            # its latency suite's fori_loop walks
            "serial_rmw": "src/repro/core/rmw.py:106",
            "chase": "benchmarks/latency.py:60"}
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
    libraries = (K.LIBRARY, SK.LIBRARY, FK.LIBRARY, XK.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        done = list(pool.map(_build_one, libraries))
    for built, secs in done:
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        emit("build", seconds=secs, library=built.path.name, ptxas=ptxas)
    emit("build", total_seconds=time.perf_counter() - t0)
    emit("build", serial_sass=_serial_sass(XK.LIBRARY.load().path))


def _serial_sass(lib_path):
    """The one-thread kernels' SASS (``cuobjdump -sass``), written beside
    the library; per kernel, its instructions and its global atomics (a
    loop that waits on each atomic's return before the next holds one)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {"file": None, "kernels": "cuobjdump not found"}
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    with open(str(lib_path) + ".sass", "w") as f:
        f.write(sass)
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = {"instructions": 0, "atomics": 0}
        elif name and "*/" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            out[name]["instructions"] += 1
            out[name]["atomics"] += bool(words) and words[0].split(".")[0] \
                in ("ATOMG", "ATOM", "RED")
    return {"file": str(lib_path) + ".sass", "kernels": out}


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


def _kronecker_idx(gen, scale, n):
    """Graph500 RMAT destinations (A = 0.57, B = 0.19, C = 0.19, the rule of
    `core.bfs.kronecker_graph`), drawn on the card: BFS's slot skew."""
    a, b, c = 0.57, 0.19, 0.19
    idx = torch.zeros((n,), dtype=torch.int64, device="cuda")
    for level in range(scale):
        r = torch.rand((n,), generator=gen, device="cuda")
        bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        idx |= bit.long() << level
    perm = torch.randperm(1 << scale, generator=gen, device="cuda")
    return perm[idx].int()


def _fetched_cases(gen, bfs_n):
    """The fetched kernel's edge shapes, int32 (name, table, idx, vals)."""
    cases = []
    for name, n, m in (("m1", 1 << 22, 1), ("bfs_90pct_dropped", bfs_n,
                                             1 << SCALE),
                       ("all_dropped", 1 << 22, 1 << 20),
                       ("m_2pow25_plus1", 1 << 24, (1 << 25) + 1),
                       ("kronecker", 1 << 22, 1 << SCALE)):
        tab, idx, val = _inputs(gen, n, m, torch.int32, drops=False)
        if name == "bfs_90pct_dropped":
            drop = torch.rand((n,), generator=gen, device="cuda") < 0.9
            idx = torch.where(drop, m, idx)
        elif name == "all_dropped":
            idx = torch.where(idx % 2 == 0, m, -1 - idx)
        elif name == "kronecker":
            idx = _kronecker_idx(gen, SCALE, n)
        cases.append((name, tab, idx, val))
    return cases


def _check_fetched_cases(gen, bfs_n):
    """Every op, int32, bit-equal to the plain version and to a second run
    of the kernel, at m = 1, the BFS shape with 90% of ops dropped, every op
    dropped, m = 2^25 + 1 (four radix passes) and Kronecker skew."""
    done = []
    for name, tab, idx, val in _fetched_cases(gen, bfs_n):
        for op in OPS:
            exp = 0 if op == "cas" else None
            got = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
            again = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
            want = K.rmw_table_fetched_plain(tab, idx, val, op, exp)
            sync()
            for g, a, w, what in zip(got, again, want,
                                     ("table", "fetched", "success")):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"rmw_table_fetched {op} {name}: {what} differs "
                        f"from the plain version in {int((g != w).sum())} "
                        f"places")
                if not torch.equal(g, a):
                    raise AssertionError(
                        f"rmw_table_fetched {op} {name}: {what} differs "
                        f"between two runs")
        done.append(dict(case=name, n=int(idx.shape[0]), m=int(tab.shape[0]),
                         kept=int(((idx >= 0) & (idx < tab.shape[0])).sum())))
    return done


def _fp32_faa_run_to_run(gen):
    """Whether fp32 FAA on normal values gives the same bits twice, for the
    kernel and for the plain version (`index_add_` and a sort), at the
    contended shape, where segments span tiles.  Reported, not gated."""
    tab, idx, val = _inputs(gen, 1 << 22, 1024, torch.float32, normal=True)
    out = {}
    for name, fn in (("kernel", lambda: K.rmw_table_fetched(tab, idx, val)),
                     ("plain", lambda: K.rmw_table_fetched_plain(
                         tab, idx, val, "faa"))):
        runs = [fn() for _ in range(3)]
        sync()
        out[name] = {what: all(torch.equal(r[i], runs[0][i])
                               for r in runs[1:])
                     for i, what in ((0, "table"), (1, "fetched"))}
    return out


def _same_bits(got, want, what):
    """NaN where the plain version has NaN, every other value bit for bit
    (−0 is not +0); a NaN's payload is not compared."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan) or not torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)):
        raise AssertionError(f"{what}: differs from the plain version")


def _check_fp32_zeros_and_nans(gen):
    """fp32 MIN/MAX in the reference's order (−0 below +0, NaN wins and
    stays), and uniform CAS with `expected` 0, −0 and 1 (the serialized
    chain's bits): both kernels against their plain versions on tables and
    operands drawn from ±0, ±1, 2 and NaN, at the contended shape, at a
    sparse one and over three L2 windows; the table-only kernel in every
    regime the shape allows."""
    pool = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, math.nan, -math.nan],
                        device="cuda")
    weights = torch.tensor([4.0, 4.0, 2.0, 2.0, 2.0, 0.3, 0.3],
                           device="cuda")
    done = []
    for n, m in ((1 << 22, 1024), (1 << 20, 1 << 18),
                 (1 << 22, 3 * K.WINDOW_SLOTS)):
        tab = pool[torch.multinomial(weights, m, True, generator=gen)]
        val = pool[torch.multinomial(weights, n, True, generator=gen)]
        idx = torch.randint(0, m + 7, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        for op in ("min", "max"):
            want = ref.rmw_table_ref(tab, idx, val, op)
            _same_bits(K.rmw_table(tab, idx, val, op), want,
                       f"rmw_table fp32 {op} ±0/NaN")
            for regime in K.table_regimes(m):
                _same_bits(K.table_combine(tab.clone(), idx, val, op,
                                           regime), want,
                           f"rmw_table fp32 {op} ±0/NaN {regime}")
            got = K.rmw_table_fetched(tab, idx, val, op)
            want = K.rmw_table_fetched_plain(tab, idx, val, op)
            sync()
            for g, w, what in zip(got[:2], want[:2], ("table", "fetched")):
                _same_bits(g, w, f"rmw_table_fetched fp32 {op} ±0/NaN "
                                 f"{what}")
            if not torch.equal(got[2], want[2]):
                raise AssertionError(f"rmw_table_fetched fp32 {op} ±0/NaN: "
                                     f"success differs")
        # uniform CAS: a value equal to `expected` in the other zero's bits
        # keeps the chain alive and is what the next op fetches
        for exp in (0.0, -0.0, 1.0):
            got = K.rmw_table_fetched(tab, idx, val, "cas", expected=exp)
            want = K.rmw_table_fetched_plain(tab, idx, val, "cas", exp)
            sync()
            for g, w, what in zip(got[:2], want[:2], ("table", "fetched")):
                _same_bits(g, w, f"rmw_table_fetched fp32 cas (expected "
                                 f"{exp}) ±0/NaN {what}")
            if not torch.equal(got[2], want[2]):
                raise AssertionError(f"rmw_table_fetched fp32 cas ±0/NaN: "
                                     f"success differs")
        done.append(dict(n=n, m=m, regimes=K.table_regimes(m),
                         nan_slots_after_min=int(torch.isnan(
                             K.rmw_table(tab, idx, val, "min")).sum())))
    return done


# the table-only kernel's shapes (name, n, m): a small table, the cluster
# range, BFS's n over 2^20 uniform and Kronecker, over L2 windows, one
# slot, every op dropped, the largest private copy
TABLE_CASES = (("cluster_range", 1 << 25, 300_000),
               ("uniform_bfs_n", 2 * EDGEFACTOR << SCALE, 1 << SCALE),
               ("kronecker", 2 * EDGEFACTOR << SCALE, 1 << SCALE),
               ("uniform_2pow24", 1 << 24, 1 << 24), ("m1", 1 << 22, 1),
               ("all_dropped", 1 << 22, 1 << 20),
               ("smem_full", 1 << 22, K.SMEM_SLOTS))


def _check_table_regimes(gen, errs):
    """`rmw_table` (faa, min, max, swp; int32 and integer-valued fp32, so
    every sum is exact) and `slot_counts`, in the regime the rule picks and
    forced into every other regime the shape allows, bit-equal to the plain
    versions, the input table unchanged; normal fp32 FAA in the regime the
    rule picks within rtol 1e-5, atol 1e-5 sqrt(max occupancy)."""
    done = []
    for name, n, m in TABLE_CASES:
        if name == "kronecker":
            idx = _kronecker_idx(gen, SCALE, n)
        else:
            idx = torch.randint(0, m + 3, (n,), generator=gen, device="cuda",
                                dtype=torch.int32)
            if name == "all_dropped":
                idx = torch.where(idx % 2 == 0, m, -1 - idx)
        want = K.slot_counts_plain(idx, m)
        if not torch.equal(K.slot_counts(idx, m), want):
            raise AssertionError(f"slot_counts {name}: counts differ")
        for regime in K.table_regimes(m):
            if not torch.equal(K.table_combine(torch.zeros_like(want), idx,
                                               None, "count", regime), want):
                raise AssertionError(f"slot_counts {name} {regime}: differ")
        atol = 1e-5 * math.sqrt(max(int(want.max()), 1))
        for dtype in (torch.int32, torch.float32):
            tab, _, val = _inputs(gen, n, m, dtype, drops=False)
            before = tab.clone()
            for op in ("faa", "min", "max", "swp"):
                want = ref.rmw_table_ref(tab, idx, val, op)
                got = {None: K.rmw_table(tab, idx, val, op)}
                for regime in K.table_regimes(m):
                    got[regime] = K.table_combine(tab.clone(), idx, val, op,
                                                  regime)
                sync()
                for regime, g in got.items():
                    if not torch.equal(g, want):
                        raise AssertionError(
                            f"rmw_table {op} {dtype} {name} "
                            f"{regime or 'picked'}: differs from the plain "
                            f"version in {int((g != want).sum())} places")
            if not torch.equal(tab, before):
                raise AssertionError(f"rmw_table {name}: input changed")
        # normal fp32 FAA: the regime the rule picks and every forced one
        # (twice each: atomic order varies from run to run) held to the
        # tolerance against the plain version summed in float64: in fp32 on
        # the card it is itself an atomic-order sum, whose rounding at
        # m = 1 (0.009-0.027 from run to run on the same inputs) is the
        # tolerance's size
        tab, _, val = _inputs(gen, n, m, torch.float32, normal=True,
                              drops=False)
        want = ref.rmw_table_ref(tab.double(), idx, val.double(),
                                 "faa").float()
        got = K.rmw_table(tab, idx, val, "faa")
        err = _max_err(got, want)
        if not torch.allclose(got, want, rtol=1e-5, atol=atol):
            raise AssertionError(f"rmw_table fp32 normal FAA {name}: off by "
                                 f"{err}")
        errs["rmw_table"] = max(errs["rmw_table"], err)
        forced = {}
        for regime in K.table_regimes(m):
            forced[regime] = []
            for _ in range(2):
                g = K.table_combine(tab.clone(), idx, val, "faa", regime)
                forced[regime].append(_max_err(g, want))
                if not torch.allclose(g, want, rtol=1e-5, atol=atol):
                    raise AssertionError(
                        f"rmw_table fp32 normal FAA {name} forced {regime}: "
                        f"off the float64 sum by {forced[regime][-1]} "
                        f"(atol {atol})")
        done.append(dict(case=name, n=n, m=m,
                         picked=K.table_regime("faa", torch.int32, n, m),
                         regimes=K.table_regimes(m),
                         kept=int(((idx >= 0) & (idx < m)).sum()),
                         normal_faa_max_abs_err=err, normal_faa_atol=atol,
                         normal_faa_forced_max_abs_err=forced))
    return done


def phase_kernels(gen, errs):
    if K.fetched_layout(1)[1] != K.RADIX_BITS:
        raise AssertionError("rmw_table_fetched: the library's radix digit "
                             "is not the cost model's RADIX_BITS")
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
    emit("kernels", table_regimes_as_plain=_check_table_regimes(gen, errs),
         fetched_int32_bit_equal_twice=_check_fetched_cases(
        gen, 2 * EDGEFACTOR << SCALE),
         fp32_min_max_zeros_and_nans_as_plain=_check_fp32_zeros_and_nans(
             gen),
         fp32_normal_faa_same_bits_run_to_run=_fp32_faa_run_to_run(gen))


# ---------------------------------------------------------------------------
# 3b. the one-thread device loops against their plain versions
# ---------------------------------------------------------------------------

SUBNORMALS = (1e-40, -1e-40, 5e-39, -1.1e-38, 1.2e-38, -1.5e-45,
              1.17549435e-38)


def _serial_values(gen, n, dtype, kind):
    """Operands (or a table) of ``n`` values: integers in [-8, 8] (every
    fp32 sum exact), ±0/±1/2/NaN for fp32 MIN/MAX and CAS, or normal
    draws mixed with subnormals for fp32 FAA."""
    if kind == "zeros_nans":
        pool = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, math.nan, -math.nan],
                            device="cuda")
        w = torch.tensor([4.0, 4.0, 2.0, 2.0, 2.0, 0.5, 0.5], device="cuda")
        return pool[torch.multinomial(w, n, True, generator=gen)]
    if kind == "subnormal":
        x = torch.randn((n,), generator=gen, device="cuda") * 1e-38
        sub = torch.tensor(SUBNORMALS, device="cuda")
        pick = torch.randint(0, len(SUBNORMALS), (n,), generator=gen,
                             device="cuda")
        return torch.where(torch.rand((n,), generator=gen, device="cuda")
                           < 0.5, sub[pick], x)
    return torch.randint(-8, 9, (n,), generator=gen,
                         device="cuda").to(dtype)


def _check_serial(got, tab, idx, val, op, exp, what):
    """`serial_rmw` against the host loop: every output bit for bit, NaN
    by ``isnan``.  Returns the largest difference over non-NaN values."""
    want = XK.serial_rmw(tab.cpu(), idx.cpu(),
                         val.cpu(), op, exp.cpu() if isinstance(
                             exp, torch.Tensor) else exp)
    for g, w, name in zip(got[:2], want[:2], ("table", "fetched")):
        _same_bits(g.cpu(), w, f"serial_rmw {what}: {name}")
    if not torch.equal(got[2].cpu(), want[2]):
        raise AssertionError(f"serial_rmw {what}: success differs")
    return max(_max_err(g[~torch.isnan(g)].cpu(), w[~torch.isnan(w)])
               if g.dtype.is_floating_point else 0.0
               for g, w in zip(got[:2], want[:2]))


def _serial_cases(gen):
    """(what, table, indices, values, op, expected): every op in int32 and
    fp32 at n = 4,096 over 1,024 slots and over one (indices from -m - 3
    to m + 3: negative ones count from the end, those outside drop); fp32
    MIN/MAX and CAS on ±0 and NaN; CAS with a per-op and a scalar
    expected; fp32 FAA on subnormals; then the suites' shapes."""
    n = 4096
    for m in (1024, 1):
        for dtype in (torch.int32, torch.float32):
            kinds = ("ints",) + (("zeros_nans",) if dtype == torch.float32
                                 else ())
            for kind in kinds:
                tab = _serial_values(gen, m, dtype, kind)
                val = _serial_values(gen, n, dtype, kind)
                idx = torch.randint(-m - 3, m + 3, (n,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                for op in XK.OP_CODES:
                    if kind == "zeros_nans" and op in ("faa", "swp"):
                        continue
                    exp = (_serial_values(gen, n, dtype, kind)
                           if op == "cas" else None)
                    yield (f"{op} {dtype} {kind} m={m}", tab, idx, val, op,
                           exp)
                    if op == "cas":
                        yield (f"cas scalar {dtype} {kind} m={m}", tab, idx,
                               val, op, 0)
        tab = _serial_values(gen, m, torch.float32, "subnormal")
        val = _serial_values(gen, n, torch.float32, "subnormal")
        idx = torch.randint(0, m, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        yield f"faa fp32 subnormal m={m}", tab, idx, val, "faa", None
    # the suites' shapes: bandwidth (4,096 over 262,144, normal fp32),
    # contention's hot slot (2,048 on one of 65,536), operand_size and
    # operands_fetched (2,048 CAS over 65,536, expected 0 or gathered)
    rng = np.random.default_rng(1)
    m = bw_suite.TABLE
    tab = torch.zeros((m,), device="cuda")
    idx = torch.as_tensor(rng.integers(0, m, bw_suite.N_OPS_SER),
                          dtype=torch.int32).cuda()
    val = torch.as_tensor(rng.normal(size=bw_suite.N_OPS_SER),
                          dtype=torch.float32).cuda()
    for op in ("faa", "swp"):
        yield f"bandwidth {op}", tab, idx, val, op, None
    hot = torch.zeros((2048,), dtype=torch.int32, device="cuda")
    yield ("contention serialized_hot", torch.zeros((65536,), device="cuda"),
           hot, val[:2048], "faa", None)
    for dtype in (torch.int32, torch.float32):
        tab = torch.zeros((65536,), dtype=dtype, device="cuda")
        idx = torch.randint(0, 65536, (2048,), generator=gen, device="cuda",
                            dtype=torch.int32)
        val = torch.randint(1, 100, (2048,), generator=gen,
                            device="cuda").to(dtype)
        exp = torch.randint(0, 3, (65536,), generator=gen,
                            device="cuda").to(dtype)[idx.long()]
        yield (f"operand_size cas {dtype}", tab, idx, val, "cas",
               torch.zeros_like(val))
        yield f"operands_fetched cas2 {dtype}", tab, idx, val, "cas", exp


def _check_chase(table, steps, mode, start, what):
    """`chase` against `chase_plain` on a copy of the same table: the end
    slot and the table after."""
    host = table._replace(words=table.words.cpu())
    got = XK.chase(table, steps, mode, start)
    want = XK.chase_plain(host, steps, mode, start)
    sync()
    if int(got) != int(want):
        raise AssertionError(f"chase {what}: ends at {int(got)}, the plain "
                             f"version at {int(want)}")
    after = table.words.cpu()
    if not torch.equal(after, host.words):
        raise AssertionError(f"chase {what}: table after differs in "
                             f"{int((after != host.words).sum())} slots")


def phase_serial_kernels(gen, errs):
    """`serial_rmw` bit-equal to the host loop on every case of
    `_serial_cases`; `chase` equal to its plain version in all four modes
    at 2^12 slots (three times round the cycle) and at the latency suite's
    L2 table (2^22 slots, 2^20 steps)."""
    checked = 0
    for what, tab, idx, val, op, exp in _serial_cases(gen):
        got = XK.serial_rmw(tab, idx, val, op, exp)
        sync()
        errs["serial_rmw"] = max(errs["serial_rmw"],
                                 _check_serial(got, tab, idx, val, op, exp,
                                               what))
        checked += 1
    chases = []
    for m, steps in ((1 << 12, 3 << 12), (1 << 22, 1 << 20)):
        table = XK.single_cycle(m, gen, device="cuda")
        for mode in XK.CHASE_MODES:
            start = int(torch.randint(0, m, (1,), generator=gen,
                                      device="cuda"))
            _check_chase(table, steps, mode, start, f"{mode} m={m}")
            chases.append(f"{mode} m={m} steps={steps}")
    errs["chase"] = 0.0                 # slots: equal or the check raised
    emit("serial_kernels", serial_rmw_bit_equal_cases=checked,
         chase_equal=chases, launches=dict(XK.LAUNCHES))


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
    reached, runs, parents = None, {}, {}
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
        parents[op] = res.parent
    emit("bfs", scale=SCALE, edgefactor=EDGEFACTOR, vertices=n,
         directed_edges=int(s.shape[0]), root=root, generator_s=gen_s,
         runs=runs)
    return s, d, root, parents


def phase_bfs_search(s, d, root, parents):
    """The search alone, as Graph500 times it (its kernel 2): the edges
    already on the card.  Host time of one call per op, and the device
    trace of another (busy time, the RMW kernels' share, idle share).
    Beside it, `bfs()` with the edges narrowed to int32 on the host first
    (`host_narrowed_s`), as it was given them before it narrowed them on
    the card: the host pass's share of `bfs()` on host arrays."""
    n = 1 << SCALE
    s_dev, d_dev = (torch.as_tensor(x).cuda().int() for x in (s, d))
    runs = {}
    for op in ("cas", "swp", "faa"):
        sync()
        t0 = time.perf_counter()
        narrowed = bfs_mod.bfs(s.astype(np.int32), d.astype(np.int32), n,
                               root=root, op=op)
        sync()
        host_narrowed_s = time.perf_counter() - t0
        if not torch.equal(narrowed.parent, parents[op]):
            raise AssertionError(f"bfs {op}: parents differ with the edges "
                                 f"narrowed on the host")
        sync()
        t0 = time.perf_counter()
        res = bfs_mod.bfs(s_dev, d_dev, n, root=root, op=op)
        sync()
        secs = time.perf_counter() - t0
        if not torch.equal(res.parent, parents[op]):
            raise AssertionError(f"bfs {op}: parents differ with the edges "
                                 f"on the card")
        runs[op] = dict(seconds=secs, teps=res.edges_traversed / secs,
                        host_narrowed_s=host_narrowed_s,
                        trace=_device_trace(
                            lambda: bfs_mod.bfs(s_dev, d_dev, n, root=root,
                                                op=op), RMW_KERNELS))
    emit("bfs_search", runs=runs)


# ---------------------------------------------------------------------------
# 6. the SSD chunk kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(gen, b, s, h, g=None):
    """The reference tests' distributions (tests/test_kernels_ssd.py:14-20):
    x, B, C standard normal, dt in [0.01, 0.2], A in -[0.5, 2]; B and C on
    g groups of heads (default: one per head)."""
    dev = "cuda"
    g = h if g is None else g
    x = torch.randn((b, s, h, SSD_P), generator=gen, device=dev)
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.19 + 0.01
    A = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
    B = torch.randn((b, s, g, SSD_N), generator=gen, device=dev)
    C = torch.randn((b, s, g, SSD_N), generator=gen, device=dev)
    return x, dt, A, B, C


def _chunk_inputs(gen, bh, s, hpg=1):
    """ssd_chunk's operands, made as `ops.ssd` makes them: (BH, S, ·) f32,
    B and C (BH / hpg, S, N) for groups of hpg heads."""
    x, dt, A, B, C = _ssd_inputs(gen, 1, s, bh, bh // hpg)

    def flat(t):
        return t.transpose(1, 2).reshape(-1, s, *t.shape[3:]).contiguous()

    return (flat(x * dt[..., None]), flat(dt * A), flat(B), flat(C))


# ssd_chunk's shapes (name, BH, heads per group): mamba2_780m serving one
# sequence (48 heads in one group), four sequences, the reference's
# per-head interface, and two groups of 24
SSD_CASES = [("serving", SSD_H, SSD_H), ("batch4", 4 * SSD_H, SSD_H),
             ("serving_per_head", SSD_H, 1), ("two_groups", SSD_H, SSD_H // 2)]


def _check_close(got, want, what):
    err = _max_err(got, want)
    if not torch.allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL):
        raise AssertionError(f"{what}: off by {err} (rtol = atol = "
                             f"{SSD_TOL})")
    return err


def phase_ssd_kernel(gen):
    errs = {}
    for name, bh, hpg in SSD_CASES:
        args = _chunk_inputs(gen, bh, 4096, hpg)
        y, st = SK.ssd_chunk(*args, chunk=SSD_Q, heads_per_group=hpg)
        y_p, st_p = SK.ssd_chunk_plain(*args, chunk=SSD_Q,
                                       heads_per_group=hpg)
        sync()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_chunk {name}: non-finite output")
        errs[name] = {"y_intra": _check_close(y, y_p, f"ssd_chunk {name} y"),
                      "states": _check_close(st, st_p,
                                             f"ssd_chunk {name} states")}
        fields = {}
        if name == "serving":
            # the control: one TF32 pass per product must fail the check
            y_c, st_c = SK.ssd_chunk_plain(*args, chunk=SSD_Q,
                                           heads_per_group=hpg,
                                           tf32_operands=True)
            sync()
            fields["tf32_one_pass_control"] = {
                "y_intra": _max_err(y_c, y_p), "states": _max_err(st_c, st_p),
                "fails_tolerance": not (
                    torch.allclose(y_c, y_p, rtol=SSD_TOL, atol=SSD_TOL)
                    and torch.allclose(st_c, st_p, rtol=SSD_TOL,
                                       atol=SSD_TOL))}
            if not fields["tf32_one_pass_control"]["fails_tolerance"]:
                print(f"ssd_chunk: the tolerance {SSD_TOL} cannot tell one "
                      f"TF32 pass from f32 at the serving shape", flush=True)
            del y_c, st_c
        emit("ssd_kernel", shape=name, bh=bh, heads_per_group=hpg, s=4096,
             p=SSD_P, n=SSD_N, chunk=SSD_Q, rtol=SSD_TOL, atol=SSD_TOL,
             max_abs_err=errs[name], launches=dict(SK.LAUNCHES), **fields)
    # a short prompt, 1000 = 3 * 256 + 232 steps, through the composition
    # (padding, flattening, cross-chunk recurrence) and the sequential oracle
    s = 1000
    args = _ssd_inputs(gen, 1, s, SSD_H, 1)
    before = SK.LAUNCHES["ssd_chunk"]
    y, hf = ssd_ops.ssd(*args, chunk=SSD_Q, use_kernel=True,
                        return_final_state=True)
    if SK.LAUNCHES["ssd_chunk"] != before + 1:
        raise AssertionError("ops.ssd on one group: not one kernel launch")
    y_p, hf_p = ssd_ops.ssd_chunked(*args, chunk=SSD_Q,
                                    return_final_state=True)
    y_o = ssd_ref.ssd_ref(*args[:3], *(t.expand(-1, -1, SSD_H, -1)
                                       for t in args[3:]))
    sync()
    errs["ops_ssd"] = {
        "y": _check_close(y, y_p, "ops.ssd y vs ssd_chunked"),
        "h_final": _check_close(hf, hf_p, "ops.ssd h_final vs ssd_chunked"),
        "y_vs_sequential_oracle": _check_close(y, y_o, "ops.ssd vs ssd_ref")}
    emit("ssd_kernel", shape="ops_ssd_short", b=1, s=s, h=SSD_H, groups=1,
         p=SSD_P, n=SSD_N, chunk=SSD_Q, rtol=SSD_TOL, atol=SSD_TOL,
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
    and a (1, 4112, 1, 256) KV cache."""
    return _attention_args(gen, s, cached, G_HQ, G_HKV, G_D, dtype)


def _attention_args(gen, s, cached, hq, hkv, d, dtype=torch.bfloat16):
    """One attention call as the model makes it: q (1, s, hq, d) and a
    (1, 4112, hkv, d) KV cache, handed to the kernel as transposed views,
    ``cached`` rows before the ``s`` new ones; rows past them hold NaN,
    which the kernel must never read."""
    q = torch.randn((1, s, hq, d), generator=gen, device="cuda")
    kc, vc = (torch.randn((1, G_S_MAX, hkv, d), generator=gen,
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


def _device_trace(fn, kernel, steps=1, top=0):
    """Kernels the card ran during ``fn()`` (torch.profiler's CUPTI trace):
    count, busy time, the span from the first kernel's start to the last's
    end, the idle share of that span, and the busy time of the kernels
    whose name holds ``kernel`` (a name, or a tuple of names); per step.
    With ``top``, also the ``top`` kernel names by busy time (ms and count
    per step, the name cut to 80 characters).  All None where the trace
    holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    # the card's events but the ranges `record_function` marks on it (the
    # MoE layer's stages), which span kernels and are none themselves
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", bool)()
           and not e.name().startswith("moe.")]
    if not dev:
        return dict(kernels=None, busy_ms=None, span_ms=None,
                    idle_share=None, kernel_ms=None)
    busy = sum(e.duration_ns() for e in dev) / 1e6
    span = (max(e.end_ns() for e in dev) - min(e.start_ns() for e in dev)) \
        / 1e6
    names = (kernel,) if isinstance(kernel, str) else kernel
    mine = sum(e.duration_ns() for e in dev
               if any(k in e.name() for k in names)) / 1e6
    out = dict(kernels=len(dev) / steps, busy_ms=busy / steps,
               span_ms=span / steps, idle_share=1 - busy / span,
               kernel_ms=mine / steps)
    if top:
        by = {}
        for e in dev:
            ms, n = by.get(e.name()[:80], (0.0, 0))
            by[e.name()[:80]] = (ms + e.duration_ns() / 1e6, n + 1)
        out["top"] = [[k, ms / steps, n / steps] for k, (ms, n) in
                      sorted(by.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


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
    # length (CUDA events), in the group form serving calls, x 48 layers,
    # over the prefills' host time
    ssd_ms = 0.0
    for v in lengths:
        sp = -(-v // SSD_Q) * SSD_Q
        args = _chunk_inputs(torch.Generator(device="cuda").manual_seed(v),
                             SSD_H, sp, SSD_H)
        ssd_ms += cfg.n_layers * time_ms(
            lambda: SK.ssd_chunk(*args, chunk=SSD_Q, heads_per_group=SSD_H))
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


def bound(nbytes, nops, nops_bf16=0, nops_tf32=0):
    """The least time for the work: bytes over the memory rate, or the
    operations over the peak for their operands' type (``nops`` at f32's,
    ``nops_bf16`` at bf16's and ``nops_tf32`` at TF32's tensor-core rate),
    whichever is longer."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (nops / PEAK_OPS + nops_bf16 / PEAK_BF16
             + nops_tf32 / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_ms(fn, reps=5):
    """Device time per call of each kernel ``fn`` launches, by name, from
    torch.profiler's CUPTI trace (None where it holds no device events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name().split("(")[0].split("<")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6 / reps
    return out or None


def fetched_design_bytes(idx, m, op):
    """`K.fetched_design_bytes` for this batch, and the ops it keeps."""
    live = idx[(idx >= 0) & (idx < m)]
    k, slots = live.shape[0], torch.unique(live).shape[0]
    return K.fetched_design_bytes(idx.shape[0], k, m, slots, op), k


def _fetched_row(shape, tab, idx, val, op):
    n, m = idx.shape[0], tab.shape[0]
    exp = 0 if op == "cas" else None
    b, by = bound(13 * n + 8 * m, n)
    design, k = fetched_design_bytes(idx, m, op)
    fn = lambda: K.rmw_table_fetched(tab, idx, val, op, expected=exp)
    row = dict(kernel="rmw_table_fetched", op=op, shape=shape, n=n, m=m,
               kept=k, design_bytes=design,
               design_bytes_ms=design / HBM_BPS * 1e3, ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: K.rmw_table_fetched_plain(
                   tab, idx, val, op, exp), 3),
               library_ms=None, bound_ms=b, bound_by=by)
    if op == "cas":
        row["stages_ms"] = stage_ms(fn)
    return row


def _table_rows(shape, tab, idx, val, ops=("faa", "min", "max", "swp"),
                device=False):
    """`rmw_table` (``ops``) and `slot_counts` at one shape, each beside its
    bound, its plain version and the PyTorch call that computes the same
    function (`index_add`, `scatter_reduce`, `bincount`; none for SWP), on
    the indices in range (those calls take no others).  The bound counts
    what this batch needs: every index, the values of the k ops it keeps,
    the table in and out (a count: the indices and the counts out).  With
    ``device``, also the device time of one call (``device_ms``: its
    kernels' sum in the profiler's trace, the table's copy included), for
    calls shorter than their own host work."""
    n, m = idx.shape[0], tab.shape[0]
    live = (idx >= 0) & (idx < m)
    k = int(live.sum())
    # the library calls take only in-range indices
    idx_k, val_k = idx[live], val[live]
    idx_kl = idx_k.long()
    rows = []
    for op in ops:
        lib = {"faa": lambda: torch.index_add(tab, 0, idx_k, val_k),
               "min": lambda: torch.scatter_reduce(tab, 0, idx_kl, val_k,
                                                   "amin"),
               "max": lambda: torch.scatter_reduce(tab, 0, idx_kl, val_k,
                                                   "amax")}.get(op)
        b, by = bound(4 * n + 4 * k + 8 * m, n)
        fn = lambda: K.rmw_table(tab, idx, val, op)
        rows.append(dict(
            kernel="rmw_table", op=op, shape=shape, n=n, m=m, kept=k,
            regime=K.table_regime(op, tab.dtype, n, m), ms=time_ms(fn),
            plain_ms=time_ms(lambda: ref.rmw_table_ref(tab, idx, val, op)),
            library_ms=None if lib is None else time_ms(lib),
            bound_ms=b, bound_by=by))
        if device:
            rows[-1]["device_ms"] = _device_ms(fn)
    b, by = bound(4 * n + 4 * m, n)
    fn = lambda: K.slot_counts(idx, m)
    rows.append(dict(
        kernel="slot_counts", op="count", shape=shape, n=n, m=m, kept=k,
        regime=K.table_regime("count", torch.int32, n, m), ms=time_ms(fn),
        plain_ms=time_ms(lambda: K.slot_counts_plain(idx, m)),
        library_ms=time_ms(lambda: torch.bincount(idx_kl, minlength=m)),
        bound_ms=b, bound_by=by))
    if device:
        rows[-1]["device_ms"] = _device_ms(fn)
    return rows


def _device_ms(fn):
    """`stage_ms`'s total, or None (not measured) where the profiler's
    trace holds no device events."""
    stages = stage_ms(fn)
    return None if stages is None else sum(stages.values())


def phase_timing(gen, bfs_n, bfs_m):
    """Each kernel beside its bound, its plain version and its library
    call.  The RMW rows: ``uniform_bfs_n`` is BFS's batch size (n = 2^25
    edges over 2^20 vertices) with uniform slots and every op kept, not
    BFS's traffic; ``kronecker`` and ``kronecker_90pct_dropped`` are BFS's
    Graph500 skew, with every op kept and with 90% dropped as its levels
    run; ``contended`` is the paper's n = 2^22 over 1,024 slots; ``uniform``
    n = m = 2^24, a table past the L2."""
    rows = []
    for shape, (n, m) in {"uniform_bfs_n": (bfs_n, bfs_m),
                          "uniform": (1 << 24, 1 << 24)}.items():
        tab, idx, val = _inputs(gen, n, m, torch.int32, drops=False)
        rows += _table_rows(shape, tab, idx, val)
        for op in OPS:
            rows.append(_fetched_row(shape, tab, idx, val, op))
    kron = _kronecker_idx(gen, SCALE, bfs_n)
    drop = torch.rand((bfs_n,), generator=gen, device="cuda") < 0.9
    for shape, idx in (("kronecker", kron),
                       ("kronecker_90pct_dropped",
                        torch.where(drop, bfs_m, kron))):
        tab, _, val = _inputs(gen, bfs_n, bfs_m, torch.int32, drops=False)
        rows += _table_rows(shape, tab, idx, val, ("faa", "min", "swp"))
    tab, idx, val = _inputs(gen, 1 << 22, 1024, torch.int32, drops=False)
    rows += _table_rows("contended", tab, idx, val, device=True)
    # ... and the fetched kernel at the BFS shape with 90% of ops dropped,
    # uniform slots
    tab, idx, val = _inputs(gen, bfs_n, bfs_m, torch.int32, drops=False)
    idx = torch.where(drop, bfs_m, idx)
    for op in OPS:
        rows.append(_fetched_row("bfs_90pct_dropped", tab, idx, val, op))
    for name, bh, hpg in SSD_CASES[:3]:
        s, q, n, p = 4096, SSD_Q, SSD_N, SSD_P
        args = _chunk_inputs(gen, bh, s, hpg)
        nc = bh * s // q
        tri = q * (q + 1) // 2          # (t, s) pairs with s <= t
        # xdt, adt in, y out; B and C once per group; the states out
        nbytes = 4 * (bh * s * (2 * p + 1) + 2 * (bh // hpg) * s * n
                      + nc * n * p)
        # the group's scores once, then per head the masked product and the
        # state; on the tensor cores each f32 product is three TF32 ones
        ops_scores = (bh // hpg) * (s // q) * tri * 2 * n
        ops_heads = nc * (tri * (2 * p + 1) + 2 * q * n * p)
        b, by = bound(nbytes, 0, nops_tf32=3 * (ops_scores + ops_heads))
        rows.append(dict(
            kernel="ssd_chunk", op=name,
            shape=f"BH={bh} S={s} P={p} N={n} Q={q} heads_per_group={hpg}",
            bytes=nbytes, ops=ops_scores + ops_heads, ops_scores=ops_scores,
            bound_bytes_ms=nbytes / HBM_BPS * 1e3,
            bound_ops_ms=3 * (ops_scores + ops_heads) / PEAK_TF32 * 1e3,
            ms=time_ms(lambda: SK.ssd_chunk(*args, chunk=q,
                                            heads_per_group=hpg), 20),
            plain_ms=time_ms(lambda: SK.ssd_chunk_plain(
                *args, chunk=q, heads_per_group=hpg), 5),
            library_ms=None, bound_ms=b, bound_by=by))
    rows += flash_timing(gen)
    for row in rows:
        emit("timing", **row)
    return rows


def _fa_row(shape, args, kw, s, cached, hq, hkv, d):
    """One flash_attention call beside its bound, its plain version and
    SDPA, as device times (`graph_ms`; ``eager_ms`` with the wrapper's host
    time as the model pays it)."""
    valid, causal = kw["kv_valid"], kw["causal"]
    pairs = (sum(min(i + cached + 1, valid) for i in range(s)) if causal
             else s * valid)
    # q k^T and p v, 2 operations per multiply-add each.  q k^T has bf16
    # operands, and a bf16 product is exact in f32: the bf16 rate.  p v
    # takes p in f32, as the TPU kernel keeps it.  p splits exactly into
    # three bf16 parts (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi
    # - mid)) whose products with bf16 v are exact in f32, so the same
    # function costs three bf16 products: 3 x ops_pv at the bf16 rate.
    ops_qk = ops_pv = 2 * hq * d * pairs
    nbytes = 2 * d * (2 * hq * s + 2 * hkv * valid)  # bf16
    b, by = bound(nbytes, 0, nops_bf16=ops_qk + 3 * ops_pv)
    # the yardstick: SDPA on contiguous (B, H, S, D) copies of the valid
    # rows; top-left causal alignment is ours only when square
    lq, lk, lv = (t[:, :, :valid].contiguous() for t in args)
    lib = lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal and s > 1, enable_gqa=True)
    reps = 5 if s > 1 else 50
    return dict(
        kernel="flash_attention", op=shape,
        shape=f"B=1 Hq={hq} Hkv={hkv} Sq={s} kv_valid={valid} "
              f"D={d} bf16 {'causal' if causal else 'non-causal'}",
        bytes=nbytes, ops=ops_qk + ops_pv,
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
        bound_ms=b, bound_by=by)


def flash_timing(gen):
    """flash_attention at gemma_2b's prefill call and its decode calls at
    1,600 and 3,600 rows, then at qwen2_vl's and whisper's calls
    (`MM_FLASH`), beside its bound, its plain version and SDPA.
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
        rows.append(_fa_row(shape, args, kw, s, cached, G_HQ, G_HKV, G_D))
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
    # qwen2_vl's and whisper's calls (`MM_FLASH`), each a row of its own
    for name, args, kw, s, cached, hq, hkv, d in _mm_flash_calls(gen):
        rows.append(dict(arch=name.split("_")[0], **_fa_row(
            name, args, kw, s, cached, hq, hkv, d)))
    return rows


# ---------------------------------------------------------------------------
# 11. the paper's measurement suites (this slice's main path)
# ---------------------------------------------------------------------------

#: the suites of the tuning slice, run by `phase_tuning`
TUNING_SUITES = ("contention_observe", "tuning")


def _run_suites(names):
    """`repro_torch.benchmarks.run`'s suites ``names`` on the card, each
    printing its rows; raises if one failed."""
    csv, results, failures = suites.run_suites(names, device="cuda")
    for name in names:
        emit("suites", suite=name, rows=[
            r for r in csv.rows if r["name"].split(".")[0] == name])
    if failures:
        raise AssertionError(f"suites failed: {failures}")
    return results


def phase_suites():
    """`repro_torch.benchmarks.run`'s suites on the card (all but the
    tuning slice's), with the launch counters reset just before and read
    just after; raises if a suite failed or a one-thread kernel never
    launched."""
    t0 = time.perf_counter()
    XK.reset_launches()
    K.reset_launches()
    results = _run_suites([n for n in suites.SUITES
                           if n not in TUNING_SUITES])
    launches = dict(XK.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"never launched by the suites: {missing}")
    mv = results["model_validation"]
    emit("suites", seconds=time.perf_counter() - t0, launches=launches,
         rmw_launches=dict(K.LAUNCHES), latency_ns=results["latency"],
         nrmse=mv["nrmse"], flagged=mv["flagged"],
         validation_rows=mv["rows"],
         calibrate_kept_priors=results["calibrate"]["kept_priors"])
    return results, launches


def serial_timing(gen, latency_ns):
    """The one-thread kernels at the suites' shapes beside their bounds and
    plain versions.  Bound: latency, as no two of their ops may overlap
    more than the card lets one thread's atomics: n (or steps) times the
    read chase's measured latency at the tier the table sits in (the L2
    for both shapes here)."""
    l2_ms = latency_ns["L2"]["read"] * 1e-6
    rng = np.random.default_rng(1)
    m, n = bw_suite.TABLE, bw_suite.N_OPS_SER
    tab = torch.zeros((m,), device="cuda")
    idx = torch.as_tensor(rng.integers(0, m, n), dtype=torch.int32).cuda()
    val = torch.as_tensor(rng.normal(size=n), dtype=torch.float32).cuda()
    host = (tab.cpu(), idx.cpu(), val.cpu())
    rows = [dict(kernel="serial_rmw", op="faa",
                 shape=f"bandwidth n={n} m={m} fp32",
                 ms=time_ms(lambda: XK.serial_rmw(tab, idx, val, "faa"), 20),
                 plain_ms=_host_ms(lambda: XK.serial_rmw(*host, "faa")),
                 library_ms=None, bound_ms=n * l2_ms,
                 bound_by="operations",
                 bound_note="n x the L2 read chase's latency")]
    m, steps = 1 << 22, 1 << 20
    table = XK.single_cycle(m, gen, device="cuda")
    plain_table = table._replace(words=table.words.cpu())
    rows.append(dict(kernel="chase", op="faa",
                     shape=f"latency L2 m={m} steps={steps}",
                     ms=time_ms(lambda: XK.chase(table, steps, "faa"), 3),
                     plain_ms=_host_ms(lambda: XK.chase_plain(
                         plain_table, steps, "faa"), 1),
                     library_ms=None, bound_ms=steps * l2_ms,
                     bound_by="operations",
                     bound_note="steps x the L2 read chase's latency"))
    for row in rows:
        emit("timing", **row)
    return rows


def _host_ms(fn, reps=3):
    """Host time of a plain version that runs on the CPU, in ms."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# 12. the sharded tier on 4 ranks sharing the card (this slice's main path)
# ---------------------------------------------------------------------------

SH_SHAPE, SH_AXES = (2, 2), ("pod", "dev")
SH_WORLD = 4
SH_N, SH_M = 1 << 22, 1 << 24    # ops a rank; global int32 slots (16 MB a
#                                  shard of four)
SH_STRATEGIES = ("naive", "oneshot", "hierarchical")
SH_RETRY_N, SH_RETRY_M = 64, 1 << 12
SH_REPS = 3
# the oracle groups: (op, distribution, dtype); every case below is held
# against its group's `rmw_serialized` over the batches in rank order
SH_GROUPS = [(op, dist, "int32") for op in ("faa", "swp", "min", "cas",
                                            "cas_perop")
             for dist in ("hot", "uniform")]
SH_GROUPS += [("faa", "hot", "float32"), ("faa", "uniform", "float32"),
              ("faa", "hot_normal", "float32"), ("min", "hot", "float32"),
              ("min", "uniform", "float32"), ("swp", "hot", "float32"),
              ("cas", "hot", "float32")]
F32_POOL = (0.0, -0.0, 1.0, -1.0, 2.0, float("nan"))


def _sh_case(group, strategy="oneshot", *, need_fetched=True,
             replicated=False, reverse=False, stats=False, gated=True):
    return dict(group=group, strategy=strategy, need_fetched=need_fetched,
                replicated=replicated, reverse=reverse, stats=stats,
                gated=gated)


def _sh_cases():
    """Every strategy x op (naive, oneshot, hierarchical x faa, swp, min,
    uniform cas; hot and uniform), per-op CAS, dense, 2 replicas x 2
    shards, reverse_ranks, a table-only CAS (BFS's call), stats; int32 and
    fp32."""
    out = []
    for op in ("faa", "swp", "min", "cas"):
        for dist in ("hot", "uniform"):
            for strategy in SH_STRATEGIES:
                out.append(_sh_case((op, dist, "int32"), strategy,
                                    stats=(op, dist, strategy)
                                    == ("faa", "hot", "oneshot")))
    for dist in ("hot", "uniform"):
        out.append(_sh_case(("cas_perop", dist, "int32")))
        out.append(_sh_case(("faa", dist, "int32"), "dense",
                            need_fetched=False))
    for op in ("faa", "swp", "min", "cas", "cas_perop"):
        out.append(_sh_case((op, "hot", "int32"), replicated=True))
    out.append(_sh_case(("faa", "hot", "int32"), "dense", need_fetched=False,
                        replicated=True))
    for strategy in SH_STRATEGIES:
        out.append(_sh_case(("swp", "hot", "int32"), strategy, reverse=True))
    out.append(_sh_case(("faa", "uniform", "int32"), reverse=True))
    out.append(_sh_case(("cas", "hot", "int32"), reverse=True))
    out.append(_sh_case(("cas_perop", "hot", "int32"), reverse=True))
    out.append(_sh_case(("cas", "hot", "int32"), need_fetched=False))
    for dist in ("hot", "uniform"):
        for strategy in SH_STRATEGIES:
            out.append(_sh_case(("faa", dist, "float32"), strategy))
    # fp32 FAA of normal values, ~2^21 a hot slot: held to float64 sums
    # (the sequential oracle's own rounding is the tolerance's size)
    out.append(_sh_case(("faa", "hot_normal", "float32")))
    for strategy in SH_STRATEGIES:
        out.append(_sh_case(("min", "hot", "float32"), strategy))
    out.append(_sh_case(("min", "uniform", "float32")))
    out.append(_sh_case(("swp", "hot", "float32"), "hierarchical"))
    out.append(_sh_case(("cas", "hot", "float32")))
    return out


def _sh_inputs(k, world, dev):
    """Group ``k``'s batches (world, SH_N) and table (SH_M,), made on the
    card from the group's seed, so every rank makes the same.  ``hot`` is
    the reference example's distribution (95% of every rank's ops on 8
    slots of shard 0); ``uniform`` spans the table and a few slots past
    it (dropped).  int32 values in [-8, 8] (CAS in [-1, 1]); fp32 FAA
    integer-valued (exact sums) or normal (``hot_normal``, uniform); fp32
    MIN/MAX/SWP/CAS from ±0, ±1, 2 and NaN."""
    op, dist, dtype = SH_GROUPS[k]
    g = torch.Generator(device=dev)
    g.manual_seed(1000 + k)
    shape = (world, SH_N)
    ri = lambda lo, hi, size: torch.randint(lo, hi, size, generator=g,
                                            device=dev, dtype=torch.int32)
    if dist.startswith("hot"):
        idx = torch.where(torch.rand(shape, generator=g, device=dev) < 0.95,
                          ri(0, 8, shape), ri(0, SH_M, shape))
    else:
        idx = ri(0, SH_M + 64, shape)
    lo, hi = (-1, 2) if op.startswith("cas") else (-8, 9)
    if dtype == "int32":
        vals, table, exps = ri(lo, hi, shape), ri(lo, hi, (SH_M,)), \
            ri(-1, 2, shape)
    elif op == "faa" and dist != "hot":
        vals = torch.randn(shape, generator=g, device=dev)
        table = torch.randn((SH_M,), generator=g, device=dev)
        exps = torch.zeros(shape, device=dev)
    elif op == "faa":
        vals, table = ri(lo, hi, shape).float(), ri(lo, hi, (SH_M,)).float()
        exps = torch.zeros(shape, device=dev)
    else:
        pool = torch.tensor(F32_POOL, device=dev)
        pick = lambda size: pool[ri(0, len(F32_POOL), size).long()]
        vals, table, exps = pick(shape), pick((SH_M,)), pick(shape)
    return idx, vals, exps, table


def _sh_oracle(k, inputs):
    """Group ``k``'s `rmw_serialized` over every rank's batch in rank
    order: (table, fetched, success), dropped ops fetching 0 and failing."""
    idx, vals, exps, table = inputs
    op = SH_GROUPS[k][0]
    kind = "cas" if op.startswith("cas") else op
    exp = exps.reshape(-1) if op == "cas_perop" else (
        torch.zeros_like(vals.reshape(-1)) if kind == "cas" else None)
    # out-of-range ops write nothing and report fetched 0, success False
    flat = idx.reshape(-1)
    valid = (flat >= 0) & (flat < SH_M)
    res = _serialized_dropping(table, flat, vals.reshape(-1), kind, exp)
    return (res[0], torch.where(valid, res[1], torch.zeros_like(res[1])),
            res[2] & valid)


def _sh_faa_f64(idx, vals, table0):
    """fp32 FAA over every rank's batch in rank order, summed in float64:
    the table (per-slot sums) and the fetched values (a stable sort by
    slot, then an exclusive cumsum a slot); dropped ops fetch 0."""
    m = table0.shape[0]
    flat = idx.reshape(-1).long()
    v = vals.reshape(-1).double()
    valid = (flat >= 0) & (flat < m)
    slot = torch.where(valid, flat, m)
    pad = torch.cat([table0.double(), table0.new_zeros(1, dtype=
                                                       torch.float64)])
    table = pad.clone().index_add_(0, slot, v)[:m]
    order = torch.sort(slot, stable=True).indices
    ss, vs = slot[order], v[order]
    excl = torch.cumsum(vs, 0) - vs
    start = torch.ones_like(ss, dtype=torch.bool)
    start[1:] = ss[1:] != ss[:-1]
    first = torch.where(start, torch.arange(ss.shape[0], device=ss.device),
                        0).cummax(0).values
    fetched = torch.empty_like(v)
    fetched[order] = pad[ss] + excl - excl[first]
    fetched = torch.where(valid, fetched, torch.zeros_like(fetched))
    return table.float(), fetched.float()


def _serialized_dropping(table, idx, vals, op, exp):
    """`core.rmw.rmw_serialized` (on the card, `serial_rmw`) with dropped
    ops on a scratch row past the table."""
    from repro_torch.core.rmw import rmw_serialized
    m = table.shape[0]
    pad = torch.cat([table, table.new_zeros(1)])
    res = rmw_serialized(pad, torch.where((idx >= 0) & (idx < m), idx, m),
                         vals, op, exp)
    return res.table[:m], res.fetched, res.success


def _bcast(mesh, x):
    """Rank 0's ``x`` on every rank (fp32 as its bits, bool as bytes)."""
    if x.dtype == torch.float32:
        return mesh.broadcast(x.view(torch.int32), SH_AXES).view(x.dtype)
    if x.dtype == torch.bool:
        return mesh.broadcast(x.to(torch.uint8), SH_AXES).bool()
    return mesh.broadcast(x, SH_AXES)


def _same(got, want, *, f32, faa_tol=None):
    """(equal, max abs err): bit for bit, NaN by isnan; or, for fp32 FAA,
    within rtol 1e-5 and ``faa_tol`` (atol)."""
    if got.shape != want.shape:
        return False, None
    if faa_tol is not None:
        err = _max_err(got, want)
        return bool(torch.allclose(got, want, rtol=1e-5, atol=faa_tol)), err
    if not f32:
        return bool(torch.equal(got, want)), None
    nan = torch.isnan(want)
    ok = torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))
    return bool(ok), None


def _sh_levels(mesh, op, n, m_global):
    """The engine backend `auto` picks at each level of each strategy (the
    pre-combine over n ops, the owner resolve over its received rows)."""
    from repro_torch.core import rmw_engine
    sel = lambda nn, mm, nf=True: rmw_engine.select_backend(
        op, nn, mm, device="cuda", dtype=torch.int32, need_fetched=nf)
    m_loc = m_global // SH_WORLD
    cap1 = min(n, m_loc * SH_SHAPE[0])
    return {"oneshot": {"combine": sel(n, n),
                        "resolve": sel(SH_WORLD * min(n, m_loc), m_loc)},
            "hierarchical": {"combine": sel(n, n),
                             "deputy": sel(SH_SHAPE[1] * cap1,
                                           SH_SHAPE[1] * cap1),
                             "resolve": sel(SH_SHAPE[0] * min(
                                 SH_SHAPE[1] * cap1, m_loc), m_loc)},
            "naive": {"resolve": sel(SH_WORLD * n, m_loc)},
            "dense": {"combine": sel(n, m_global, False)}}


def _kernel_split(fn):
    """Device time of ``fn``'s kernels and of its copies (host staging),
    from torch.profiler's CUPTI trace; None where it holds none."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    except (RuntimeError, AssertionError):   # no CUPTI trace here
        return None, None
    if not dev:
        return None, None
    copy = sum(e.duration_ns() for e in dev if "Memcpy" in e.name()
               or "Memset" in e.name()) / 1e6
    return sum(e.duration_ns() for e in dev) / 1e6 - copy, copy


def _sharded_rank(mesh, cfg):
    """One rank of the `sharded` phase; returns what it checked and timed.

    Rank 0 first runs every group's serialized oracle, each on its own
    stream (one thread each, side by side), and broadcasts them; the
    launch counts are reset after that, so they hold only the main path:
    every case through `atomics.execute` on a sharded table, `bfs_sharded`
    (cas, swp) and `execute_until` with every policy.  The timing runs
    come after the counts are read."""
    from repro_torch.core.bfs import bfs_sharded
    dev = torch.device("cuda")
    world = mesh.size(SH_AXES)
    me = mesh.index(SH_AXES)
    staged = mesh.probe(dev)
    out = dict(rank=mesh.rank, host_staged=list(staged), cases=[])
    t0 = time.perf_counter()
    oracles = {}
    if me == 0:
        # every group's inputs first, then each oracle on its own stream:
        # the one-thread loops run side by side
        inputs = [_sh_inputs(k, world, dev) for k in range(len(SH_GROUPS))]
        sync()
        for k, s in enumerate([torch.cuda.Stream() for _ in SH_GROUPS]):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                oracles[k] = _sh_oracle(k, inputs[k])
        sync()
        del inputs
    out["oracle_s"] = time.perf_counter() - t0
    K.reset_launches()
    XK.reset_launches()
    t_main = time.perf_counter()
    for k, (op, dist, dtype) in enumerate(SH_GROUPS):
        cases = [c for c in _sh_cases() if c["group"] == (op, dist, dtype)]
        if not cases:
            continue
        idx, vals, exps, table0 = _sh_inputs(k, world, dev)
        if me == 0:
            want = oracles.pop(k)
        else:                            # shapes to receive rank 0's into
            want = (torch.empty_like(table0),
                    torch.empty_like(vals.reshape(-1)),
                    torch.empty((world * SH_N,), dtype=torch.bool,
                                device=dev))
        want = [_bcast(mesh, w) for w in want]
        f32 = dtype == "float32"
        # fp32 FAA on normal values: gated against float64 sums; the
        # sequential oracle's distance is reported beside them
        want64 = (_sh_faa_f64(idx, vals, table0) if dist == "hot_normal"
                  else None)
        kind = "cas" if op.startswith("cas") else op
        for c in cases:
            rep = c["replicated"]
            axis, rep_axes = ("dev", "pod") if rep else (SH_AXES, ())
            n_shards = mesh.size(axis)
            m_loc = SH_M // n_shards
            shard = mesh.index(axis)
            rows = slice(shard * m_loc, (shard + 1) * m_loc)
            # reverse_ranks: rank r takes rank (world - 1 - r)'s batch, so
            # the reversed rank order replays the same stream, and the
            # same oracle holds
            src = world - 1 - me if c["reverse"] else me
            i, v, e = (t[src] for t in (idx, vals, exps))
            table = atomics.AtomicTable(table0[rows].clone(), axis=axis,
                                        replica_axes=rep_axes, mesh=mesh)
            aop = (atomics.Cas(i, v, expected=e if op == "cas_perop" else 0)
                   if kind == "cas" else atomics.OP_KINDS[kind](i, v))
            res = atomics.execute(table, aop, strategy=c["strategy"],
                                  need_fetched=c["need_fetched"],
                                  reverse_ranks=c["reverse"],
                                  collect_stats=c["stats"])
            sync()
            tol = None
            if f32 and op == "faa":
                occ = torch.bincount(idx[(idx >= 0) & (idx < SH_M)].long(),
                                     minlength=SH_M)
                tol = 1e-5 * math.sqrt(int(occ.max()))
            ref_t = want[0] if want64 is None else want64[0]
            ok_t, err_t = _same(res.table.data, ref_t[rows], f32=f32,
                                faa_tol=tol)
            row = dict(group=f"{op}/{dist}/{dtype}", strategy=c["strategy"],
                       need_fetched=c["need_fetched"], replicated=rep,
                       reverse=c["reverse"], gated=c["gated"], table=ok_t,
                       table_err=err_t)
            sl = slice(src * SH_N, (src + 1) * SH_N)
            if want64 is not None:
                row.update(reference="float64", faa_atol=tol,
                           seq_oracle_table_err=_max_err(
                               res.table.data, want[0][rows]),
                           seq_oracle_vs_f64_table_err=_max_err(
                               want[0][rows], want64[0][rows]))
            if c["need_fetched"]:
                ref_f = want[1] if want64 is None else want64[1]
                row["fetched"], row["fetched_err"] = _same(
                    res.fetched, ref_f[sl], f32=f32, faa_tol=tol)
                row["success"] = bool(torch.equal(res.success, want[2][sl]))
                if want64 is not None:
                    row.update(seq_oracle_fetched_err=_max_err(
                        res.fetched, want[1][sl]),
                        seq_oracle_vs_f64_fetched_err=_max_err(
                            want[1][sl], want64[1][sl]))
            if c["stats"]:
                flat = idx.reshape(-1)
                live = flat[(flat >= 0) & (flat < SH_M)]
                plain = stats_from_occupancy(
                    K.slot_counts_plain(live, SH_M), live.shape[0])
                row["stats"] = all(torch.equal(getattr(res.stats, f),
                                               getattr(plain, f))
                                   for f in ("n_ops", "distinct_slots",
                                             "max_occupancy",
                                             "occupancy_hist", "topk_slots",
                                             "topk_counts"))
                row["level_ops"] = [res.stats.level_ops_in.tolist(),
                                    res.stats.level_ops_out.tolist()]
            out["cases"].append(row)
        del want, want64
    out["cases_s"] = time.perf_counter() - t_main
    # bfs_sharded at scale 20 over all four ranks, both protocols
    t0 = time.perf_counter()
    s = np.load(cfg["src"], mmap_mode="r")
    d = np.load(cfg["dst"], mmap_mode="r")
    out["bfs"] = {}
    for op in ("cas", "swp"):
        sync()
        t1 = time.perf_counter()
        r = bfs_sharded(s, d, cfg["n"], root=cfg["root"], mesh=mesh,
                        axis=SH_AXES, op=op, device=dev)
        sync()
        out["bfs"][op] = dict(seconds=time.perf_counter() - t1,
                              levels=r.levels, edges=r.edges_traversed,
                              parent=r.parent.cpu() if me == 0 else None)
    out["bfs_s"] = time.perf_counter() - t0
    # execute_until on a fully contended CAS batch, every policy, against
    # the local tier (on the CPU, the plain versions: no launches counted)
    out["retry"] = {}
    for name in atomics.POLICIES:
        pol = (atomics.ExponentialBackoff(base_s=1e-5, max_s=1e-3)
               if name == "exponential" else atomics.POLICIES[name]())
        n = SH_RETRY_N

        def make_ops(slots, observed, where=dev):
            if slots is None:
                zeros = torch.zeros((n,), dtype=torch.int32, device=where)
                return atomics.Cas(zeros, zeros + 1, expected=zeros)
            return atomics.Cas(slots, observed + 1, expected=observed)

        runs = {}
        for tier, where in (("sharded", dev), ("local", "cpu")):
            table = atomics.make_table(
                SH_RETRY_M, torch.int32, device=where,
                **(dict(mesh=mesh, axis=SH_AXES) if tier == "sharded"
                   else {}))
            runs[tier] = atomics.execute_until(
                table, lambda s_, o_: make_ops(s_, o_, where),
                max_rounds=4 * n, policy=pol)
        sh, lo = runs["sharded"], runs["local"]
        full = mesh.all_gather(sh.table.data, SH_AXES)
        out["retry"][name] = dict(
            n=n, rounds=sh.n_rounds, pending=int(sh.pending.size),
            attempts=int(sh.rounds.sum()),
            history_equal=bool(sh.n_rounds == lo.n_rounds and all(
                np.array_equal(getattr(sh, f), getattr(lo, f))
                for f in ("rounds", "fetched", "success", "pending"))
                and torch.equal(full.cpu(), lo.table.data)))
    out["launches"] = {**K.LAUNCHES, **XK.LAUNCHES}
    out["main_s"] = time.perf_counter() - t_main
    # timing: ms per batch per strategy, the exchange (wall clock inside
    # the collectives, the card synchronised around each) beside the rest
    out["levels"] = _sh_levels(mesh, "faa", SH_N, SH_M)
    out["timing"] = []
    mesh.sync_timing = True
    for k, (op, dist, dtype) in enumerate(SH_GROUPS):
        if (op, dtype) != ("faa", "int32"):
            continue
        idx, vals, _, table0 = _sh_inputs(k, world, dev)
        table = atomics.AtomicTable(table0[me * (SH_M // world):(me + 1) * (
            SH_M // world)].clone(), axis=SH_AXES, mesh=mesh)
        for strategy in SH_STRATEGIES + ("dense",):
            nf = strategy != "dense"
            call = lambda: atomics.execute(table, atomics.Faa(idx[me],
                                                              vals[me]),
                                           strategy=strategy,
                                           need_fetched=nf)
            call()
            sync()
            mesh.exchange_s = 0.0
            t0 = time.perf_counter()
            for _ in range(SH_REPS):
                call()
            sync()
            wall = (time.perf_counter() - t0) / SH_REPS * 1e3
            exch = mesh.exchange_s / SH_REPS * 1e3
            kern, copy = _kernel_split(call)
            out["timing"].append(dict(
                dist=dist, strategy=strategy, need_fetched=nf, ms=wall,
                exchange_ms=exch, rest_ms=wall - exch, kernel_ms=kern,
                copy_ms=copy))
    mesh.sync_timing = False
    return out


def _nccl_rank(mesh, cfg):
    """The world-size-1 NCCL run: FAA (oneshot) and per-op CAS through
    `atomics.execute` on a one-shard table, against the serialized
    oracle; NCCL carries every collective (no host staging)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n, m = SH_N, SH_M
    idx = torch.randint(0, m + 64, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    vals = torch.randint(-1, 2, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    exps = torch.randint(-1, 2, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    table0 = torch.randint(-1, 2, (m,), generator=g, device=dev,
                           dtype=torch.int32)
    out = dict(backend=mesh.backend)
    for name, op, kind, exp in (("faa_oneshot", atomics.Faa(idx, vals),
                                 "faa", None),
                                ("cas_perop", atomics.Cas(idx, vals,
                                                          expected=exps),
                                 "cas", exps)):
        table = atomics.AtomicTable(table0.clone(), axis="dev", mesh=mesh)
        res = atomics.execute(table, op, strategy="oneshot")
        want = _serialized_dropping(table0, idx, vals, kind, exp)
        live = (idx >= 0) & (idx < m)
        out[name] = bool(torch.equal(res.table.data, want[0]) and torch.equal(
            res.fetched[live], want[1][live]) and torch.equal(
            res.success, want[2] & live))
    return out


def _nccl_pair_rank(mesh, cfg):
    """Two NCCL ranks on one card: one all-reduce (NCCL refuses them)."""
    x = torch.ones((1,), device="cuda")
    return float(mesh.all_reduce(x, "dev").item())


def phase_sharded(s, d, root, parents):
    """The sharded tier on 4 ranks sharing the card (gloo, CUDA tensors;
    the libraries already built, so the ranks load them), then the
    world-size-1 NCCL run and two NCCL ranks on the card.  Raises if a
    rank failed or a gated check did not hold; returns the kernel launches
    inside the ranks' main path, summed."""
    import shutil
    import tempfile
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        np.save(os.path.join(tmp, "src.npy"), s.astype(np.int32))
        np.save(os.path.join(tmp, "dst.npy"), d.astype(np.int32))
        cfg = dict(src=os.path.join(tmp, "src.npy"),
                   dst=os.path.join(tmp, "dst.npy"), n=1 << SCALE,
                   root=root)
        out = ranks.launch(f"{os.path.abspath(__file__)}:_sharded_rank",
                           SH_WORLD, mesh=(SH_SHAPE, SH_AXES),
                           device="cuda", args=(cfg,), timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    bad = [f"rank {o['rank']}: {c}" for o in out for c in o["cases"]
           if c["gated"] and not all(c.get(k, True) for k in (
               "table", "fetched", "success", "stats"))]
    for op in ("cas", "swp"):
        if not torch.equal(out[0]["bfs"][op]["parent"], parents[op].cpu()):
            bad.append(f"bfs_sharded {op}: parents differ from the local "
                       f"phase's")
    for o in out:
        # n ops in <= n rounds (immediate, exponential); shrink trades
        # rounds for fewer attempts (the reference's contract for it)
        rt = o["retry"]
        for name, r in rt.items():
            bound = (r["attempts"] < rt["immediate"]["attempts"]
                     if name == "shrink" else r["rounds"] <= r["n"])
            if not (r["history_equal"] and r["pending"] == 0 and bound):
                bad.append(f"rank {o['rank']}: execute_until {name}: {r}")
    launches = {k: sum(o["launches"][k] for o in out)
                for k in out[0]["launches"]}
    missing = [k for k in ("rmw_table", "rmw_table_fetched", "slot_counts",
                           "serial_rmw") if launches[k] == 0]
    if missing:
        bad.append(f"never launched inside the ranks: {missing}")
    t1 = time.perf_counter()
    nccl = ranks.launch(f"{os.path.abspath(__file__)}:_nccl_rank", 1,
                        mesh=((1,), ("dev",)), backend="nccl",
                        device="cuda", args=({},), timeout=300)[0]
    if not (nccl["faa_oneshot"] and nccl["cas_perop"]):
        bad.append(f"NCCL world-size-1 run: {nccl}")
    nccl["seconds"] = time.perf_counter() - t1
    try:
        pair = ranks.launch(f"{os.path.abspath(__file__)}:_nccl_pair_rank",
                            2, mesh=((2,), ("dev",)), backend="nccl",
                            device="cuda", args=({},), timeout=120,
                            collective_timeout_s=60)
        pair_error = f"no error: {pair}"
    except ranks.RankFailed as e:
        # NCCL's own words: the "Duplicate GPU" line, else the lines after
        # its "Last error:"
        lines = str(e).splitlines()
        dup = [ln for ln in lines if "Duplicate GPU" in ln]
        last = [k for k, ln in enumerate(lines) if "Last error" in ln]
        pair_error = " | ".join(
            dup[:1] or (lines[last[-1]:last[-1] + 3] if last
                        else lines[-3:]))[-600:]
    unchecked = [c for c in out[0]["cases"] if not c["gated"]]
    emit("sharded", ranks=SH_WORLD, mesh=dict(zip(SH_AXES, SH_SHAPE)),
         n_per_rank=SH_N, m_global=SH_M, seconds=wall,
         rank_seconds={k: max(o[k] for o in out) for k in (
             "oracle_s", "cases_s", "bfs_s", "main_s")},
         transport="gloo", host_staged=out[0]["host_staged"],
         cases=len(out[0]["cases"]), cases_checked_per_rank=sum(
             c["gated"] for c in out[0]["cases"]),
         not_gated=unchecked, bad=bad[:20],
         float64_faa=[dict(rank=o["rank"], **c) for o in out
                      for c in o["cases"] if c.get("reference")
                      == "float64"],
         stats_levels=[c.get("level_ops") for c in out[0]["cases"]
                       if "stats" in c],
         bfs={op: {k: v for k, v in r.items() if k != "parent"}
              for op, r in out[0]["bfs"].items()},
         retry={o["rank"]: o["retry"] for o in out[:1]},
         levels=out[0]["levels"], launches=launches,
         timing=[dict(rank=o["rank"], **t) for o in out
                 for t in o["timing"]],
         nccl_world1=nccl, nccl_two_ranks_one_card=pair_error)
    if bad:
        raise AssertionError(f"sharded phase: {bad[:10]}")
    return launches


# ---------------------------------------------------------------------------
# 13. the elastic tier on 4 ranks sharing the card (this slice's main path)
# ---------------------------------------------------------------------------

EL_N_POST = 1 << 20      # ops a rank in each batch after a migration
EL_HISTORY = (0, 1, 0, 1)  # the sharded phase's FAA groups: hot, uniform
EL_POST_OPS = ("faa", "cas", "swp")  # fetched FAA (stats), per-op CAS, SWP
EL_STEPS = 4
EL_CHAOS = ("seed=7,step=1.0@1,ckpt_save=1.0@1,ckpt_restore=1.0@1,"
            "reshard=1.0@1")
EL_REPS = 3


def _el_post_batch(seed, k, full, dev):
    """A batch after a migration, ``k`` rows of EL_N_POST ops (by flat
    index on the mesh that runs it), from ``seed``: half on 8 hot slots,
    half uniform with some past the table (dropped); values in [-8, 8];
    CAS expects each slot's value before the batch, so the first op on a
    slot succeeds."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (k, EL_N_POST)
    ri = lambda lo, hi: torch.randint(lo, hi, shape, generator=g, device=dev,
                                      dtype=torch.int32)
    idx = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                      ri(0, 8), ri(0, SH_M + 64))
    exps = full[idx.clamp(0, SH_M - 1).long()]
    return idx, ri(-8, 9), exps


def _el_flat_rows(table):
    """This member's rows of the whole table under ``table``'s layout."""
    lay = table.layout()
    return slice(*lay.rows_of_shard(lay.shard_of_device(table.mesh.flat)))


def _el_run(table, op, idx, vals, exps, stats=False):
    """One batch on the members of ``table``'s mesh (row = flat index);
    None outside it."""
    if not table.mesh.is_member:
        return None
    f = table.mesh.flat
    aop = (atomics.Cas(idx[f], vals[f], expected=exps[f]) if op == "cas"
           else atomics.OP_KINDS[op](idx[f], vals[f]))
    return atomics.execute(table, aop, collect_stats=stats)


def _el_after(world_mesh, tag, moved, never, full, seed, dev):
    """Check 3 after one migration: three batches (EL_POST_OPS) on the
    migrated table ``moved`` and the same global streams on ``never`` (a
    table that was never resharded), each against the other and against
    `rmw_serialized` over the stream in rank order (run on rank 0 of the
    world, on the card, and broadcast).  Returns the rows and the three
    tables after the batches."""
    rows = []
    k = len(moved.mesh.ranks)
    kn = len(never.mesh.ranks)
    for j, op in enumerate(EL_POST_OPS):
        idx, vals, exps = _el_post_batch(seed + j, k, full, dev)
        flat = idx.reshape(-1)
        if world_mesh.rank == 0:
            want = _serialized_dropping(full, flat, vals.reshape(-1), op,
                                        exps.reshape(-1) if op == "cas"
                                        else None)
            live = (flat >= 0) & (flat < SH_M)
            want = (want[0], torch.where(live, want[1], 0), want[2] & live)
        else:
            want = (torch.empty_like(full), torch.empty_like(flat),
                    torch.empty(flat.shape, dtype=torch.bool, device=dev))
        want = [_bcast(world_mesh, w) for w in want]
        stats = op == "faa"
        res = _el_run(moved, op, idx, vals, exps, stats=stats)
        res_n = _el_run(never, op, *(t.reshape(kn, -1)
                                     for t in (idx, vals, exps)))
        sync()
        row = dict(migration=tag, op=op, ranks=k)
        for name, r, n_rows in (("moved", res, k), ("never", res_n, kn)):
            if r is None:
                continue
            f = r.table.mesh.flat
            n = flat.shape[0] // n_rows
            sl = slice(f * n, (f + 1) * n)
            row[name] = bool(
                torch.equal(r.table.data, want[0][_el_flat_rows(r.table)])
                and torch.equal(r.fetched, want[1][sl])
                and torch.equal(r.success, want[2][sl]))
        if stats and res is not None:
            live = flat[(flat >= 0) & (flat < SH_M)]
            plain = stats_from_occupancy(K.slot_counts_plain(live, SH_M),
                                         live.shape[0])
            row["stats"] = all(torch.equal(getattr(res.stats, f),
                                           getattr(plain, f))
                               for f in ("n_ops", "distinct_slots",
                                         "max_occupancy", "occupancy_hist",
                                         "topk_slots", "topk_counts"))
        rows.append(row)
        moved = res.table if res is not None else moved
        never = res_n.table if res_n is not None else never
        full = want[0]
    return rows, moved, never, full


def _el_time(fn, reps=EL_REPS):
    """Median wall clock of ``fn`` in ms, the card synchronised around each
    call (the collectives run through gloo on the host)."""
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _el_recovery(mesh, table0, tmp, dev):
    """Check 5: `run_with_recovery` over a state holding the sharded table,
    one FAA batch of SH_N ops a rank a step through `atomics.execute`,
    with `reshard_tables` as the elastic hook; under the seeded plan and
    under none.  Returns the fault plan's stats, the run's failures and
    whether this rank's final shard equals the fault-free run's."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.elastic import reshard_tables
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     run_with_recovery)

    def fresh():
        return {"table": reshard_suite.shard_of(mesh, table0, SH_AXES),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(step, state):
        g = torch.Generator(device=dev)
        g.manual_seed(5000 + step)
        idx = torch.randint(0, SH_M + 64, (SH_WORLD, SH_N), generator=g,
                            device=dev, dtype=torch.int32)
        vals = torch.randint(-8, 9, (SH_WORLD, SH_N), generator=g,
                             device=dev, dtype=torch.int32)
        f = mesh.flat
        res = atomics.execute(state["table"], atomics.Faa(idx[f], vals[f]),
                              need_fetched=False)
        return {"table": res.table, "step": state["step"] + 1}

    def run(tag, plan):
        d = os.path.join(tmp, tag)

        def restore_fn():
            with use_mesh(mesh):
                got = ckpt.restore_latest_valid(d, fresh())
            return None if got is None else got[:2]

        res = run_with_recovery(
            step_fn, fresh, EL_STEPS,
            FaultConfig(max_failures=8, backoff_base_s=0),
            lambda s, st: ckpt.save(d, s, st), restore_fn,
            reshard_fn=lambda s: reshard_tables(s, mesh), chaos=plan)
        return res, restore_fn()

    t0 = time.perf_counter()
    plan = FaultPlan.from_spec(EL_CHAOS)
    res, final = run("chaos", plan)
    t1 = time.perf_counter()
    base_res, base = run("no_faults", FaultPlan.null())
    t2 = time.perf_counter()
    return dict(stats=plan.stats(), failures=res.failures,
                events=res.event_counts(), steps=res.steps_done,
                final_step=final[0], base_failures=base_res.failures,
                bit_equal=bool(final[0] == base[0] == EL_STEPS
                               and torch.equal(final[1]["table"].data,
                                               base[1]["table"].data)
                               and int(final[1]["step"]) == EL_STEPS),
                chaos_s=t1 - t0, no_faults_s=t2 - t1)


def _elastic_rank(mesh, cfg):
    """One rank of the `elastic` phase's 4-rank world.

    The launch counts are reset first, so they hold this slice's main
    path: the history, the three migrations (exchange; device_put onto
    the survivors and back), check 3's batches and oracles, the
    checkpoints and the recovery runs.  The timing runs come after they
    are read."""
    from repro_torch.atomics import reshard
    from repro_torch.atomics.layout import TableLayout
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import rmw_engine
    from repro_torch.runtime import elastic
    from repro_torch.runtime.elastic import survivors_mesh
    dev = torch.device("cuda")
    staged = mesh.probe(dev)
    me = mesh.flat
    out = dict(rank=mesh.rank, host_staged=list(staged), rows=[], bits={})
    elastic.reset_degraded()
    K.reset_launches()
    XK.reset_launches()
    t_main = time.perf_counter()
    # the history: the sharded phase's FAA batches, hot and uniform, twice
    groups = {k: _sh_inputs(k, SH_WORLD, dev) for k in set(EL_HISTORY)}
    table0 = groups[0][3]
    history = [groups[k][:2] for k in EL_HISTORY]
    src_t = reshard_suite.run_history(
        reshard_suite.shard_of(mesh, table0, SH_AXES), history,
        need_fetched=False)
    src = src_t.layout()
    full0 = reshard.gather_table(src_t.data, src, mesh)
    sync()
    out["history_s"] = time.perf_counter() - t_main
    # check 1: exchange, (pod, dev)-sharded -> dev-sharded, pod replicas
    dst = TableLayout.from_mesh(mesh, num_slots=SH_M, dtype=torch.int32,
                                axis=("dev",), replica_axes=("pod",))
    x_plan = reshard.plan_reshard(src, dst, dst_mesh=mesh, src_mesh=mesh,
                                  device=dev)
    moved = x_plan.execute(src_t)
    out["exchange_path"] = x_plan.path
    out["bits"]["exchange"] = bool(torch.equal(
        moved.data, full0[_el_flat_rows(moved)]))
    rows, _, never, full1 = _el_after(mesh, "exchange", moved, src_t, full0,
                                      100, dev)
    out["rows"] += rows
    # check 2: device_put onto the survivors (2 ranks of 4) and back
    surv = survivors_mesh(dict(mesh.shape), 1, axis="pod")
    shrunk = reshard.migrate(never, surv)
    grown = reshard.migrate(shrunk, mesh)
    out["shrink_path"] = reshard.plan_reshard(
        never.layout(), reshard.live_layout(shrunk), dst_mesh=surv,
        src_mesh=mesh).path
    out["grow_path"] = reshard.plan_reshard(
        reshard.live_layout(shrunk), grown.layout(), dst_mesh=mesh,
        src_mesh=surv).path
    if surv.is_member:
        out["bits"]["shrink"] = bool(torch.equal(
            shrunk.data, full1[_el_flat_rows(shrunk)]))
    out["bits"]["round_trip"] = bool(torch.equal(grown.data, never.data))
    rows, _, _, _ = _el_after(mesh, "shrink", shrunk, never, full1, 200, dev)
    out["rows"] += rows
    rows, after_g, _, full3 = _el_after(mesh, "grow", grown, never, full1,
                                        300, dev)
    out["rows"] += rows
    # check 4 (first half): two steps saved at 4 ranks
    ck = cfg["ckpt_dir"]
    ckpt.save(ck, 1, {"counters": never, "step": torch.tensor(1)})
    ckpt.save(ck, 2, {"counters": after_g, "step": torch.tensor(2)})
    if mesh.rank == 0:
        torch.save({"step1": full1.cpu(), "step2": full3.cpu()},
                   cfg["expected"])
    # check 5: recovery under the seeded plan
    out["recovery"] = _el_recovery(mesh, table0, cfg["tmp"], dev)
    out["degraded"] = dict(elastic.DEGRADED)
    sync()
    out["launches"] = {**K.LAUNCHES, **XK.LAUNCHES}
    out["main_s"] = time.perf_counter() - t_main
    # check 7: times (after the counts were read)
    spec = rmw_engine.default_spec(dev)
    n_hist = len(EL_HISTORY) * SH_WORLD * SH_N
    shrink_plan = reshard.plan_reshard(
        never.layout(), reshard.live_layout(shrunk), dst_mesh=surv,
        src_mesh=mesh, device=dev)
    grow_plan = reshard.plan_reshard(
        reshard.live_layout(shrunk), grown.layout(), dst_mesh=mesh,
        src_mesh=surv, device=dev)
    timing = []
    for tag, plan, table, replay_mesh, axis, rep in (
            ("exchange", x_plan, src_t, mesh, ("dev",), ("pod",)),
            ("device_put_shrink", shrink_plan, never, surv, SH_AXES, ()),
            ("device_put_grow", grow_plan, shrunk, mesh, SH_AXES, ())):
        k = len(replay_mesh.ranks)
        resplit = [(i.reshape(k, -1), v.reshape(k, -1)) for i, v in history]

        def replay():
            return reshard_suite.run_history(
                reshard_suite.shard_of(replay_mesh, table0, axis, rep),
                resplit, need_fetched=False)

        replayed = replay()
        replay_ok = (not replay_mesh.is_member or torch.equal(
            replayed.data, full0[_el_flat_rows(replayed)]))
        timing.append(dict(
            migration=tag, path=plan.path,
            migrate_ms=_el_time(lambda: plan.execute(table)),
            predicted_ms=plan.predicted_s[plan.path] * 1e3,
            predicted_all_ms={p: v * 1e3 for p, v in plan.predicted_s.items()
                              if math.isfinite(v)},
            replay_ms=_el_time(replay, reps=2), replay_ranks=k,
            replay_bits=bool(replay_ok),
            cost_replay_ms=reshard.cost_replay(
                spec, plan.dst, n_hist, n_batches=len(EL_HISTORY),
                need_fetched=False, device_type="cuda") * 1e3))
    out["timing"] = timing
    return out


def _elastic_restore_rank(mesh, cfg):
    """One rank of the second world (2 ranks): check 4's restore under its
    own mesh, the batch after it, and the walk back past a corrupted
    step."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import use_mesh
    dev = torch.device("cuda")
    mesh.probe(dev)
    want = torch.load(cfg["expected"])
    ck = cfg["ckpt_dir"]
    K.reset_launches()
    XK.reset_launches()
    like = {"counters": atomics.make_table(SH_M, torch.int32, device=dev,
                                           mesh=mesh, axis=SH_AXES),
            "step": torch.tensor(0)}
    out = dict(rank=mesh.rank)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        restored, _ = ckpt.restore(ck, 2, like)
    sync()
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3
    full = want["step2"].to(dev)
    tbl = restored["counters"]
    out["restored"] = bool(torch.equal(tbl.data, full[_el_flat_rows(tbl)])
                           and int(restored["step"]) == 2)
    rows, _, _, _ = _el_after(mesh, "restored_2_ranks", tbl, tbl, full,
                              400, dev)
    out["rows"] = rows
    mesh.all_reduce(torch.zeros(1, device=dev), SH_AXES)  # all restored
    if mesh.rank == 0:                 # one byte of the newest step's npz
        path = os.path.join(ck, "step-00000002", "arrays.npz")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    mesh.all_reduce(torch.zeros(1, device=dev), SH_AXES)  # all see it
    with use_mesh(mesh):
        got = ckpt.restore_latest_valid(ck, like)
    full1 = want["step1"].to(dev)
    out["walked_back_to"] = None if got is None else got[0]
    out["walk_back_bits"] = bool(got is not None and torch.equal(
        got[1]["counters"].data, full1[_el_flat_rows(got[1]["counters"])]))
    out["launches"] = {**K.LAUNCHES, **XK.LAUNCHES}
    return out


def phase_elastic():
    """The elastic tier on 4 ranks sharing the card (gloo, CUDA tensors),
    then a second world of 2 ranks that restores the 4-rank world's
    checkpoint.  Raises if a rank failed or a check did not hold; returns
    the kernel launches inside the ranks' main paths, summed."""
    import shutil
    import tempfile
    from repro_torch.launch import ranks
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        cfg = dict(tmp=tmp, ckpt_dir=os.path.join(tmp, "ckpt"),
                   expected=os.path.join(tmp, "expected.pt"))
        out = ranks.launch(f"{os.path.abspath(__file__)}:_elastic_rank",
                           SH_WORLD, mesh=(SH_SHAPE, SH_AXES),
                           device="cuda", args=(cfg,), timeout=900)
        t1 = time.perf_counter()
        out2 = ranks.launch(
            f"{os.path.abspath(__file__)}:_elastic_restore_rank", 2,
            mesh=((1, 2), SH_AXES), device="cuda", args=(cfg,),
            timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t2 = time.perf_counter()
    bad = []
    for o in out:
        r = o["rank"]
        if o["exchange_path"] != "exchange":
            bad.append(f"rank {r}: exchange planned {o['exchange_path']}")
        if (o["shrink_path"], o["grow_path"]) != ("device_put",
                                                  "device_put"):
            bad.append(f"rank {r}: shrink/grow paths {o['shrink_path']}, "
                       f"{o['grow_path']}")
        bad += [f"rank {r}: {k} not bit-equal" for k, v in o["bits"].items()
                if not v]
        rec = o["recovery"]
        fired = {s: v["fired"] for s, v in rec["stats"].items()
                 if v["fired"]}
        if fired != {"step": 1, "ckpt_save": 1, "ckpt_restore": 1,
                     "reshard": 1} or not rec["bit_equal"] \
                or rec["failures"] != 4 or rec["base_failures"]:
            bad.append(f"rank {r}: recovery {rec}")
        if any(o["degraded"].values()):
            bad.append(f"rank {r}: degraded {o['degraded']}")
        bad += [f"rank {r}: replay after {t['migration']} not bit-equal"
                for t in o["timing"] if not t["replay_bits"]]
    for o in out + out2:
        bad += [f"rank {o['rank']}: {row}" for row in o["rows"]
                if not all(row.get(k, True) for k in ("moved", "never",
                                                      "stats"))]
    for o in out2:
        if not o["restored"]:
            bad.append(f"2-rank world, rank {o['rank']}: restore differs")
        if o["walked_back_to"] != 1 or not o["walk_back_bits"]:
            bad.append(f"2-rank world, rank {o['rank']}: walk back "
                       f"{o['walked_back_to']}")
    launches = {k: sum(o["launches"][k] for o in out + out2)
                for k in out[0]["launches"]}
    missing = [k for k in ("rmw_table", "rmw_table_fetched", "slot_counts",
                           "serial_rmw") if launches[k] == 0]
    if missing:
        bad.append(f"never launched inside the ranks: {missing}")
    emit("elastic", ranks=SH_WORLD, mesh=dict(zip(SH_AXES, SH_SHAPE)),
         m_global=SH_M, history_ops_per_rank=len(EL_HISTORY) * SH_N,
         post_ops_per_rank=EL_N_POST, seconds=t2 - t0,
         world4_seconds=t1 - t0, world2_seconds=t2 - t1,
         rank_seconds={k: max(o[k] for o in out) for k in (
             "history_s", "main_s")},
         host_staged=out[0]["host_staged"],
         checks=len(out[0]["rows"]) + len(out2[0]["rows"]),
         recovery=out[0]["recovery"],
         restore_ms=[o["restore_ms"] for o in out2],
         degraded=out[0]["degraded"], launches=launches, bad=bad[:20],
         timing=[dict(rank=o["rank"], **t) for o in out
                 for t in o["timing"]])
    if bad:
        raise AssertionError(f"elastic phase: {bad[:10]}")
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 14. MoE: dbrx at full width, jamba, expert parallelism (this slice's path)
# ---------------------------------------------------------------------------

DBRX, JAMBA = "dbrx_132b", "jamba_1_5_large_398b"
# dbrx at full width (d 6144, 48 heads, GQA 8, head_dim 128, 16 experts,
# top 4, d_ff_expert 10752, vocab 100352); depth cut to 4 layers (6.52 GB a
# layer in bf16: the 40 do not fit one card), and to 2 for the f32 check
DBRX_LAYERS, DBRX_F32_LAYERS = 4, 2
D_HQ, D_HKV, D_D = 48, 8, 128
D_PREFILL, D_DECODE_VALID = 3523, 1600
# jamba at full width (d 8192, 64 heads over 8 KV heads of 128, SSD heads
# of P 64 and N 128 in chunks of 256, 16 experts top 2, d_ff 24,576, vocab
# 65,536); depth cut to 5 layers, its first five, which hold every layer
# kind: SSD with a dense MLP (layers 0, 2), SSD with MoE (1, 3), attention
# without positions and a dense MLP (4); about 48 GB in bf16 (an MoE layer
# is 19.3 GB).  The f32 check takes the first 2 (SSD + dense, SSD + MoE;
# about 48 GB)
JAMBA_LAYERS, JAMBA_F32_LAYERS = 5, 2
J_HQ, J_HKV, J_D = 64, 8, 128
# the bf16 served prefill logits of the first 4 prompts (3,523 to 1,292
# tokens) against the plain path routed as the kernel path chose: within
# GEMMA_FLOOR_FACTOR x the floor, the plain path with its attention through
# the kernel's own f32 function, routed the same, as serve_gemma gates
MOE_GATE_PROMPTS = 4
# moe_ep: one full-width dbrx MoE layer on 4 ranks sharing the card, a 2x2
# ("data", "model") mesh over gloo; x (2, 2048, 6144) in f32, batch and
# sequence split: 1,024 tokens a rank
EP_WORLD, EP_SHAPE, EP_AXES = 4, (2, 2), ("data", "model")
EP_X = (2, 2048, 6144)
# a capacity where nothing drops: every token's k assignments go to k
# distinct experts, so capacity_factor E / k gives each expert a slot for
# every token, locally (4,096) and on a rank (1,024)
EP_NO_DROP = 4.0
# the expert-parallel output against the local path where nothing drops:
# the same f32 products (TF32 off) over buffers of other shapes, (1, 16,
# 4096) rows locally and (2, 8, 1024) on a rank, which cuBLAS may block
# differently; dot products of K = 6,144 and 10,752 terms round at about
# eps sqrt(K) ~ 1e-5 of their scale, so two blockings differ by that; 1e-4
# is ten times it, and far under what one routing difference moves (a gate
# times an expert's output, about 0.1)
EP_TOL = 1e-4
# ... and a capacity at the mean load (capacity_factor 1), where experts
# overflow on a rank and across the mesh, so the global filter drops
EP_TIGHT = 1.0


@contextlib.contextmanager
def _served_config(cfg):
    """`BatchServer(arch, reduced=False)` builds ``cfg``: the server takes
    an arch name, so the cut config comes in through its module's config
    lookup for the block."""
    from repro_torch.launch import serve as serve_mod
    real = serve_mod.get_config
    serve_mod.get_config = lambda arch: cfg
    try:
        yield
    finally:
        serve_mod.get_config = real


@contextlib.contextmanager
def _routing_log():
    """Every MoE layer's routing in call order, as the model runs it (read
    by wrapping `moe._route`): the expert ids and the router's top-k margin
    (the k-th probability less the (k+1)-th: how near a tie the choice
    was)."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod._route
    log = []

    def logged(x2d, router_w, m):
        out = real(x2d, router_w, m)
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        log.append(dict(ids=torch.sort(out[1].long(), -1).values,
                        margin=top[:, m.top_k - 1] - top[:, m.top_k]))
        return out

    moe_mod._route = logged
    try:
        yield log
    finally:
        moe_mod._route = real


def _routing_flips(a, b, n_moe, limit=10):
    """Assignments whose expert set differs between two runs' logs: count,
    and the first few by (MoE call, its layer, token, margin in each
    run)."""
    flips, n = [], 0
    for call, (x, y) in enumerate(zip(a, b)):
        bad = (x["ids"] != y["ids"]).any(-1).nonzero().flatten().tolist()
        n += len(bad)
        flips += [dict(call=call, layer=call % n_moe, token=t,
                       margin_kernel=float(x["margin"][t]),
                       margin_plain=float(y["margin"][t]))
                  for t in bad[:limit - len(flips)]]
    return n, flips


@contextlib.contextmanager
def _routing_pinned(choices=None):
    """Without ``choices``: records each MoE call's expert ids, as
    `moe._route` chose them.  With them: routes each call to its recorded
    ids instead, in call order, with the router's probabilities there as
    gates, normalised as `moe._route` does (so a run on another path takes
    the same experts, and rounding moves only the gates)."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod._route
    rec = []
    pinned = iter(choices or ())

    def route(x2d, router_w, m):
        if choices is None:
            out = real(x2d, router_w, m)
            rec.append(out[1])
            return out
        ids = next(pinned)
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        gates = probs.gather(1, ids.long())
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        counts = torch.bincount(ids[:, 0].long(),
                                minlength=m.n_experts).to(torch.float32)
        return gates, ids, (probs.mean(0), counts)

    moe_mod._route = route
    try:
        yield rec
    finally:
        moe_mod._route = real


def _bf16_pinned_gate(name, model, prompts):
    """The served bf16 model's prefill logits of the first
    `MOE_GATE_PROMPTS` prompts through the kernels, against the plain path
    routed to the experts the kernel path chose (`_routing_pinned`): within
    `GEMMA_FLOOR_FACTOR` x the floor, the plain path with attention
    through the kernel's own f32 function (`flash_attention_plain`), routed
    the same, against that plain run.  Routing flips between the paths
    (near ties that rounding tips) are counted in the served runs; here
    they cannot hide a fault in the kernels' bf16 path."""
    errs, floors = [], []
    for p in prompts[:MOE_GATE_PROMPTS]:
        model.use_kernel = None
        with _routing_pinned() as chosen:
            kern = _prefill_logits(model, p, G_S_MAX)
        model.use_kernel = False
        with _routing_pinned(chosen):
            plain = _prefill_logits(model, p, G_S_MAX)
        model.use_kernel = None
        with _attention_through_plain_version(), _routing_pinned(chosen):
            floor = _prefill_logits(model, p, G_S_MAX)
        errs.append(_max_err(kern, plain))
        floors.append(_max_err(floor, plain))
    err, floor = max(errs), max(floors)
    if err > GEMMA_FLOOR_FACTOR * floor:
        raise AssertionError(f"{name} bf16 prefill logits, routing pinned: "
                             f"kernel path off the plain path by {err} > "
                             f"{GEMMA_FLOOR_FACTOR} x floor {floor}")
    return dict(bf16_pinned_logit_max_abs_err=err, bf16_pinned_floor=floor,
                bf16_pinned_gate=GEMMA_FLOOR_FACTOR * floor,
                bf16_pinned_prompts=[len(p) for p in
                                     prompts[:MOE_GATE_PROMPTS]])


def _strict_f32(cfg, prompts, n_prompts=2):
    """``cfg`` in f32 (TF32 off): prefill logits of the first prompts
    through the kernels and the plain paths, same weights (seed 0), within
    `SERVE_F32_LOGIT_ATOL`; routing flips between the two reported by
    token and margin."""
    m32 = LM(cfg.replace(dtype="float32"), seed=0, attn_impl="ref")
    with _routing_log() as kern_log:
        kern = [_prefill_logits(m32, p, G_S_MAX) for p in prompts[:n_prompts]]
    m32.use_kernel = False
    with _routing_log() as plain_log:
        plain = [_prefill_logits(m32, p, G_S_MAX)
                 for p in prompts[:n_prompts]]
    n_moe = sum(b.is_moe for b in m32.blocks)
    del m32
    torch.cuda.empty_cache()
    err = max(_max_err(a, b) for a, b in zip(kern, plain))
    n_flips, flips = _routing_flips(kern_log, plain_log, n_moe)
    if err > SERVE_F32_LOGIT_ATOL:
        raise AssertionError(f"{cfg.name} f32 prefill logits: kernel path "
                             f"off the plain path by {err} > "
                             f"{SERVE_F32_LOGIT_ATOL}; routing flips "
                             f"{n_flips}: {flips}")
    return dict(f32_layers=cfg.n_layers, f32_prompts=n_prompts,
                f32_logit_max_abs_err=err,
                f32_logit_atol=SERVE_F32_LOGIT_ATOL,
                f32_routing_flips=n_flips, f32_flips=flips,
                f32_min_margin=min(float(x["margin"].min())
                                   for x in plain_log))


def _moe_ranges(fn):
    """Each `moe.<stage>` range's host ms (its span on the host) and
    device ms (its kernels' time on the card, from torch.profiler's CUPTI
    trace; None where the trace holds none) during ``fn()``, summed over
    its calls."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    host, dev = {}, {}
    for e in prof.events():
        if e.name.startswith("moe.") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            k = e.name[len("moe."):]
            host[k] = host.get(k, 0.0) + e.cpu_time_total / 1e3
            dev[k] = dev.get(k, 0.0) + e.device_time_total / 1e3
    if not any(dev.values()):
        dev = {k: None for k in dev}
    return host, dev


def _moe_stages(block, cfg, s, reps=3):
    """One MoE layer by stage (route, rank, scatter, experts, combine) on
    (1, s, d) bf16 activations, from the ranges of a profiled run of
    ``reps`` calls after a warm-up: device ms a call, host ms a call."""
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(device="cuda").manual_seed(s)
    h = torch.randn((1, s, cfg.d_model), generator=g, device="cuda").to(
        block.moe["w1"].dtype)
    moe_mod.moe_ffn(block.moe, h, cfg)
    host, dev = _moe_ranges(lambda: [moe_mod.moe_ffn(block.moe, h, cfg)
                                     for _ in range(reps)])
    return dict(device_ms={k: v and v / reps for k, v in dev.items()},
                host_ms={k: v / reps for k, v in host.items()})


def _serve_moe(name, cfg, *, kernels):
    """``cfg`` through `BatchServer` on the card: the 8 requests of the
    serving phases (3523 to 319 tokens), 4 slots, 16 new tokens, with the
    launch counters reset just before and read just after (each of
    ``kernels`` must launch); then the same requests on the plain paths,
    the routing flips between the two runs (count, and the first by
    layer, token and margin), the bf16 gate with the plain path routed as
    the kernel path chose (`_bf16_pinned_gate`), and the device's busy and
    idle time for a
    prefill and 8 decode steps.  Returns (launches, fields to emit, the
    server, the prompts)."""
    t0 = time.perf_counter()
    with _served_config(cfg):
        server = BatchServer(name, reduced=False, slots=SERVE_SLOTS,
                             s_max=G_S_MAX, seed=0, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    blocks = server.model.blocks
    n_attn = sum(b.kind == "attn" for b in blocks)
    n_ssm = sum(b.kind == "ssm" for b in blocks)
    if not any(b.is_moe for b in blocks):
        raise AssertionError(f"{name}: no MoE layer in {cfg}")
    rng = np.random.default_rng(0)
    lengths = [int(v) for v in rng.integers(256, 4097, SERVE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, v).tolist() for v in lengths]
    _prefill_logits(server.model, prompts[0][:300], G_S_MAX)   # warm-up
    sync()

    reqs = _requests(prompts)
    with _routing_log() as kern_log:
        FK.reset_launches()              # the serving path starts here
        SK.reset_launches()
        stats = server.run(reqs)
        launches = {**FK.LAUNCHES, **SK.LAUNCHES}   # ... and ends here
    timing = dict(server.timing)
    decode_tokens = SERVE_REQUESTS * (SERVE_MAX_NEW - 1)
    want = {"flash_attention": n_attn * (SERVE_REQUESTS + decode_tokens),
            "ssd_chunk": n_ssm * SERVE_REQUESTS}
    if launches != want or 0 in [want[k] for k in kernels]:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if stats["completed"] != SERVE_REQUESTS or stats["tokens"] != \
            decode_tokens:
        raise AssertionError(f"{name}: serve stats {stats}")
    for r in reqs:
        lg = r.prefill_logits
        if lg.shape != (cfg.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"{name} request {r.rid}: bad logits")
        if len(r.out) != SERVE_MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{name} request {r.rid}: bad tokens "
                                 f"{r.out}")

    # the same requests on the same weights through the plain paths
    server.model.use_kernel = False
    server.timing = {k: type(v)() for k, v in server.timing.items()}
    plain = _requests(prompts)
    with _routing_log() as plain_log:
        plain_stats = server.run(plain)
    if {**FK.LAUNCHES, **SK.LAUNCHES} != want:
        raise AssertionError(f"{name}: the plain path launched a kernel")
    server.model.use_kernel = None
    n_moe = sum(b.is_moe for b in blocks)
    n_flips, flips = _routing_flips(kern_log, plain_log, n_moe)
    del kern_log, plain_log
    gate = _bf16_pinned_gate(name, server.model, prompts)
    logit_err = max(_max_err(a.prefill_logits, b.prefill_logits)
                    for a, b in zip(reqs, plain))
    same_tok = sum(x == y for a, b in zip(reqs, plain)
                   for x, y in zip(a.out, b.out))

    first = torch.tensor([prompts[0]], device="cuda")
    box = {}

    def prefill():
        box["cache"] = server.model.prefill({"tokens": first}, G_S_MAX)[0]

    def decode(steps=8):
        tok = first[:, -1:]
        for _ in range(steps):
            server.model.decode_step(box["cache"], {"tokens": tok})

    names = FA_KERNELS + ("ssd_chunk_kernel",)
    fields = dict(
        arch=name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, dtype=cfg.dtype,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        d_ff_expert=cfg.moe.d_ff_expert,
        layers={"attn": n_attn, "ssm": n_ssm, "moe": n_moe},
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in server.model.parameters()),
        init_s=init_s, prompt_lengths=lengths, slots=SERVE_SLOTS,
        max_new=SERVE_MAX_NEW, stats=stats, plain_stats=plain_stats,
        launches=launches,
        prefill_ms_per_request=1e3 * timing["prefill_s"]
        / timing["prefills"],
        decode_ms_per_token=1e3 * timing["decode_s"]
        / timing["decode_steps"],
        plain_prefill_ms_per_request=1e3 * server.timing["prefill_s"]
        / server.timing["prefills"],
        plain_decode_ms_per_token=1e3 * server.timing["decode_s"]
        / server.timing["decode_steps"],
        prefill_trace=dict(prompt=lengths[0],
                           **_device_trace(prefill, names)),
        decode_trace_per_token=_device_trace(decode, names, steps=8),
        bf16_prefill_logit_max_abs_err=logit_err,
        plain_logit_std=float(plain[0].prefill_logits.std()),
        greedy_tokens_equal=f"{same_tok}/{SERVE_REQUESTS * SERVE_MAX_NEW}",
        bf16_routing_flips=n_flips, bf16_first_flips=flips, **gate)
    return launches, fields, server, prompts


def phase_flash_dbrx(gen):
    """flash_attention at dbrx's shapes (48 query heads over 8 KV heads of
    128, bf16) and jamba's (64 over 8 of 128): the prefill of the longest
    served prompt (3,523 rows) and a decode call at 1,600 rows, against the
    plain version within one bf16 ulp (`FA_GEMMA_BF16`); each beside its
    bound, the plain version and SDPA."""
    errs, rows = {}, []
    for arch, hq, hkv, d in (("dbrx", D_HQ, D_HKV, D_D),
                             ("jamba", J_HQ, J_HKV, J_D)):
        for shape, s, cached in (("prefill", D_PREFILL, 0),
                                 ("decode", 1, D_DECODE_VALID - 1)):
            args, kw = _attention_args(gen, s, cached, hq, hkv, d)
            got = FK.flash_attention(*args, **kw)
            want = FK.flash_attention_plain(*args, **kw)
            errs[f"{arch}_{shape}"] = _check_fa(
                got, want, f"{arch} {shape} bf16", **FA_GEMMA_BF16)
            rows.append(dict(arch=arch, **_fa_row(shape, args, kw, s, cached,
                                                  hq, hkv, d)))
    emit("flash_dbrx", tol=FA_GEMMA_BF16, max_abs_err=errs, rows=rows)
    return max(errs.values())


def phase_serve_dbrx():
    """dbrx at full width and 4 layers in bf16 through `BatchServer`
    (`flash_attention` launches must be 4 x (8 + 120) = 512), the MoE
    layer's time by stage at a prefill's and a decode's shape; then, with
    the bf16 model freed, the strict check at 2 layers in f32 (about 31
    GB)."""
    from repro_torch.configs import get_config
    cfg = get_config(DBRX).replace(n_layers=DBRX_LAYERS)
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.vocab_size, cfg.dtype) != (6144, D_HQ, D_HKV, D_D, 16, 4,
                                           10752, 100352, "bfloat16"):
        raise AssertionError(f"not dbrx at full width: {cfg}")
    launches, fields, server, prompts = _serve_moe(
        DBRX, cfg, kernels=("flash_attention",))
    block = next(b for b in server.model.blocks if b.is_moe)
    fields["moe_stage_ms"] = {
        "prefill_3523": _moe_stages(block, cfg, D_PREFILL),
        "decode": _moe_stages(block, cfg, 1, reps=20)}
    del server, block
    torch.cuda.empty_cache()
    fields.update(_strict_f32(cfg.replace(n_layers=DBRX_F32_LAYERS),
                              prompts))
    emit("serve_dbrx", **fields)
    return launches


def phase_serve_jamba():
    """jamba at full width and 5 layers (every layer kind) in bf16 through
    `BatchServer` (`ssd_chunk` and `flash_attention` must both launch: 4 x
    8 and 1 x 128); then, with the bf16 model freed, the strict check at 2
    layers in f32 (about 48 GB)."""
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA).replace(n_layers=JAMBA_LAYERS)
    if (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk,
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.vocab_size, cfg.dtype) != (8192, J_HQ, J_HKV, J_D, 64, 128,
                                           256, 16, 2, 24576, 65536,
                                           "bfloat16"):
        raise AssertionError(f"not jamba at full width: {cfg}")
    launches, fields, server, prompts = _serve_moe(
        JAMBA, cfg, kernels=("flash_attention", "ssd_chunk"))
    kinds = [(b.kind, b.is_moe) for b in server.model.blocks]
    if set(kinds) != {("ssm", False), ("ssm", True), ("attn", False)}:
        raise AssertionError(f"jamba's 5 layers miss a kind: {kinds}")
    del server
    torch.cuda.empty_cache()
    fields.update(_strict_f32(cfg.replace(n_layers=JAMBA_F32_LAYERS),
                              prompts))
    emit("serve_jamba", ssm=dataclasses.asdict(cfg.ssm), **fields)
    return launches


def _ep_config(capacity_factor, policy):
    """One dbrx MoE layer at full width, in f32."""
    from repro_torch.configs import get_config
    cfg = get_config(DBRX).replace(n_layers=1, dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor, overflow_policy=policy))


def _ep_params(cfg, experts, rows):
    """The layer's weights for ``experts`` and the d-rows ``rows`` of
    w1/w3 (w2: its rows of f), each expert's drawn from its own seed, so a
    rank's shard holds exactly the global tensor's values there."""
    m, d = cfg.moe, cfg.d_model
    f = m.d_ff_expert
    out = {"router": torch.randn(
        (d, m.n_experts), generator=torch.Generator(device="cuda")
        .manual_seed(11), device="cuda") * d ** -0.5}
    for w, (din, dout) in enumerate(((d, f), (d, f), (f, d))):
        parts = []
        for e in experts:
            g = torch.Generator(device="cuda").manual_seed(100 + 3 * e + w)
            full = torch.randn((din, dout), generator=g, device="cuda")
            parts.append((full[rows(din)] * din ** -0.5).clone())
            del full
        out[("w1", "w3", "w2")[w]] = torch.stack(parts)
    return out


def _ep_x():
    g = torch.Generator(device="cuda").manual_seed(12)
    return torch.randn(EP_X, generator=g, device="cuda")


@contextlib.contextmanager
def _ep_observed(mesh):
    """What `moe._ep_ffn` did on this rank, read at the module's seams:
    the routing's expert ids (`moe._route`), the local slot ranks
    (`moe._priority_rank`), the fetched sharded FAA's global arrival ranks
    (`atomics.execute` with ``need_fetched``) and the tensors this rank
    sent through ``mesh.all_to_all`` (the dispatch buffer among them)."""
    from repro_torch.models import moe as moe_mod
    seen = {"global_rank": None, "sent": []}
    route, rank, execute = moe_mod._route, moe_mod._priority_rank, \
        atomics.execute

    def route_(*a):
        out = route(*a)
        seen["ids"] = out[1]
        return out

    def rank_(*a):
        seen["rank"] = rank(*a)
        return seen["rank"]

    def execute_(table, op, **kw):
        res = execute(table, op, **kw)
        if kw.get("need_fetched", True):
            seen["global_rank"] = res.fetched
        return res

    def all_to_all_(x, axis):
        seen["sent"].append(x)
        return type(mesh).all_to_all(mesh, x, axis)

    moe_mod._route, moe_mod._priority_rank = route_, rank_
    atomics.execute, mesh.all_to_all = execute_, all_to_all_
    try:
        yield seen
    finally:
        moe_mod._route, moe_mod._priority_rank = route, rank
        atomics.execute = execute
        del mesh.all_to_all


def _ep_kept(seen, plan, cfg):
    """Which assignments the dispatch kept, read from the buffer it sent:
    an assignment (expert e, local rank r < capacity) was kept iff its row
    (e's shard, e's local row, r) holds a token (x has no zero row)."""
    e_loc, cap = cfg.moe.n_experts // plan.ep, plan.capacity
    send = next(t for t in seen["sent"] if t.dim() == 3
                and t.shape[:2] == (plan.ep, e_loc * cap))
    full = send.abs().sum(-1) != 0
    flat, r = seen["ids"].reshape(-1).long(), seen["rank"].long()
    slot = (flat % e_loc) * cap + r.clamp(max=cap - 1)
    return (r < cap) & full[flat // e_loc, slot]


def _moe_ep_rank(mesh, cfg):
    """One rank of the `moe_ep` phase: its shards of the layer's weights,
    the global x, then the rank's body of the expert-parallel layer
    (`moe._ep_ffn`, which `moe_ffn` runs under the mesh on its cuts of the
    global weights) three times, the launch counts reset just before, each
    call profiled by stage: where nothing drops, then under
    swp_drop_newest at the default capacity and at the mean load."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe as moe_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    staged = mesh.probe(dev)
    no_drop = _ep_config(EP_NO_DROP, "swp_drop_newest")
    default = _ep_config(1.25, "swp_drop_newest")
    tight = _ep_config(EP_TIGHT, "swp_drop_newest")
    ep = mesh.shape["model"]
    fsdp = mesh.size("data")
    e_loc = default.moe.n_experts // ep
    i, j = mesh.index("model"), mesh.index("data")
    params = _ep_params(default, range(i * e_loc, (i + 1) * e_loc),
                        lambda n: slice(j * n // fsdp, (j + 1) * n // fsdp))
    x = _ep_x()
    sync()
    K.reset_launches()
    XK.reset_launches()
    out = dict(rank=mesh.rank, host_staged=list(staged))
    with use_mesh(mesh):
        for name, cfg_ in (("no_drop", no_drop), ("default", default),
                           ("tight", tight)):
            box = {}

            def call():
                box["y"], box["aux"] = moe_mod._ep_ffn(params, x, cfg_, mesh)

            with _ep_observed(mesh) as seen:
                host, devt = _moe_ranges(call)
            plan = moe_mod.ep_plan(mesh, cfg_, *EP_X[:2])
            gr = seen["global_rank"]
            out[name] = dict(
                aux=float(box["aux"]), plan=dataclasses.asdict(plan),
                ids=seen["ids"].cpu(), local_rank=seen["rank"].cpu(),
                keep=_ep_kept(seen, plan, cfg_).cpu(),
                global_rank=None if gr is None else gr.cpu(),
                host_ms=host, device_ms=devt)
            if name == "no_drop":
                y = box["y"]
            del box, seen
    out["launches"] = {**K.LAUNCHES, **XK.LAUNCHES}
    out.update(
        y=y.cpu() if mesh.rank == 0 else None,
        y_abs_sum=float(y.double().abs().sum()),
        peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def phase_moe_ep():
    """Expert parallelism on 4 ranks sharing the card (gloo): one dbrx MoE
    layer at full width, x (2, 2048, 6144) f32, 1,024 tokens a rank.
    Raises unless (1) where nothing drops, the gathered output equals the
    local `moe_ffn` within `EP_TOL`; (2) under swp_drop_newest, at the
    default capacity and at the mean load, every assignment's global
    arrival rank equals a host recount in rank order (data-major,
    model-minor), exactly, and an assignment is kept exactly where its
    local and global ranks are under their capacities; (3) the aux loss
    equals the local path's within 1e-5 relative.  Returns the RMW kernels' launches inside
    the ranks, summed."""
    from repro_torch.launch import ranks
    from repro_torch.models import moe as moe_mod
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = ranks.launch(f"{os.path.abspath(__file__)}:_moe_ep_rank",
                       EP_WORLD, mesh=(EP_SHAPE, EP_AXES), device="cuda",
                       args=({},), timeout=900)
    ranks_s = time.perf_counter() - t0
    bad = []
    # the local path on the same x and weights (no mesh)
    no_drop = _ep_config(EP_NO_DROP, "swp_drop_newest")
    e = no_drop.moe.n_experts
    params = _ep_params(no_drop, range(e), lambda n: slice(0, n))
    x = _ep_x()
    t1 = time.perf_counter()
    want, aux_local = moe_mod.moe_ffn(params, x, no_drop)
    sync()
    local_s = time.perf_counter() - t1
    del params
    y = out[0]["y"].cuda()
    err = _max_err(y, want)
    if not torch.allclose(y, want, rtol=EP_TOL, atol=EP_TOL):
        bad.append(f"no-drop output off the local path by {err}")
    if not all(bool(o["no_drop"]["keep"].all()) for o in out):
        bad.append("an assignment dropped at the no-drop capacity")
    if len({o["y_abs_sum"] for o in out}) != 1:
        bad.append(f"ranks gathered different outputs: "
                   f"{[o['y_abs_sum'] for o in out]}")
    del y, want, x
    torch.cuda.empty_cache()
    # (2) the global arrival ranks: a host recount over the ranks in mesh
    # order (the world rank here: data-major, model-minor); and the drops:
    # kept exactly where the local and the global rank are both under
    # their capacities
    drops = {}
    for name in ("default", "tight"):
        runs = [o[name] for o in out]
        ids = torch.cat([r["ids"].reshape(-1) for r in runs]).numpy()
        recount = np.zeros_like(ids)
        seen = {}
        for n, ex in enumerate(ids):
            recount[n] = seen.get(int(ex), 0)
            seen[int(ex)] = recount[n] + 1
        got = torch.cat([r["global_rank"] for r in runs]).numpy()
        cap, cap_g = runs[0]["plan"]["capacity"], \
            runs[0]["plan"]["global_capacity"]
        if not np.array_equal(got, recount):
            bad.append(f"{name}: global arrival ranks differ from the host "
                       f"recount in {int((got != recount).sum())} of "
                       f"{len(got)}")
        local_ok = torch.cat([r["local_rank"] < cap for r in runs])
        global_ok = torch.from_numpy(got < cap_g)
        keep = torch.cat([r["keep"] for r in runs])
        if not torch.equal(keep, local_ok & global_ok):
            bad.append(f"{name}: kept is not (local rank < {cap}) & "
                       f"(global rank < {cap_g})")
        drops[name] = dict(capacity=cap, global_capacity=cap_g,
                           assignments=len(got), kept=int(keep.sum()),
                           dropped_local=int((~local_ok).sum()),
                           dropped_global_only=int(
                               (local_ok & ~global_ok).sum()))
    # (3) the aux loss
    aux = float(aux_local)
    for o in out:
        for a in (o["no_drop"]["aux"], o["default"]["aux"],
                  o["tight"]["aux"]):
            if abs(a - aux) > 1e-5 * abs(aux):
                bad.append(f"rank {o['rank']} aux {a} != local {aux}")
    launches = {k: sum(o["launches"][k] for o in out)
                for k in out[0]["launches"]}
    for k in ("rmw_table", "rmw_table_fetched"):
        if launches[k] == 0:
            bad.append(f"{k} never launched inside the ranks")
    # host ms by range, the slowest rank (gather, atomics and exchange are
    # host-staged gloo collectives, and an exchange's span includes the wait
    # for the kernels queued before it); device ms by range, the slowest
    stage = {f: {k: max((o["default"][f][k] for o in out
                         if o["default"][f][k] is not None), default=None)
                 for k in out[0]["default"][f]}
             for f in ("host_ms", "device_ms")}
    emit("moe_ep", ranks=EP_WORLD, mesh=dict(zip(EP_AXES, EP_SHAPE)),
         x=list(EP_X), dtype="float32", tokens_per_rank=EP_X[0] * EP_X[1]
         // EP_WORLD, transport="gloo", host_staged=out[0]["host_staged"],
         plan=out[0]["default"]["plan"], seconds=time.perf_counter() - t0,
         ranks_s=ranks_s, local_s=local_s,
         no_drop_max_abs_err=err, tol=EP_TOL, drops=drops,
         aux_local=aux, aux_ranks=[(o["no_drop"]["aux"], o["default"]["aux"],
                                    o["tight"]["aux"]) for o in out],
         stage_ms_max_over_ranks=stage,
         stage_ms_no_drop_rank0={f: out[0]["no_drop"][f]
                                 for f in ("host_ms", "device_ms")},
         peak_gb=[o["peak_gb"] for o in out], launches=launches,
         bad=bad[:10])
    if bad:
        raise AssertionError(f"moe_ep phase: {bad}")
    return launches


# ---------------------------------------------------------------------------
# 14. training: gemma_2b at full width, its f32 step against f64, the
#     fault-tolerance contract, deepseek_v3 reduced; 15. deepseek_v3 served
# ---------------------------------------------------------------------------

# the trainer's own shapes: 8 sequences of 256 tokens, 30 steps, no remat
T_ARCH, T_STEPS, T_SEQ, T_BATCH = "gemma_2b", 30, 256, 8
BF16_PEAK = 989e12       # H100 SXM dense bf16, NVIDIA data sheet
# f32 against f64 on one step (TF32 off): the loss and the grad norm are
# sums whose f32 rounding is about eps sqrt(terms) ~ 1e-5 of their scale
# at the most (2,048 tokens of 256,000 logits); each gradient leaf's
# relative L2 error 1e-4, ten times what f32 sums of K <= 16,384 terms give
T_LOSS_RTOL, T_GRAD_TOL = 1e-5, 1e-4
# train_recovery: train_100m's ~110M config, the verify recipe's chaos spec
R_STEPS, R_CHAOS = 8, "seed=3,step=1.0@2,ckpt_save=1.0@1"
# serve_deepseek: the first 4 layers (3 dense, then MoE: every layer kind)
DS, DS_LAYERS = "deepseek_v3_671b", 4
# the MLA layer in f32 against f64 (TF32 off), and decode through the
# latent cache against a prefill of the same tokens in f32: sums of K <=
# 16,384 terms round at about eps sqrt(K) ~ 1e-5 of their scale; 1e-4 of
# the output's largest magnitude
DS_MLA_TOL = 1e-4
DS_MLA_PREFILL, DS_MLA_DECODE = 1024, 4


@contextlib.contextmanager
def _no_kernel_launched(what):
    """The block must launch none of the port's kernels: training takes
    the plain paths (no kernel has a backward), MLA the plain math."""
    mods = (K, SK, FK, XK)
    for mod in mods:
        mod.reset_launches()
    yield
    ran = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    if ran:
        raise AssertionError(f"{what} launched kernels: {ran}")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _train_batch(vocab, step=0, seed=0):
    """The trainer's batch (8 x 256) of step ``step`` over ``vocab``."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    return synthetic_batch(DataConfig(seq_len=T_SEQ, global_batch=T_BATCH,
                                      vocab_size=vocab, seed=seed),
                           step, device="cuda")


def _profiled_train_step(cfg):
    """The device's busy and idle time over one train step at full width
    (the third; two warm up), and the step's kernel count."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, init_state
    model = LM(cfg, seed=0, use_kernel=False, attn_impl="chunked",
               remat_policy="none", loss_chunk=2048)
    opt = AdamWConfig(warmup_steps=7, total_steps=T_STEPS)
    step = make_train_step(model, opt)
    box = {"params": dict(model.named_parameters())}
    box["state"] = init_state(box["params"], opt)

    def one(i):
        batch = _train_batch(cfg.vocab_size, i)
        box["params"], box["state"], m = step(box["params"], box["state"],
                                              batch)
        return float(m["loss"])

    for i in range(2):
        one(i)
    trace = _device_trace(lambda: one(2), ("gemm", "nvjet"), top=12)
    del model, box, step
    torch.cuda.empty_cache()
    return trace


def phase_train_gemma():
    """gemma_2b at full width through `launch.train.train(reduced=False)`:
    bf16 parameters, f32 master and moments, 8 x 256 tokens, 30 steps, no
    remat, no checkpoint directory; once with deterministic algorithms (the
    trainer's default) and once without, for what exactness costs.  The
    losses must be finite and the last 5 below the first 5; no kernel may
    launch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    cfg = get_config(T_ARCH)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) != (
            18, 2048, 8, 1, 256, 16384, 256000, "bfloat16"):
        raise AssertionError(f"not gemma_2b at full width: {cfg}")
    n = cfg.param_count()
    tokens = T_SEQ * T_BATCH
    gib = 2 ** 30
    logits = T_BATCH * T_SEQ * cfg.vocab_size * 4
    reckoned = {"params_bf16": 2 * n / gib, "master_f32": 4 * n / gib,
                "moments_f32": 8 * n / gib, "grads_bf16": 2 * n / gib,
                "logits_chunk_f32": logits / gib,
                "logits_grad_f32": logits / gib}
    reckoned["total"] = sum(reckoned.values())
    runs = {}
    with _no_kernel_launched("train_gemma"):
        for det in (True, False):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = train_mod.train(T_ARCH, steps=T_STEPS, seq_len=T_SEQ,
                                  global_batch=T_BATCH, reduced=False,
                                  remat_policy="none", log_every=1,
                                  device="cuda", deterministic=det)
            wall = time.perf_counter() - t0
            hist = out["history"]
            secs = [h["sec"] for h in hist]
            step_s = float(np.median(secs[3:]))
            runs["deterministic" if det else "default"] = dict(
                losses=[h["loss"] for h in hist],
                grad_norms=[h["grad_norm"] for h in hist],
                step_ms=1e3 * step_s, step_ms_all=[1e3 * s for s in secs],
                tokens_per_s=tokens / step_s,
                train_mfu=6 * n * tokens / step_s / BF16_PEAK,
                peak_gib=torch.cuda.max_memory_allocated() / gib,
                wall_s=wall, steps_done=out["steps_done"])
            del out
        trace = _profiled_train_step(cfg)
    det = runs["deterministic"]
    losses = det["losses"]
    if len(losses) != T_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_gemma losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train_gemma: loss did not fall: {losses}")
    emit("train_gemma", arch=T_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=n,
         mfu_counts=("6 N tokens / step time / 989 TFLOP/s: N every "
                     "parameter, the tied embedding once (its head "
                     "product); attention's score products not counted"),
         steps=T_STEPS, seq_len=T_SEQ, global_batch=T_BATCH,
         tokens_per_step=tokens, memory_reckoned_gib=reckoned,
         exactness_cost=det["step_ms"] / runs["default"]["step_ms"],
         profiled_step=trace, **runs)


def _master_checks(a, b, opt, init, ndims):
    """The f32 step's master weights (``a``) against (1) f64 AdamW applied
    to the f32 step's own gradients, from the same weights widened: only
    AdamW's f32 rounding separates them, so each leaf within 2 f32 ulps of
    its largest weight plus 1e-6 of lr; and (2) the f64 step (``b``), each
    element within what its gradient's f32 error moves Adam's step: at step
    1 the step is g' / (|g'| + eps) with g' the clipped gradient, whose
    slope is at most 1 / eps, so |master32 - master64| <= lr min(2,
    |g'32 - g'64| / eps) + 2 ulps.  Returns (worst of (1) over its bound,
    worst of (2) over its bound, the raw largest |master32 - master64|)."""
    from repro_torch.optim.adamw import apply_updates, init_state
    w64 = {n: t.double() for n, t in init.items()}
    st = init_state(w64, opt)
    _, st, _ = apply_updates(w64, {n: g.double() for n, g in
                                   a["grads"].items()}, st, opt, ndims)
    lr = a["lr"]
    f32_eps = torch.finfo(torch.float32).eps
    worst_opt = worst_step = raw = 0.0
    sa = min(1.0, opt.grad_clip / max(a["grad_norm"], 1e-12))
    sb = min(1.0, opt.grad_clip / max(b["grad_norm"], 1e-12))
    for n, m32 in a["master"].items():
        ulps = 2 * f32_eps * float(init[n].abs().max())
        d_opt = float((m32.double() - st["master"][n]).abs().max())
        worst_opt = max(worst_opt, d_opt / (ulps + 1e-6 * lr))
        dm = (m32.double() - b["master"][n]).abs()
        dg = (a["grads"][n].double() * sa - b["grads"][n] * sb).abs()
        bound = lr * torch.clamp(dg / opt.eps, max=2.0) + ulps + 1e-6 * lr
        worst_step = max(worst_step, float((dm / bound).max()))
        raw = max(raw, float(dm.max()))
        del dm, dg, bound
    del st, w64
    return worst_opt, worst_step, raw


def phase_train_check():
    """The same step in f32 against f64 on the card, at gemma_2b's full
    width cut to 2 layers, TF32 off, deterministic algorithms on (so the
    step's gradients are the ones computed beside it): one
    `make_train_step` step on one batch; the loss, the grad norm and every
    gradient leaf (relative L2), and the updated master weights
    (`_master_checks`).  A control with the label mask dropped must fail
    the gradient check."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, reference_ndims
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.optim.adamw import AdamWConfig, init_state
    cfg = get_config(T_ARCH).replace(n_layers=2)
    opt = AdamWConfig(warmup_steps=7, total_steps=T_STEPS)
    batch = _train_batch(cfg.vocab_size)
    unmasked = dict(batch, labels=batch["labels"].clamp(min=0))
    res = {}
    with _no_kernel_launched("train_check"), deterministic_algorithms(True):
        for dt in ("float32", "float64"):
            model = LM(cfg.replace(dtype=dt), seed=0, use_kernel=False,
                       remat_policy="none", loss_chunk=2048)
            if dt == "float64":    # the f32 weights, widened
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(res["float32"]["init"][name])
            loss, grads = loss_and_grads(model, batch)
            extra = {}
            if dt == "float32":
                extra["init"] = {n: p.detach().clone()
                                 for n, p in model.named_parameters()}
                extra["control"] = loss_and_grads(model, unmasked)[1]
                ndims = reference_ndims(model)
            step = make_train_step(model, opt)
            params = dict(model.named_parameters())
            _, state, m = step(params, init_state(params, opt), batch)
            res[dt] = dict(loss=float(loss), grads=grads,
                           grad_norm=float(m["grad_norm"]),
                           lr=float(m["lr"]), master=state["master"],
                           **extra)
            del model, step, params, state
            torch.cuda.empty_cache()
        a, b = res["float32"], res["float64"]
        opt_worst, step_worst, master_raw = _master_checks(
            a, b, opt, a["init"], ndims)
    grad_err = {n: _rel_l2(a["grads"][n], b["grads"][n]) for n in b["grads"]}
    control_err = max(_rel_l2(a["control"][n], b["grads"][n])
                      for n in b["grads"])
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    norm_err = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
    worst = max(grad_err, key=grad_err.get)
    fields = dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                  vocab=cfg.vocab_size, tokens=T_SEQ * T_BATCH,
                  loss_f32=a["loss"], loss_f64=b["loss"],
                  loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                  grad_rel_l2_worst=grad_err[worst], grad_worst_leaf=worst,
                  grad_rel_l2=grad_err, control_unmasked_rel_l2=control_err,
                  master_max_abs_err=master_raw, lr=b["lr"],
                  master_vs_f64_adamw_over_bound=opt_worst,
                  master_vs_f64_step_over_bound=step_worst,
                  tol=dict(loss=T_LOSS_RTOL, grad=T_GRAD_TOL))
    del res, a, b
    torch.cuda.empty_cache()
    emit("train_check", **fields)
    if loss_err > T_LOSS_RTOL or norm_err > T_LOSS_RTOL \
            or fields["grad_rel_l2_worst"] > T_GRAD_TOL \
            or opt_worst > 1 or step_worst > 1:
        raise AssertionError("train_check: f32 off f64 beyond the "
                             "tolerances")
    if not control_err > T_GRAD_TOL:
        raise AssertionError(f"train_check: the unmasked control passed "
                             f"({control_err})")


def _replay_breakers(cfg, deterministic):
    """The leaves whose gradient bits differ between two runs of the same
    loss on the same batch and weights (and the largest difference)."""
    from repro_torch.launch.train import deterministic_algorithms
    model = LM(cfg, seed=0, use_kernel=False, remat_policy="none",
               loss_chunk=2048)
    batch = _train_batch(cfg.vocab_size, seed=1)
    with deterministic_algorithms(deterministic):
        _, g1 = loss_and_grads(model, batch)
        _, g2 = loss_and_grads(model, batch)
    out = {n: _max_err(g1[n], g2[n]) for n in g1
           if not torch.equal(g1[n], g2[n])}
    del model, g1, g2
    torch.cuda.empty_cache()
    return out


def _faa_replay(deterministic):
    """`core.scatter_add_grads`, the embedding gradient's FAA batch, twice
    on the same fp32 rows: 2,048 rows of 2,048 into gemma_2b's 256,000
    (train_gemma's tokens, few collisions) and into 256 rows (8 ops a
    slot): whether the two results are bit-equal."""
    from repro_torch.core import scatter_add_grads
    from repro_torch.launch.train import deterministic_algorithms
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = _train_batch(256000)["tokens"]
    rows = torch.randn((*ids.shape, 2048), generator=gen, device="cuda")
    out = {}
    with deterministic_algorithms(deterministic):
        for tag, m, i in (("vocab_256000", 256000, ids),
                          ("hot_256", 256, ids % 256)):
            table = torch.zeros((m, 2048), device="cuda")
            a = scatter_add_grads(table, i, rows)
            b = scatter_add_grads(table, i, rows)
            out[tag] = bool(torch.equal(a, b))
    return out


def _final_checkpoint(path):
    from repro_torch.checkpoint import ckpt as ckpt_lib
    step = ckpt_lib.latest_step(path)
    _, data = ckpt_lib._load_validated(ckpt_lib._step_path(path, step))
    return step, data


def phase_train_recovery():
    """The fault-tolerance contract on the card: train_100m's ~110M config
    (12 x 768 x 3072, vocab 32,768), 8 steps of 8 x 256 tokens, with a
    checkpoint directory, once clean and once under `R_CHAOS`; failures >
    0, and the final loss and every leaf of the final checkpoint
    (parameters, master, moments) bit-equal.  First, which backward ops
    break replay: the leaves whose gradients differ between two runs of
    one batch, without and with deterministic algorithms, for this config
    and for deepseek_v3's reduced one (MoE's gathers)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_reduced
    from repro_torch.examples.train_100m import config_100m
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.chaos import FaultPlan
    cfg = config_100m(small=False)
    breakers = {}
    for name, c in (("train_100m", cfg),
                    (DS, get_reduced(DS).replace(dtype="float32"))):
        breakers[name] = {"default": _replay_breakers(c, False),
                          "deterministic": _replay_breakers(c, True)}
    faa_bit_equal = {"default": _faa_replay(False),
                     "deterministic": _faa_replay(True)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    real = train_mod.get_config
    train_mod.get_config = lambda arch: cfg
    runs = {}
    try:
        with _no_kernel_launched("train_recovery"):
            for tag, chaos in (("clean", None), ("chaos", R_CHAOS)):
                t0 = time.perf_counter()
                out = train_mod.train(
                    "gemma_2b", steps=R_STEPS, seq_len=T_SEQ,
                    global_batch=T_BATCH, reduced=False, log_every=1,
                    ckpt_dir=os.path.join(tmp, tag), device="cuda",
                    chaos=FaultPlan.from_spec(chaos) if chaos else None)
                runs[tag] = dict(out, wall_s=time.perf_counter() - t0)
        (sa, ca), (sb, cb) = (_final_checkpoint(os.path.join(tmp, t))
                              for t in ("clean", "chaos"))
        differ = sorted(k for k in ca if not np.array_equal(ca[k], cb[k]))
        leaves = len(ca)
    finally:
        train_mod.get_config = real
        shutil.rmtree(tmp, ignore_errors=True)
    clean, chaos = runs["clean"], runs["chaos"]
    if breakers["train_100m"]["deterministic"] or \
            breakers[DS]["deterministic"] or \
            not all(faa_bit_equal["deterministic"].values()):
        raise AssertionError(f"deterministic gradients differ between "
                             f"runs: {breakers}")
    emit("train_recovery", config="train_100m (full, not --small)",
         params=cfg.param_count(), steps=R_STEPS, chaos=R_CHAOS,
         failures=chaos["failures"], backoff_s=chaos["backoff_total_s"],
         final_loss=[clean["final_loss"], chaos["final_loss"]],
         checkpoint_steps=[sa, sb], checkpoint_leaves=leaves,
         leaves_differing=differ,
         wall_s=[clean["wall_s"], chaos["wall_s"]],
         replay_breakers=breakers, scatter_add_grads_bit_equal=faa_bit_equal)
    if chaos["failures"] < 1 or clean["failures"] != 0:
        raise AssertionError(f"train_recovery: failures {clean['failures']}"
                             f" clean, {chaos['failures']} under chaos")
    if clean["final_loss"] != chaos["final_loss"] or differ or sa != sb:
        raise AssertionError(f"train_recovery: not bit-equal: losses "
                             f"{clean['final_loss']} {chaos['final_loss']},"
                             f" leaves {differ}")


def phase_train_moe():
    """The trainer on deepseek_v3's reduced config (MLA, a dense first
    layer, MoE with a shared expert), 20 steps on the card at the
    quickstart's learning rate for reduced configs (3e-3): the losses
    finite and falling, the aux loss finite."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train as train_mod
    cfg = get_reduced(DS)
    model = LM(cfg, seed=0, use_kernel=False)
    with torch.no_grad():
        x = model._embed_in(_train_batch(cfg.vocab_size))
        _, _, aux = model._backbone(x, caches=None)
    del model
    with _no_kernel_launched("train_moe"):
        out = train_mod.train(DS, steps=20, seq_len=T_SEQ,
                              global_batch=T_BATCH, lr=3e-3, log_every=1,
                              device="cuda")
    losses = [h["loss"] for h in out["history"]]
    emit("train_moe", arch=DS, reduced=True,
         layers=[(b.kind, b.is_moe) for b in LM(cfg, device="meta").blocks],
         losses=losses, aux_loss=float(aux),
         step_ms=[1e3 * h["sec"] for h in out["history"]])
    if not all(math.isfinite(v) for v in losses) or \
            not math.isfinite(float(aux)):
        raise AssertionError(f"train_moe: not finite: {losses}, {aux}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train_moe: loss did not fall: {losses}")


def _mla_check(cfg):
    """The full-width MLA layer in f32 against f64 (TF32 off): a prefill of
    `DS_MLA_PREFILL` tokens into the latent cache and `DS_MLA_DECODE`
    decode steps; and, in f32, the decode steps against one prefill of all
    the tokens.  Errors relative to the output's largest magnitude."""
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator(device="cuda").manual_seed(3)
    p64 = attn_mod.attn_init(gen, cfg, torch.float64)
    p32 = attn_mod.attn_init(gen, cfg, torch.float32)
    with torch.no_grad():
        for (_, a), (_, b) in zip(p32.named_parameters(),
                                  p64.named_parameters()):
            a.copy_(b)
    s = DS_MLA_PREFILL + DS_MLA_DECODE
    x64 = torch.randn((1, s, cfg.d_model), generator=gen, device="cuda",
                      dtype=torch.float64)
    outs = {}
    with torch.no_grad():
        for dt, p in ((torch.float32, p32), (torch.float64, p64)):
            x = x64.to(dt)
            cache = attn_mod.make_kv_cache(cfg, 1, s, dt, device="cuda")
            o, cache = attn_mod.mla_forward(p, x[:, :DS_MLA_PREFILL], cfg,
                                            cache=cache)
            steps = [o]
            for t in range(DS_MLA_PREFILL, s):
                o, cache = attn_mod.mla_forward(p, x[:, t:t + 1], cfg,
                                                cache=cache)
                steps.append(o)
            outs[dt] = torch.cat(steps, 1)
            if dt == torch.float32:
                outs["full"] = attn_mod.mla_forward(p, x, cfg)[0]
    scale = float(outs[torch.float64].abs().max())
    pre, dec = slice(0, DS_MLA_PREFILL), slice(DS_MLA_PREFILL, s)
    res = dict(
        mla_prefill_rows=DS_MLA_PREFILL, mla_decode_steps=DS_MLA_DECODE,
        mla_f32_vs_f64_prefill=_max_err(outs[torch.float32][:, pre],
                                        outs[torch.float64][:, pre]) / scale,
        mla_f32_vs_f64_decode=_max_err(outs[torch.float32][:, dec],
                                       outs[torch.float64][:, dec]) / scale,
        mla_decode_vs_prefill_f32=_max_err(outs[torch.float32][:, dec],
                                           outs["full"][:, dec]) / scale,
        mla_tol=DS_MLA_TOL)
    del p32, p64, outs
    torch.cuda.empty_cache()
    bad = {k: v for k, v in res.items()
           if k.startswith("mla_f") or k.startswith("mla_decode_vs")}
    if max(bad.values()) > DS_MLA_TOL:
        raise AssertionError(f"serve_deepseek MLA check: {res}")
    return res


def phase_serve_deepseek():
    """deepseek_v3 at full width (d 7168, 128 heads, MLA q_lora 1536,
    kv_lora 512, rope 64, nope 128, v 128; 256 experts top 8 and a shared
    one, d_ff_expert 2048, dense d_ff 18,432; vocab 129,280) cut to its
    first 4 layers (3 dense, then MoE): the MLA layer's checks, then the 8
    requests of the serving phases in bf16 through `BatchServer` (the
    chunked attention math: MLA's expanded heads, 128 x 3,523^2 scores in
    f32, do not fit as one block), with no kernel launched; then, the bf16
    model freed, the served f32 logits (about 60 GB of weights) finite on
    the first prompt."""
    from repro_torch.configs import get_config
    cfg = get_config(DS).replace(n_layers=DS_LAYERS)
    m, moe = cfg.mla, cfg.moe
    if (cfg.d_model, cfg.n_heads, m.q_lora_rank, m.kv_lora_rank,
            m.qk_rope_head_dim, m.qk_nope_head_dim, m.v_head_dim,
            moe.n_experts, moe.top_k, moe.n_shared_experts,
            moe.d_ff_expert, moe.first_dense_layers, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) != (7168, 128, 1536, 512, 64, 128,
                                           128, 256, 8, 1, 2048, 3, 18432,
                                           129280, "bfloat16"):
        raise AssertionError(f"not deepseek_v3 at full width: {cfg}")
    fields = _mla_check(cfg.replace(dtype="float32"))
    t0 = time.perf_counter()
    with _served_config(cfg):
        server = BatchServer(DS, reduced=False, slots=SERVE_SLOTS,
                             s_max=G_S_MAX, seed=0, device="cuda")
    server.model.attn_impl = "chunked"
    sync()
    init_s = time.perf_counter() - t0
    kinds = [(b.kind, b.is_moe) for b in server.model.blocks]
    if kinds != [("attn", False)] * 3 + [("attn", True)]:
        raise AssertionError(f"deepseek's 4 layers: {kinds}")
    rng = np.random.default_rng(0)
    lengths = [int(v) for v in rng.integers(256, 4097, SERVE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, v).tolist() for v in lengths]
    _prefill_logits(server.model, prompts[0][:300], G_S_MAX)   # warm-up
    sync()
    reqs = _requests(prompts)
    with _no_kernel_launched("serve_deepseek"):
        stats = server.run(reqs)
    timing = dict(server.timing)
    decode_tokens = SERVE_REQUESTS * (SERVE_MAX_NEW - 1)
    if stats["completed"] != SERVE_REQUESTS or \
            stats["tokens"] != decode_tokens:
        raise AssertionError(f"serve_deepseek stats {stats}")
    for r in reqs:
        lg = r.prefill_logits
        if lg.shape != (cfg.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"serve_deepseek request {r.rid}: logits")
    first = torch.tensor([prompts[0]], device="cuda")
    box = {}

    def prefill():
        box["cache"] = server.model.prefill({"tokens": first}, G_S_MAX)[0]

    def decode(steps=8):
        tok = first[:, -1:]
        for _ in range(steps):
            server.model.decode_step(box["cache"], {"tokens": tok})

    weight_bytes = sum(p.numel() * p.element_size()
                       for p in server.model.parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for b in server.model.blocks if b.is_moe
                       for n, p in b.moe.named_parameters()
                       if n in ("w1", "w2", "w3"))
    fields.update(
        arch=DS, n_layers=cfg.n_layers, layers=kinds, d_model=cfg.d_model,
        params=sum(p.numel() for p in server.model.parameters()),
        weight_bytes=weight_bytes, expert_bytes=expert_bytes,
        init_s=init_s, prompt_lengths=lengths, stats=stats,
        prefill_ms_per_request=1e3 * timing["prefill_s"]
        / timing["prefills"],
        decode_ms_per_token=1e3 * timing["decode_s"]
        / timing["decode_steps"],
        decode_bytes_bound_ms=1e3 * weight_bytes / HBM_BPS,
        prefill_trace=dict(prompt=lengths[0], **_device_trace(
            prefill, ("gemm", "nvjet"), top=8)),
        decode_trace_per_token=_device_trace(decode, ("gemm", "nvjet"),
                                             steps=8, top=8))
    del server, box
    torch.cuda.empty_cache()
    m32 = LM(cfg.replace(dtype="float32"), seed=0, attn_impl="chunked")
    lg = _prefill_logits(m32, prompts[0], G_S_MAX)
    fields["f32_logits"] = dict(
        layers=cfg.n_layers, prompt=lengths[0],
        finite=bool(torch.isfinite(lg).all()), std=float(lg.std()),
        weight_gib=sum(p.numel() * 4 for p in m32.parameters()) / 2 ** 30)
    del m32, lg
    torch.cuda.empty_cache()
    emit("serve_deepseek", **fields)
    if not fields["f32_logits"]["finite"]:
        raise AssertionError("serve_deepseek: f32 logits not finite")


# ---------------------------------------------------------------------------
# 17. qwen2_vl (M-RoPE, embedding inputs) and whisper (the encoder)
# ---------------------------------------------------------------------------

# qwen2_vl_2b (configs/qwen2_vl_2b.py): 28 layers, d 1536, 12 query heads
# over 2 KV heads of 128, qkv bias, M-RoPE sections (16, 24, 24), a tied
# vocabulary of 151,936
QW, QW_HQ, QW_HKV, QW_D = "qwen2_vl_2b", 12, 2, 128
# the embeds prefill: 64 text tokens, an image of 16 x 16 patches, 32 text
# tokens after it, then 4 decode steps
QW_TEXT, QW_GRID, QW_TAIL, QW_DECODE = 64, (16, 16), 32, 4
# whisper_small (configs/whisper_small.py): 12 encoder and 12 decoder
# layers, d 768, 12 heads of 64 (group 1), 1,500 frames, a vocabulary of
# 51,865; the decoder takes at most 448 positions, so a request's prompt
# plus its 16 tokens stays within 448
WH, WH_H, WH_D, WH_FRAMES, WH_MAX_POS = "whisper_small", 12, 64, 1500, 448
WH_PROMPTS = (4, 37, 200, WH_MAX_POS - SERVE_MAX_NEW)
# the calls the flash kernel is checked and timed at: (name, Sq, cached
# rows before them, Skv, Hq, Hkv, D, causal); the qwen2_vl prefill is the
# served mix's longest prompt, its decode at 1,600 rows of a 4,112-row
# cache; whisper's cross-attention prefill at a 200-token prompt
MM_FLASH = (("qwen2_vl_prefill", D_PREFILL, 0, G_S_MAX, QW_HQ, QW_HKV, QW_D,
             True),
            ("qwen2_vl_decode", 1, D_DECODE_VALID - 1, G_S_MAX, QW_HQ,
             QW_HKV, QW_D, True),
            ("whisper_encoder", WH_FRAMES, 0, WH_FRAMES, WH_H, WH_H, WH_D,
             False),
            ("whisper_cross_prefill", 200, 0, WH_FRAMES, WH_H, WH_H, WH_D,
             False),
            ("whisper_cross_decode", 1, 0, WH_FRAMES, WH_H, WH_H, WH_D,
             False))
MM_TRAIN_STEPS = 10


def _mm_flash_calls(gen, dtype=torch.bfloat16):
    """(name, args, kw, Sq, cached, Hq, Hkv, D) of each `MM_FLASH` call as
    the models make it: qwen2_vl's through `_attention_args` (a KV cache,
    NaN past the valid rows); whisper's with q (1, Sq, 12, 64) over k and
    v (1, 1,500, 12, 64) projections, every row valid, not causal."""
    out = []
    for name, sq, cached, skv, hq, hkv, d, causal in MM_FLASH:
        if causal:
            args, kw = _attention_args(gen, sq, cached, hq, hkv, d, dtype)
        else:
            args = tuple(torch.randn((1, n, h, d), generator=gen,
                                     device="cuda").to(dtype).transpose(1, 2)
                         for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
            kw = dict(causal=False, kv_valid=skv, kv_offset=0)
        out.append((name, args, kw, sq, cached, hq, hkv, d))
    return out


def phase_flash_mm(gen):
    """flash_attention at every `MM_FLASH` call against its plain version:
    bf16 within one bf16 ulp (`FA_GEMMA_BF16`), f32 within 3e-5.  Whisper's
    calls are the first non-causal ones at these sizes: the encoder's
    1,500 x 1,500 and the cross-attention's prefill on tensor cores, and
    the cross-attention's decode (Sq 1, Skv 1,500, causal 0) through the
    split-KV walk and combine; qwen2_vl's decode has 6 rows a KV head, the
    split path too.  Each non-causal call's causal counterpart from key 0
    (row i sees keys <= i) must differ from it, or the mask went
    unchecked."""
    errs = {}
    f32_tol = dict(rtol=FA_TOL[torch.float32], atol=FA_TOL[torch.float32])
    for dtype, tol in ((torch.bfloat16, FA_GEMMA_BF16),
                       (torch.float32, f32_tol)):
        for name, args, kw, *_ in _mm_flash_calls(gen, dtype):
            got = FK.flash_attention(*args, **kw)
            want = FK.flash_attention_plain(*args, **kw)
            errs[f"{name}_{str(dtype)[6:]}"] = _check_fa(
                got, want, f"{name} {dtype}", **tol)
            if not kw["causal"]:
                masked = FK.flash_attention(*args, **dict(kw, causal=True))
                if torch.allclose(masked.float(), want.float(), **tol):
                    raise AssertionError(f"flash_attention {name}: the "
                                         f"causal call matches the "
                                         f"non-causal plain version")
    emit("flash_mm", calls=[dict(zip(("name", "sq", "cached", "skv", "hq",
                                      "hkv", "d", "causal"), c))
                            for c in MM_FLASH],
         max_abs_err=errs)
    return max(errs.values())


def mm_positions3(b, n_text, grid, n_tail):
    """(3, b, S) int64 M-RoPE ids: ``n_text`` text tokens at t = h = w = i,
    an image of ``grid`` = (gh, gw) patches at t = n_text, h = n_text +
    row, w = n_text + col, then ``n_tail`` text tokens from the image's
    largest id on (Qwen2-VL's layout; three distinct axes)."""
    gh, gw = grid
    t = list(range(n_text))
    h, w = list(t), list(t)
    for r in range(gh):
        for c in range(gw):
            t.append(n_text)
            h.append(n_text + r)
            w.append(n_text + c)
    nxt = n_text + max(gh, gw)
    for i in range(n_tail):
        for axis in (t, h, w):
            axis.append(nxt + i)
    return torch.tensor([t, h, w], device="cuda")[:, None].expand(
        3, b, len(t)).contiguous()


def _three_ways(model, run):
    """``run(model)`` on the kernel path, on `_sdpa` (the plain path) and
    with the kernel's own f32 function in the kernel's place (the floor):
    (kernel, plain, floor) outputs; the plain and floor runs launch no
    kernel."""
    kern = run(model)
    before = FK.LAUNCHES["flash_attention"]
    model.use_kernel = False
    plain = run(model)
    model.use_kernel = None
    with _attention_through_plain_version():
        floor = run(model)
    if FK.LAUNCHES["flash_attention"] != before:
        raise AssertionError("the plain or floor run launched the kernel")
    return kern, plain, floor


def _floor_gate(name, kern, plain, floor):
    """The bf16 gate of the serving phases: the kernel path within
    `GEMMA_FLOOR_FACTOR` x the floor (the kernel's own f32 function in the
    model against the plain path) of the plain path, logit for logit."""
    if not all(torch.isfinite(a).all() for a in kern):
        raise AssertionError(f"{name}: non-finite logits")
    err = max(_max_err(a, b) for a, b in zip(kern, plain))
    fl = max(_max_err(a, b) for a, b in zip(floor, plain))
    if err > GEMMA_FLOOR_FACTOR * fl:
        raise AssertionError(f"{name}: kernel path off the plain path by "
                             f"{err} > {GEMMA_FLOOR_FACTOR} x floor {fl}")
    return dict(max_abs_err=err, floor=fl, gate=GEMMA_FLOOR_FACTOR * fl,
                plain_std=float(plain[0].std()))


def _qw_embeds_run(p3, embeds):
    """Prefill ``embeds`` with ``p3`` into a cache, then `QW_DECODE` steps
    of the next embeddings with their ids: [prefill logits, step logits
    ...] (each (B, vocab) f32)."""
    n = embeds.shape[1] - QW_DECODE

    def run(model):
        cache, lg = model.prefill({"embeds": embeds[:, :n],
                                   "positions3": p3[:, :, :n]},
                                  embeds.shape[1])
        out = [lg]
        for t in range(n, embeds.shape[1]):
            cache, lg = model.decode_step(cache, {
                "embeds": embeds[:, t:t + 1],
                "positions3": p3[:, :, t:t + 1]})
            out.append(lg)
        return out
    return run


def _qw_embeds(d, n, dtype):
    return (torch.randn((1, n, d), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(7)) * 0.02).to(dtype)


def _qw_f32_check(cfg):
    """qwen2_vl at full width cut to 2 layers, f32: the embeds prefill and
    decode with distinct positions3 through the kernel and the plain path
    within `SERVE_F32_LOGIT_ATOL`."""
    m32 = LM(cfg.replace(n_layers=2, dtype="float32"), seed=0,
             attn_impl="ref")
    p3 = mm_positions3(1, QW_TEXT, QW_GRID, QW_TAIL + QW_DECODE)
    run = _qw_embeds_run(p3, _qw_embeds(cfg.d_model, p3.shape[-1],
                                        torch.float32))
    kern = run(m32)
    m32.use_kernel = False
    plain = run(m32)
    del m32
    torch.cuda.empty_cache()
    err = max(_max_err(a, b) for a, b in zip(kern, plain))
    if err > SERVE_F32_LOGIT_ATOL:
        raise AssertionError(f"qwen2_vl f32 (2 layers): kernel path off the "
                             f"plain path by {err} > {SERVE_F32_LOGIT_ATOL}")
    return dict(layers=2, max_abs_err=err, atol=SERVE_F32_LOGIT_ATOL)


def _serving_traces(model, prefill_batch, s_max, step_batch):
    """The device trace of one prefill of ``prefill_batch`` and, per token,
    of eight decode steps of ``step_batch`` from its cache."""
    box = {}

    def prefill():
        box["cache"] = model.prefill(prefill_batch, s_max)[0]

    def decode(steps=8):
        for _ in range(steps):
            model.decode_step(box["cache"], step_batch)

    return dict(prefill_trace=_device_trace(prefill, FA_KERNELS),
                decode_trace_per_token=_device_trace(decode, FA_KERNELS,
                                                     steps=8))


def phase_serve_qwen2_vl():
    """qwen2_vl_2b at full width and depth in bf16: the serving phases' 8
    prompts through `BatchServer` (4 slots, 16 new tokens; the server feeds
    tokens, which the model embeds from its table, with 1-D positions on
    M-RoPE's three axes, as the reference's server does), the flash
    kernel's launches counted; the prefill logits of every prompt gated
    against the plain path at 2x the floor; then a prefill from
    ``embeds`` with distinct positions3 (64 text tokens, a 16 x 16 patch
    grid, 32 text tokens) and 4 decode steps through `LM.prefill` and
    `LM.decode_step`, gated the same way, and held to differ from the same
    run with 1-D positions; the f32 check at 2 layers."""
    from repro_torch.configs import get_config
    cfg = get_config(QW)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.mrope_sections,
            cfg.qkv_bias, cfg.tie_embeddings, cfg.dtype) != (
            28, 1536, QW_HQ, QW_HKV, QW_D, 8960, 151_936, (16, 24, 24), True,
            True, "bfloat16"):
        raise AssertionError(f"not qwen2_vl_2b at full width: {cfg}")
    t0 = time.perf_counter()
    server = BatchServer(QW, reduced=False, slots=SERVE_SLOTS,
                         s_max=G_S_MAX, seed=0, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    model = server.model
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(0)
    lengths = [int(v) for v in rng.integers(256, 4097, SERVE_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, v).tolist() for v in lengths]
    _prefill_logits(model, prompts[0][:300], G_S_MAX)          # warm-up
    sync()
    reqs = _requests(prompts)
    FK.reset_launches()                  # the serving path starts here
    stats = server.run(reqs)
    launches = dict(FK.LAUNCHES)         # ... and ends here
    timing = dict(server.timing)
    decode_tokens = SERVE_REQUESTS * (SERVE_MAX_NEW - 1)
    want = cfg.n_layers * (SERVE_REQUESTS + decode_tokens)
    if launches["flash_attention"] != want:
        raise AssertionError(f"qwen2_vl: flash_attention launched "
                             f"{launches['flash_attention']} times, want "
                             f"{want}")
    if stats["completed"] != SERVE_REQUESTS or \
            stats["tokens"] != decode_tokens:
        raise AssertionError(f"serve_qwen2_vl stats {stats}")
    served = [r.prefill_logits for r in reqs]
    _, plain, floor = _three_ways(model, lambda m: [
        _prefill_logits(m, p, G_S_MAX) for p in prompts])
    tokens_gate = _floor_gate("qwen2_vl prefill logits", served, plain,
                              floor)
    # the embeds path with M-RoPE's distinct axes
    p3 = mm_positions3(1, QW_TEXT, QW_GRID, QW_TAIL + QW_DECODE)
    embeds = _qw_embeds(cfg.d_model, p3.shape[-1], torch.bfloat16)
    before = FK.LAUNCHES["flash_attention"]
    kern, plain_e, floor_e = _three_ways(model, _qw_embeds_run(p3, embeds))
    if FK.LAUNCHES["flash_attention"] - before != cfg.n_layers * (
            1 + QW_DECODE):
        raise AssertionError("qwen2_vl embeds run: launch count")
    embeds_gate = _floor_gate("qwen2_vl embeds + positions3 logits", kern,
                              plain_e, floor_e)
    flat = _qw_embeds_run(torch.arange(p3.shape[-1], device="cuda").expand(
        3, 1, -1), embeds)(model)
    moved = max(_max_err(a, b) for a, b in zip(flat, kern))
    if moved <= embeds_gate["gate"]:
        raise AssertionError(f"qwen2_vl: positions3 moved the logits by "
                             f"{moved}, within the gate: M-RoPE's axes "
                             f"are not reaching the attention")
    first = torch.tensor([prompts[0]], device="cuda")
    fields = dict(
        arch=QW, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=sum(p.numel()
                                         for p in model.parameters()),
        weight_bytes=weight_bytes, init_s=init_s, prompt_lengths=lengths,
        stats=stats, launches=launches,
        prefill_ms_per_request=1e3 * timing["prefill_s"]
        / timing["prefills"],
        decode_ms_per_token=1e3 * timing["decode_s"]
        / timing["decode_steps"],
        decode_bytes_bound_ms=1e3 * weight_bytes / HBM_BPS,
        tokens_prefill_gate=tokens_gate,
        embeds=dict(positions=int(p3.shape[-1]), grid=QW_GRID,
                    decode_steps=QW_DECODE, **embeds_gate,
                    moved_by_positions3=moved),
        trace_prompt=lengths[0],
        **_serving_traces(model, {"tokens": first}, G_S_MAX,
                          {"tokens": first[:, -1:]}))
    del server, model
    torch.cuda.empty_cache()
    fields["f32"] = _qw_f32_check(cfg)
    emit("serve_qwen2_vl", **fields)
    return launches


def _wh_frames(b, seed, d=768):
    return torch.randn((b, WH_FRAMES, d), device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(seed)) * 0.02


def _wh_serve(model, prompt, frames, tokens=None):
    """One request: prefill the decoder prompt with the frames (the
    encoder runs once, its output kept in the cache), then 15 greedy
    decode steps (or the given ``tokens``, teacher-forced): ([16 logits],
    [16 tokens], host seconds of the prefill, of the decode steps)."""
    toks = torch.tensor([prompt], device="cuda")
    t0 = time.perf_counter()
    cache, lg = model.prefill({"tokens": toks, "frames": frames},
                              len(prompt) + SERVE_MAX_NEW)
    out_lg = [lg]
    out_tok = [int(torch.argmax(lg, -1)[0]) if tokens is None
               else tokens[0]]
    t1 = time.perf_counter()
    for i in range(1, SERVE_MAX_NEW):
        cache, lg = model.decode_step(cache, {"tokens": torch.tensor(
            [[out_tok[-1]]], device="cuda")})
        out_lg.append(lg)
        out_tok.append(int(torch.argmax(lg, -1)[0]) if tokens is None
                       else tokens[i])
    t2 = time.perf_counter()
    return out_lg, out_tok, t1 - t0, t2 - t1


def phase_serve_whisper():
    """whisper_small at full width and depth in bf16, served through
    `LM.prefill` and `LM.decode_step` with frames (the reference's
    `BatchServer` feeds tokens only and cannot serve an encoder-decoder):
    4 requests, decoder prompts of 4 to 432 tokens, 1,500 frames each from
    the seed, 16 new tokens each.  The flash kernel launches, per prefill,
    12 non-causal encoder calls and per decoder layer one causal and one
    non-causal cross call, and per decode token the decoder's 12 + 12;
    every logit (prefill and each step, the kernel path's tokens
    teacher-forced on the others) gated against the plain path at 2x the
    floor; the f32 check at 2 + 2 layers."""
    from repro_torch.configs import get_config
    cfg = get_config(WH)
    enc = cfg.encoder
    if (enc.n_layers, enc.n_frames, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.pos_emb, cfg.dtype) != (12, WH_FRAMES, 12, 768, WH_H, WH_H,
                                        WH_D, 3072, 51_865, "learned",
                                        "bfloat16"):
        raise AssertionError(f"not whisper_small at full width: {cfg}")
    t0 = time.perf_counter()
    model = LM(cfg, seed=0, attn_impl="ref")
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in WH_PROMPTS]
    frames = [_wh_frames(1, i) for i in range(len(prompts))]
    _wh_serve(model, prompts[0], frames[0])                    # warm-up
    sync()
    FK.reset_launches()                  # the serving path starts here
    served = [_wh_serve(model, p, f) for p, f in zip(prompts, frames)]
    launches = dict(FK.LAUNCHES)         # ... and ends here
    per_prefill = enc.n_layers + 2 * cfg.n_layers
    per_token = 2 * cfg.n_layers
    want = len(prompts) * (per_prefill + (SERVE_MAX_NEW - 1) * per_token)
    if launches["flash_attention"] != want:
        raise AssertionError(f"whisper: flash_attention launched "
                             f"{launches['flash_attention']} times, want "
                             f"{len(prompts)} x ({per_prefill} + "
                             f"{SERVE_MAX_NEW - 1} x {per_token}) = {want}")
    kern = [lg for s in served for lg in s[0]]
    _, plain, floor = _three_ways(model, lambda m: [
        lg for p, f, s in zip(prompts, frames, served)
        for lg in _wh_serve(m, p, f, tokens=s[1])[0]])
    gate = _floor_gate("whisper logits", kern, plain, floor)
    tp = prompts[2]
    fields = dict(
        arch=WH, encoder_layers=enc.n_layers, decoder_layers=cfg.n_layers,
        d_model=cfg.d_model, frames=WH_FRAMES, vocab=cfg.vocab_size,
        params=sum(p.numel() for p in model.parameters()),
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
        init_s=init_s, prompt_lengths=list(WH_PROMPTS), launches=launches,
        launches_per_prefill=per_prefill, launches_per_token=per_token,
        prefill_ms_per_request=1e3 * sum(s[2] for s in served)
        / len(served),
        decode_ms_per_token=1e3 * sum(s[3] for s in served)
        / (len(served) * (SERVE_MAX_NEW - 1)),
        logits_gate=gate, trace_prompt=len(tp),
        **_serving_traces(
            model, {"tokens": torch.tensor([tp], device="cuda"),
                    "frames": frames[2]}, len(tp) + SERVE_MAX_NEW,
            {"tokens": torch.tensor([[tp[-1]]], device="cuda")}))
    del model
    torch.cuda.empty_cache()
    # f32 at 2 encoder and 2 decoder layers: every logit within 1e-3, the
    # plain path teacher-forced on the kernel path's tokens
    m32 = LM(cfg.replace(n_layers=2, dtype="float32",
                         encoder=dataclasses.replace(enc, n_layers=2)),
             seed=0, attn_impl="ref")
    k32 = [_wh_serve(m32, p, f) for p, f in zip(prompts, frames)]
    m32.use_kernel = False
    p32 = [_wh_serve(m32, p, f, tokens=k[1])
           for p, f, k in zip(prompts, frames, k32)]
    del m32
    torch.cuda.empty_cache()
    f32_err = max(_max_err(a, b) for k, q in zip(k32, p32)
                  for a, b in zip(k[0], q[0]))
    fields["f32"] = dict(layers="2 + 2", max_abs_err=f32_err,
                         atol=SERVE_F32_LOGIT_ATOL)
    emit("serve_whisper", **fields)
    if f32_err > SERVE_F32_LOGIT_ATOL:
        raise AssertionError(f"whisper f32 (2 + 2 layers): kernel path off "
                             f"the plain path by {f32_err}")
    return launches


def phase_train_mm():
    """The trainer on qwen2_vl_2b and whisper_small at full width, bf16
    parameters with f32 master and moments, `MM_TRAIN_STEPS` steps each at
    the trainer's default lr (3e-4) on its own batches (8 x 256: qwen2_vl's
    are ``embeds`` with positions3, whisper's tokens with 1,500 frames):
    losses finite, the last 3 below the first 3 on average; no kernel may
    launch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    out = {}
    for arch in (QW, WH):
        n = get_config(arch).param_count()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _no_kernel_launched(f"train_mm {arch}"):
            res = train_mod.train(arch, steps=MM_TRAIN_STEPS, seq_len=T_SEQ,
                                  global_batch=T_BATCH, reduced=False,
                                  remat_policy="none", log_every=1,
                                  device="cuda")
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        step_s = float(np.median([h["sec"] for h in hist[2:]]))
        out[arch] = dict(
            params=n, losses=losses, step_ms=1e3 * step_s,
            tokens_per_s=T_SEQ * T_BATCH / step_s,
            train_mfu=6 * n * T_SEQ * T_BATCH / step_s / BF16_PEAK,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            wall_s=time.perf_counter() - t0)
        del res
        if len(losses) != MM_TRAIN_STEPS or \
                not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train_mm {arch}: losses {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"train_mm {arch}: loss did not fall: "
                                 f"{losses}")
    emit("train_mm", steps=MM_TRAIN_STEPS, seq_len=T_SEQ,
         global_batch=T_BATCH, **out)


# ---------------------------------------------------------------------------
# 17b. sharded training: 4 ranks sharing the card on a 2x2 mesh
# ---------------------------------------------------------------------------

# gemma_2b at full width on 2x2 ("data", "model"): fsdp splits over data,
# heads / ffn / vocab over model where they divide (its one KV head does
# not: wk and wv stay whole along model); the global batch 8 x 256 splits
# over data, 4 sequences a rank
TS_WORLD, TS_SHAPE, TS_AXES = 4, (2, 2), ("data", "model")
TS_F32_LAYERS, TS_STEPS = 2, 3
TS_BF16_LAYERS, TS_BF16_STEPS = 4, 3
# sharded against local in f32 (TF32 off, deterministic algorithms): the
# loss and the grad norm are sums in another order (rtol 1e-5, as
# `train_check`), each gathered parameter leaf after 3 steps within
# relative L2 1e-4 (`train_check`'s per-leaf bound)
TS_RTOL, TS_LEAF_TOL = 1e-5, 1e-4
TS_CHAOS = "seed=3,step=1.0@2,ckpt_save=1.0@1"
TS_CHAOS_STEPS = 6


def _ts_cfg(dtype, layers):
    from repro_torch.configs import get_config
    return get_config(T_ARCH).replace(dtype=dtype, n_layers=layers)


def _ts_opt(steps):
    """`launch.train.train`'s AdamW for a run of ``steps``."""
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=min(20, steps // 5 + 1),
                       total_steps=steps)


def _ts_masked(batch):
    """The batch with its first half of rows 90% masked: on 2x2 the cut of
    data index 0 holds about a tenth of the other's valid labels."""
    labels = batch["labels"].clone()
    b, s = labels.shape
    labels[: b // 2, : (9 * s) // 10] = -100
    return dict(batch, labels=labels)


def _ts_model(cfg):
    return LM(cfg, device="cuda", seed=0, use_kernel=False,
              attn_impl="chunked", remat_policy="none", loss_chunk=2048)


def _ts_bytes(specs, model, mesh, opt_bytes):
    """GiB a rank holds: the whole parameters (the gathered workspace),
    their f32 gradients, and its blocks of the parameters plus master and
    moments (``opt_bytes`` a parameter element)."""
    whole = blocks = grads = 0
    for name, p in model.named_parameters():
        n = p.numel()
        split = math.prod(mesh.size(e) for e in specs[name] if e)
        whole += n * p.element_size()
        grads += n * 4
        blocks += n // split * (p.element_size() + opt_bytes)
    return {"params_whole": whole / 2 ** 30, "grads_f32": grads / 2 ** 30,
            "blocks": blocks / 2 ** 30,
            "total": (whole + grads + blocks) / 2 ** 30}


def _train_sharded_rank(mesh, tmp):
    """One rank of `train_sharded`: (a) 3 sharded steps in f32 at 2 layers
    (`make_sharded_train_step`, the trainer's step), each gathered
    parameter held by rank 0 against the local run's (``tmp/local.pt``),
    then one step on the masked batch from the same weights, weighted by
    counts and as a mean of the ranks' means; (b) `train(mesh=...)` in
    bf16 at `TS_BF16_LAYERS` layers; (c) `train(mesh=...)` on the reduced
    config with checkpoints, clean and under `TS_CHAOS`."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import gather_full, shard_of
    from repro_torch.launch.shardings import arch_rules, params_shardings
    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.optim.adamw import init_state
    from repro_torch.runtime.chaos import FaultPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = dict(rank=mesh.rank, host_staged=list(mesh.probe(dev)))
    for mod in (K, SK, FK, XK):
        mod.reset_launches()
    # (a) f32 against the local step
    cfg = _ts_cfg("float32", TS_F32_LAYERS)
    opt = _ts_opt(TS_STEPS)
    rules = arch_rules(cfg, mesh, "train")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    with train_mod.deterministic_algorithms(True):
        model = _ts_model(cfg)
        step = make_sharded_train_step(model, opt, mesh, rules)
        specs = step.specs
        init = {n: shard_of(p.detach(), specs[n], mesh)
                for n, p in model.named_parameters()}

        def fresh():
            params = {n: b.clone() for n, b in init.items()}
            return params, init_state(params, opt)

        params, state = fresh()
        hist = []
        for i in range(TS_STEPS):
            params, state, m = step(params, state,
                                    _train_batch(cfg.vocab_size, i))
            hist.append({k: float(v) for k, v in m.items()})
        del state
        torch.cuda.empty_cache()
        # each leaf gathered, and held by rank 0 against the local one (f32
        # norms: a 2 GiB leaf in f64 twice would not fit beside the ranks)
        local = (torch.load(os.path.join(tmp, "local.pt"), mmap=True)
                 if mesh.rank == 0 else None)
        leaf_err = {}
        for name in list(params):
            whole = gather_full(params[name], specs[name], mesh)
            if local is not None:
                ref_leaf = local[name].to(dev)
                leaf_err[name] = float(
                    torch.linalg.vector_norm(whole - ref_leaf)
                    / torch.linalg.vector_norm(ref_leaf))
                del ref_leaf
            del whole
        del params, local
        control = {}
        masked = _ts_masked(_train_batch(cfg.vocab_size, 0))
        for tag, mm in (("masked", False), ("mean_of_means", True)):
            params, state = fresh()
            one = make_sharded_train_step(model, opt, mesh, rules,
                                          mean_of_means=mm)
            m = one(params, state, masked)[2]
            control[tag] = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del params, state, one, m
        out["f32"] = dict(history=hist, leaf_rel_l2=leaf_err,
                          control=control, specs={
                              n: [list(e) if isinstance(e, tuple) else e
                                  for e in s] for n, s in specs.items()},
                          memory_reckoned_gib=_ts_bytes(specs, model, mesh,
                                                        12),
                          peak_gib=torch.cuda.max_memory_allocated()
                          / 2 ** 30)
        del model, step, init
    torch.cuda.empty_cache()
    seconds = {"f32": time.perf_counter() - start}
    # (b) bf16 through the trainer
    real = train_mod.get_config
    train_mod.get_config = lambda arch: _ts_cfg("bfloat16", TS_BF16_LAYERS)
    try:
        torch.cuda.reset_peak_memory_stats()
        ex0 = mesh.exchange_s
        t0 = time.perf_counter()
        got = train_mod.train(T_ARCH, steps=TS_BF16_STEPS, seq_len=T_SEQ,
                              global_batch=T_BATCH, reduced=False, mesh=mesh,
                              log_every=1, device="cuda")
        out["bf16"] = dict(history=got["history"],
                           wall_s=time.perf_counter() - t0,
                           exchange_s=mesh.exchange_s - ex0,
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30)
        del got
    finally:
        train_mod.get_config = real
    model = LM(_ts_cfg("bfloat16", TS_BF16_LAYERS), device="meta")
    out["bf16"]["memory_reckoned_gib"] = _ts_bytes(
        params_shardings(model.cfg, dict(model.named_parameters()), mesh,
                         arch_rules(model.cfg, mesh)), model, mesh, 12)
    del model
    torch.cuda.empty_cache()
    seconds["bf16"] = time.perf_counter() - start - seconds["f32"]
    # (c) chaos against clean, the reduced config, checkpoints every 2 steps
    for tag, chaos in (("clean", None), ("chaos", TS_CHAOS)):
        got = train_mod.train(
            T_ARCH, steps=TS_CHAOS_STEPS, seq_len=T_SEQ,
            global_batch=T_BATCH, mesh=mesh, log_every=1, device="cuda",
            ckpt_dir=os.path.join(tmp, tag), checkpoint_every=2,
            chaos=FaultPlan.from_spec(chaos) if chaos else None)
        out[tag] = {k: got[k] for k in ("final_loss", "failures",
                                         "steps_done")}
    out["launches"] = {k: v for mod in (K, SK, FK, XK)
                       for k, v in mod.LAUNCHES.items() if v}
    seconds["chaos"] = time.perf_counter() - start - sum(seconds.values())
    out["seconds"] = seconds
    return out


def phase_train_sharded():
    """Sharded training on 4 ranks sharing the card (gloo) on a 2x2
    ``("data", "model")`` mesh, gemma_2b at full width (d_model 2048, ffn
    16,384, vocab 256,000), the global batch 8 x 256.  (a) f32 at 2
    layers, 3 steps: the losses and grad norms within `TS_RTOL` of the
    local step's on the same weights and batches, every gathered
    parameter within relative L2 `TS_LEAF_TOL`, clipping active in a
    step; one step on a batch whose first half of rows is 90% masked,
    weighted by the all-reduced counts, must pass the same loss and
    grad-norm check, and the control (a mean of the ranks' means) must
    fail it.  (b) `train(mesh=...)` in bf16 at `TS_BF16_LAYERS` layers:
    step ms split into gather, compute and reduce, the host-staged
    collectives, peak memory per rank, losses finite and falling.  (c)
    `train(mesh=...)` on the reduced config under `TS_CHAOS`: failures,
    and every leaf of the final checkpoint bit-equal to a clean sharded
    run's.  No kernel may launch, here or in the ranks."""
    import shutil
    import tempfile
    from repro_torch.launch import ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.optim.adamw import init_state
    cfg = _ts_cfg("float32", TS_F32_LAYERS)
    opt = _ts_opt(TS_STEPS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        t0 = time.perf_counter()
        with _no_kernel_launched("train_sharded"), \
                deterministic_algorithms(True):
            model = _ts_model(cfg)
            init = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
            step = make_train_step(model, opt)
            params = dict(model.named_parameters())
            state = init_state(params, opt)
            local = []
            for i in range(TS_STEPS):
                params, state, m = step(params, state,
                                        _train_batch(cfg.vocab_size, i))
                local.append({k: float(m[k])
                              for k in ("loss", "grad_norm", "lr")})
            torch.save({n: p.detach().cpu() for n, p in params.items()},
                       os.path.join(tmp, "local.pt"))
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(init[n])
            del init, state
            m = step(params, init_state(params, opt),
                     _ts_masked(_train_batch(cfg.vocab_size, 0)))[2]
            local_masked = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del model, step, params, m
        local_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        parent_gib = torch.cuda.memory_allocated() / 2 ** 30
        t1 = time.perf_counter()
        # four ranks' transients on one card: grow segments, not new ones
        env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            out = ranks.launch(f"{os.path.abspath(__file__)}:"
                               f"_train_sharded_rank", TS_WORLD,
                               mesh=(TS_SHAPE, TS_AXES), device="cuda",
                               args=(tmp,), timeout=900)
        finally:
            if env is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
        ranks_s = time.perf_counter() - t1
        ckpts = {tag: _final_checkpoint(os.path.join(tmp, tag))
                 for tag in ("clean", "chaos")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = []
    a = out[0]["f32"]
    for o in out:
        if o["launches"]:
            bad.append(f"rank {o['rank']} launched kernels: {o['launches']}")
        if [h["loss"] for h in o["f32"]["history"]] != \
                [h["loss"] for h in a["history"]]:
            bad.append(f"rank {o['rank']}'s losses differ from rank 0's")

    def off(got, want):
        return [k for k in ("loss", "grad_norm")
                if abs(got[k] - want[k]) > TS_RTOL * abs(want[k])]

    step_off = {i: off(g, w) for i, (g, w) in enumerate(zip(a["history"],
                                                            local))}
    if any(step_off.values()):
        bad.append(f"sharded steps off the local ones: {step_off}")
    worst = max(a["leaf_rel_l2"], key=a["leaf_rel_l2"].get)
    if a["leaf_rel_l2"][worst] > TS_LEAF_TOL:
        bad.append(f"gathered {worst} off the local run by "
                   f"{a['leaf_rel_l2'][worst]}")
    clipped = [h["grad_norm"] > _ts_opt(TS_STEPS).grad_clip
               for h in a["history"]]
    if not any(clipped):
        bad.append(f"no step clipped: {[h['grad_norm'] for h in local]}")
    masked_off = off(a["control"]["masked"], local_masked)
    control_off = off(a["control"]["mean_of_means"], local_masked)
    if masked_off:
        bad.append(f"masked batch off the local step: {masked_off}")
    if not control_off:
        bad.append("the mean-of-means control passed")
    b = out[0]["bf16"]
    losses = [h["loss"] for h in b["history"]]
    if len(losses) != TS_BF16_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        bad.append(f"bf16 losses: {losses}")
    (sa, ca), (sb, cb) = ckpts["clean"], ckpts["chaos"]
    differ = sorted(k for k in ca if not np.array_equal(ca[k], cb[k]))
    clean, chaos = out[0]["clean"], out[0]["chaos"]
    if chaos["failures"] < 1 or clean["failures"] != 0 or differ \
            or sa != sb or clean["final_loss"] != chaos["final_loss"]:
        bad.append(f"chaos not bit-equal to clean: {clean} {chaos} "
                   f"leaves {differ}")
    hist = b["history"][1:]          # the first step warms up
    split = {k[:-2]: 1e3 * float(np.median([h[k] for h in hist]))
             for k in ("gather_s", "compute_s", "reduce_s")}
    emit("train_sharded", arch=T_ARCH, mesh=dict(zip(TS_AXES, TS_SHAPE)),
         ranks=TS_WORLD, d_model=cfg.d_model, ffn=cfg.d_ff,
         vocab=cfg.vocab_size, seq_len=T_SEQ, global_batch=T_BATCH,
         host_staged=out[0]["host_staged"],
         f32=dict(n_layers=TS_F32_LAYERS, steps=TS_STEPS,
                  sharded=a["history"], local=local,
                  steps_off=step_off, clipped=clipped,
                  leaf_rel_l2_worst=a["leaf_rel_l2"][worst],
                  leaf_worst=worst, leaf_rel_l2=a["leaf_rel_l2"],
                  masked_local=local_masked, masked=a["control"]["masked"],
                  mean_of_means=a["control"]["mean_of_means"],
                  control_off=control_off, specs=a["specs"],
                  peak_gib=[o["f32"]["peak_gib"] for o in out],
                  memory_reckoned_gib=a["memory_reckoned_gib"],
                  tol=dict(rtol=TS_RTOL, leaf=TS_LEAF_TOL)),
         bf16=dict(n_layers=TS_BF16_LAYERS, steps=TS_BF16_STEPS,
                   losses=losses,
                   step_ms=[1e3 * h["sec"] for h in b["history"]],
                   split_ms_median=split,
                   exchange_s=[o["bf16"]["exchange_s"] for o in out],
                   wall_s=b["wall_s"],
                   peak_gib=[o["bf16"]["peak_gib"] for o in out],
                   memory_reckoned_gib=b["memory_reckoned_gib"]),
         chaos=dict(spec=TS_CHAOS, steps=TS_CHAOS_STEPS, clean=clean,
                    chaos=chaos, checkpoint_steps=[sa, sb],
                    checkpoint_leaves=len(ca), leaves_differing=differ),
         parent_gib_at_launch=parent_gib, local_s=local_s, ranks_s=ranks_s,
         rank0_s=out[0]["seconds"])
    if bad:
        raise AssertionError("train_sharded: " + "; ".join(bad))


# ---------------------------------------------------------------------------
# 18. telemetry
# ---------------------------------------------------------------------------

TM_CHAOS = "seed=7,step=1.0@1,ckpt_save=1.0@1,straggler_delay=1.0@1"
#: the live probe's update windows (of `TuningConfig.min_events` events)
TN_WINDOWS = 12


def _tuning_probe():
    """A default controller on the card over the telemetry suite's local
    drift traffic (every backend forced and as the selector picks, FAA
    spread and on 8 slots and uniform CAS, 4 to 4,096 ops over 1,024
    slots), until `TN_WINDOWS` update cycles ran: each window's outcome,
    every ``tuning.*`` event, the fields active at the end, and what auto
    picks for the traffic's batches before and after."""
    from repro_torch import telemetry
    from repro_torch.benchmarks import telemetry_drift as td
    from repro_torch.tuning import SpecController

    class Log(telemetry.RingBuffer):
        """The controller's events and the measured calls: like the
        controller's tap it reads measured events only, so it adds no
        event to an unmeasured call."""
        measured_only = True

        def emit(self, event):
            if "measured_s" in event or event["event"].startswith("tuning."):
                super().emit(event)

    rng = np.random.default_rng(0)
    tbl = atomics.make_table(td.LOCAL_M, torch.int32)
    work = [(b, op) for n in (4, 64, 512, td.GATE_N)
            for op in td._local_batches(n, "cuda", rng)
            for b in td._backends("cuda")]
    for b, op in work:                   # warm
        atomics.execute(tbl, op, backend=b)
    sync()
    windows, auto = [], []
    t0 = time.perf_counter()
    with telemetry.capture(Log(capacity=1 << 16)) as buf:
        with SpecController(device="cuda") as ctrl:
            while len(windows) < TN_WINDOWS:
                for b, op in work:
                    atomics.execute(tbl, op, backend=b)
                    out = ctrl.step()
                    if out is not None:
                        windows.append(out)
                        if len(windows) == TN_WINDOWS:
                            break
            stats = ctrl.stats()
            final = ctrl.active
    seconds = time.perf_counter() - t0
    measured = [e for e in buf.events
                if e["event"] == "atomics.execute" and "measured_s" in e]
    from repro_torch.core import rmw_engine
    # what auto picks for the traffic's batches, before and after
    auto = {}
    for n in (4, 64, 512, td.GATE_N):
        for kind, uniform in (("faa", True), ("cas", True)):
            auto[f"{kind}.{n}"] = [rmw_engine.select_backend(
                kind, n, td.LOCAL_M, spec, uniform_expected=uniform,
                dtype=torch.int32, device="cuda")
                for spec in (rmw_engine.calibrated_spec("cuda"), final)]
    events = [{k: v for k, v in e.items() if k != "t"} for e in buf.events
              if e["event"].startswith("tuning.")]
    quarantined = sorted({f for e in events
                          if e["event"] == "tuning.quarantine"
                          for f in e["fields"]})
    applied = [sorted(e["fields"]) for e in events
               if e["event"] == "tuning.apply"]
    return dict(windows=windows, stats=stats, seconds=seconds,
                batches=len(measured),
                measured_kinds=len({(e["op"], e["n"], e["backend"])
                                    for e in measured}),
                auto_before_after=auto,
                quarantined=quarantined,
                applied=applied, events=events,
                tuned_fields=stats["tuned_fields"])


def phase_tuning():
    """The tuning slice on the card, its own main path: the launch
    counters reset, the `contention_observe` and `tuning` suites (their
    gates raise inside the suites), their results checked and printed,
    then `_tuning_probe`; the counters read after.  Raises if the
    estimator was not fed from the device, a bit-identity run took the
    untuned run's choices on every batch, or `slot_counts`,
    `rmw_table_fetched` or `serial_rmw` never launched."""
    t0 = time.perf_counter()
    XK.reset_launches()
    K.reset_launches()
    results = _run_suites(list(TUNING_SUITES))
    probe = _tuning_probe()
    launches = {**dict(K.LAUNCHES), **dict(XK.LAUNCHES)}
    co, tn = results["contention_observe"], results["tuning"]
    est = co["estimator_feed"]
    if not (est["n_updates_device"] >= 1 and est["slot_counts_launches"]
            >= 1 and est["same_site_keys"]):
        raise AssertionError(f"estimator feed: {est}")
    bit = tn["bit_identity"]
    for tier in ("local", "sharded"):
        if not (bit[tier]["bit_equal"]
                and bit[tier]["batches_choice_differs"] >= 1):
            raise AssertionError(f"tuning bit identity {tier}: {bit[tier]}")
    missing = [k for k in ("slot_counts", "rmw_table_fetched", "serial_rmw")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"never launched by the tuning phase: "
                             f"{missing}")
    if len(probe["windows"]) != TN_WINDOWS:
        raise AssertionError(f"tuning probe: {probe['windows']}")
    emit("tuning", seconds=time.perf_counter() - t0, launches=launches,
         contention_overhead=co["overhead"], estimator_feed=est,
         sharded_observe={k: v for k, v in co["sharded"].items()
                          if k not in ("level_ops_in", "level_ops_out")},
         writers_per_slot=[{k: r[k] for k in (
             "writers_per_slot", "backend", "measured_wall_us", "kernels_us",
             "measured_bytes_per_s", "measured_max_occupancy",
             "predicted_serialized_bytes_per_s",
             "predicted_combining_bytes_per_s")}
             for r in co["model_vs_measured"]["rows"]],
         collapse=co["model_vs_measured"]["measured_collapse_factor"],
         convergence={k: tn["convergence"][k] for k in (
             "windows_to_converge", "outcomes", "fields",
             "selection_probe")},
         rollback=tn["rollback"], quarantine=tn["quarantine"],
         tuning_overhead={k: v for k, v in tn["overhead"].items()
                          if k != "controller"},
         bit_identity=bit)
    emit("tuning_probe", **probe)
    return launches


def phase_telemetry(drift_result):
    """The telemetry layer on the card: the `telemetry_drift` suite's
    result (run in `suites`): every tier drifted, every local
    `atomics.execute` event under sync measured and naming its backend,
    ``cuda`` among them, the overhead gate held; then `run_with_recovery`
    over an FAA step on a CUDA table under `TM_CHAOS` with a ring sink:
    `RunResult.telemetry_ring` must hold every ``chaos.fire`` and
    ``recovery.*`` event, the recovery events equal to `RunResult.events`
    in order, each raised fault right after the fire that caused it."""
    from repro_torch import telemetry
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     run_with_recovery)
    r = drift_result
    if r["tiers_covered"] != ["local", "migration", "sharded"]:
        raise AssertionError(f"telemetry_drift tiers: {r['tiers_covered']}")
    if not r["local_all_measured"] or "cuda" not in r["local_backends"]:
        raise AssertionError(f"telemetry_drift local events: backends "
                             f"{r['local_backends']}, all measured "
                             f"{r['local_all_measured']}")
    if not r["overhead"]["overhead"] < r["overhead"]["gate"]:
        raise AssertionError(f"telemetry overhead {r['overhead']}")
    store = {}

    def step(s, table):
        idx = (torch.arange(64, device="cuda", dtype=torch.int32) * (s + 1)
               ) % 1024
        return atomics.execute(table, atomics.Faa(
            idx, torch.ones(64, dtype=torch.int32, device="cuda"))).table

    def restore():
        if not store:
            return None
        last = max(store)
        return last, atomics.AtomicTable(store[last].clone())

    plan = FaultPlan.from_spec(TM_CHAOS, sleep_fn=lambda d: None)
    telemetry.enable(telemetry.RingBuffer(capacity=1 << 14), sync=True)
    try:
        res = run_with_recovery(
            step, lambda: atomics.make_table(1024, torch.int32), 8,
            FaultConfig(checkpoint_every=2, backoff_base_s=0.0),
            lambda s, t: store.__setitem__(s, t.data.clone()), restore,
            chaos=plan, sleep_fn=lambda d: None)
    finally:
        telemetry.disable()
    ring = res.telemetry_ring
    names = [e["event"] for e in ring]
    fires = [e for e in ring if e["event"] == "chaos.fire"]
    rec = [{k: v for k, v in e.items() if k != "t"} for e in ring
           if e["event"].startswith("recovery.")]
    if len(fires) != plan.total_fired or plan.total_fired < 3:
        raise AssertionError(f"telemetry ring: {len(fires)} chaos.fire "
                             f"events, the plan fired {plan.total_fired}")
    if rec != res.events:
        raise AssertionError("telemetry ring: the recovery events differ "
                             "from RunResult.events")
    for i, e in enumerate(ring):
        if e["event"] == "chaos.fire" and e["kind"] == "raise" and \
                names[i + 1] != "recovery.fault":
            raise AssertionError(f"telemetry ring: {e} not followed by its "
                                 f"recovery.fault ({names[i + 1]})")
    execs = [e for e in ring if e["event"] == "atomics.execute"]
    if not execs or not all(e.get("measured_s", 0) > 0 for e in execs):
        raise AssertionError("telemetry ring: unmeasured execute events")
    emit("telemetry", drift_rows=r["drift"], spec_update=r["spec_update"],
         spec_update_skipped=r["spec_update_skipped"],
         overhead=r["overhead"], n_events=r["n_events"],
         local_backends=r["local_backends"],
         recovery=dict(plan=TM_CHAOS, failures=res.failures,
                       fired=plan.total_fired, ring_events=len(ring),
                       sequence=[n for n in names
                                 if n != "atomics.execute"]))


def main():
    # f32 products in full f32 on the card (the plain versions' matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timeline = {}
    mark = [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, kept under ``name``."""
        now = time.perf_counter()
        timeline[name] = timeline.get(name, 0.0) + now - mark[0]
        mark[0] = now

    phase_device()
    phase_build()
    lap("device_build")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"rmw_table": 0.0, "rmw_table_fetched": 0.0, "slot_counts": 0.0,
            "fetched_normal_faa": 0.0, "serial_rmw": 0.0}
    phase_kernels(gen, errs)
    phase_serial_kernels(gen, errs)
    errs["ssd_chunk"] = phase_ssd_kernel(gen)
    errs["flash_attention"] = max(phase_flash_kernel(gen),
                                  phase_flash_dbrx(gen), phase_flash_mm(gen))
    lap("kernel_checks")

    K.reset_launches()                   # the main path starts here
    phase_atomics(gen)
    bfs_graph = phase_bfs()
    launches = dict(K.LAUNCHES)          # ... and ends here
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    phase_bfs_search(*bfs_graph)
    bfs_n, bfs_m = bfs_graph[0].shape[0], 1 << SCALE
    lap("atomics_bfs")

    launches.update(phase_serve())       # resets and reads its own count
    lap("serve")
    launches.update(phase_serve_gemma())  # the same
    lap("serve_gemma")
    for phase in (phase_serve_dbrx, phase_serve_jamba,    # the same, added
                  phase_serve_qwen2_vl, phase_serve_whisper):
        for k, v in phase().items():
            launches[k] += v
        lap(phase.__name__[len("phase_"):])

    rows = phase_timing(gen, bfs_n, bfs_m)
    lap("timing")
    suite_results, suite_launches = phase_suites()  # its own main path
    launches.update(suite_launches)
    rows += serial_timing(gen, suite_results["latency"])
    lap("suites")
    phase_telemetry(suite_results["telemetry_drift"])
    lap("telemetry")
    # the tuning slice's suites and live probe: its own counts, added
    for k, v in phase_tuning().items():
        launches[k] += v
    lap("tuning")
    # the sharded tier last, on the local BFS's graph: its main path runs
    # inside its ranks, which reset and read their own counts, and their
    # sums join the kernels line
    for k, v in phase_sharded(*bfs_graph).items():
        launches[k] += v
    lap("sharded")
    # ... then the elastic tier, whose ranks count the same way
    for k, v in phase_elastic().items():
        launches[k] += v
    lap("elastic")
    # ... then expert parallelism, whose ranks count the same way
    for k, v in phase_moe_ep().items():
        launches[k] += v
    lap("moe_ep")
    # training and deepseek_v3's serving launch no kernel (each phase
    # checks that), so they come after every count is read
    for phase in (phase_train_gemma, phase_train_check, phase_train_recovery,
                  phase_train_moe, phase_train_mm, phase_serve_deepseek,
                  phase_train_sharded):
        phase()
        lap(phase.__name__[len("phase_"):])
    headline = {"rmw_table": ("faa", "uniform_bfs_n"),
                "rmw_table_fetched": ("cas", "uniform_bfs_n"),
                "slot_counts": ("count", "uniform_bfs_n"),
                "ssd_chunk": ("serving", None),
                "flash_attention": ("prefill", None),
                "serial_rmw": ("faa", None), "chase": ("faa", None)}
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
        if name in ("rmw_table", "slot_counts"):
            # ... and at BFS's Kronecker skew, every op kept
            kron = next(r for r in rows if r["kernel"] == name
                        and r["op"] == op and r["shape"] == "kronecker")
            kernels[-1]["kronecker"] = {f: kron[f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    # flash_attention's headline is the prefill call; its decode call at
    # 1,600 rows goes beside it
    dec = next(r for r in rows if r["kernel"] == "flash_attention"
               and r["op"] == "decode")
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    fa["decode"] = {k: dec[k] for k in (
        "ms", "eager_ms", "host_us", "scratch_alloc_us", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}
    # ssd_chunk's headline is the group form serving calls; the reference's
    # per-head form at the same shape goes beside it
    per_head = next(r for r in rows if r["kernel"] == "ssd_chunk"
                    and r["op"] == "serving_per_head")
    sk = next(k for k in kernels if k["name"] == "ssd_chunk")
    sk["per_head"] = {k: per_head[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
    # rmw_table_fetched: the same call with 90% of ops dropped, as BFS's
    # levels run it (the bytes its stages move are in the timing rows)
    dropped = next(r for r in rows if r["kernel"] == "rmw_table_fetched"
                   and r["op"] == "cas" and r["shape"] == "bfs_90pct_dropped")
    rf = next(k for k in kernels if k["name"] == "rmw_table_fetched")
    rf["bfs_90pct_dropped"] = {k: dropped[k] for k in (
        "ms", "plain_ms", "bound_ms")}
    # the chase's ns per op at every tier and mode of the latency suite
    ch = next(k for k in kernels if k["name"] == "chase")
    ch["latency_ns"] = suite_results["latency"]
    emit("timeline", seconds=timeline, total_s=sum(timeline.values()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
