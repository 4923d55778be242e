#!/usr/bin/env python3
"""The multimodal and telemetry phases of `chip_smoke.py`, alone, on one card.

    python3 tools/mm_probe.py phases        # flash_mm and its timing rows,
                                            # serve_qwen2_vl, serve_whisper,
                                            # train_mm, the telemetry_drift
                                            # suite and the telemetry phase
    python3 tools/mm_probe.py overhead [N]  # the telemetry overhead sweep
                                            # N times (default 5)
    python3 tools/mm_probe.py train LR      # qwen2_vl_2b and whisper_small
                                            # at full width, 10 steps at LR

Run from the repository root on a machine with one CUDA card; it builds
the kernels it needs from the checkout.  ``phases`` prints the smoke's
JSON lines and ``TIME <phase> <seconds>`` for each, and exits 1 if a phase
failed (every phase runs); ``overhead`` prints each sweep and a
``SUMMARY`` line of (paired median, ratio of minima) per size and the
unsynchronised call's paired median (``host_only``); ``train``
prints each model's losses and median step ms.
"""

import json
import os
import statistics
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
import torch  # noqa: E402


def phases() -> int:
    C.phase_device()
    C.phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failed = []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 — report it and run the rest
            traceback.print_exc()
            failed.append(name)
            out = None
        print("TIME", name, time.perf_counter() - t0, flush=True)
        return out

    def rows():
        for name, args, kw, s, cached, hq, hkv, d in C._mm_flash_calls(gen):
            C.emit("timing", **C._fa_row(name, args, kw, s, cached, hq, hkv,
                                         d))

    def telemetry():
        from repro_torch.benchmarks import telemetry_drift
        from repro_torch.benchmarks.common import Csv
        C.phase_telemetry(telemetry_drift.run(Csv(), device="cuda"))

    run("flash_mm", C.phase_flash_mm, gen)
    run("flash_rows", rows)
    run("serve_qwen2_vl", C.phase_serve_qwen2_vl)
    run("serve_whisper", C.phase_serve_whisper)
    run("train_mm", C.phase_train_mm)
    run("telemetry", telemetry)
    print("FAILED", json.dumps(failed), flush=True)
    return 1 if failed else 0


def overhead(n: int) -> int:
    from repro_torch.benchmarks import telemetry_drift
    from repro_torch.kernels.rmw import kernel as K
    C.phase_device()
    K.LIBRARY.load()
    summary = []
    for _ in range(n):
        out = telemetry_drift.overhead("cuda", fast=False)
        print(json.dumps(out), flush=True)
        summary.append({k: (v["overhead"], v["overhead_of_minima"])
                        for k, v in out["eager_sweep"].items()})
        summary[-1]["host_only"] = out["host_only"]["overhead"]
    print("SUMMARY", json.dumps(summary), flush=True)
    return 0


def train(lr: float) -> int:
    from repro_torch.launch import train as train_mod
    C.phase_device()
    for arch in (C.QW, C.WH):
        res = train_mod.train(arch, steps=C.MM_TRAIN_STEPS, seq_len=C.T_SEQ,
                              global_batch=C.T_BATCH, reduced=False, lr=lr,
                              remat_policy="none", log_every=1,
                              device="cuda")
        hist = res["history"]
        print(json.dumps({"arch": arch, "lr": lr,
                          "losses": [h["loss"] for h in hist],
                          "step_ms": 1e3 * statistics.median(
                              h["sec"] for h in hist[2:])}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


def main(argv) -> int:
    if argv[:1] == ["phases"]:
        return phases()
    if argv[:1] == ["overhead"]:
        return overhead(int(argv[1]) if len(argv) > 1 else 5)
    if argv[:1] == ["train"] and len(argv) == 2:
        return train(float(argv[1]))
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
