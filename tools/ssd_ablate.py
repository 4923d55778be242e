#!/usr/bin/env python3
"""Stage ablations of the SSD chunk kernel on one CUDA card.

    python3 tools/ssd_ablate.py [VARIANT ...]

Run from the repository root on a machine with a card and nvcc.  Each
variant is a copy of `src/repro_torch/kernels/ssd/csrc/ssd.cu` with one
stage cut or one choice forced (written under `build/ssd_ablate/`, built as
its own library); all are timed in turns, twice, with CUDA events at
mamba2_780m's shapes: BH 48 in one group (serving), the same per head, and
BH 192 in four groups (batch4); S 4096, P 64, N 128, Q 256.  A cut variant
computes something else: only its time means anything.  Prints the card's
name and power limit, then one JSON line per shape.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels.build import BUILD_DIR, NvccLibrary  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402

HPC_RULE = ("    if (best == 0 || tiles * (hpg / h) + state_ctas >= 2LL * "
            "sms) best = h;")
# variant -> (text in ssd.cu, its replacement), applied in order
VARIANTS = {
    "full": [],
    # the y CTAs alone, the state CTAs alone
    "no_state": [("    if (a.hps == 2)\n      state_role<8>",
                  "    return;\n    if (a.hps == 2)\n      state_role<8>")],
    "no_y": [("  y_role<NT8>(a, smem, gc / nc, gc % nc, hb, ti);",
              "  return;")],
    # the y CTAs' scores (phase 1) with the state CTAs
    "y_phase1_only": [("  // phase 2: per pass", "  return;\n  // phase 2")],
    # one TF32 product in place of three: the cost of f32 accuracy
    "one_mma": [("  mma_tf32(d[0], al[0], b0h, b1h);\n"
                 "  mma_tf32(d[1], al[1], b0h, b1h);\n"
                 "  mma_tf32(d[0], ah[0], b0l, b1l);\n"
                 "  mma_tf32(d[1], ah[1], b0l, b1l);\n", "")],
    # the B operands passed unsplit: the cost of splitting them per warp
    "no_split_b": [("  split(b0, b0h, b0l);\n  split(b1, b1h, b1l);",
                    "  b0h = b0l = __float_as_uint(b0);\n"
                    "  b1h = b1l = __float_as_uint(b1);")],
    # the mask's exponentials left out
    "no_exp": [(f"exp2f(lt[mt][{i}] - l{c})", "1.f")
               for i in (0, 1) for c in "ab"],
    # heads per y CTA forced to 4, or to 8 (the rule takes 16 at serving)
    "hpc4": [(HPC_RULE, "    if (best == 0) best = h;")],
    "hpc8": [(HPC_RULE, "    if (h <= 8) best = h;")],
}
SHAPES = (("serving", 48, 48), ("per_head", 48, 1), ("batch4", 192, 48))


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablate: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    src = SK.LIBRARY.source.read_text()
    out_dir = BUILD_DIR.parent / "ssd_ablate"
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"ssd_ablate: {name}: cut not found")
            text = text.replace(old, new)
        path = out_dir / f"ssd_{name}.cu"
        path.write_text(text)
        libs[name] = NvccLibrary(f"ssd_{name}", path, SK.LIBRARY.signatures)
    with ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(lambda lib: lib.load(),
                                        libs.values())))
    for name, b in built.items():
        used = [ln.strip() for ln in b.log.splitlines() if "Used" in ln]
        print(json.dumps({"variant": name, "ptxas": used}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    s, q, p, n = 4096, 256, 64, 128
    for shape, bh, hpg in SHAPES:
        xdt = torch.randn((bh, s, p), generator=gen, device="cuda") * 0.1
        adt = -torch.rand((bh, s), generator=gen, device="cuda") * 0.3
        B, C = (torch.randn((bh // hpg, s, n), generator=gen, device="cuda")
                for _ in range(2))
        y = torch.empty_like(xdt)
        st = torch.empty((bh, s // q, n, p), device="cuda")

        def run(lib):
            lib.launch("ssd_chunk_launch", xdt.data_ptr(), adt.data_ptr(),
                       B.data_ptr(), C.data_ptr(), y.data_ptr(),
                       st.data_ptr(), bh, s, q, p, n, hpg,
                       torch.cuda.current_stream().cuda_stream)
        ms = {}
        for _ in range(2):
            for name, lib in libs.items():
                ms.setdefault(name, []).append(time_ms(lambda: run(lib)))
        print(json.dumps({"shape": shape, "bh": bh, "heads_per_group": hpg,
                          "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
