#!/usr/bin/env python3
"""One tree's numbers for a parent-against-change comparison on one card.

    python3 tools/ab_probe.py TREE [SECTION ...]

TREE is a checkout of this repository (the working tree, or a parent
commit unpacked with `git archive` into a directory `.gitignore` lists);
its `src/` is imported and its kernels are built into its own `build/`.
Run the trees in turns in one call, parent, change, change, parent, e.g.

    for t in build/parent . . build/parent; do
        python3 tools/ab_probe.py $t; done

Prints one JSON line of the SECTIONs asked for (default: all):
``mamba``, mamba2_780m's prefill of its 3,523-token serving prompt at full
width and depth, bf16, random weights from seed 0 (host ms of one call;
busy ms, kernel count, idle share and `ssd_chunk` ms of two traced calls);
``ssd``, `ssd_chunk` at the serving shape per head, and in group form
where the tree's kernel takes groups; ``rmw``, the RMW kernels at BFS's
shape (n = 2^25 ops over m = 2^20 uniform slots, int32, and fp32 MIN/MAX
there and contended, n = 2^22 over m = 1024); ``bfs``, Graph500 BFS's
search at scale 20, edgefactor 16, the edges on the card, per op (cas,
swp, faa): host ms of one call, and of two traced calls the device's busy
ms, the RMW kernels' ms and the table-only kernels' ms; ``decode``,
mamba2_780m's and gemma_2b's decode at full width and depth, bf16, random
weights from seed 0, from the cache of the 3,523-token serving prompt:
host ms a token over 32 steps after 4 untimed, and one traced step.
"""

import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


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


def trace(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in dev) / 1e6
    span = (max(e.end_ns() for e in dev)
            - min(e.start_ns() for e in dev)) / 1e6
    ssd = sum(e.duration_ns() for e in dev if "ssd_chunk" in e.name()) / 1e6
    return dict(kernels=len(dev), busy_ms=busy, span_ms=span,
                idle_share=1 - busy / span, ssd_chunk_ms=ssd)


# the RMW kernels, and of them the table-only ones, as the device trace
# names them in either tree (before and after their redesign)
RMW_KERNELS = ("rmw_table_kernel", "table_combine_kernel", "swp_write_kernel",
               "fetched_", "cas_success_kernel", "slot_counts")
TABLE_KERNELS = ("rmw_table_kernel", "table_combine_kernel",
                 "swp_write_kernel")


def bfs_trace(fn):
    """Host ms of one ``fn()``, then busy, RMW-kernel and table-kernel ms of
    two traced calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out = {"host_ms": 1e3 * (time.perf_counter() - t0), "traces": []}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        out["traces"].append({
            "busy_ms": sum(e.duration_ns() for e in dev) / 1e6,
            "rmw_ms": sum(e.duration_ns() for e in dev
                          if any(k in e.name() for k in RMW_KERNELS)) / 1e6,
            "table_ms": sum(e.duration_ns() for e in dev
                            if any(k in e.name() for k in TABLE_KERNELS))
            / 1e6})
    return out


def probe_bfs(out, bfs_mod):
    src, dst = bfs_mod.kronecker_graph(20, 16, seed=0)
    s_dev = torch.as_tensor(np.concatenate([src, dst])).cuda().int()
    d_dev = torch.as_tensor(np.concatenate([dst, src])).cuda().int()
    root = int(s_dev[0])
    for op in ("cas", "swp", "faa"):
        out[f"bfs_search_{op}"] = bfs_trace(
            lambda: bfs_mod.bfs(s_dev, d_dev, 1 << 20, root=root, op=op))


def probe_mamba(out, get_config, LM):
    cfg = get_config("mamba2_780m")
    model = LM(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)            # chip_smoke.py's prompts
    lengths = [int(v) for v in rng.integers(256, 4097, 8)]
    prompt = rng.integers(0, cfg.vocab_size, lengths[0]).tolist()
    toks = torch.tensor([prompt], device="cuda")
    model.prefill({"tokens": toks[:, :300]}, 4096)

    def prefill():
        model.prefill({"tokens": toks}, 4096)
    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    out["prefill_tokens"] = lengths[0]
    out["prefill_host_ms"] = 1e3 * (time.perf_counter() - t0)
    out["prefill_traces"] = [trace(prefill) for _ in range(2)]
    del model
    torch.cuda.empty_cache()


def probe_decode(out, get_config, LM):
    rng = np.random.default_rng(0)            # chip_smoke.py's prompts
    lengths = [int(v) for v in rng.integers(256, 4097, 8)]
    for arch in ("mamba2_780m", "gemma_2b"):
        cfg = get_config(arch)
        model = LM(cfg, seed=0, device="cuda")
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   lengths[0]).tolist()
        toks = torch.tensor([prompt], device="cuda")
        cache, _ = model.prefill({"tokens": toks}, 4096 + 16)
        tok = toks[:, -1:]

        def step():
            model.decode_step(cache, {"tokens": tok})
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            step()
        torch.cuda.synchronize()
        out[f"{arch}_decode_host_ms"] = 1e3 * (time.perf_counter() - t0) / 32
        out[f"{arch}_decode_trace"] = trace(step)
        del model, cache
        torch.cuda.empty_cache()


def probe_ssd(out, gen, SK):
    bh, s, q = 48, 4096, 256
    xdt = torch.randn((bh, s, 64), generator=gen, device="cuda") * 0.1
    adt = -torch.rand((bh, s), generator=gen, device="cuda") * 0.3
    B, C = (torch.randn((1, s, 128), generator=gen, device="cuda")
            for _ in range(2))
    Bh, Ch = (t.expand(bh, -1, -1).contiguous() for t in (B, C))
    out["ssd_chunk_per_head_ms"] = time_ms(
        lambda: SK.ssd_chunk(xdt, adt, Bh, Ch, chunk=q))
    try:
        out["ssd_chunk_group_ms"] = time_ms(
            lambda: SK.ssd_chunk(xdt, adt, B, C, chunk=q,
                                 heads_per_group=bh))
    except TypeError:                          # a tree without groups
        out["ssd_chunk_group_ms"] = None


def probe_rmw(out, gen, K):
    n, m = 1 << 25, 1 << 20
    idx = torch.randint(0, m, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tab = torch.randint(-8, 9, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    val = torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    for op in ("faa", "min", "max", "swp"):
        out[f"rmw_table_{op}_ms"] = time_ms(
            lambda: K.rmw_table(tab, idx, val, op))
    out["slot_counts_ms"] = time_ms(lambda: K.slot_counts(idx, m))
    for op in ("faa", "min", "cas"):
        exp = 0 if op == "cas" else None
        out[f"rmw_table_fetched_{op}_ms"] = time_ms(
            lambda: K.rmw_table_fetched(tab, idx, val, op, expected=exp))
    ftab, fval = tab.float(), val.float()
    idc = torch.randint(0, 1024, (1 << 22,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tc = torch.randn((1024,), generator=gen, device="cuda")
    vc = torch.randn((1 << 22,), generator=gen, device="cuda")
    for op in ("min", "max"):
        out[f"rmw_table_fp32_{op}_ms"] = time_ms(
            lambda: K.rmw_table(ftab, idx, fval, op))
        out[f"rmw_table_fp32_{op}_contended_ms"] = time_ms(
            lambda: K.rmw_table(tc, idc, vc, op))


def main():
    tree = sys.argv[1]
    sections = sys.argv[2:] or ["mamba", "ssd", "rmw", "bfs"]
    sys.path.insert(0, f"{tree}/src")
    from repro_torch.configs import get_config
    from repro_torch.core import bfs as bfs_mod
    from repro_torch.kernels.rmw import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models.model import LM

    if not torch.cuda.is_available():
        raise SystemExit("ab_probe: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": tree}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if "mamba" in sections:
        probe_mamba(out, get_config, LM)
    if "decode" in sections:
        probe_decode(out, get_config, LM)
    if "ssd" in sections:
        probe_ssd(out, gen, SK)
    if "rmw" in sections:
        probe_rmw(out, gen, K)
    if "bfs" in sections:
        probe_bfs(out, bfs_mod)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
