"""Contention observatory: `collect_stats=` measured end to end.

Port of `benchmarks/contention_observe.py`, at its sizes and gates.  Four
deliverables:

  bit identity       results with ``collect_stats=True`` and ``False`` are
                     digest-equal on the local tier (FAA + per-op CAS) and
                     on the sharded tier (4 ranks on a 2x2 ``("pod",
                     "dev")`` mesh over gloo, one launch: on the card the
                     ranks share it), with the stats exact.
  overhead gates     (a) ``collect_stats=False`` against the flag absent —
                     the same dispatch, so the delta is the timing's noise
                     floor, gated < 3% (`NOISE_GATE`); (b) the contended
                     retry workload — a CAS loop of n = 4,096 ops over 64
                     slots of 1,024, 64 writers a slot, to convergence
                     (`execute_until`, the round-0 device pass amortised
                     over 64 rounds) — with stats against without, gated
                     < 5% (`OVERHEAD_GATE`).  Both are the median over
                     interleaved pairs of batches of the ratio (the
                     telemetry suite's protocol, `common.paired_ratio`),
                     the ratio of minima beside it; the eager per-call
                     cost of the stats pass is reported, not gated.
  estimator feed     under a running `tuning.SpecController`,
                     `execute_until` feeds the contention estimator from
                     the device pass by default (on the card the
                     ``slot_counts`` kernel); its site keys and EWMA must
                     equal the host ``np.unique`` path's, with the device
                     counter populated (``n_updates_device``).
  model vs measured  the paper's Fig. 8 axis: writers per slot (4 -> 512,
                     plus 1) at n = 4,096, eager FAA's host wall (and, on
                     the card, its kernels' device time from a profiler
                     trace, `common.kernel_us`) and
                     the measured occupancy beside `core.contention`'s
                     serialized and combining predictions under the
                     device's spec.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        --only contention_observe [--fast] [--device cpu] [--out DIR]

The result goes to ``contention_observe.json`` under ``--out`` (no file
without it).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.benchmarks.common import Csv, kernel_us, paired_ratio

#: stats-on overhead on the contended retry workload, the acceptance bound
OVERHEAD_GATE = 0.05
#: stats-off must be indistinguishable from the flag not existing
NOISE_GATE = 0.03

_GATE_N = 4096
_GATE_M = 1024
#: writers per slot in the gate workload: 64 contenders on each of 64
#: slots -> 64 convergence rounds, the contended regime of Fig. 8
_GATE_DUP = 64
#: (pairs, calls a batch) of the noise gate and of the retry gate (one
#: workload is 64 rounds), full and fast
NOISE_PAIRS, RETRY_PAIRS = (100, 20), (30, 1)
FAST_PAIRS = 6
#: the sharded table's global slots; its batch (global ops), full and fast
SHARDED_M, SHARDED_N = 4096, (4096, 1024)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _digest(res, extra=()) -> str:
    h = hashlib.sha256()
    for a in (res.table.data, res.fetched, res.success, *extra):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def _bit_identity_local(device) -> Dict[str, object]:
    m = 256
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    idx_np = rng.integers(0, m, 2048)
    idx = t(idx_np)
    vals = t(rng.integers(-5, 6, 2048))
    exp = t(rng.integers(-1, 2, 2048))
    tbl = atomics.AtomicTable(t(rng.integers(-1, 2, m)))
    occ = np.bincount(idx_np, minlength=m)
    out: Dict[str, object] = {}
    for name, op in (("faa", atomics.Faa(idx, vals)),
                     ("cas_perop", atomics.Cas(idx, vals, expected=exp))):
        r_off = atomics.execute(tbl, op)
        r_on = atomics.execute(tbl, op, collect_stats=True)
        out[f"{name}_bit_identical"] = _digest(r_off) == _digest(r_on)
        st = r_on.stats
        out[f"{name}_distinct_exact"] = (
            int(st.distinct_slots) == int((occ > 0).sum()))
        out[f"{name}_max_occ_exact"] = int(st.max_occupancy) == int(occ.max())
    out["stats_off_is_none"] = atomics.execute(tbl, op).stats is None
    return out


def _sharded_rank(mesh, device: str, fast: bool) -> Dict[str, object]:
    """One rank of the sharded check (every rank runs it and returns the
    same record): a one-round FAA `execute_until` with stats and without,
    digests, the mesh-global stats against a host count, and host walls
    interleaved."""
    import time
    mesh.probe(torch.device(device))
    n = SHARDED_N[1] if fast else SHARDED_N[0]
    m = SHARDED_M
    idx = np.random.default_rng(7).integers(0, m // 2, size=n)  # half hot

    def make_ops(slots, observed):
        if slots is None:
            return atomics.Faa(torch.as_tensor(idx, dtype=torch.int32,
                                               device=device),
                               torch.ones((n,), dtype=torch.int32,
                                          device=device))
        return None

    def run(collect):
        res = atomics.execute_until(
            atomics.make_table(m, torch.int32, device=device, mesh=mesh,
                               axis=("pod", "dev")),
            make_ops, max_rounds=1, collect_stats=collect)
        _sync(device)
        return res

    def digest(res):
        rows = mesh.all_gather(res.table.data, ("pod", "dev"))
        return _digest(res, (rows, res.rounds))

    r_off, r_on = run(False), run(True)
    st = r_on.stats
    levels_in = st.level_ops_in.cpu().tolist()
    levels_out = st.level_ops_out.cpu().tolist()
    reps = 3 if fast else 5
    t_on, t_off = [], []
    for _ in range(reps):                        # interleaved, warm from above
        t0 = time.perf_counter()
        run(True)
        t_on.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(False)
        t_off.append(time.perf_counter() - t0)
    return {
        "bit_identical": digest(r_off) == digest(r_on),
        "stats_off_is_none": r_off.stats is None,
        "distinct_device": int(st.distinct_slots),
        "distinct_host": int(np.unique(idx).size),
        "max_occupancy": int(st.max_occupancy),
        "n_ops": int(st.n_ops),
        "level_ops_in": levels_in,
        "level_ops_out": levels_out,
        "levels_monotone": all(o <= i for i, o in zip(levels_in,
                                                      levels_out)),
        "on_s": min(t_on), "off_s": min(t_off),
    }


def sharded(device, fast: bool) -> Dict[str, object]:
    from repro_torch.launch import ranks
    dev = torch.device(device).type
    out = ranks.launch(
        "repro_torch.benchmarks.contention_observe:_sharded_rank", 4,
        mesh=((2, 2), ("pod", "dev")), args=(dev, fast), device=dev,
        timeout=900)
    same = all({k: v for k, v in r.items() if k not in ("on_s", "off_s")}
               == {k: v for k, v in out[0].items()
                   if k not in ("on_s", "off_s")} for r in out)
    return {**out[0], "ranks_agree": same}


def _retry_workload(device, collect) -> None:
    """The gate workload: `_GATE_DUP` writers per slot, full convergence."""
    idx = torch.as_tensor(np.tile(np.arange(_GATE_N // _GATE_DUP,
                                            dtype=np.int32), _GATE_DUP),
                          device=device)
    ones = torch.ones((_GATE_N,), dtype=torch.int32, device=device)
    zeros = torch.zeros((_GATE_N,), dtype=torch.int32, device=device)

    def make_ops(slots, observed):
        if slots is None:
            return atomics.Cas(idx, ones, expected=zeros)
        return observed + 1

    res = atomics.execute_until(
        atomics.make_table(_GATE_M, torch.int32, device=device), make_ops,
        max_rounds=_GATE_DUP + 1, collect_stats=collect)
    assert res.success.all()


def overhead(device, fast: bool) -> Dict[str, object]:
    """The two gates (module docstring) and the eager per-call cost."""
    m, n = _GATE_M, _GATE_N
    rng = np.random.default_rng(5)
    tbl = atomics.make_table(m, torch.int32, device=device)
    op = atomics.Faa(torch.as_tensor(rng.integers(0, m, n), dtype=torch.int32,
                                     device=device),
                     torch.ones((n,), dtype=torch.int32, device=device))

    def eager(**kw):
        atomics.execute(tbl, op, **kw)
        _sync(device)

    for kw in ({}, {"collect_stats": False}, {"collect_stats": True}):
        eager(**kw)                              # warm every path
    _retry_workload(device, True)                # warm every round shape
    _retry_workload(device, False)

    def noise_pair():
        pairs, batch = NOISE_PAIRS
        return paired_ratio(lambda: eager(collect_stats=False), eager,
                            batch=batch,
                            n_batches=FAST_PAIRS if fast else pairs)

    def retry_pair():
        pairs, batch = RETRY_PAIRS
        return paired_ratio(lambda: _retry_workload(device, True),
                            lambda: _retry_workload(device, False),
                            batch=batch,
                            n_batches=FAST_PAIRS if fast else pairs)

    noise, retry = noise_pair(), retry_pair()
    if retry["overhead"] >= OVERHEAD_GATE or noise["overhead"] >= NOISE_GATE:
        # one more full attempt before declaring a regression, each gate
        # keeping its lower reading, as the reference does: on a shared
        # host noise only fakes failures
        noise = min(noise, noise_pair(), key=lambda r: r["overhead"])
        retry = min(retry, retry_pair(), key=lambda r: r["overhead"])
    pairs, batch = NOISE_PAIRS
    eager_stats = paired_ratio(lambda: eager(collect_stats=True), eager,
                               batch=batch,
                               n_batches=FAST_PAIRS if fast else pairs)
    return {
        "noise_floor": noise["overhead"],
        "noise_floor_of_minima": noise["overhead_of_minima"],
        "noise_gate": NOISE_GATE,
        "eager_base_us": eager_stats["b_us"],
        "eager_stats_us": eager_stats["a_us"],
        "eager_per_call_overhead_ungated": eager_stats["overhead"],
        "retry_n": _GATE_N, "retry_m": _GATE_M,
        "retry_writers_per_slot": _GATE_DUP,
        "retry_off_ms": retry["b_us"] / 1e3,
        "retry_on_ms": retry["a_us"] / 1e3,
        "retry_overhead": retry["overhead"],
        "retry_overhead_of_minima": retry["overhead_of_minima"],
        "pairs": {"noise": noise["pairs"], "retry": retry["pairs"]},
        "gate": OVERHEAD_GATE,
    }


def estimator_feed(device) -> Dict[str, object]:
    """The same contended CAS loop under a fresh controller twice: host
    count (``collect_stats=False``), then the default (device pass)."""
    from repro_torch.kernels.rmw import kernel as K
    from repro_torch.tuning import SpecController, TuningConfig, site_key
    idx = torch.as_tensor(np.tile(np.arange(32, dtype=np.int32), 8),
                          device=device)

    def loop(collect):
        def make_ops(slots, observed):
            if slots is None:
                return atomics.Cas(
                    idx, torch.ones((256,), dtype=torch.int32, device=device),
                    expected=torch.zeros((256,), dtype=torch.int32,
                                         device=device))
            return observed + 1

        return atomics.execute_until(
            atomics.make_table(64, torch.int32, device=device), make_ops,
            max_rounds=16, collect_stats=collect)

    key = site_key("cas", "local", 64, 256)
    with SpecController(TuningConfig(), device=device) as ctrl:
        loop(False)                              # host np.unique path
        host_sites = ctrl.estimator.sites()
        host_updates = ctrl.estimator.n_updates_host
    counts0 = K.LAUNCHES["slot_counts"]
    with SpecController(TuningConfig(), device=device) as ctrl:
        res = loop(None)                         # default -> device pass
        device_sites = ctrl.estimator.sites()
        device_updates = ctrl.estimator.n_updates_device
    return {
        "host_sites": len(host_sites), "device_sites": len(device_sites),
        "same_site_keys": sorted(host_sites) == sorted(device_sites),
        "host_raw": host_sites.get(key), "device_raw": device_sites.get(key),
        "host_updates": host_updates, "n_updates_device": device_updates,
        "slot_counts_launches": K.LAUNCHES["slot_counts"] - counts0,
        "stats_returned": res.stats is not None,
        "distinct_agree": host_sites.get(key) == device_sites.get(key),
    }


def _min_wall_us(call, *, batch: int, reps: int) -> float:
    """Least host µs a call over ``reps`` batches of ``batch`` calls."""
    import time
    call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(batch):
            call()
        best = min(best, (time.perf_counter() - t0) / batch)
    return best * 1e6


def model_vs_measured(device, fast: bool) -> Dict[str, object]:
    from repro_torch.core import contention as cmodel
    from repro_torch.core import rmw_engine
    spec = rmw_engine.default_spec(device)
    cuda = torch.device(device).type == "cuda"
    n, m = _GATE_N, _GATE_M
    reps = 3 if fast else 5
    rows = []
    # 4 is the floor that still fits n // dup distinct slots in the table;
    # 1 (every op its own slot) is the uncontended end
    for dup in (1, 4, 16, 64, 512):
        idx = torch.as_tensor(np.tile(np.arange(n // dup, dtype=np.int32),
                                      dup) % m, device=device)
        op = atomics.Faa(idx, torch.ones((n,), dtype=torch.int32,
                                         device=device))
        tbl = atomics.make_table(m, torch.int32, device=device)

        def call(op=op, tbl=tbl):
            atomics.execute(tbl, op)
            _sync(device)

        wall = _min_wall_us(call, batch=10, reps=reps)
        st = atomics.execute(tbl, op, collect_stats=True).stats
        rows.append({
            "writers_per_slot": dup,
            "backend": rmw_engine.select_backend(
                "faa", n, m, dtype=torch.int32, device=device),
            "measured_bytes_per_s": n * 4 / (wall * 1e-6),
            "measured_wall_us": wall,
            "kernels_us": (kernel_us(lambda: atomics.execute(tbl, op),
                                     reps=reps) if cuda else None),
            "measured_max_occupancy": int(st.max_occupancy),
            "measured_distinct_slots": int(st.distinct_slots),
            "occupancy_hist": st.occupancy_hist.cpu().tolist(),
            "predicted_serialized_bytes_per_s":
                cmodel.contended_bandwidth_serialized(spec, "faa", dup,
                                                      operand_bytes=4),
            "predicted_combining_bytes_per_s":
                cmodel.contended_bandwidth_combining(spec, "faa", dup,
                                                     operand_bytes=4,
                                                     batch_per_writer=dup),
        })
    by = {r["writers_per_slot"]: r for r in rows}
    return {"rows": rows,
            # the combine-tier claim: throughput at 512 writers a slot
            # stays within a few x of 4 (the serialized model predicts a
            # collapse orders of magnitude deeper)
            "measured_collapse_factor": by[4]["measured_bytes_per_s"]
            / by[512]["measured_bytes_per_s"]}


def run(csv: Csv, fast: bool = False, device="cuda",
        out_path: Optional[str] = None) -> Dict[str, object]:
    local_ident = _bit_identity_local(device)
    sh = sharded(device, fast)
    ovh = overhead(device, fast)
    est = estimator_feed(device)
    model = model_vs_measured(device, fast)

    csv.add("contention_observe.noise_floor", ovh["noise_floor"] * 100,
            f"off-vs-absent pct, gate<{NOISE_GATE * 100:.0f}pct")
    csv.add("contention_observe.retry_overhead", ovh["retry_overhead"] * 100,
            f"n={_GATE_N} dup={_GATE_DUP} on={ovh['retry_on_ms']:.1f}ms "
            f"off={ovh['retry_off_ms']:.1f}ms "
            f"gate<{OVERHEAD_GATE * 100:.0f}pct")
    csv.add("contention_observe.eager_per_call",
            ovh["eager_per_call_overhead_ungated"] * 100,
            "pct, informational (the stats pass on one eager call)")
    csv.add("contention_observe.sharded_overhead",
            (sh["on_s"] / sh["off_s"] - 1.0) * 100,
            f"pct, informational (4 ranks, n_ops={sh['n_ops']})")
    for r in model["rows"]:
        csv.add(f"contention_observe.bw.dup{r['writers_per_slot']}",
                r["measured_bytes_per_s"] / 1e6,
                f"MB/s max_occ={r['measured_max_occupancy']} "
                f"pred_ser={r['predicted_serialized_bytes_per_s'] / 1e6:.3g} "
                f"pred_comb={r['predicted_combining_bytes_per_s'] / 1e6:.3g}")

    identity_ok = (all(local_ident.values()) and sh["bit_identical"]
                   and sh["stats_off_is_none"] and sh["ranks_agree"]
                   and sh["distinct_device"] == sh["distinct_host"]
                   and sh["levels_monotone"])
    est_ok = (est["same_site_keys"] and est["n_updates_device"] >= 1
              and est["distinct_agree"] and est["stats_returned"]
              and (torch.device(device).type != "cuda"
                   or est["slot_counts_launches"] >= 1))
    gates_ok = (ovh["retry_overhead"] < OVERHEAD_GATE
                and ovh["noise_floor"] < NOISE_GATE)
    acceptance = identity_ok and est_ok and gates_ok
    out = {
        "fast": fast, "device": str(device),
        "bit_identity_local": local_ident,
        "sharded": sh,
        "overhead": ovh,
        "estimator_feed": est,
        "model_vs_measured": model,
        "acceptance_bit_identical_overhead_and_device_feed":
            bool(acceptance),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if not acceptance:
        raise AssertionError(
            f"contention observe acceptance failed: identity={identity_ok} "
            f"est={est_ok} retry_overhead={ovh['retry_overhead']:.4f} "
            f"noise={ovh['noise_floor']:.4f}")
    return out
