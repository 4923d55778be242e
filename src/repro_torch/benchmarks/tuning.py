"""Self-tuning: the guarded spec controller measuring itself.

Port of `benchmarks/tuning.py`, with its four gates:

  convergence      a controller driven by closed-loop drift windows against
                   a "true" spec (two constants mis-calibrated 4x slow and
                   4x fast, the first window skewed by the ``spec_perturb``
                   chaos site) must walk every tuned constant to within 25%
                   (log space) of the truth in <= 12 update windows.
  rollback         after a confirmed honest apply, one regressed window must
                   reinstall the previous spec in exactly one update and
                   restore it bit-equal.  A NaN-poisoned window (chaos) must
                   quarantine, and the same window without chaos must apply.
  overhead         a *live* controller (sink attached, sync on, `step()`
                   every call, its update cycles) on eager FAA at n = 4,096
                   must cost < 5% against the stream off: the median over
                   interleaved pairs of batches of `SYNC_EVERY` calls (one
                   measured call a batch on the card, on average) of the
                   ratio,
                   `common.paired_ratio`; the update cycle is also timed on
                   its own.
  bit identity     tuned and untuned runs of a deterministic int32 FAA +
                   fetched-sum workload are bit-equal — on the local tier,
                   and (full runs only) on 4 ranks on a 2x2 mesh with the
                   contention estimator live on a contended CAS loop.  The
                   tuned run must take another backend or strategy than the
                   untuned run on at least one batch (read from both runs'
                   ``atomics.execute`` events), or the check could not
                   fail: it starts from a restored state file whose spec
                   (`FLIP`) moves the selection of the workload's batch,
                   and its windows (every call measured) also fit the
                   drift of probe batches forced onto the ``onehot`` and
                   ``serialized`` backends.

The selection probe is information only: how often the tuned spec and the
truth pick the same local backend across a size sweep.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only tuning \\
        [--fast] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import atomics, telemetry
from repro_torch.benchmarks.common import Csv, paired_ratio
from repro_torch.core import perf_model, rmw_engine
from repro_torch.runtime.chaos import FaultPlan, SiteSpec
from repro_torch.tuning import SpecController, TuningConfig
from repro_torch.tuning.controller import SYNC_EVERY

#: live-controller overhead on eager execute, the acceptance bound
OVERHEAD_GATE = 0.05
#: ... and convergence: |log(tuned / truth)| per field after the run
CONVERGENCE_LOG_TOL = 0.25
MAX_WINDOWS = 12

#: the deliberate mis-calibration the controller must correct: one
#: constant 4x slow (needs two clamped applies), one 4x fast
TRUTH_FACTORS = {"loop_step_s": 4.0, "gather_elem_s": 0.25}
_FIELD_GROUP = {"loop_step_s": "serialized", "gather_elem_s": "onehot"}
P0 = 1e-5
#: (pairs, calls a batch) of the overhead gate, full and fast: a batch of
#: `tuning.controller.SYNC_EVERY` calls holds one measured call on the
#: card on average (0-2: one at a random place in each run of that many)
OVERHEAD_PAIRS, FAST_PAIRS = 100, 6
OVERHEAD_BATCH = SYNC_EVERY

#: the bit-identity workload: steps of an FAA batch of 16 ops over 64 slots
_N_STEPS, _M, _N = 16, 64, 16
#: the restored state's change (factors on the calibrated spec, inside the
#: quarantine envelope): the workload batch's auto backend moves, from
#: `sort` to `cuda` on the card and from `sort` to `onehot` on the CPU
FLIP = {"gather_elem_s": 32.0, "sort_elem_pass_s": 32.0}


def _perturb_seed(pick) -> int:
    """First seed whose deterministic spec_perturb draw satisfies
    ``pick``."""
    for seed in range(256):
        plan = FaultPlan(seed, {"spec_perturb": SiteSpec(prob=1.0)})
        plan.fire("spec_perturb")
        if pick(plan.param("spec_perturb")):
            return seed
    raise RuntimeError("no seed in 0..255 draws the wanted parameter")


def _drive_window(ctrl: SpecController, factors: Dict[str, float]):
    """One closed-loop drift window: predictions priced off the ACTIVE
    spec, measurements off the truth (``base * factor``)."""
    per = max(1, ctrl.cfg.min_events // len(factors))
    for field, factor in factors.items():
        k = getattr(ctrl.active, field) / getattr(ctrl.base, field)
        for _ in range(per):
            telemetry.record("atomics.execute", tier="local",
                             backend=_FIELD_GROUP[field], op="faa", n=256,
                             predicted_s=P0 * k, measured_s=P0 * factor)
    return ctrl.step()


def _log_errs(ctrl: SpecController) -> Dict[str, float]:
    return {f: abs(math.log(getattr(ctrl.active, f)
                            / (getattr(ctrl.base, f) * factor)))
            for f, factor in TRUTH_FACTORS.items()}


def convergence(csv: Csv, device) -> Dict[str, object]:
    skew = _perturb_seed(
        lambda u: u < 0.5 and abs(4.0 * u - 1.0) * math.log(8.0) > 0.3)
    plan = FaultPlan(skew, {"spec_perturb": SiteSpec(prob=1.0, count=1)})
    cfg = TuningConfig(cooldown_updates=0)
    outcomes: List[str] = []
    converged_at = None
    with SpecController(cfg, chaos=plan, device=device) as ctrl:
        for w in range(1, MAX_WINDOWS + 1):
            outcomes.append(_drive_window(ctrl, TRUTH_FACTORS))
            if max(_log_errs(ctrl).values()) < CONVERGENCE_LOG_TOL:
                converged_at = w
                break
        errs = _log_errs(ctrl)
        fields = {f: {"calibrated": getattr(ctrl.base, f),
                      "truth": getattr(ctrl.base, f) * factor,
                      "tuned": getattr(ctrl.active, f),
                      "log_err": errs[f]}
                  for f, factor in TRUTH_FACTORS.items()}
        probe = _selection_probe(ctrl, device)
        stats = ctrl.stats()
    for f, info in fields.items():
        csv.add(f"tuning.converge.{f}", info["tuned"] * 1e6,
                f"truth={info['truth'] * 1e6:.3g}us "
                f"log_err={info['log_err']:.3f} "
                f"tol<{CONVERGENCE_LOG_TOL}")
    csv.add("tuning.converge.windows",
            float(converged_at or MAX_WINDOWS + 1),
            f"max={MAX_WINDOWS} outcomes={'/'.join(outcomes)} "
            f"perturbs={stats['perturbs']}")
    return {"skew_seed": skew, "windows_to_converge": converged_at,
            "outcomes": outcomes, "fields": fields,
            "selection_probe": probe, "controller": stats,
            "ok": converged_at is not None}


def _selection_probe(ctrl: SpecController, device) -> Dict[str, object]:
    """Information only: does the tuned spec pick the same local backend
    as the truth spec would?  Probed across a batch-size sweep at m =
    1024."""
    truth = dataclasses.replace(
        ctrl.base, **{f: getattr(ctrl.base, f) * factor
                      for f, factor in TRUTH_FACTORS.items()})
    agree, rows = 0, {}
    sizes = (4, 32, 256, 2048)
    for n in sizes:
        a = rmw_engine.select_backend("faa", n, 1024, ctrl.active,
                                      dtype=torch.int32, device=device)
        b = rmw_engine.select_backend("faa", n, 1024, truth,
                                      dtype=torch.int32, device=device)
        rows[str(n)] = {"tuned": a, "truth": b}
        agree += a == b
    return {"agreement": agree / len(sizes), "choices": rows}


def rollback_and_quarantine(csv: Csv, device) -> Dict[str, object]:
    cfg = TuningConfig(cooldown_updates=0)
    # rollback latency: honest apply, then one regressed window
    with SpecController(cfg, device=device) as ctrl:
        assert _drive_window(ctrl, {"loop_step_s": 2.0}) == "apply"
        pre_apply = ctrl.base
        applied = ctrl.active
        windows = 0
        outcome = None
        while windows < 3 and outcome != "rollback":
            outcome = _drive_window(ctrl, {"loop_step_s": 64.0})
            windows += 1
        rollback = {"windows": windows, "outcome": outcome,
                    "restored_bit_equal": ctrl.active == pre_apply,
                    "had_applied": applied != pre_apply,
                    "ok": outcome == "rollback" and windows == 1
                    and ctrl.active == pre_apply}
    # quarantine firing/non-firing pair: the SAME drift window, with and
    # without the NaN-poison chaos draw
    nan_seed = _perturb_seed(lambda u: 0.5 <= u < 0.75)
    plan = FaultPlan(nan_seed, {"spec_perturb": SiteSpec(prob=1.0,
                                                         count=1)})
    with SpecController(cfg, chaos=plan, device=device) as ctrl:
        fired = _drive_window(ctrl, {"loop_step_s": 3.0})
        poisoned_installed = ctrl.active != ctrl.base
        n_quarantined = ctrl.n_quarantined
    with SpecController(cfg, device=device) as ctrl:
        unfired = _drive_window(ctrl, {"loop_step_s": 3.0})
        honest_applied = ctrl.active != ctrl.base
    quarantine = {"nan_seed": nan_seed, "fired_outcome": fired,
                  "unfired_outcome": unfired,
                  "n_quarantined": n_quarantined,
                  "ok": fired == "quarantine" and not poisoned_installed
                  and n_quarantined >= 1 and unfired == "apply"
                  and honest_applied}
    csv.add("tuning.rollback.windows", float(rollback["windows"]),
            f"outcome={rollback['outcome']} "
            f"bit_equal={rollback['restored_bit_equal']}")
    csv.add("tuning.quarantine", float(quarantine["n_quarantined"]),
            f"fired={fired} unfired={unfired}")
    return {"rollback": rollback, "quarantine": quarantine}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def overhead(device, fast: bool) -> Dict[str, object]:
    """Eager FAA with a LIVE controller (sink + sync + `step()` every call
    + its update cycles) against the stream off, the device synchronised
    after each call in both; the backend pinned, since the gate measures
    the controller's machinery, not a kernel swap."""
    m, n = 1024, 4096
    rng = np.random.default_rng(2)
    tbl = atomics.make_table(m, torch.int32, device=device)
    op = atomics.Faa(torch.as_tensor(rng.integers(0, m, (n,)),
                                     dtype=torch.int32, device=device),
                     torch.ones((n,), dtype=torch.int32, device=device))
    pinned = rmw_engine.select_backend(
        "faa", n, m, rmw_engine.calibrated_spec(device), dtype=torch.int32,
        device=device)

    def call():
        atomics.execute(tbl, op, backend=pinned)
        _sync(device)

    ctrl = SpecController(device=device)
    for _ in range(OVERHEAD_BATCH):
        call()                               # warm, no stream
    ctrl.start()
    try:
        for _ in range(4 * OVERHEAD_BATCH):  # quiesce: early windows apply
            call()                           # and settle to holds
            ctrl.step()
        with telemetry.capture(sync=True) as buf:    # one window, every
                                                     # call measured
            for _ in range(ctrl.cfg.min_events):
                call()
    finally:
        ctrl.stop()

    def tuned():
        call()
        ctrl.step()

    # up to 3 attempts, the lowest kept, as the reference does: the
    # controller's cost is a floor under every attempt, and noise on a
    # shared host only fakes failures
    attempts = []
    for _ in range(3):
        attempts.append(paired_ratio(
            tuned, call, batch=OVERHEAD_BATCH,
            n_batches=FAST_PAIRS if fast else OVERHEAD_PAIRS,
            setup_a=ctrl.start, teardown_a=ctrl.stop))
        if attempts[-1]["overhead"] < OVERHEAD_GATE:
            break
    pair = min(attempts, key=lambda r: r["overhead"])
    # the update cycle alone, on a captured window of this traffic
    window = [e for e in buf.events if e["event"] == "atomics.execute"]
    probe = SpecController(device=device)
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        probe._update(list(window))
    cycle_us = (time.perf_counter() - t0) / reps * 1e6
    rmw_engine.clear_live_spec()
    return {"n": n, "backend": pinned,
            "disabled_us": pair["b_us"], "enabled_us": pair["a_us"],
            "overhead": pair["overhead"],
            "overhead_of_minima": pair["overhead_of_minima"],
            "pairs": pair["pairs"], "batch": pair["batch"],
            "attempts": [a["overhead"] for a in attempts],
            "update_cycle_us": cycle_us, "window_events": len(window),
            "gate": OVERHEAD_GATE, "controller": ctrl.stats(),
            "ok": pair["overhead"] < OVERHEAD_GATE}


# --- bit identity -----------------------------------------------------------

def flip_state(path: str, device, shapes) -> Dict[str, float]:
    """Write a tuning state file for ``device`` whose spec (the calibrated
    spec changed by `FLIP`) makes auto pick another backend for at least
    one ``(op, n, m)`` of ``shapes``, or raise; returns the change."""
    cal = rmw_engine.calibrated_spec(device)
    spec = dataclasses.replace(cal, **{f: getattr(cal, f) * k
                                       for f, k in FLIP.items()})

    def picks(spec):
        return [rmw_engine.select_backend(op, n, m, spec, dtype=torch.int32,
                                          device=device)
                for op, n, m in shapes]

    if picks(spec) == picks(cal):
        raise RuntimeError(f"FLIP moves no selection of {shapes} on "
                           f"{device}")
    with open(path, "w") as f:
        json.dump({"version": 1, "backend": torch.device(device).type,
                   "spec": perf_model.spec_to_dict(spec),
                   "estimator": {"alpha": 0.25, "sites": {}}}, f)
    return dict(FLIP)


def _choices(events) -> List[Tuple[str, object, object]]:
    """(tier, backend, strategy) of every ``atomics.execute`` event."""
    return [(e.get("tier"), e.get("backend"), e.get("strategy"))
            for e in events if e.get("event") == "atomics.execute"]


def workload(controller, device) -> Tuple[np.ndarray, int]:
    """Deterministic int32 FAA + fetched-sum accumulator steps (fetched
    values load-bearing), each step also one probe batch forced onto the
    ``onehot`` and one onto the ``serialized`` backend (their drift feeds
    the controller), optionally under a live controller."""
    table = atomics.make_table(_M, torch.int32, device=device)
    probes = atomics.make_table(_M, torch.int32, device=device)
    acc = 0
    for step in range(_N_STEPS):
        idx = torch.as_tensor((np.arange(_N) * (step + 3)) % _M,
                              dtype=torch.int32, device=device)
        vals = torch.as_tensor(np.arange(_N) + step, dtype=torch.int32,
                               device=device)
        res = atomics.execute(table, atomics.Faa(idx, vals))
        table = res.table
        acc += int(res.fetched.sum())
        for backend in ("onehot", "serialized"):
            probes = atomics.execute(probes, atomics.Faa(idx, vals),
                                     backend=backend).table
        if controller is not None:
            controller.step()
    return np.concatenate([table.data.cpu().numpy(),
                           probes.data.cpu().numpy()]), acc


def bit_identity_local(device, state_dir: str) -> Dict[str, object]:
    path = os.path.join(state_dir, "flip_local.json")
    change = flip_state(path, device, [("faa", _N, _M)])
    with telemetry.capture() as base_buf:
        base_table, base_acc = workload(None, device)
    plan = FaultPlan(7, {"spec_perturb": SiteSpec(prob=0.5)})
    # every call measured (the capture's sync), so the 16 steps' 48
    # batches fill windows
    cfg = TuningConfig(min_events=8, min_samples=1, cooldown_updates=0)
    with telemetry.capture(sync=True) as buf:
        with SpecController(cfg, chaos=plan, state_path=path,
                            device=device) as ctrl:
            tuned_table, tuned_acc = workload(ctrl, device)
            stats = ctrl.stats()
    base_c, tuned_c = _choices(base_buf.events), _choices(buf.events)
    differs = sum(a != b for a, b in zip(base_c, tuned_c))
    restored = [e for e in buf.events if e["event"] == "tuning.restore"]
    ok = bool((tuned_table == base_table).all()) and tuned_acc == base_acc
    return {"ok": ok and differs > 0 and len(base_c) == len(tuned_c),
            "bit_equal": ok, "acc": base_acc, "restored_change": change,
            "restored": bool(restored and restored[0]["accepted"]),
            "batches": len(base_c), "batches_choice_differs": differs,
            "untuned_backends": sorted({c[1] for c in base_c}),
            "tuned_backends": sorted({c[1] for c in tuned_c}),
            "controller": stats}


def _sharded_rank(mesh, device: str, state_path: str) -> Dict[str, object]:
    """One rank: the untuned run, then the tuned run (a controller on the
    mesh, restored from ``state_path``), each returning a digest of every
    result and the batches' choices."""
    mesh.probe(torch.device(device))
    m = 512
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)

    def faa_ops(step, n=256):
        rng = np.random.default_rng(step)

        def make_ops(slots, observed):
            if slots is None:
                return atomics.Faa(t(rng.integers(0, m, (n,))),
                                   t(np.ones(n)))
            return None
        return make_ops

    def hot_ops(slots, observed):
        # 256 FAA ops on 4 slots: the estimator learns a hint of 4
        if slots is None:
            return atomics.Faa(t(np.arange(256) % 4), t(np.ones(256)))
        return None

    def cas_ops(slots, observed):
        # 64 ops over 8 hot slots: the contended loop the estimator observes
        if slots is None:
            return atomics.Cas(t(np.arange(64) % 8), t(np.ones(64)),
                               expected=0)
        return observed + 1          # lock-free fetch-increment

    def run(ctrl):
        tab = atomics.make_table(m, torch.int32, device=device, mesh=mesh,
                                 axis=("pod", "dev"))
        local = atomics.make_table(_M, torch.int32, device=device)
        digest = hashlib.sha256()
        fetched_total = 0
        # the tuned run measures every call (the capture's sync)
        with telemetry.capture(sync=ctrl is not None) as buf:
            for step in range(5):
                for make in (faa_ops(step), hot_ops):
                    res = atomics.execute_until(tab, make, max_rounds=1)
                    tab = res.table
                    fetched_total += int(res.fetched.sum())
                # the local workload's batch on this rank's own table
                idx = t((np.arange(_N) * (step + 3)) % _M)
                lres = atomics.execute(local, atomics.Faa(idx, idx + step))
                local = lres.table
                fetched_total += int(lres.fetched.sum())
                if ctrl is not None:
                    ctrl.step()
            # the CAS loop twice: under tuning, the second call takes the
            # estimator's hint learned from the first
            for _ in range(2):
                res = atomics.execute_until(tab, cas_ops, max_rounds=16)
                tab = res.table
                fetched_total += int(res.fetched.sum())
                digest.update(np.asarray(res.rounds).tobytes())
                if ctrl is not None:
                    ctrl.step()
        rows = mesh.all_gather(tab.data, ("pod", "dev"))
        digest.update(rows.cpu().numpy().tobytes())
        digest.update(local.data.cpu().numpy().tobytes())
        return {"digest": digest.hexdigest(), "fetched_total": fetched_total,
                "choices": _choices(buf.events)}

    untuned = run(None)
    ctrl = SpecController(TuningConfig(min_events=8, min_samples=1,
                                       cooldown_updates=0),
                          state_path=state_path, device=device,
                          mesh=mesh).start()
    try:
        tuned = run(ctrl)
        tuned["estimator_sites"] = len(ctrl.estimator)
        tuned["estimator"] = ctrl.estimator.snapshot()
        tuned["stats"] = ctrl.stats()
        tuned["active"] = perf_model.spec_to_dict(ctrl.active)
    finally:
        ctrl.stop()
    return {"untuned": untuned, "tuned": tuned}


def bit_identity_sharded(device, state_dir: str) -> Dict[str, object]:
    from repro_torch.launch import ranks
    path = os.path.join(state_dir, "flip_sharded.json")
    change = flip_state(path, device, [("faa", _N, _M)])
    dev = torch.device(device).type
    out = ranks.launch("repro_torch.benchmarks.tuning:_sharded_rank", 4,
                       mesh=((2, 2), ("pod", "dev")), args=(dev, path),
                       device=dev, timeout=900)
    r0 = out[0]
    differs = sum(a != b for a, b in zip(r0["untuned"]["choices"],
                                         r0["tuned"]["choices"]))
    strategies = sorted({str(c[2]) for r in out
                         for c in r["tuned"]["choices"] if c[0] == "sharded"})
    bit_equal = all(r["tuned"]["digest"] == r["untuned"]["digest"]
                    and r["tuned"]["fetched_total"]
                    == r["untuned"]["fetched_total"] for r in out)
    agree = all(r["tuned"][k] == r0["tuned"][k] for r in out
                for k in ("stats", "active", "estimator"))
    return {"ok": bit_equal and agree and differs > 0
            and r0["tuned"]["estimator_sites"] >= 1,
            "bit_equal": bit_equal, "ranks_agree": agree,
            "restored_change": change,
            "batches_choice_differs": differs,
            "sharded_strategies": strategies,
            "estimator_sites": r0["tuned"]["estimator_sites"],
            "controller": r0["tuned"]["stats"],
            "fetched_total": r0["untuned"]["fetched_total"]}


def run(csv: Csv, fast: bool = False, device="cuda",
        out_path: Optional[str] = None) -> Dict[str, object]:
    conv = convergence(csv, device)
    guards = rollback_and_quarantine(csv, device)
    ovh = overhead(device, fast)
    with tempfile.TemporaryDirectory(prefix="repro_torch_tuning_") as tmp:
        bit_local = bit_identity_local(device, tmp)
        bit_sharded = None if fast else bit_identity_sharded(device, tmp)

    csv.add("tuning.overhead", ovh["enabled_us"],
            f"n={ovh['n']} disabled={ovh['disabled_us']:.0f}us "
            f"overhead={ovh['overhead'] * 100:.2f}pct "
            f"cycle={ovh['update_cycle_us']:.0f}us "
            f"gate<{OVERHEAD_GATE * 100:.0f}pct")
    csv.add("tuning.bit_identity", 0.0 if bit_local["ok"] else 1.0,
            f"local_ok={bit_local['ok']} "
            f"differs={bit_local['batches_choice_differs']}"
            + (f" sharded_ok={bit_sharded['ok']}" if bit_sharded else
               " sharded=skipped(fast)"))

    acceptance = (conv["ok"] and guards["rollback"]["ok"]
                  and guards["quarantine"]["ok"] and ovh["ok"]
                  and bit_local["ok"]
                  and (bit_sharded is None or bit_sharded["ok"]))
    out = {
        "fast": fast, "device": str(device),
        "convergence": conv,
        "rollback": guards["rollback"],
        "quarantine": guards["quarantine"],
        "overhead": ovh,
        "bit_identity": {"local": bit_local, "sharded": bit_sharded},
        "acceptance_converged_guarded_cheap_and_bit_identical":
            bool(acceptance),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if not acceptance:
        raise AssertionError(
            f"tuning acceptance failed: convergence={conv['ok']} "
            f"rollback={guards['rollback']['ok']} "
            f"quarantine={guards['quarantine']['ok']} "
            f"overhead={ovh['overhead']:.4f} (gate {OVERHEAD_GATE}) "
            f"bit_local={bit_local['ok']} "
            f"bit_sharded={bit_sharded and bit_sharded['ok']}")
    return out
