"""The port's recovery loop and fault injection against the reference.

The reference's `tests/test_fault_tolerance.py` and `tests/test_chaos.py`
cases on `repro_torch.runtime` (the reference reads a fatal fault's event
from its telemetry stream; the port, which has none yet, from its log),
and its recovery-hook cases (`tests/test_reshard.py`).  One seed fires at
the same visits of every site in both packages' `FaultPlan`.  The seeded
chaos matrix (faults at every site of the loop, five seeds) ends bit-equal
to the run with no faults, which itself equals the FAA history applied in
order with numpy.
"""

import logging

import numpy as np
import pytest
import torch

from repro.runtime import chaos as rchaos
from repro_torch import atomics
from repro_torch.checkpoint import ckpt
from repro_torch.runtime.chaos import (CHAOS_ENV, RECOVERY_SITES, SITES,
                                       ChaosError, FaultPlan, SiteSpec)
from repro_torch.runtime.elastic import reshard_tables
from repro_torch.runtime.fault_tolerance import (
    FatalFault, FaultConfig, StragglerMonitor, backoff_delay,
    declare_donation, run_with_recovery)


class Store:
    """In-memory checkpoint store for the recovery driver."""

    def __init__(self):
        self.ckpts = {}

    def save(self, step, state):
        self.ckpts[step] = state

    def restore(self):
        if not self.ckpts:
            return None
        s = max(self.ckpts)
        return s, self.ckpts[s]


def _crashing_injector(steps):
    budget = dict(steps)

    def injector(step):
        if budget.get(step):
            budget[step] -= 1
            raise RuntimeError(f"chip lost at {step}")
    return injector


# ---------------------------------------------------------------------------
# the reference's test_fault_tolerance.py
# ---------------------------------------------------------------------------

def test_recovers_from_injected_failures():
    store = Store()
    res = run_with_recovery(lambda s, x: x + 1, 0, 30,
                            FaultConfig(max_failures=5, checkpoint_every=5),
                            store.save, store.restore,
                            failure_injector=_crashing_injector({7: 1,
                                                                 23: 1}),
                            sleep_fn=lambda d: None)
    assert res.steps_done == 30 and res.failures == 2
    assert res.restored_from
    assert store.ckpts[30] == 30


def test_too_many_failures_raises():
    store = Store()

    def injector(step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError):
        run_with_recovery(lambda s, x: x, 0, 10,
                          FaultConfig(max_failures=2, checkpoint_every=5),
                          store.save, store.restore,
                          failure_injector=injector, sleep_fn=lambda d: None)


def test_resume_from_existing_checkpoint():
    store = Store()
    store.save(20, 20)
    res = run_with_recovery(lambda s, x: x + 1, 0, 25,
                            FaultConfig(checkpoint_every=100),
                            store.save, store.restore)
    assert res.steps_done == 25 and res.restored_from == [20]
    assert store.ckpts[25] == 25


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(n_hosts=4, cfg=FaultConfig(
        straggler_window=5, straggler_threshold=2.0))
    for _ in range(5):
        for h in range(4):
            mon.record(h, 1.0 if h != 2 else 5.0)
    assert mon.flag() == [2]


def test_straggler_monitor_quiet_when_uniform():
    mon = StragglerMonitor(n_hosts=3, cfg=FaultConfig())
    for _ in range(5):
        for h in range(3):
            mon.record(h, 1.0)
    assert mon.flag() == []


def test_backoff_delay_is_pure_capped_exponential_as_reference():
    from repro.runtime import fault_tolerance as rft
    cfg = FaultConfig(backoff_base_s=0.01, backoff_factor=2.0,
                      backoff_max_s=0.05, backoff_jitter=0.0)
    assert [backoff_delay(cfg, k) for k in (1, 2, 3, 4, 5)] == \
        [0.01, 0.02, 0.04, 0.05, 0.05]
    for jitter, seed in ((0.5, 0), (0.1, 3)):
        got = [backoff_delay(FaultConfig(backoff_base_s=0.01,
                                         backoff_jitter=jitter,
                                         backoff_seed=seed), k)
               for k in range(1, 8)]
        want = [rft.backoff_delay(rft.FaultConfig(backoff_base_s=0.01,
                                                  backoff_jitter=jitter,
                                                  backoff_seed=seed), k)
                for k in range(1, 8)]
        assert got == want


def test_recovery_sleeps_the_backoff_and_records_it():
    store = Store()
    slept = []
    cfg = FaultConfig(max_failures=5, checkpoint_every=5,
                      backoff_base_s=0.01, backoff_factor=2.0,
                      backoff_jitter=0.0)
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 20, cfg, store.save, store.restore,
        failure_injector=_crashing_injector({4: 1, 9: 1}),
        sleep_fn=slept.append)
    assert res.steps_done == 20 and res.failures == 2
    assert slept == [0.01, 0.02]
    assert res.backoff_total_s == pytest.approx(sum(slept))
    backoffs = [e for e in res.events if e["event"] == "recovery.backoff"]
    assert [e["backoff_s"] for e in backoffs] == slept
    assert [e["attempt"] for e in backoffs] == [1, 2]
    faults = [e for e in res.events if e["event"] == "recovery.fault"]
    assert [e["site"] for e in faults] == ["step 4", "step 9"]
    assert all(e["error"] == "RuntimeError" and not e["fatal"]
               for e in faults)
    assert res.telemetry_ring == []


def test_run_result_events_summarize_the_recovery_trace():
    store = Store()
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 20,
        FaultConfig(max_failures=5, checkpoint_every=5, backoff_base_s=0.0),
        store.save, store.restore,
        failure_injector=_crashing_injector({4: 1, 9: 1}),
        sleep_fn=lambda d: None)
    assert res.event_counts() == {"recovery.restore": 3,
                                  "recovery.fault": 2,
                                  "recovery.backoff": 2}
    restores = [e for e in res.events if e["event"] == "recovery.restore"]
    assert [e["scratch"] for e in restores] == [True, True, False]
    assert restores[-1]["step"] == 5


def test_fatal_fault_is_logged_as_fatal_and_never_retried(caplog):
    store = Store()
    calls = []

    def injector(step):
        calls.append(step)
        raise FatalFault("operator abort")

    with caplog.at_level(logging.ERROR, logger="repro_torch.runtime"):
        with pytest.raises(FatalFault):
            run_with_recovery(lambda s, x: x + 1, 0, 20,
                              FaultConfig(max_failures=100,
                                          checkpoint_every=5),
                              store.save, store.restore,
                              failure_injector=injector,
                              sleep_fn=lambda d: None)
    assert calls == [0]
    assert any("fatal FatalFault" in r.getMessage() for r in caplog.records)


def test_deadline_budget_raises_timeout():
    store = Store()
    cfg = FaultConfig(max_failures=100, checkpoint_every=5,
                      backoff_base_s=0.0, deadline_s=0.0)
    with pytest.raises(TimeoutError, match="recovery deadline"):
        run_with_recovery(lambda s, x: x + 1, 0, 20, cfg, store.save,
                          store.restore,
                          failure_injector=_crashing_injector({4: 1}),
                          sleep_fn=lambda d: None)


def test_fatal_types_config_never_retried():
    store = Store()

    def injector(step):
        raise ValueError("misconfiguration")

    with pytest.raises(ValueError, match="misconfiguration"):
        run_with_recovery(lambda s, x: x + 1, 0, 20,
                          FaultConfig(max_failures=100, checkpoint_every=5,
                                      fatal_types=(ValueError,)),
                          store.save, store.restore,
                          failure_injector=injector, sleep_fn=lambda d: None)


def test_flaky_restore_is_retried():
    store = Store()
    store.save(10, 10)
    flaky = {"left": 2}
    real_restore = store.restore

    def restore():
        if flaky["left"]:
            flaky["left"] -= 1
            raise OSError("ckpt server hiccup")
        return real_restore()

    res = run_with_recovery(lambda s, x: x + 1, 0, 15,
                            FaultConfig(max_failures=5, checkpoint_every=100,
                                        backoff_base_s=0.0),
                            store.save, restore, sleep_fn=lambda d: None)
    assert res.steps_done == 15 and res.failures == 2
    assert res.restored_from == [10]
    assert store.ckpts[15] == 15


def test_donating_step_with_captured_state_warns(caplog):
    step = declare_donation(lambda s, x: x + 1, 1)
    assert step.donate_argnums == (1,)
    with caplog.at_level(logging.WARNING, logger="repro_torch.runtime"):
        res = run_with_recovery(step, 0, 3, FaultConfig(), Store().save,
                                lambda: None)
        run_with_recovery(step, lambda: 0, 3, FaultConfig(), Store().save,
                          lambda: None)
    assert res.steps_done == 3
    warned = [r for r in caplog.records if "donate_argnums" in r.getMessage()]
    assert len(warned) == 1             # the factory call does not warn


def test_run_with_recovery_invokes_reshard_hook():
    store = {2: 2}
    calls = []
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 6,
        FaultConfig(max_failures=2, checkpoint_every=2),
        lambda step, s: store.__setitem__(step, s),
        lambda: (max(store), store[max(store)]) if store else None,
        failure_injector=_crashing_injector({4: 1}),
        reshard_fn=lambda s: (calls.append(s), s)[1],
        sleep_fn=lambda d: None)
    assert res.steps_done == 6 and res.failures == 1
    assert len(calls) == 2


def test_run_with_recovery_reshards_scratch_restart_too():
    adopted = []
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 3,
        FaultConfig(max_failures=2, checkpoint_every=100),
        lambda step, s: None, lambda: None,
        failure_injector=_crashing_injector({1: 1}),
        reshard_fn=lambda s: (adopted.append(s), s)[1],
        sleep_fn=lambda d: None)
    assert res.steps_done == 3
    assert adopted == [0]


# ---------------------------------------------------------------------------
# the reference's test_chaos.py: FaultPlan mechanics
# ---------------------------------------------------------------------------

def _fires(plan, site, visits):
    return [plan.fire(site) for _ in range(visits)]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_seed_fires_the_same_visits_in_both_packages(seed):
    """Every site, the same spec: the port's plan and the reference's fire
    at the same visits, and draw the same fault parameters."""
    sites = {s: rchaos.SiteSpec(prob=0.3, count=5, after=2)
             for s in rchaos.SITES}
    ref = rchaos.FaultPlan(seed, sites)
    port = FaultPlan(seed, {s: SiteSpec(prob=0.3, count=5, after=2)
                            for s in SITES})
    assert SITES == rchaos.SITES and RECOVERY_SITES == rchaos.RECOVERY_SITES
    for site in SITES:
        for _ in range(60):
            assert port.fire(site) == ref.fire(site), site
            assert port.param(site) == ref.param(site), site
    assert port.stats() == ref.stats()
    spec = f"seed={seed},step=0.2@3,ckpt_save=0.5,reshard=1.0@1,delay=0.5"
    a, b = FaultPlan.from_spec(spec), rchaos.FaultPlan.from_spec(spec)
    assert repr(a) == repr(b)
    for site in RECOVERY_SITES:
        assert _fires(a, site, 40) == _fires(b, site, 40), site


def test_same_seed_same_schedule():
    sites = {"step": 0.3, "ckpt_save": 0.5}
    a, b = FaultPlan(7, sites), FaultPlan(7, sites)
    for site in ("step", "ckpt_save"):
        assert _fires(a, site, 200) == _fires(b, site, 200)
    assert _fires(FaultPlan(8, sites), "step", 200) != \
        _fires(FaultPlan(7, sites), "step", 200)


def test_sites_draw_independent_streams():
    only_step = _fires(FaultPlan(3, {"step": 0.4}), "step", 100)
    mixed = FaultPlan(3, {"step": 0.4, "ckpt_restore": 0.9})
    got = []
    for k in range(100):
        mixed.fire("ckpt_restore")
        if k % 3 == 0:
            mixed.fire("reshard")
        got.append(mixed.fire("step"))
    assert got == only_step


def test_count_cap_and_after():
    plan = FaultPlan(1, {"step": SiteSpec(prob=1.0, count=3, after=5)})
    fired = _fires(plan, "step", 20)
    assert sum(fired) == 3
    assert not any(fired[:5])
    assert fired[5:8] == [True, True, True]
    assert plan.stats()["step"] == {"visits": 20, "fired": 3}


def test_visit_raises_chaos_error_with_site_metadata():
    plan = FaultPlan(0, {"ckpt_save": 1.0})
    with pytest.raises(ChaosError, match="ckpt_save.*step 12"):
        plan.visit("ckpt_save", step=12)
    with pytest.raises(ValueError, match="unknown fault site"):
        plan.visit("not_a_site")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(0, {"bogus": 1.0})


def test_straggler_delay_stalls_instead_of_raising():
    slept = []
    plan = FaultPlan(0, {"straggler_delay": SiteSpec(prob=1.0,
                                                     delay_s=0.25)},
                     sleep_fn=slept.append)
    plan.visit("straggler_delay", step=3)
    assert slept == [0.25]


def test_replay_reinjects_identical_faults():
    plan = FaultPlan(11, {"step": 0.5})
    first = _fires(plan, "step", 50)
    assert _fires(plan.replay(), "step", 50) == first


def test_from_spec_and_env(monkeypatch):
    plan = FaultPlan.from_spec(
        "seed=42, step=0.25, ckpt_save=0.5@2, straggler_delay=1.0, "
        "delay=0.125")
    assert plan.seed == 42
    assert plan.sites["step"] == SiteSpec(prob=0.25)
    assert plan.sites["ckpt_save"] == SiteSpec(prob=0.5, count=2)
    assert plan.sites["straggler_delay"].delay_s == 0.125
    with pytest.raises(ValueError, match="key=value"):
        FaultPlan.from_spec("step:0.5")
    monkeypatch.delenv(CHAOS_ENV, raising=False)
    assert FaultPlan.from_env().sites == {}
    monkeypatch.setenv(CHAOS_ENV, "seed=9,step=1.0@1")
    env_plan = FaultPlan.from_env()
    assert env_plan.seed == 9 and env_plan.sites["step"].count == 1
    assert CHAOS_ENV == rchaos.CHAOS_ENV == "REPRO_CHAOS"


def test_env_hook_reaches_run_with_recovery(monkeypatch):
    monkeypatch.setenv(CHAOS_ENV, "seed=5,step=1.0@2")
    store = {}
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 10,
        FaultConfig(max_failures=10, checkpoint_every=2,
                    backoff_base_s=0.0),
        lambda s, x: store.__setitem__(s, x),
        lambda: (max(store), store[max(store)]) if store else None)
    assert res.steps_done == 10 and res.failures == 2
    assert store[10] == 10


def test_chaos_all_sites_are_wired():
    assert set(SITES) == set(RECOVERY_SITES) | {"spec_perturb"}
    for site in RECOVERY_SITES:
        plan = FaultPlan(0, {site: SiteSpec(prob=1.0, count=1,
                                            delay_s=1e-4)})
        store = {2: 2}
        res = run_with_recovery(
            lambda s, x: x + 1, 0, 6,
            FaultConfig(max_failures=5, checkpoint_every=2,
                        backoff_base_s=0.0),
            lambda s, x: store.__setitem__(s, x),
            lambda: (max(store), store[max(store)]) if store else None,
            reshard_fn=lambda s: s, chaos=plan)
        assert res.steps_done == 6
        assert res.failures == (0 if site == "straggler_delay" else 1), site
        assert plan.total_fired == 1, site
        assert store[6] == 6, site


# ---------------------------------------------------------------------------
# the seeded chaos matrix: a live table through execute and checkpoints
# ---------------------------------------------------------------------------

N_STEPS, M_SLOTS = 20, 16


def _step_batch(step):
    return ((np.arange(8) * (step + 3)) % M_SLOTS).astype(np.int32), \
        (np.arange(8) + step).astype(np.int32)


def _step_fn(step, state):
    table, acc = state
    idx, vals = (torch.from_numpy(a) for a in _step_batch(step))
    res = atomics.execute(table, atomics.Faa(idx, vals))
    return res.table, acc + res.fetched.sum().to(torch.int32)


def _like():
    return {"table": atomics.AtomicTable(torch.zeros(M_SLOTS,
                                                     dtype=torch.int32)),
            "acc": torch.tensor(0, dtype=torch.int32)}


def _run(tmp_path, tag, plan):
    ckpt_dir = str(tmp_path / tag)

    def save_fn(step, state):
        ckpt.save(ckpt_dir, step, {"table": state[0], "acc": state[1]})

    def restore_fn():
        got = ckpt.restore_latest_valid(ckpt_dir, _like())
        if got is None:
            return None
        step, tree, _ = got
        return step, (tree["table"], tree["acc"])

    init = _like()
    res = run_with_recovery(
        _step_fn, (init["table"], init["acc"]), N_STEPS,
        FaultConfig(max_failures=60, checkpoint_every=5, backoff_base_s=0.0),
        save_fn, restore_fn, chaos=plan,
        reshard_fn=lambda s: reshard_tables(s, None),
        sleep_fn=lambda d: None)
    return res, ckpt.restore_latest_valid(ckpt_dir, _like())


def _numpy_history():
    table = np.zeros(M_SLOTS, np.int64)
    acc = 0
    for step in range(N_STEPS):
        idx, vals = _step_batch(step)
        for i, v in zip(idx, vals):       # FAA in batch order
            acc += table[i]
            table[i] += v
    return table.astype(np.int32), np.int32(acc)


def test_chaos_matrix_bit_equal_to_fault_free(tmp_path):
    base, base_final = _run(tmp_path, "baseline", FaultPlan.null())
    assert base.failures == 0 and base_final[0] == N_STEPS
    want_table, want_acc = _numpy_history()
    np.testing.assert_array_equal(base_final[1]["table"].data.numpy(),
                                  want_table)
    assert int(base_final[1]["acc"]) == want_acc
    sites = {"step": SiteSpec(prob=0.25, count=2),
             "ckpt_save": SiteSpec(prob=0.25, count=2),
             "ckpt_restore": SiteSpec(prob=0.25, count=2),
             "reshard": SiteSpec(prob=0.25, count=2),
             "straggler_delay": SiteSpec(prob=0.2, count=2, delay_s=1e-4)}
    total_fired, any_restored = 0, False
    for seed in range(1, 6):
        plan = FaultPlan(seed, sites, sleep_fn=lambda d: None)
        res, final = _run(tmp_path, f"seed{seed}", plan)
        assert res.steps_done == N_STEPS and final[0] == N_STEPS
        total_fired += plan.total_fired
        any_restored |= bool(res.restored_from)
        np.testing.assert_array_equal(final[1]["table"].data.numpy(),
                                      want_table, err_msg=f"seed {seed}")
        assert int(final[1]["acc"]) == want_acc, f"seed {seed}"
    assert total_fired >= 5 and any_restored



def test_fault_recovery_suite_on_the_cpu():
    """`python -m repro_torch.benchmarks.run --device cpu --fast --only
    fault_recovery`: the reference's rows and gates."""
    from repro_torch.benchmarks import run as trun
    csv, results, failures = trun.run_suites(["fault_recovery"], fast=True,
                                             device="cpu")
    assert not failures, failures
    out = results["fault_recovery"]
    assert [r["name"] for r in out["recovery"]] == \
        ["recovery/p0.0", "recovery/p0.05", "recovery/p0.2"]
    assert all(r["bit_equal"] for r in out["recovery"])
    assert {r["name"] for r in out["retry"]} == {
        f"retry/{p}/n{n}" for p in ("immediate", "shrink", "exponential")
        for n in (8, 32)}
    assert all(r["le_n_rounds"] for r in out["retry"]
               if r["policy"] != "shrink")
    assert out["sharded"]["name"] == "retry/sharded/n16"
    assert out["sharded"]["n_rounds"] <= 16
    assert all(r["name"].startswith("fault_recovery.") for r in csv.rows)
