"""repro_torch.tuning: the guarded spec controller and the contention
estimator, against the reference and on their own.

The first part feeds the same seeded windows of synthetic drift to
`repro.tuning.SpecController` and to the port's, each built on one base
spec (`convert.spec_from_reference` of the reference's `spec_to_dict`),
each through its own package's event stream: after every `step()` the same
outcome and the same active spec float for float, then the same `stats()`
and the same ``tuning.*`` events up to their clocks — honest windows, the
4x-off walk, a regressed window, NaN and negative poison, a cooldown, a
deadband hold, per-field floors and a `FaultPlan` seed over a long run.
The estimator and `execute_until`'s feed are held to the reference's the
same way.  The second part is the reference's `tests/test_tuning.py` on
the port (its test names), with the port's own cases: a state file of the
reference's rejected, the ranks of a mesh installing one spec at the same
call, and the two suites at their fast sizes.  A fixture stops any
controller, clears both live specs and disables both streams around every
test.
"""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import atomics as jatomics
from repro import telemetry as jtelemetry
from repro import tuning as jtuning
from repro.core import perf_model as jperf
from repro.core import rmw_engine as jengine
from repro.runtime import chaos as jchaos
from repro_torch import atomics, convert, telemetry
from repro_torch.checkpoint import ckpt
from repro_torch.core import perf_model, rmw_engine
from repro_torch.launch import ranks
from repro_torch.runtime.chaos import FaultPlan, SiteSpec
from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                 declare_donation,
                                                 run_with_recovery)
from repro_torch.tuning import (TUNABLE_FIELDS, TUNING_ENV,
                                ContentionEstimator, SpecController,
                                TuningConfig, active_controller, from_env,
                                site_key)

HERE = os.path.dirname(os.path.abspath(__file__))

#: the test-sized guardrail config: tiny windows, no cooldown
CFG = TuningConfig(min_events=8, min_samples=2, cooldown_updates=0)

P0 = 1e-5     # base predicted wall per synthetic drift event


@pytest.fixture(autouse=True)
def _tuning_hygiene(monkeypatch):
    """No live spec, controller or stream state leaks across tests, in
    either package."""
    monkeypatch.delenv(TUNING_ENV, raising=False)
    telemetry.disable()
    jtelemetry.disable()
    yield
    for ctrl in (active_controller(), jtuning.active_controller()):
        if ctrl is not None:
            ctrl.stop()
    rmw_engine.clear_live_spec()
    jengine.clear_live_spec()
    assert not telemetry.enabled() and not jtelemetry.enabled()


def _events(buf, name):
    return [e for e in buf.events if e.get("event") == name]


def _perturb_u(seed):
    """The deterministic spec_perturb parameter draw of ``seed``'s first
    firing — what the controller's `_maybe_perturb` will see."""
    plan = FaultPlan(seed, {"spec_perturb": SiteSpec(prob=1.0)})
    assert plan.fire("spec_perturb")
    return plan.param("spec_perturb")


def _seed_where(pred):
    for seed in range(256):
        if pred(_perturb_u(seed)):
            return seed
    raise AssertionError("no seed in 0..255 draws the wanted parameter")


# ---------------------------------------------------------------------------
# Both packages, the same windows
# ---------------------------------------------------------------------------

#: the drift group each tunable field is fitted from, and its sense
GROUPS = {"loop_step_s": ("local", "serialized", "direct"),
          "sort_elem_pass_s": ("local", "sort", "direct"),
          "gather_elem_s": ("local", "onehot", "direct"),
          "collective_launch_s": ("sharded", "oneshot", "direct"),
          "host_roundtrip_Bps": ("migration", "device_put", "inverse")}


def _specs():
    jspec = jperf.cpu_default_spec()
    return jspec, convert.spec_from_reference(jperf.spec_to_dict(jspec))


def _record(tel, field, predicted, measured):
    tier, choice, _ = GROUPS[field]
    if tier == "migration":
        tel.record("atomics.reshard.migrate", tier=tier, path=choice,
                   n_slots=4096, predicted_s=predicted, measured_s=measured)
    else:
        key = "backend" if tier == "local" else "strategy"
        tel.record("atomics.execute", tier=tier, op="faa", n=256,
                   predicted_s=predicted, measured_s=measured,
                   **{key: choice})


def _drive(ctrl, tel, window):
    """One closed-loop window through ``tel``'s stream: each (field,
    truth, noise) event predicted off the controller's ACTIVE spec and
    measured off the truth, then one `step()`."""
    for field, truth, noise in window:
        k = getattr(ctrl.active, field) / getattr(ctrl.base, field)
        if GROUPS[field][2] == "inverse":
            k = 1.0 / k
        _record(tel, field, P0 * k, P0 * truth * noise)
    return ctrl.step()


def _windows(seed, n_windows, truths, events=8, sigma=0.1):
    """Seeded windows: ``events`` drift events each, fields drawn in turn
    from ``truths`` ({field: truth factor}, or a list of such per window),
    a log-normal noise of ``sigma`` on each measurement."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_windows):
        t = truths[w] if isinstance(truths, list) else truths
        fields = sorted(t)
        out.append([(fields[i % len(fields)], t[fields[i % len(fields)]],
                     float(np.exp(rng.normal(0.0, sigma))))
                    for i in range(events)])
    return out


def _strip(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events
            if e["event"].startswith("tuning.")]


def _both(cfg, windows, *, chaos=None):
    """Drive the same windows through both packages' controllers; returns
    the per-step records and the events."""
    jspec, tspec = _specs()
    jcfg = jtuning.TuningConfig(**dataclasses.asdict(cfg))
    jplan = tplan = None
    if chaos is not None:
        seed, sites = chaos
        jplan = jchaos.FaultPlan(seed, {k: jchaos.SiteSpec(**vars(v))
                                        for k, v in sites.items()})
        tplan = FaultPlan(seed, sites)
    got = {}
    for name, tel, ctrl in (
            ("ref", jtelemetry, jtuning.SpecController(
                jcfg, base_spec=jspec, chaos=jplan)),
            ("port", telemetry, SpecController(
                cfg, base_spec=tspec, chaos=tplan, device="cpu"))):
        steps = []
        with tel.capture() as buf:
            with ctrl:
                for window in windows:
                    out = _drive(ctrl, tel, window)
                    steps.append((out, {f: getattr(ctrl.active, f)
                                        for f in TUNABLE_FIELDS},
                                  ctrl.active))
                stats = ctrl.stats()
        got[name] = (steps, stats, _strip(buf.events))
    return got


SCENARIOS = {
    "honest": (CFG, _windows(1, 4, {"loop_step_s": 1.0,
                                    "gather_elem_s": 1.0})),
    "walk_4x": (CFG, _windows(2, 5, {"loop_step_s": 4.0,
                                     "gather_elem_s": 0.25}, sigma=0.02)),
    "regressed": (CFG, _windows(3, 3, [{"loop_step_s": 2.0},
                                       {"loop_step_s": 64.0},
                                       {"loop_step_s": 1.0}], sigma=0.0)),
    "cooldown": (dataclasses.replace(CFG, cooldown_updates=1),
                 _windows(4, 4, {"loop_step_s": 2.0}, sigma=0.0)),
    "deadband": (CFG, _windows(5, 2, {"loop_step_s": math.exp(0.02)},
                               sigma=0.0)),
    "floors": (dataclasses.replace(
        CFG, min_samples_per_field={"sort_elem_pass_s": 99,
                                    "host_roundtrip_Bps": 3}),
               _windows(6, 3, {f: 3.0 for f in GROUPS}, events=10)),
    "every_field": (dataclasses.replace(CFG, min_samples=1),
                    _windows(7, 6, {f: t for f, t in zip(
                        GROUPS, (8.0, 0.2, 3.0, 100.0, 0.5))}, events=10)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_reference(name):
    cfg, windows = SCENARIOS[name]
    got = _both(cfg, windows)
    (jsteps, jstats, jev), (tsteps, tstats, tev) = got["ref"], got["port"]
    assert len(jsteps) == len(tsteps) == len(windows)
    for i, ((jo, jf, jact), (to, tf, tact)) in enumerate(zip(jsteps,
                                                             tsteps)):
        assert to == jo, (name, i)
        assert tf == jf, (name, i)               # float for float
        assert tact == convert.spec_from_reference(
            jperf.spec_to_dict(jact)), (name, i)
    assert tstats == jstats
    assert tev == jev and tev


@pytest.mark.parametrize("kind,pick", [
    ("nan", lambda u: 0.5 <= u < 0.75),
    ("negative", lambda u: u >= 0.75),
    ("skew", lambda u: u < 0.5 and abs(4.0 * u - 1.0) * math.log(8.0) > 0.3),
])
def test_poison_and_skew_match_reference(kind, pick):
    chaos = (_seed_where(pick), {"spec_perturb": SiteSpec(prob=1.0,
                                                          count=1)})
    got = _both(CFG, _windows(8, 4, {"loop_step_s": 3.0}, sigma=0.0),
                chaos=chaos)
    assert [s[:2] for s in got["port"][0]] == [s[:2] for s in got["ref"][0]]
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][1]["perturbs"] == 1


@pytest.mark.parametrize("seed", [3, 11])
def test_fault_plan_seed_matches_reference(seed):
    """A long mixed run under one `FaultPlan` seed with ``spec_perturb``
    at 0.5: every outcome, spec, stat and event equal."""
    truths = [{"loop_step_s": 4.0, "gather_elem_s": 0.5},
              {"loop_step_s": 1.0, "sort_elem_pass_s": 6.0},
              {"collective_launch_s": 3.0, "host_roundtrip_Bps": 0.3}] * 4
    got = _both(dataclasses.replace(CFG, min_samples=1),
                _windows(seed, len(truths), truths),
                chaos=(seed, {"spec_perturb": SiteSpec(prob=0.5)}))
    assert [s[:2] for s in got["port"][0]] == [s[:2] for s in got["ref"][0]]
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][1]["perturbs"] >= 1


def test_estimator_matches_reference():
    rng = np.random.default_rng(0)
    keys = [("cas", "local", 16, 8), ("faa", "sharded", 4096, 512),
            ("cas", "sharded", 1 << 20, 3)]
    j, t = jtuning.ContentionEstimator(0.3), ContentionEstimator(0.3)
    for _ in range(60):
        kind, tier, m, n = keys[rng.integers(len(keys))]
        d = float(rng.choice([rng.integers(-2, 600), np.nan, 0.5]))
        src = "device" if rng.random() < 0.5 else "host"
        j.update(jtuning.site_key(kind, tier, m, n), d, source=src)
        t.update(site_key(kind, tier, m, n), d, source=src)
    assert site_key(*keys[1]) == jtuning.site_key(*keys[1])
    assert t.sites() == j.sites() and len(t) == len(j) == 3
    for key in t.sites():
        assert t.hint(key) == j.hint(key) and t.raw(key) == j.raw(key)
    assert (t.n_updates, t.n_updates_host, t.n_updates_device) == \
        (j.n_updates, j.n_updates_host, j.n_updates_device)
    snap = json.loads(json.dumps(t.snapshot()))
    assert snap == json.loads(json.dumps(j.snapshot()))
    back = ContentionEstimator(0.3)
    assert back.restore(snap) == 3 and back.sites() == t.sites()


def _cas_loop(mod, arr, m, idx):
    def make_ops(slots, observed):
        if slots is None:
            return mod.Cas(arr(idx), arr(np.ones(len(idx), np.int32)),
                           expected=arr(np.zeros(len(idx), np.int32)))
        return observed + 1
    return make_ops


def test_execute_until_feed_matches_reference():
    """The same contended CAS loops (256 ops over 32 of 64 slots, then 96
    over 3 slots of 16) under a running controller in each package: the
    same site keys and EWMA, equal results, the device pass on by
    default."""
    loops = [(64, np.tile(np.arange(32, dtype=np.int32), 8)),
             (16, np.array([0, 5, 9] * 32, np.int32)),
             (64, np.tile(np.arange(32, dtype=np.int32), 8))]
    got = {}
    for name, mod, arr, tbl, ctrl in (
            ("ref", jatomics, jnp.asarray,
             lambda m: jatomics.AtomicTable(jnp.zeros((m,), jnp.int32)),
             jtuning.SpecController(jtuning.TuningConfig())),
            ("port", atomics, torch.as_tensor,
             lambda m: atomics.AtomicTable(torch.zeros((m,),
                                                       dtype=torch.int32)),
             SpecController(TuningConfig(), device="cpu"))):
        results = []
        with ctrl:
            for m, idx in loops:
                res = mod.execute_until(tbl(m), _cas_loop(mod, arr, m, idx),
                                        max_rounds=40)
                assert res.stats is not None        # default: device pass
                results.append([np.asarray(res.table.data), res.fetched,
                                res.success, res.rounds,
                                int(np.asarray(res.stats.distinct_slots))])
            est = ctrl.estimator
            got[name] = (results, est.sites(), est.n_updates_device,
                         est.n_updates_host)
    (jr, js, jdev, jhost), (tr, ts, tdev, thost) = got["ref"], got["port"]
    for a, b in zip(jr, tr):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert ts == js and len(ts) == 2
    # per loop: the device pass, then the CAS first-attempt winners
    assert tdev == jdev == 3 and thost == jhost == 3


# ---------------------------------------------------------------------------
# The reference's cases on the port: the live-spec indirection
# ---------------------------------------------------------------------------

def _feed_window(ctrl, true_factor, *, events=None):
    """Emit one full drift window through the live stream, closed-loop:
    predictions from the *active* spec, measurements from the 'true'
    hardware (``base * true_factor``), then one controller step."""
    k = ctrl.active.loop_step_s / ctrl.base.loop_step_s
    for _ in range(events if events is not None else ctrl.cfg.min_events):
        telemetry.record("atomics.execute", tier="local",
                         backend="serialized", op="faa", n=256,
                         predicted_s=P0 * k, measured_s=P0 * true_factor)
    return ctrl.step()


def test_live_spec_indirection_covers_default_spec():
    cal = rmw_engine.calibrated_spec("cpu")
    assert rmw_engine.live_spec() is None
    assert rmw_engine.default_spec("cpu") == cal
    e0 = rmw_engine.spec_epoch()
    tuned = dataclasses.replace(cal, loop_step_s=cal.loop_step_s * 2)
    rmw_engine.set_live_spec(tuned)
    assert rmw_engine.default_spec("cpu") == tuned
    assert rmw_engine.default_spec("cuda") == tuned
    assert rmw_engine.live_spec() == tuned
    assert rmw_engine.spec_epoch() == e0 + 1
    rmw_engine.clear_live_spec()
    assert rmw_engine.default_spec("cpu") == cal
    assert rmw_engine.spec_epoch() == e0 + 2
    rmw_engine.clear_live_spec()            # idempotent: no spurious bump
    assert rmw_engine.spec_epoch() == e0 + 2


def test_set_live_spec_rejects_non_spec():
    with pytest.raises(TypeError, match="HardwareSpec"):
        rmw_engine.set_live_spec({"loop_step_s": 1.0})


def test_swap_moves_every_selector_at_the_next_call():
    """A swap reaches `execute`'s cached decision, `select_exchange` and
    `select_migration` at once: each prices with the new spec."""
    from repro_torch.atomics import reshard
    from repro_torch.atomics.layout import TableLayout
    from repro_torch.core import rmw_sharded as rs
    mesh_axes = (("pod", 2), ("dev", 2))
    src = TableLayout(1 << 16, "int32", ("pod", "dev"), (), mesh_axes)
    dst = TableLayout(1 << 16, "int32", ("dev",), ("pod",), mesh_axes)
    tbl = atomics.make_table(64, torch.int32, device="cpu")
    op = atomics.Faa(torch.arange(16, dtype=torch.int32) % 64,
                     torch.ones(16, dtype=torch.int32))
    axes = rs._mesh_axes(("pod", "dev"), [2, 2], None)
    cal = rmw_engine.calibrated_spec("cpu")
    fast = dataclasses.replace(cal, loop_step_s=cal.loop_step_s / 1e6,
                               collective_launch_s=cal.collective_launch_s
                               * 1e3, host_roundtrip_Bps=1.0)
    with telemetry.capture() as buf:
        atomics.execute(tbl, op)
        ex0 = rs.select_exchange_with_cost("faa", 64, 4096, axes,
                                           device="cpu")
        mig0 = reshard.select_migration(src, dst, exchange_feasible=True)
        rmw_engine.set_live_spec(fast)
        atomics.execute(tbl, op)
        ex1 = rs.select_exchange_with_cost("faa", 64, 4096, axes,
                                           device="cpu")
        mig1 = reshard.select_migration(src, dst, exchange_feasible=True)
    before, after = _events(buf, "atomics.execute")
    pick = lambda spec: rmw_engine.select_backend(
        "faa", 16, 64, spec, dtype=torch.int32, device="cpu")
    assert before["backend"] == pick(cal) != pick(fast) == after["backend"]
    assert after["predicted_s"] < before["predicted_s"]
    assert ex1.predicted_s > ex0.predicted_s
    assert (mig0, mig1) == ("device_put", "exchange")


def test_sync_every_samples_and_widens():
    """The sampling period is the least ``Sink.sync_every`` among the sinks
    installed with sync, worked out again as sinks come and go: a sink
    added without sync has no say, a ``capture(sync=True)`` measures every
    call and restores, and a transient sink that measures every call
    leaves a running controller's period as it found it.  `sync_due`
    measures one call in each run of k.  A CPU table is measured on every
    call."""
    from repro_torch.telemetry import core
    from repro_torch.tuning import controller
    a, b, c = (telemetry.RingBuffer() for _ in range(3))
    a.sync_every, b.sync_every = 4, 8
    telemetry.add_sink(a, sync=True)
    assert core._sync_every == 4
    due = [core.sync_due() for _ in range(4 * 50)]
    runs = [due[i:i + 4] for i in range(0, len(due), 4)]
    assert all(sum(r) == 1 for r in runs)
    telemetry.add_sink(b, sync=True)
    telemetry.add_sink(c)                         # no sync: no say
    assert core._sync_every == 4
    with telemetry.capture(sync=True):
        assert core._sync_every == 1 and core.sync_due()
    assert core._sync_every == 4
    tbl = atomics.make_table(16, device="cpu")
    op = atomics.Faa(torch.arange(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.int32))
    for _ in range(3):
        atomics.execute(tbl, op)
    assert all("measured_s" in e for e in a.events) and len(a) == 3
    telemetry.remove_sink(a)
    assert core._sync_every == 8
    telemetry.remove_sink(b)
    telemetry.remove_sink(c)
    assert core._sync_every == 1 and not telemetry.enabled()
    with SpecController(CFG):
        assert core._sync and core._sync_every == controller.SYNC_EVERY \
            == 64
        transient = telemetry.RingBuffer()
        telemetry.add_sink(transient, sync=True)
        assert core._sync_every == 1
        telemetry.remove_sink(transient)
        assert core._sync_every == controller.SYNC_EVERY
    assert core._sync_every == 1


def test_sampling_covers_traffic_that_repeats():
    """Traffic that repeats every 60 calls (the live probe's cycle of 60
    batches) sampled one call in 64: measuring every 64th call would see
    only the 15 places that share the period's factor 4; `sync_due`'s
    random place in each run sees most of the 60."""
    from repro_torch.telemetry import core
    ring = telemetry.RingBuffer()
    ring.sync_every = 64
    telemetry.add_sink(ring, sync=True)
    try:
        due = [core.sync_due() for _ in range(64 * 120)]
    finally:
        telemetry.remove_sink(ring)
    assert sum(due) == 120
    assert len({i % 60 for i, d in enumerate(due) if d}) > 40
    assert len({i % 60 for i in range(63, 64 * 120, 64)}) == 15


def test_unmeasured_execute_builds_no_event_for_measured_only_sinks():
    """While every sink is ``measured_only`` (the controller's tap), an
    unmeasured `execute` records nothing; a ring beside it brings the
    decision events back, and a measured call always records."""
    from repro_torch.telemetry import core

    class Tap(telemetry.RingBuffer):
        measured_only = True

    tap, ring = Tap(), telemetry.RingBuffer()
    tbl = atomics.make_table(16, device="cpu")
    op = atomics.Faa(torch.arange(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.int32))
    telemetry.add_sink(tap)                       # no sync: unmeasured
    assert not core._every_event
    atomics.execute(tbl, op)
    assert len(tap) == 0
    telemetry.add_sink(ring)
    assert core._every_event
    atomics.execute(tbl, op)
    assert len(tap) == len(ring) == 1 and "measured_s" not in ring.events[0]
    telemetry.remove_sink(ring)
    telemetry.add_sink(tap, sync=True)            # CPU calls: all measured
    atomics.execute(tbl, op)
    assert len(tap) == 2 and "measured_s" in tap.events[-1]
    telemetry.remove_sink(tap)
    assert not telemetry.enabled() and not core._every_event


# ---------------------------------------------------------------------------
# the update cycle: apply / confirm / clamp-walk / rollback / deadband
# ---------------------------------------------------------------------------

def test_window_fills_then_applies():
    with telemetry.capture() as buf:
        with SpecController(CFG) as ctrl:
            assert ctrl.step() is None          # empty window: fast path
            out = _feed_window(ctrl, 2.0, events=CFG.min_events - 1)
            assert out is None                  # still below min_events
            out = _feed_window(ctrl, 2.0, events=1)
            assert out == "apply"
            assert ctrl.active.loop_step_s == pytest.approx(
                ctrl.base.loop_step_s * 2.0)
            # installed process-wide, under every tier's default
            assert rmw_engine.default_spec() == ctrl.active
        assert rmw_engine.live_spec() is None   # stop() clears the override
    (apply,) = _events(buf, "tuning.apply")
    assert "loop_step_s" in apply["fields"]
    assert apply["fields"]["loop_step_s"]["to"] == pytest.approx(
        ctrl.base.loop_step_s * 2.0)


def test_clamp_walks_large_corrections_then_converges():
    with telemetry.capture() as buf:
        with SpecController(CFG) as ctrl:
            assert _feed_window(ctrl, 4.0) == "apply"     # clamped to 2x
            assert _feed_window(ctrl, 4.0) == "apply"     # walks to 4x
            assert _feed_window(ctrl, 4.0) == "hold"      # converged
            assert ctrl.active.loop_step_s == pytest.approx(
                ctrl.base.loop_step_s * 4.0)
            assert ctrl.n_applied == 2 and ctrl.n_rollbacks == 0
    first = _events(buf, "tuning.apply")[0]
    assert "loop_step_s" in first["clamped"]
    assert len(_events(buf, "tuning.confirm")) == 2
    (hold,) = [e for e in _events(buf, "tuning.skip")
               if e["reason"] == "deadband"]
    assert hold["n"] == CFG.min_events


def test_rollback_reinstalls_the_previous_spec():
    with telemetry.capture() as buf:
        with SpecController(CFG) as ctrl:
            assert _feed_window(ctrl, 2.0) == "apply"
            assert _feed_window(ctrl, 64.0) == "rollback"
            assert ctrl.active == ctrl.base               # bit-equal restore
            assert rmw_engine.default_spec() == ctrl.base
            assert ctrl.n_rollbacks == 1
    (rb,) = _events(buf, "tuning.rollback")
    assert rb["score"] > rb["pre_swap_score"] + CFG.rollback_margin
    assert not _events(buf, "tuning.confirm")


def test_cooldown_sits_out_a_window_after_a_swap():
    cfg = dataclasses.replace(CFG, cooldown_updates=1)
    with telemetry.capture() as buf:
        with SpecController(cfg) as ctrl:
            assert _feed_window(ctrl, 2.0) == "apply"
            assert _feed_window(ctrl, 2.0) == "cooldown"
            assert _feed_window(ctrl, 2.0) == "hold"
    assert len(_events(buf, "tuning.confirm")) == 1
    assert [e["reason"] for e in _events(buf, "tuning.skip")] == \
        ["cooldown", "deadband"]


def test_deadband_holds_sub_threshold_moves():
    with telemetry.capture() as buf:
        with SpecController(CFG) as ctrl:
            assert _feed_window(ctrl, math.exp(0.02)) == "hold"
            assert ctrl.active == ctrl.base
            assert ctrl.n_applied == 0
    (skip,) = _events(buf, "tuning.skip")
    assert skip["reason"] == "deadband"


def test_per_field_sample_floors_surface_skipped_fields():
    cfg = dataclasses.replace(
        CFG, min_samples=2, min_samples_per_field={"sort_elem_pass_s": 99})
    with telemetry.capture() as buf:
        with SpecController(cfg) as ctrl:
            for _ in range(6):
                telemetry.record("atomics.execute", tier="local",
                                 backend="serialized", op="faa", n=256,
                                 predicted_s=P0, measured_s=P0 * 2)
            for _ in range(2):
                telemetry.record("atomics.execute", tier="local",
                                 backend="sort", op="faa", n=256,
                                 predicted_s=P0, measured_s=P0 * 3)
            assert ctrl.step() == "apply"
            assert ctrl.active.loop_step_s == pytest.approx(
                ctrl.base.loop_step_s * 2)
            assert ctrl.active.sort_elem_pass_s == ctrl.base.sort_elem_pass_s
    (apply,) = _events(buf, "tuning.apply")
    assert apply["skipped"]["sort_elem_pass_s"] == {"n": 2,
                                                    "min_samples": 99}


def test_only_one_controller_per_process():
    with telemetry.capture():
        with SpecController(CFG):
            with pytest.raises(RuntimeError, match="already running"):
                SpecController(CFG).start()
        with SpecController(CFG):           # released on stop
            pass


def test_stats_reports_counters_and_tuned_fields():
    with telemetry.capture():
        with SpecController(CFG) as ctrl:
            _feed_window(ctrl, 2.0)
            stats = ctrl.stats()
    assert stats["applied"] == 1 and stats["updates"] == 1
    assert stats["last_outcome"] == "apply"
    assert set(stats["tuned_fields"]) == {"loop_step_s"}
    assert stats["tuned_fields"]["loop_step_s"]["active"] == pytest.approx(
        stats["tuned_fields"]["loop_step_s"]["calibrated"] * 2)


def test_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv(TUNING_ENV, raising=False)
    assert from_env() is None
    monkeypatch.setenv(TUNING_ENV, "off")
    assert from_env() is None
    monkeypatch.setenv(TUNING_ENV, "on")
    ctrl = from_env()
    assert isinstance(ctrl, SpecController) and ctrl.state_path is None
    assert ctrl.device.type == "cuda"            # the port's default device
    assert ctrl.base == rmw_engine.calibrated_spec("cuda")
    assert from_env(device="cpu").base == rmw_engine.calibrated_spec("cpu")
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv(TUNING_ENV, path)
    assert from_env().state_path == path


# ---------------------------------------------------------------------------
# chaos: the spec_perturb site
# ---------------------------------------------------------------------------

def test_spec_perturb_draws_are_deterministic():
    assert _perturb_u(3) == _perturb_u(3)
    _seed_where(lambda u: u < 0.5)               # skew
    _seed_where(lambda u: 0.5 <= u < 0.75)       # NaN poison
    _seed_where(lambda u: u >= 0.75)             # negative poison


def test_skewed_window_is_walked_back_by_honest_windows():
    seed = _seed_where(
        lambda u: u < 0.5 and abs(4.0 * u - 1.0) * math.log(8.0) > 0.3)
    plan = FaultPlan(seed, {"spec_perturb": SiteSpec(prob=1.0, count=1)})
    with telemetry.capture() as buf:
        with SpecController(CFG, chaos=plan) as ctrl:
            assert _feed_window(ctrl, 1.0) == "apply"     # the skewed swap
            assert ctrl.active.loop_step_s != ctrl.base.loop_step_s
            _feed_window(ctrl, 1.0)                       # honest: walk back
            _feed_window(ctrl, 1.0)
            assert abs(math.log(ctrl.active.loop_step_s
                                / ctrl.base.loop_step_s)) < CFG.deadband
            assert ctrl.n_perturbs == 1
    (pert,) = _events(buf, "tuning.perturb")
    assert pert["kind"] == "skew"


@pytest.mark.parametrize("kind,pick", [
    ("nan", lambda u: 0.5 <= u < 0.75),
    ("negative", lambda u: u >= 0.75),
])
def test_poisoned_proposals_are_quarantined(kind, pick):
    plan = FaultPlan(_seed_where(pick),
                     {"spec_perturb": SiteSpec(prob=1.0, count=1)})
    with telemetry.capture() as buf:
        with SpecController(CFG, chaos=plan) as ctrl:
            assert _feed_window(ctrl, 3.0) == "quarantine"
            assert ctrl.active == ctrl.base
            assert ctrl.n_quarantined == 1
            assert _feed_window(ctrl, 3.0) == "apply"
    (q,) = _events(buf, "tuning.quarantine")
    (name, info), = q["fields"].items()
    assert name in TUNABLE_FIELDS
    assert info["reason"] == "non-finite or non-positive"
    (pert,) = _events(buf, "tuning.perturb")
    assert pert["kind"] == "poison" and pert["poison"] == kind


def test_out_of_envelope_proposal_falls_back_to_calibrated():
    with telemetry.capture():
        with SpecController(CFG) as ctrl:
            assert _feed_window(ctrl, 2.0) == "apply"     # now tuned 2x
            applied, _clamped, quarantined = ctrl._guard(
                {"loop_step_s": ctrl.base.loop_step_s
                 * CFG.envelope_factor * 10})
            assert "loop_step_s" in quarantined
            assert quarantined["loop_step_s"]["reason"] == \
                "outside calibrated envelope"
            assert applied == {"loop_step_s": ctrl.base.loop_step_s}


# ---------------------------------------------------------------------------
# validated persistence
# ---------------------------------------------------------------------------

EST_KEY = ("cas", "local", "2^4", "2^3")


def test_state_roundtrip_restores_spec_and_estimator(tmp_path):
    path = str(tmp_path / "tuned.json")
    with telemetry.capture():
        with SpecController(CFG, state_path=path) as ctrl:
            _feed_window(ctrl, 2.0)
            ctrl.estimator.update(EST_KEY, 4)
            tuned = ctrl.active
    saved = json.load(open(path))
    assert saved["backend"] == "cuda" and "jax_backend" not in saved
    assert saved["version"] == 1 and saved["counters"]["applied"] == 1
    with telemetry.capture() as buf:
        with SpecController(CFG, state_path=path) as ctrl2:
            assert ctrl2.active == tuned
            assert rmw_engine.default_spec() == tuned     # re-installed
            assert ctrl2.estimator.raw(EST_KEY) == 4.0
    (restore,) = _events(buf, "tuning.restore")
    assert restore["accepted"] and not restore["quarantined"]
    assert restore["estimator_sites"] == 1


def test_restore_rejects_backend_mismatch(tmp_path):
    path = tmp_path / "tuned.json"
    base = rmw_engine.calibrated_spec()
    path.write_text(json.dumps({
        "version": 1, "backend": "not-this-backend",
        "spec": perf_model.spec_to_dict(
            dataclasses.replace(base, loop_step_s=base.loop_step_s * 2))}))
    with telemetry.capture() as buf:
        with SpecController(CFG, state_path=str(path)) as ctrl:
            assert ctrl.active == ctrl.base               # nothing installed
    (restore,) = _events(buf, "tuning.restore")
    assert restore["accepted"] is False
    assert "backend mismatch" in restore["reason"]


def test_restore_rejects_a_cpu_state_on_the_card(tmp_path):
    """A state tuned on the CPU never installs on a controller for the
    card, and the reverse."""
    path = str(tmp_path / "tuned.json")
    with telemetry.capture():
        with SpecController(CFG, state_path=path, device="cpu") as ctrl:
            _feed_window(ctrl, 2.0)
    assert json.load(open(path))["backend"] == "cpu"
    with telemetry.capture() as buf:
        with SpecController(CFG, state_path=path, device="cuda") as ctrl:
            assert ctrl.active == ctrl.base
    (restore,) = _events(buf, "tuning.restore")
    assert not restore["accepted"] and "'cpu'" in restore["reason"]


def test_restore_rejects_the_references_state_file(tmp_path):
    """A state file written by `repro.tuning` (``"jax_backend"``, no
    ``"backend"``) is rejected whole, on either device."""
    path = str(tmp_path / "tuned.json")
    with jtelemetry.capture():
        with jtuning.SpecController(jtuning.TuningConfig(
                min_events=8, min_samples=2, cooldown_updates=0),
                state_path=path) as jctrl:
            for _ in range(8):
                jtelemetry.record("atomics.execute", tier="local",
                                  backend="serialized", op="faa", n=256,
                                  predicted_s=P0, measured_s=2 * P0)
            assert jctrl.step() == "apply"
    assert "jax_backend" in json.load(open(path))
    for device in ("cpu", "cuda"):
        with telemetry.capture() as buf:
            with SpecController(CFG, state_path=path,
                                device=device) as ctrl:
                assert ctrl.active == ctrl.base
                assert rmw_engine.live_spec() is None
        (restore,) = _events(buf, "tuning.restore")
        assert restore["accepted"] is False
        assert "backend mismatch" in restore["reason"]


def test_restore_quarantines_out_of_envelope_fields(tmp_path):
    path = tmp_path / "tuned.json"
    base = rmw_engine.calibrated_spec()
    poisoned = dataclasses.replace(
        base,
        loop_step_s=base.loop_step_s * CFG.envelope_factor * 100,
        gather_elem_s=base.gather_elem_s * 1.5)           # this one is fine
    path.write_text(json.dumps({
        "version": 1, "backend": "cuda",
        "spec": perf_model.spec_to_dict(poisoned)}))
    with telemetry.capture() as buf:
        with SpecController(CFG, state_path=str(path)) as ctrl:
            assert ctrl.active.loop_step_s == base.loop_step_s
            assert ctrl.active.gather_elem_s == pytest.approx(
                base.gather_elem_s * 1.5)
    (restore,) = _events(buf, "tuning.restore")
    assert restore["accepted"] and \
        set(restore["quarantined"]) == {"loop_step_s"}


def test_restore_rejects_unreadable_state(tmp_path):
    path = tmp_path / "tuned.json"
    path.write_text("not json {{{")
    with telemetry.capture() as buf:
        with SpecController(CFG, state_path=str(path)) as ctrl:
            assert ctrl.active == ctrl.base
    (restore,) = _events(buf, "tuning.restore")
    assert restore["accepted"] is False


# ---------------------------------------------------------------------------
# the contention estimator
# ---------------------------------------------------------------------------

def test_estimator_ewma_and_pow2_hint():
    est = ContentionEstimator(alpha=0.5)
    key = site_key("cas", "local", 16, 8)
    assert est.hint(key) is None
    est.update(key, 2)
    est.update(key, 6)                        # ewma: 2 + .5*(6-2) = 4
    assert est.raw(key) == pytest.approx(4.0)
    assert est.hint(key) == 4
    est.update(key, 6)                        # ewma 5 -> rounds to 4
    assert est.hint(key) in (4, 8)
    assert math.log2(est.hint(key)).is_integer()
    est.update(key, 0)
    est.update(key, -3)
    est.update(key, float("nan"))
    assert est.raw(key) == pytest.approx(5.0)
    with pytest.raises(ValueError, match="alpha"):
        ContentionEstimator(alpha=0.0)


def test_estimator_snapshot_restore_drops_malformed():
    est = ContentionEstimator()
    est.update(EST_KEY, 4)
    snap = est.snapshot()
    snap["sites"]["bad|key"] = 2.0            # wrong arity
    snap["sites"]["a|b|c|d"] = float("nan")   # non-finite
    snap["sites"]["e|f|g|h"] = 0.5            # below 1: no signal
    fresh = ContentionEstimator()
    assert fresh.restore(snap) == 1
    assert fresh.raw(EST_KEY) == 4.0
    assert len(fresh) == 1


def test_execute_until_feeds_the_estimator():
    with telemetry.capture(sync=True) as buf:
        with SpecController(CFG) as ctrl:
            table = atomics.AtomicTable(torch.zeros((8,), dtype=torch.int32))

            def make_ops(slots, observed):
                if slots is None:             # all six ops fight slot 0
                    return atomics.Cas(torch.zeros(6, dtype=torch.int32),
                                       torch.ones(6, dtype=torch.int32),
                                       expected=0)
                return observed + 1

            res = atomics.execute_until(table, make_ops, max_rounds=8)
            assert res.success.all()
            assert int(res.table.data[0]) == 6
            key = site_key("cas", "local", 8, 6)
            assert ctrl.estimator.raw(key) == pytest.approx(1.0)
            assert ctrl.estimator.hint(key) == 1
            assert ctrl.estimator.n_updates_device == 1
    rounds = _events(buf, "atomics.retry.round")
    assert rounds[0]["distinct_observed"] == 1


def test_execute_until_default_skips_the_host_count(monkeypatch):
    """Under a controller the default runs the device pass and never the
    host count; ``collect_stats=False`` takes the host count instead."""
    from repro_torch.atomics import retry
    calls = []
    real = retry._host_distinct
    monkeypatch.setattr(retry, "_host_distinct",
                        lambda x: calls.append(len(x)) or real(x))
    with SpecController(CFG) as ctrl:
        make = _cas_loop(atomics, torch.as_tensor, 8,
                         np.array([0, 0, 3], np.int32))
        res = atomics.execute_until(atomics.make_table(8, device="cpu"),
                                    make, max_rounds=4)
        assert res.stats is not None and not calls
        res = atomics.execute_until(atomics.make_table(8, device="cpu"),
                                    make, max_rounds=4, collect_stats=False)
        assert res.stats is None and calls == [3]
        assert ctrl.estimator.n_updates_host == 3      # + two CAS winners


def test_execute_until_sharded_hint_uses_the_global_size():
    """The site key of a sharded table names its global slots."""
    from repro_torch.atomics import retry

    class FakeMesh:
        def size(self, axes):
            return 4

    tab = atomics.AtomicTable(torch.zeros(64, dtype=torch.int32))
    assert retry._global_m(tab) == 64
    sharded = atomics.AtomicTable(torch.zeros(64, dtype=torch.int32),
                                  axis=("pod", "dev"), mesh=FakeMesh())
    assert retry._global_m(sharded) == 256


def test_execute_until_without_controller_is_unchanged():
    """No controller: no estimator, no device pass by default, and the
    same results and events as with ``collect_stats=False`` spelled
    out."""
    def make_ops(slots, observed):
        if slots is None:
            return atomics.Cas(torch.tensor([0, 1, 1, 2, 1],
                                            dtype=torch.int32),
                               torch.ones(5, dtype=torch.int32), expected=0)
        return observed + 1

    keep = lambda evs: [{k: v for k, v in e.items()
                         if k not in ("t", "measured_s")} for e in evs]
    got = []
    for kw in ({}, {"collect_stats": False}):
        with telemetry.capture(sync=True) as buf:
            res = atomics.execute_until(atomics.make_table(8, device="cpu"),
                                        make_ops, max_rounds=4, **kw)
        got.append((res, keep(buf.events)))
    (a, ea), (b, eb) = got
    assert a.success.all() and a.n_rounds == 3 and a.stats is None
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert torch.equal(a.table.data, b.table.data)
    assert ea == eb and ea
    assert active_controller() is None


# ---------------------------------------------------------------------------
# integration: wrap_step, the chaos matrix, train()
# ---------------------------------------------------------------------------

def test_wrap_step_preserves_donation_and_runs_the_cycle():
    def step(i, state):
        return state

    donating = declare_donation(step, (1,))
    with telemetry.capture():
        with SpecController(CFG) as ctrl:
            wrapped = ctrl.wrap_step(donating)
            assert tuple(wrapped.donate_argnums) == (1,)
            for _ in range(CFG.min_events):
                telemetry.record("atomics.execute", tier="local",
                                 backend="serialized", op="faa", n=256,
                                 predicted_s=P0, measured_s=P0 * 2)
            wrapped(0, None)
            assert ctrl.last_outcome == "apply"


N_STEPS = 12
M_SLOTS = 16


def _matrix_step(step, state):
    table, acc = state
    idx = torch.as_tensor((np.arange(8) * (step + 3)) % M_SLOTS,
                          dtype=torch.int32)
    vals = torch.as_tensor(np.arange(8) + step, dtype=torch.int32)
    res = atomics.execute(table, atomics.Faa(idx, vals))
    return res.table, acc + res.fetched.sum().to(torch.int32)


def _run_matrix(tmp_path, tag, chaos, controller):
    from repro_torch.runtime.elastic import reshard_tables
    ckpt_dir = str(tmp_path / tag)
    like = lambda: {"table": atomics.AtomicTable(
        torch.zeros((M_SLOTS,), dtype=torch.int32)),
        "acc": torch.tensor(0, dtype=torch.int32)}
    step_fn = (_matrix_step if controller is None
               else controller.wrap_step(_matrix_step))

    def save_fn(step, state):
        ckpt.save(ckpt_dir, step, {"table": state[0], "acc": state[1]})

    def restore_fn():
        got = ckpt.restore_latest_valid(ckpt_dir, like())
        if got is None:
            return None
        step, tree, _ = got
        return step, (tree["table"], tree["acc"])

    init = like()
    res = run_with_recovery(
        step_fn, (init["table"], init["acc"]), N_STEPS,
        FaultConfig(max_failures=60, checkpoint_every=4, backoff_base_s=0.0),
        save_fn, restore_fn, chaos=chaos,
        reshard_fn=lambda s: reshard_tables(s, None),
        sleep_fn=lambda d: None)
    assert res.steps_done == N_STEPS
    final = ckpt.restore_latest_valid(ckpt_dir, like())
    assert final[0] == N_STEPS
    return final[1]["table"].data.numpy(), int(final[1]["acc"])


def test_tuned_chaos_matrix_bit_identical_to_untuned(tmp_path):
    """5 seeds of recovery faults plus spec_perturb poison, with a live
    controller retuning mid-run: the final table and fetched-sum
    accumulator bit-equal to the untuned fault-free run, every seed."""
    base_table, base_acc = _run_matrix(tmp_path, "base", FaultPlan.null(),
                                       None)
    assert base_table.any()
    sites = {"step": SiteSpec(prob=0.2, count=2),
             "ckpt_save": SiteSpec(prob=0.2, count=2),
             "ckpt_restore": SiteSpec(prob=0.2, count=1),
             "reshard": SiteSpec(prob=0.2, count=1),
             "spec_perturb": SiteSpec(prob=0.5)}
    cfg = TuningConfig(min_events=6, min_samples=1, cooldown_updates=0)
    updates = perturbs = fired = 0
    for seed in range(1, 6):
        plan = FaultPlan(seed, sites, sleep_fn=lambda d: None)
        ctrl = SpecController(cfg, chaos=plan, device="cpu")
        with ctrl:
            table, acc = _run_matrix(tmp_path, f"seed{seed}", plan, ctrl)
        np.testing.assert_array_equal(
            table, base_table,
            err_msg=f"seed {seed}: tuned run diverged from untuned")
        assert acc == base_acc, f"seed {seed}: accumulator diverged"
        updates += ctrl.n_updates
        perturbs += ctrl.n_perturbs
        fired += plan.total_fired
    assert updates >= 5
    assert perturbs >= 1
    assert fired >= 5


def test_train_metrics_bit_equal_tuned_vs_untuned():
    """Real train() steps on the CPU: a live controller (sync on) moves
    no loss or gradient-norm bit, and no live spec outlives train()."""
    from repro_torch.launch.train import train
    kw = dict(steps=4, seq_len=16, global_batch=2, lr=1e-3, log_every=1,
              seed=7, device="cpu")
    base = train("gemma_2b", **kw)
    ctrl = SpecController(TuningConfig(min_events=4, min_samples=1,
                                       cooldown_updates=0), device="cpu")
    tuned = train("gemma_2b", **kw, tuning=ctrl)
    assert "tuning" in tuned and tuned["tuning"]["updates"] >= 0
    assert [h["loss"] for h in base["history"]] == \
        [h["loss"] for h in tuned["history"]]
    assert [h["grad_norm"] for h in base["history"]] == \
        [h["grad_norm"] for h in tuned["history"]]
    assert rmw_engine.live_spec() is None
    assert active_controller() is None


def test_trainer_state_file_and_env_hook(tmp_path, monkeypatch, capsys):
    """``--tuning STATE`` persists the controller's state; ``REPRO_TUNING``
    = a path does the same through `train`."""
    from repro_torch.launch import train as ttrain
    path = str(tmp_path / "tuned.json")
    args = ["--arch", "gemma_2b", "--steps", "2", "--seq-len", "8",
            "--global-batch", "2", "--device", "cpu"]
    ttrain.main(args + ["--tuning", path])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["tuning"]["updates"] == 0
    assert json.load(open(path))["backend"] == "cpu"
    other = str(tmp_path / "env.json")
    monkeypatch.setenv(TUNING_ENV, other)
    got = ttrain.train("gemma_2b", steps=1, seq_len=8, global_batch=2,
                       device="cpu")
    assert "tuning" in got and os.path.exists(other)
    assert rmw_engine.live_spec() is None


# ---------------------------------------------------------------------------
# ranks: one spec on every rank of the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agree():
    return ranks.launch(f"{os.path.join(HERE, '_torch_tuning_worker.py')}"
                        ":ranks_agree", 4, mesh=((2, 2), ("pod", "dev")),
                        device="cpu", timeout=120)


def test_ranks_install_one_spec_at_the_same_call(agree):
    """Rank 0 fills its window and fits 2x slow; the other ranks' windows
    never fill alone and drift otherwise.  Every rank reports the same
    outcome, spec, spec epoch and stats after every step, and applied."""
    log0 = agree[0]["log"]
    assert [s[0] for s in log0][0] == "apply"
    assert any(s[0] == "apply" for s in log0[1:])
    for r in agree[1:]:
        assert r["log"] == log0
    assert agree[0]["log"][-1][3]["applied"] >= 2


def test_ranks_sharded_execute_until_under_the_estimator(agree):
    """The sharded CAS loop and hot FAA batches under the estimator
    finish on every rank (no hang within the launch's timeout) with the
    untuned run's int32 results, and the estimators agree."""
    for r in agree:
        assert r["tuned"] == r["untuned"] == agree[0]["untuned"]
        assert r["estimator"] == agree[0]["estimator"]
        assert r["live_after"]
    sites = agree[0]["estimator"]["sites"]
    assert set(sites) == {"cas|sharded|2^8|2^6", "faa|sharded|2^8|2^7"}


# ---------------------------------------------------------------------------
# The two suites at their fast sizes
# ---------------------------------------------------------------------------

def test_contention_observe_suite_on_the_cpu(tmp_path, monkeypatch):
    """`--only contention_observe --fast` on the CPU: bit identity local
    and on 4 ranks, the estimator's device feed, the writers-per-slot
    rows, the JSON under ``--out``; the gates pass given overheads under
    3% and 5% and fail the suite at either bound (the measured ones swing
    on a shared CPU; `overhead` itself is held by the next test)."""
    from repro_torch.benchmarks import contention_observe as C
    from repro_torch.benchmarks import run as trun
    given = {"noise_floor": 0.01, "retry_overhead": 0.02,
             "retry_on_ms": 1.0, "retry_off_ms": 1.0,
             "eager_per_call_overhead_ungated": 0.1}
    monkeypatch.setattr(C, "overhead", lambda device, fast: dict(given))
    csv, results, failures = trun.run_suites(
        ["contention_observe"], fast=True, device="cpu",
        out_dir=str(tmp_path))
    assert not failures, failures
    out = results["contention_observe"]
    assert all(out["bit_identity_local"].values())
    sh = out["sharded"]
    assert sh["bit_identical"] and sh["ranks_agree"]
    assert sh["distinct_device"] == sh["distinct_host"]
    est = out["estimator_feed"]
    assert est["same_site_keys"] and est["distinct_agree"]
    assert est["n_updates_device"] >= 1
    assert [r["writers_per_slot"] for r in
            out["model_vs_measured"]["rows"]] == [1, 4, 16, 64, 512]
    assert out["model_vs_measured"]["rows"][-1][
        "measured_max_occupancy"] == 512
    saved = json.loads((tmp_path / "contention_observe.json").read_text())
    assert saved["acceptance_bit_identical_overhead_and_device_feed"]
    assert any(r["name"] == "contention_observe.retry_overhead"
               for r in csv.rows)
    for name in ("sharded", "model_vs_measured", "estimator_feed"):
        part = {"sharded": sh, "estimator_feed": est,
                "model_vs_measured": out["model_vs_measured"]}[name]
        monkeypatch.setattr(C, name, lambda *a, part=part: part)
    for k, v in (("noise_floor", 0.03), ("retry_overhead", 0.05)):
        monkeypatch.setattr(C, "overhead",
                            lambda device, fast: {**given, k: v})
        with pytest.raises(AssertionError, match="acceptance failed"):
            C.run(trun.Csv(), fast=True, device="cpu")


def test_contention_observe_overhead_measures_both_gates(monkeypatch):
    """`overhead` on the CPU at few pairs: finite ratios for both gates,
    the gate workload converging; `paired_ratio` reads a 5 ms call
    against a 1 ms call as a large positive overhead."""
    import time
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import contention_observe as C
    monkeypatch.setattr(C, "NOISE_PAIRS", (4, 2))
    monkeypatch.setattr(C, "FAST_PAIRS", 2)
    out = C.overhead("cpu", fast=True)
    for k in ("noise_floor", "retry_overhead",
              "eager_per_call_overhead_ungated"):
        assert math.isfinite(out[k]), k
    assert out["retry_on_ms"] > 0 and out["gate"] == 0.05
    pair = common.paired_ratio(lambda: time.sleep(0.005),
                               lambda: time.sleep(0.001), batch=2,
                               n_batches=4)
    assert 0.3 < pair["overhead"] < 10.0, pair


def test_tuning_suite_on_the_cpu(tmp_path, monkeypatch):
    """`--only tuning --fast` on the CPU: convergence within 12 windows,
    one-window rollback restoring bit-equal, the quarantine pair, a local
    tuned run bit-equal to the untuned one that took another backend on
    some batch, the JSON under ``--out``; the overhead gate given (the
    measured one is held by the next test) passes under 5% and fails the
    suite at 5%."""
    from repro_torch.benchmarks import run as trun
    from repro_torch.benchmarks import tuning as T
    given = {"n": 4096, "overhead": 0.01, "enabled_us": 101.0,
             "disabled_us": 100.0, "update_cycle_us": 50.0, "ok": True}
    monkeypatch.setattr(T, "overhead", lambda device, fast: dict(given))
    csv, results, failures = trun.run_suites(
        ["tuning"], fast=True, device="cpu", out_dir=str(tmp_path))
    assert not failures, failures
    out = results["tuning"]
    assert out["convergence"]["ok"]
    assert out["convergence"]["windows_to_converge"] <= T.MAX_WINDOWS
    assert out["rollback"]["ok"] and out["quarantine"]["ok"]
    local = out["bit_identity"]["local"]
    assert local["ok"] and local["bit_equal"] and local["restored"]
    assert local["batches_choice_differs"] >= 1
    assert out["bit_identity"]["sharded"] is None           # fast: skipped
    saved = json.loads((tmp_path / "tuning.json").read_text())
    assert saved["acceptance_converged_guarded_cheap_and_bit_identical"]
    monkeypatch.setattr(T, "overhead", lambda device, fast: {
        **given, "overhead": 0.05, "ok": False})
    with pytest.raises(AssertionError, match="acceptance failed"):
        T.run(trun.Csv(), fast=True, device="cpu")


def test_tuning_overhead_measures_a_live_controller(monkeypatch):
    """`overhead` on the CPU at few pairs: a live controller ran update
    cycles (a CPU call is always measured: a 64-call batch runs two), the
    cycle was timed alone, no controller or live spec is left, and the
    ratio is finite."""
    from repro_torch.benchmarks import tuning as T
    monkeypatch.setattr(T, "FAST_PAIRS", 2)
    out = T.overhead("cpu", fast=True)
    assert math.isfinite(out["overhead"]) and out["update_cycle_us"] > 0
    assert out["window_events"] == 32 and out["batch"] == 64
    assert out["controller"]["updates"] >= 4
    assert active_controller() is None and rmw_engine.live_spec() is None


def test_flip_state_changes_the_selection(tmp_path):
    """The bit-identity runs' restored state really moves the workload
    batch's backend, on the CPU and under the card's priors."""
    from repro_torch.benchmarks import tuning as T
    for device in ("cpu", "cuda"):
        path = str(tmp_path / f"{device}.json")
        change = T.flip_state(path, device, [("faa", 16, 64)])
        saved = json.load(open(path))
        assert saved["backend"] == device and change == T.FLIP
        spec = perf_model.spec_from_dict(saved["spec"])
        cal = rmw_engine.calibrated_spec(device)
        pick = lambda s: rmw_engine.select_backend(
            "faa", 16, 64, s, dtype=torch.int32, device=device)
        assert pick(spec) != pick(cal)
