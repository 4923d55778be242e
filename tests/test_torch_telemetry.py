"""repro_torch.telemetry: the reference's telemetry tests on the port, and
both packages side by side.

The first part is tests/test_telemetry.py's cases (stream mechanics, the
instrumented atomics, drift math, sinks, the ring crash-flush, the recovery
loop's ring) on `repro_torch.telemetry`; eager torch has no trace time, so
the reference's jit-retrace case becomes "every call records, traced
False", and the sharded and migration cases run on gloo ranks.  The second
part drives the same traffic through both packages under ``capture()``:
the same event names and decision fields, ``predicted_s`` within 1e-12
relative under one spec carried by `convert.spec_from_reference`; the
drift aggregation, spec fit and report of one recorded event list equal to
the reference's; equal retry rounds and done histograms; and the same
``chaos.fire`` sequence from one `FaultPlan` spec.  Both packages read
``REPRO_TELEMETRY``, so every test that sets it uses ``monkeypatch``, and
a fixture disables both streams around every test.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import atomics as jatomics
from repro import telemetry as jtelemetry
from repro.core import perf_model as jperf
from repro.telemetry import drift as jdrift
from repro.telemetry import report as jreport
from repro_torch import atomics, convert, telemetry
from repro_torch.core.perf_model import cpu_default_spec
from repro_torch.telemetry import core
from repro_torch.telemetry import drift
from repro_torch.telemetry.report import build_report, render_text

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _streams_off(monkeypatch):
    """Every test starts and ends with both packages' streams disabled and
    no REPRO_TELEMETRY in the environment."""
    monkeypatch.delenv(telemetry.TELEMETRY_ENV, raising=False)
    telemetry.disable()
    jtelemetry.disable()
    yield
    telemetry.disable()
    jtelemetry.disable()


# ---------------------------------------------------------------------------
# Stream mechanics
# ---------------------------------------------------------------------------

def test_disabled_by_default_and_record_is_noop():
    assert not telemetry.enabled()
    telemetry.record("anything", x=1)
    assert telemetry.sinks() == ()


def test_disabled_record_is_cheap():
    """A disabled record is one boolean check: 200k no-ops in under a
    second rules out any per-call allocation or locking."""
    t0 = time.perf_counter()
    for _ in range(200_000):
        telemetry.record("noop", a=1, b=2.0)
    assert time.perf_counter() - t0 < 1.0


def test_ring_buffer_capture_and_restore():
    with telemetry.capture() as buf:
        assert telemetry.enabled()
        telemetry.record("ev", k=1)
        telemetry.record("ev", k=2)
    assert not telemetry.enabled()
    assert [e["k"] for e in buf.events] == [1, 2]
    assert all(e["event"] == "ev" and "t" in e for e in buf.events)


def test_ring_buffer_is_bounded():
    buf = telemetry.RingBuffer(capacity=4)
    with telemetry.capture(buf):
        for i in range(10):
            telemetry.record("ev", i=i)
    assert [e["i"] for e in buf.events] == [6, 7, 8, 9]


def test_capture_nests_and_restores_prior_sinks():
    outer = telemetry.RingBuffer()
    telemetry.enable(outer)
    with telemetry.capture() as inner:
        telemetry.record("both")
    telemetry.record("outer_only")
    assert [e["event"] for e in outer.events] == ["both", "outer_only"]
    assert [e["event"] for e in inner.events] == ["both"]


def test_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "cap.jsonl")
    telemetry.enable(telemetry.JsonlWriter(path))
    telemetry.record("ev", i=np.int64(3), x=np.float32(0.5),
                     arr=np.arange(2), nested={"k": (1, 2)},
                     t0=torch.tensor(7), t1=torch.arange(3))
    telemetry.disable()
    (ev,) = telemetry.read_jsonl(path)
    assert ev["event"] == "ev" and ev["i"] == 3
    assert ev["x"] == pytest.approx(0.5)
    assert ev["arr"] == [0, 1] and ev["nested"] == {"k": [1, 2]}
    assert ev["t0"] == 7 and ev["t1"] == [0, 1, 2]


def test_broken_sink_never_breaks_the_instrumented_path():
    class Boom(telemetry.Sink):
        def emit(self, event):
            raise RuntimeError("sink died")
    good = telemetry.RingBuffer()
    telemetry.enable(Boom(), good)
    telemetry.record("ev")
    tbl = atomics.AtomicTable(torch.zeros((16,), dtype=torch.int32))
    atomics.execute(tbl, _faa(8, 16))          # the dispatch survives too
    assert [e["event"] for e in good.events] == ["ev", "atomics.execute"]


def test_counters_aggregate_numeric_fields():
    c = telemetry.Counters()
    with telemetry.capture(c):
        telemetry.record("ev", v=1.0, tag="a")
        telemetry.record("ev", v=3.0, tag="b")
        telemetry.record("other")
    s = c.summary()
    assert s["ev"]["count"] == 2 and s["other"]["count"] == 1
    v = s["ev"]["fields"]["v"]
    assert (v["n"], v["mean"], v["min"], v["max"]) == (2, 2.0, 1.0, 3.0)
    assert "tag" not in s["ev"]["fields"]


def test_span_measures_even_when_disabled():
    with telemetry.span("x") as sp:
        pass
    assert sp.wall_s is not None and sp.wall_s >= 0.0
    with telemetry.capture() as buf:
        with telemetry.span("x", step=3) as sp:
            pass
    (ev,) = buf.events
    assert ev["event"] == "x" and ev["step"] == 3 and ev["ok"] is True
    assert ev["wall_s"] == pytest.approx(sp.wall_s)


def test_span_records_failure_flag():
    with telemetry.capture() as buf:
        with pytest.raises(ValueError):
            with telemetry.span("x"):
                raise ValueError("boom")
    assert buf.events[0]["ok"] is False


def test_enable_from_env(tmp_path, monkeypatch):
    assert telemetry.enable_from_env() is False
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(telemetry.TELEMETRY_ENV, path)
    assert telemetry.enable_from_env() is True
    telemetry.record("ev")
    telemetry.disable()
    assert telemetry.read_jsonl(path)[0]["event"] == "ev"


def test_annotation_is_a_profiler_range_only_when_asked():
    """``annotation`` is a no-op unless the stream is on with
    ``annotate=True``; then a ``torch.profiler`` trace names the range."""
    import contextlib
    assert isinstance(telemetry.annotation("x"), contextlib.nullcontext)
    with telemetry.capture(annotate=True):
        assert telemetry.annotations_enabled()
        with torch.profiler.profile() as prof:
            with telemetry.annotation("atomics.execute/local"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "atomics.execute/local" in names


# ---------------------------------------------------------------------------
# Instrumented atomics
# ---------------------------------------------------------------------------

def _faa(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return atomics.Faa(torch.as_tensor(rng.integers(0, m, (n,)),
                                       dtype=torch.int32),
                       torch.ones((n,), dtype=torch.int32))


def test_eager_execute_emits_one_decision_event_with_measured_time():
    tbl = atomics.AtomicTable(torch.zeros((64,), dtype=torch.int32))
    with telemetry.capture(sync=True) as buf:
        atomics.execute(tbl, _faa(32, 64))
    (ev,) = [e for e in buf.events if e["event"] == "atomics.execute"]
    assert ev["tier"] == "local" and ev["traced"] is False
    assert ev["op"] == "faa" and ev["n"] == 32 and ev["m"] == 64
    assert ev["backend"] in ("serialized", "sort", "onehot", "cuda")
    assert ev["predicted_s"] > 0.0 and ev["measured_s"] > 0.0


def test_predicted_matches_the_selectors_own_choice():
    from repro_torch.core import rmw_engine
    tbl = atomics.AtomicTable(torch.zeros((256,), dtype=torch.int32))
    with telemetry.capture() as buf:
        atomics.execute(tbl, _faa(128, 256))
    (ev,) = [e for e in buf.events if e["event"] == "atomics.execute"]
    sel = rmw_engine.select_backend_with_cost(
        "faa", 128, 256, None, dtype=tbl.dtype, device="cpu")
    assert ev["backend"] == sel.choice
    assert ev["predicted_s"] == pytest.approx(sel.predicted_s)
    assert "measured_s" not in ev                # no sync: not measured


def test_every_eager_call_records_and_a_spec_change_reprices():
    """Eager torch: each call is a dispatch, so 5 calls record 5 events
    (the reference's jit records once per trace); the cached decision is
    keyed on the spec epoch, so a live spec re-prices the next event."""
    import dataclasses
    from repro_torch.core import rmw_engine
    tbl = atomics.AtomicTable(torch.zeros((32,), dtype=torch.int32))
    op = _faa(16, 32)
    with telemetry.capture() as buf:
        for _ in range(5):
            atomics.execute(tbl, op)
    evs = [e for e in buf.events if e["event"] == "atomics.execute"]
    assert len(evs) == 5 and all(e["traced"] is False for e in evs)
    spec = rmw_engine.default_spec("cpu")
    slow = dataclasses.replace(spec, sort_elem_pass_s=10 *
                               spec.sort_elem_pass_s,
                               gather_elem_s=10 * spec.gather_elem_s,
                               loop_step_s=10 * spec.loop_step_s)
    rmw_engine.set_live_spec(slow)
    try:
        with telemetry.capture() as buf:
            atomics.execute(tbl, op)
    finally:
        rmw_engine.clear_live_spec()
    (ev,) = [e for e in buf.events if e["event"] == "atomics.execute"]
    want = rmw_engine.select_backend_with_cost(
        "faa", 16, 32, slow, dtype=torch.int32, device="cpu")
    assert ev["predicted_s"] == pytest.approx(want.predicted_s, rel=1e-12)
    assert ev["predicted_s"] > 2 * evs[0]["predicted_s"]


def test_instrumentation_changes_no_results():
    tbl = atomics.AtomicTable(torch.zeros((64,), dtype=torch.int32))
    op = _faa(48, 64, seed=3)
    base = atomics.execute(tbl, op)
    with telemetry.capture(sync=True):
        instr = atomics.execute(tbl, op, collect_stats=True)
    assert torch.equal(base.table.data, instr.table.data)
    assert torch.equal(base.fetched, instr.fetched)


def test_stats_event_at_the_sync_boundary():
    tbl = atomics.AtomicTable(torch.zeros((64,), dtype=torch.int32))
    with telemetry.capture() as buf:
        atomics.execute(tbl, _faa(48, 64), collect_stats=True)
    assert [e["event"] for e in buf.events] == ["atomics.execute"]
    with telemetry.capture(sync=True) as buf:
        res = atomics.execute(tbl, _faa(48, 64), collect_stats=True)
    names = [e["event"] for e in buf.events]
    assert names == ["atomics.execute", "contention.stats"]
    st = buf.events[1]
    assert st["n_ops"] == 48 and st["tier"] == "local"
    assert st["distinct_slots"] == int(res.stats.distinct_slots)


def _contended(n):
    def make_ops(slots, observed):
        if slots is None:
            return atomics.Cas(torch.zeros((n,), dtype=torch.int32),
                               torch.ones((n,), dtype=torch.int32),
                               expected=torch.zeros((n,), dtype=torch.int32))
        return observed + 1
    return make_ops


def test_retry_rounds_and_done_histogram():
    tbl = atomics.AtomicTable(torch.zeros((8,), dtype=torch.int32))
    n = 5
    with telemetry.capture() as buf:
        res = atomics.retry.execute_until(tbl, _contended(n), max_rounds=n)
    assert res.success.all()
    rounds = [e for e in buf.events if e["event"] == "atomics.retry.round"]
    assert len(rounds) == res.n_rounds == n
    assert [e["pending"] for e in rounds] == [5, 4, 3, 2, 1]
    assert all(e["resolved"] == 1 and e["measured_s"] > 0 for e in rounds)
    assert rounds[0]["distinct_observed"] == 1
    (done,) = [e for e in buf.events if e["event"] == "atomics.retry.done"]
    assert done["n"] == n and done["unresolved"] == 0
    assert done["round_histogram"] == [0] + [1] * n
    assert done["attempts"] == n * (n + 1) // 2


def _ranks(fn, args=()):
    from repro_torch.launch import ranks
    return ranks.launch(f"{os.path.join(HERE, '_torch_telemetry_worker.py')}"
                        f":{fn}", 4, mesh=((2, 2), ("pod", "dev")),
                        args=args, device="cpu", timeout=300)


def test_sharded_execute_until_and_migrate_events():
    """On 4 gloo ranks (2x2): one sharded `execute` records one decision
    event (strategy and prediction, no measured time: the round owns it);
    a one-round `execute_until` records its round with both times; each
    `migrate` path records one migration event.  Every rank's events are
    the same, up to the clocks."""
    out = _ranks("sharded_events")
    strip = [[{k: v for k, v in e.items()
               if k not in ("t", "measured_s")} for e in evs] for evs in out]
    assert all(s == strip[0] for s in strip)
    evs = out[0]
    ex = [e for e in evs if e["event"] == "atomics.execute"]
    assert ex[0]["tier"] == "sharded" and ex[0]["n_shards"] == 4
    assert ex[0]["m"] == 64 and ex[0]["strategy"] in (
        "oneshot", "hierarchical", "dense")
    assert ex[0]["predicted_s"] > 0 and "measured_s" not in ex[0]
    (rnd,) = [e for e in evs if e["event"] == "atomics.retry.round"]
    assert rnd["tier"] == "sharded" and rnd["predicted_s"] > 0
    assert rnd["measured_s"] > 0 and rnd["n_exec"] == 8
    mig = [e for e in evs if e["event"] == "atomics.reshard.migrate"]
    assert [e["path"] for e in mig] == ["exchange", "device_put"]
    assert all(e["tier"] == "migration" and e["n_slots"] == 64
               and e["measured_s"] > 0 and e["predicted_s"] > 0
               for e in mig)


# ---------------------------------------------------------------------------
# Drift aggregation + spec fitting (pure math)
# ---------------------------------------------------------------------------

def _ev(tier, choice, op, n, pred, meas):
    key = "path" if tier == "migration" else \
        ("backend" if tier == "local" else "strategy")
    return {"event": ("atomics.reshard.migrate" if tier == "migration"
                      else "atomics.execute"),
            "tier": tier, key: choice, "op": op, "n": n,
            "predicted_s": pred, "measured_s": meas}


def test_drift_ratio_is_geometric_mean():
    evs = [_ev("local", "sort", "faa", 64, 1e-4, 2e-4),
           _ev("local", "sort", "faa", 64, 1e-4, 5e-5)]
    (st,) = drift.aggregate(evs).values()
    assert st.n == 2
    assert st.ratio == pytest.approx(1.0)
    assert st.min_ratio == pytest.approx(0.5)
    assert st.max_ratio == pytest.approx(2.0)


def test_drift_grouping_and_skips():
    evs = [
        _ev("local", "sort", "faa", 64, 1e-4, 2e-4),
        _ev("local", "sort", "faa", 4096, 1e-4, 2e-4),
        _ev("local", "serialized", "cas", 4, 1e-5, 1e-5),
        _ev("local", "sort", "faa", 64, None, 2e-4),
        {"event": "atomics.execute", "tier": "local", "backend": "sort",
         "op": "faa", "n": 64, "predicted_s": 1e-4, "traced": False},
        {"event": "train.step", "predicted_s": 1e-4, "measured_s": 1e-4},
    ]
    assert set(drift.aggregate(evs)) == {
        ("local", "sort", "faa", "2^6"), ("local", "sort", "faa", "2^12"),
        ("local", "serialized", "cas", "2^2")}


def test_size_bucket():
    assert drift.size_bucket(1) == "2^0"
    assert drift.size_bucket(8) == "2^3"
    assert drift.size_bucket(9) == "2^4"
    assert drift.size_bucket(None) == "?"


def test_fit_spec_update_direct_and_inverse():
    spec = cpu_default_spec()
    evs = ([_ev("local", "serialized", "cas", 8, 1e-5, 4e-5)] * 4 +
           [_ev("migration", "device_put", "-", 4096, 1e-3, 2e-3)] * 4)
    out = drift.fit_spec_update(drift.aggregate(evs), spec)
    f = out["fields"]
    assert f["loop_step_s"]["ratio"] == pytest.approx(4.0)
    assert f["loop_step_s"]["proposed"] == \
        pytest.approx(spec.loop_step_s * 4.0)
    assert f["host_roundtrip_Bps"]["proposed"] == \
        pytest.approx(spec.host_roundtrip_Bps / 2.0)
    assert out["spec"].loop_step_s == pytest.approx(spec.loop_step_s * 4.0)
    assert out["spec"].name == spec.name


def test_cuda_drift_is_reported_but_not_fitted():
    """``("local", "cuda")`` has no spec field: its drift shows in the
    rows, and the fit neither uses nor lists it."""
    evs = [_ev("local", "cuda", "faa", 4096, 1e-5, 3e-5)] * 5
    stats = drift.aggregate(evs)
    assert drift.summarize(stats)[0]["choice"] == "cuda"
    out = drift.fit_spec_update(stats, cpu_default_spec())
    assert out["fields"] == {} and out["skipped"] == {}
    assert ("local", "cuda") not in drift.SPEC_FIELD_OF


def test_fit_spec_update_needs_min_samples():
    evs = [_ev("local", "sort", "faa", 64, 1e-4, 2e-4)] * 2
    out = drift.fit_spec_update(drift.aggregate(evs), cpu_default_spec(),
                                min_samples=3)
    assert out["fields"] == {}


def test_fit_spec_update_per_field_floors_and_skipped():
    spec = cpu_default_spec()
    evs = ([_ev("local", "serialized", "cas", 8, 1e-5, 2e-5)] * 5 +
           [_ev("local", "sort", "faa", 64, 1e-4, 3e-4)] * 2)
    stats = drift.aggregate(evs)
    out = drift.fit_spec_update(stats, spec,
                                min_samples={"*": 2, "loop_step_s": 6})
    assert "sort_elem_pass_s" in out["fields"]
    assert out["skipped"]["loop_step_s"] == {"n": 5, "min_samples": 6}
    out2 = drift.fit_spec_update(stats, spec, min_samples=3)
    assert "loop_step_s" in out2["fields"]
    assert out2["skipped"]["sort_elem_pass_s"] == {"n": 2, "min_samples": 3}


def test_fit_spec_update_skips_unset_fields_with_reason():
    import dataclasses
    spec = dataclasses.replace(cpu_default_spec(), loop_step_s=0.0)
    evs = [_ev("local", "serialized", "cas", 8, 1e-5, 2e-5)] * 4
    out = drift.fit_spec_update(drift.aggregate(evs), spec, min_samples=2)
    assert out["fields"] == {}
    assert out["skipped"]["loop_step_s"]["reason"] == "field unset on spec"


def test_report_build(tmp_path):
    evs = [_ev("local", "sort", "faa", 64, 1e-4, 2e-4)] * 3
    path = str(tmp_path / "cap.jsonl")
    with open(path, "w") as f:
        for e in evs:
            f.write(json.dumps(e) + "\n")
    report = build_report(telemetry.read_jsonl(path))
    assert report["n_events"] == 3
    assert report["events"]["atomics.execute"]["count"] == 3
    (row,) = report["drift"]
    assert row["ratio"] == pytest.approx(2.0)
    text = render_text(report)
    assert "atomics.execute" in text and "sort" in text


def test_report_surfaces_skipped_fields():
    evs = [_ev("local", "sort", "faa", 64, 1e-4, 2e-4)] * 2
    report = build_report(evs, spec=cpu_default_spec())
    assert report["spec_update"] == {}
    assert report["spec_update_skipped"]["sort_elem_pass_s"]["n"] == 2
    assert "sort_elem_pass_s: skipped" in render_text(report)


def test_report_cli(tmp_path, capsys):
    from repro_torch.telemetry import report
    path = str(tmp_path / "cap.jsonl")
    with open(path, "w") as f:
        for e in [_ev("local", "sort", "faa", 64, 1e-4, 2e-4)] * 3:
            f.write(json.dumps(e) + "\n")
    assert report.main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["n_events"] == 3
    assert report.main([path]) == 0
    assert "cost-model drift" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# add_sink / remove_sink and the ring crash-flush
# ---------------------------------------------------------------------------

def test_add_sink_widens_flags_and_remove_sink_resets():
    outer = telemetry.RingBuffer()
    telemetry.enable(outer, sync=True)
    tap = telemetry.RingBuffer()
    telemetry.add_sink(tap, sync=False)
    assert telemetry.sync_enabled()
    telemetry.record("ev")
    assert len(outer.events) == 1 and len(tap.events) == 1
    assert telemetry.remove_sink(tap) is True
    assert telemetry.remove_sink(tap) is False
    telemetry.record("ev")
    assert len(outer.events) == 2 and len(tap.events) == 1
    assert telemetry.remove_sink(outer) is True
    assert not telemetry.enabled()
    assert not telemetry.sync_enabled()


def test_add_sink_alone_enables_the_stream():
    tap = telemetry.RingBuffer()
    telemetry.add_sink(tap, sync=True)
    assert telemetry.enabled() and telemetry.sync_enabled()
    telemetry.remove_sink(tap)
    assert not telemetry.enabled()


def test_ring_events_and_flush_ring(tmp_path):
    assert telemetry.flush_ring() == 0
    telemetry.enable(telemetry.RingBuffer())
    telemetry.record("a", i=1)
    telemetry.record("b", arr=np.arange(2))
    assert [e["event"] for e in telemetry.ring_events()] == ["a", "b"]
    path = str(tmp_path / "flush.jsonl")
    assert telemetry.flush_ring(path) == 2
    back = telemetry.read_jsonl(path)
    assert [e["event"] for e in back] == ["a", "b"]
    assert back[1]["arr"] == [0, 1]
    telemetry.disable()
    telemetry.enable(telemetry.JsonlWriter(str(tmp_path / "cap.jsonl")))
    telemetry.record("c")
    assert telemetry.ring_events() == [] and telemetry.flush_ring() == 0


def test_enable_from_env_ring_names_the_flush_path(tmp_path, monkeypatch):
    flush_to = str(tmp_path / "ring_tail.jsonl")
    monkeypatch.setattr(core, "_ring_flush_path", None)
    monkeypatch.setenv(telemetry.TELEMETRY_ENV, f"ring:{flush_to}")
    assert telemetry.enable_from_env() is True
    telemetry.record("crashy", step=3)
    assert telemetry.flush_ring() == 1
    assert telemetry.read_jsonl(flush_to)[0]["event"] == "crashy"


def test_run_result_attaches_ring_tail():
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     run_with_recovery)
    telemetry.enable(telemetry.RingBuffer())
    store = {}
    res = run_with_recovery(
        lambda s, x: x + 1, 0, 4,
        FaultConfig(checkpoint_every=2, backoff_base_s=0.0),
        lambda s, x: store.__setitem__(s, x), lambda: None)
    assert res.steps_done == 4
    assert any(e["event"] == "recovery.restore"
               for e in res.telemetry_ring)
    telemetry.disable()
    res2 = run_with_recovery(
        lambda s, x: x + 1, 0, 2,
        FaultConfig(checkpoint_every=2, backoff_base_s=0.0),
        lambda s, x: None, lambda: None)
    assert res2.telemetry_ring == []


def test_fatal_fault_flushes_the_ring_to_disk(tmp_path, monkeypatch):
    from repro_torch.runtime.fault_tolerance import (FatalFault, FaultConfig,
                                                     run_with_recovery)
    flush_to = str(tmp_path / "postmortem.jsonl")
    monkeypatch.setattr(core, "_ring_flush_path", None)
    monkeypatch.setenv(telemetry.TELEMETRY_ENV, f"ring:{flush_to}")
    telemetry.enable_from_env()

    def dying_step(step, state):
        telemetry.record("train.step", step=step)
        if step == 2:
            raise FatalFault("chip gone for good")
        return state + 1

    with pytest.raises(FatalFault):
        run_with_recovery(
            dying_step, 0, 6,
            FaultConfig(checkpoint_every=2, backoff_base_s=0.0),
            lambda s, x: None, lambda: None)
    events = telemetry.read_jsonl(flush_to)
    assert any(e["event"] == "train.step" and e["step"] == 2
               for e in events)
    assert any(e["event"] == "recovery.fault" and e["fatal"]
               for e in events)


def test_donation_hazard_is_recorded_at_startup():
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     declare_donation,
                                                     run_with_recovery)
    step = declare_donation(lambda s, x: x + 1, (1,))
    with telemetry.capture() as buf:
        run_with_recovery(step, 0, 1, FaultConfig(backoff_base_s=0.0),
                          lambda s, x: None, lambda: None)
    (ev,) = [e for e in buf.events
             if e["event"] == "recovery.donation_hazard"]
    assert ev["donate_argnums"] == (1,)


def test_trainer_cli_captures_steps(tmp_path, monkeypatch, capsys):
    """``--telemetry PATH`` on the trainer: one ``train.step`` span per
    step, then the report renders the capture; ``REPRO_TELEMETRY=ring``
    enables the stream from the environment."""
    from repro_torch.launch import train as ttrain
    from repro_torch.telemetry import report
    path = str(tmp_path / "train.jsonl")
    ttrain.main(["--arch", "gemma_2b", "--steps", "3", "--seq-len", "8",
                 "--global-batch", "2", "--device", "cpu", "--telemetry",
                 path, "--profile-annotations"])
    assert not telemetry.enabled()               # closed at the end
    steps = [e for e in telemetry.read_jsonl(path)
             if e["event"] == "train.step"]
    assert [e["step"] for e in steps] == [0, 1, 2]
    assert all(e["arch"] == "gemma_2b" and e["wall_s"] > 0 for e in steps)
    capsys.readouterr()
    assert report.main([path]) == 0
    assert "train.step" in capsys.readouterr().out
    monkeypatch.setattr(core, "_ring_flush_path", None)
    monkeypatch.setattr(core, "_atexit_registered", True)
    monkeypatch.setenv(telemetry.TELEMETRY_ENV, "ring")
    seen = []
    monkeypatch.setattr(telemetry, "disable",
                        lambda: seen.append(telemetry.ring_events()) or
                        core.disable())
    ttrain.main(["--arch", "gemma_2b", "--steps", "2", "--seq-len", "8",
                 "--global-batch", "2", "--device", "cpu"])
    assert [e["step"] for e in seen[0] if e["event"] == "train.step"] \
        == [0, 1]


# ---------------------------------------------------------------------------
# Both packages, the same traffic
# ---------------------------------------------------------------------------

DECISION = ("event", "tier", "backend", "op", "n", "m", "distinct_slots",
            "strategy", "need_fetched")


def _specs():
    jspec = jperf.cpu_default_spec()
    return jspec, convert.spec_from_reference(jperf.spec_to_dict(jspec))


def _batches(seed=0):
    """(op kind, slots, values, expected or None) numpy batches: spread and
    contended FAA, MIN, SWP, uniform and per-op CAS, at several sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (4, 64, 512, 4096):
        spread = rng.integers(0, 1024, n).astype(np.int32)
        hot = rng.integers(0, 8, n).astype(np.int32)
        vals = rng.integers(-50, 50, n).astype(np.int32)
        out += [("faa", spread, vals, None), ("faa", hot, vals, None),
                ("min", spread, vals, None), ("swp", hot, vals, None),
                ("cas", hot, vals, np.int32(0)),
                ("cas", hot, vals, rng.integers(0, 2, n).astype(np.int32))]
    return out


def _op(mod, kind, idx, vals, exp, arr):
    if kind == "cas":
        return mod.Cas(arr(idx), arr(vals), expected=arr(exp))
    return mod.OP_KINDS[kind](arr(idx), arr(vals))


def test_same_traffic_same_decision_events():
    """Every batch through both packages' `execute` under ``capture()``:
    the same event names and decision fields, and ``predicted_s`` within
    1e-12 relative under one spec."""
    jspec, tspec = _specs()
    jt = jatomics.AtomicTable(jnp.zeros((1024,), jnp.int32))
    tt = atomics.AtomicTable(torch.zeros((1024,), dtype=torch.int32))
    with jtelemetry.capture() as jbuf:
        for b in _batches():
            jatomics.execute(jt, _op(jatomics, *b, jnp.asarray), spec=jspec)
    with telemetry.capture() as tbuf:
        for b in _batches():
            atomics.execute(tt, _op(atomics, *b, torch.as_tensor),
                            spec=tspec)
    assert len(jbuf.events) == len(tbuf.events) == len(_batches())
    for je, te in zip(jbuf.events, tbuf.events):
        assert {k: te.get(k) for k in DECISION} == \
            {k: je.get(k) for k in DECISION}
        assert te["traced"] is False
        assert te["predicted_s"] == pytest.approx(je["predicted_s"],
                                                  rel=1e-12)


def test_same_events_same_drift_fit_and_report():
    """One recorded event list (the reference's decisions, each with a
    measured time) through both packages' `aggregate`, `fit_spec_update`
    and report: equal rows, proposal and text."""
    jspec, tspec = _specs()
    jt = jatomics.AtomicTable(jnp.zeros((1024,), jnp.int32))
    with jtelemetry.capture() as jbuf:
        for _ in range(3):
            for b in _batches():
                jatomics.execute(jt, _op(jatomics, *b, jnp.asarray),
                                 spec=jspec)
    rng = np.random.default_rng(9)
    events = [dict(e, measured_s=float(e["predicted_s"]
                                       * rng.uniform(0.5, 4.0)))
              for e in jbuf.events]
    events += [_ev("migration", "device_put", "-", 4096, 1e-3, 2e-3)] * 3
    js, ts = jdrift.aggregate(events), drift.aggregate(events)
    assert drift.summarize(ts) == jdrift.summarize(js)
    jfit = jdrift.fit_spec_update(js, jspec)
    tfit = drift.fit_spec_update(ts, tspec)
    assert tfit["fields"] == jfit["fields"] and tfit["fields"]
    assert tfit["skipped"] == jfit["skipped"]
    jrep = jreport.build_report(events, spec=jspec)
    trep = build_report(events, spec=tspec)
    assert trep == jrep
    assert render_text(trep) == jreport.render_text(jrep)


def test_same_retry_rounds_and_done_histograms():
    """A contended CAS loop (12 ops over 3 slots, the shrink policy) and
    an FAA batch through both packages' `execute_until`: the same round
    and done events, up to the clocks."""
    jspec, tspec = _specs()
    idx = np.array([0, 1, 2] * 4, np.int32)

    def loop(mod, arr, table):
        def make_ops(slots, observed):
            if slots is None:
                return mod.Cas(arr(idx), arr(np.ones(12, np.int32)),
                               expected=arr(np.zeros(12, np.int32)))
            return observed + 1
        return mod.retry.execute_until(table, make_ops, max_rounds=12,
                                       policy="shrink",
                                       spec=jspec if mod is jatomics
                                       else tspec)

    keep = ("event", "op", "policy", "round", "pending", "issued",
            "resolved", "tier", "n_exec", "m", "strategy", "backend",
            "distinct_observed", "n", "n_rounds", "unresolved", "attempts",
            "round_histogram")
    with jtelemetry.capture() as jbuf:
        loop(jatomics, jnp.asarray,
             jatomics.AtomicTable(jnp.zeros((8,), jnp.int32)))
    with telemetry.capture() as tbuf:
        loop(atomics, torch.as_tensor,
             atomics.AtomicTable(torch.zeros((8,), dtype=torch.int32)))
    pick = lambda evs: [{k: e.get(k) for k in keep} for e in evs
                        if e["event"].startswith("atomics.retry")]
    assert pick(tbuf.events) == pick(jbuf.events)
    assert pick(tbuf.events)[-1]["event"] == "atomics.retry.done"


def test_same_chaos_fire_sequence():
    """One `FaultPlan` spec driven through both packages' recovery loops:
    the same ``chaos.fire`` and ``recovery.*`` events in the same order."""
    from repro.runtime.chaos import FaultPlan as JPlan
    from repro.runtime.fault_tolerance import FaultConfig as JConfig
    from repro.runtime.fault_tolerance import run_with_recovery as jrun
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                     run_with_recovery)
    spec = "seed=11,step=0.3,ckpt_save=0.5@1,straggler_delay=0.2"
    keep = ("event", "site", "occurrence", "step", "kind", "attempt",
            "fatal", "scratch")

    def drive(plan_cls, cfg_cls, run, tel):
        store = {}
        with tel.capture() as buf:
            run(lambda s, x: x + 1, 0, 12,
                cfg_cls(checkpoint_every=3, max_failures=20,
                        backoff_base_s=0.0),
                lambda s, x: store.__setitem__(s, x),
                lambda: max(store.items()) if store else None,
                chaos=plan_cls.from_spec(spec, sleep_fn=lambda d: None),
                sleep_fn=lambda d: None)
        return [{k: e.get(k) for k in keep} for e in buf.events]

    want = drive(JPlan, JConfig, jrun, jtelemetry)
    got = drive(FaultPlan, FaultConfig, run_with_recovery, telemetry)
    assert got == want
    assert sum(e["event"] == "chaos.fire" for e in got) >= 3


# ---------------------------------------------------------------------------
# The telemetry_drift suite
# ---------------------------------------------------------------------------

def test_telemetry_drift_suite_on_the_cpu(tmp_path, monkeypatch):
    """`python -m repro_torch.benchmarks.run --only telemetry_drift` at
    its fast sizes: every tier drifts, every local event under sync is
    measured and names its backend, the proposal comes out, and the JSON
    lands under ``--out``; the gate passes an overhead under 5% and
    fails the suite at 5% or more.  The overhead is a given number here:
    on a shared CPU the measured one swings past the gate under load, and
    `overhead` itself is held by the next test."""
    from repro_torch.benchmarks import run as trun
    from repro_torch.benchmarks import telemetry_drift as T
    seen = {}
    for name in ("local_capture", "sharded_capture"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, real=real, name=name:
                            seen.setdefault(name, real(*a)))
    given = {"gate_n": T.GATE_N, "overhead": 0.01, "enabled_us": 101.0,
             "disabled_us": 100.0, "overhead_of_minima": 0.01}
    monkeypatch.setattr(T, "overhead", lambda device, fast: dict(given))
    csv, results, failures = trun.run_suites(
        ["telemetry_drift"], fast=True, device="cpu", out_dir=str(tmp_path))
    assert not failures, failures
    out = results["telemetry_drift"]
    assert out["tiers_covered"] == ["local", "migration", "sharded"]
    assert out["local_all_measured"]
    assert out["local_backends"] == ["onehot", "serialized", "sort"]
    assert {"loop_step_s", "sort_elem_pass_s", "gather_elem_s",
            "collective_launch_s", "host_roundtrip_Bps"} <= \
        set(out["spec_update"])
    assert out["overhead"]["gate"] == 0.05
    assert out["acceptance_overhead_lt_gate_and_all_tiers"]
    saved = json.loads((tmp_path / "telemetry_drift.json").read_text())
    assert saved["n_events"] == out["n_events"] > 0
    assert any(r["name"] == "telemetry.overhead" for r in csv.rows)
    given["overhead"] = 0.05
    with pytest.raises(AssertionError, match="acceptance failed"):
        T.run(trun.Csv(), fast=True, device="cpu")


def test_overhead_sweep_measures_the_stream():
    """`overhead` on the CPU: every size of the sweep, the gate's row at
    n = 4096, finite times; and `_timed_pair` reads a call that sleeps
    5 ms with the stream on and 1 ms off as a large positive overhead
    (400% asleep as asked; a loaded host oversleeps either side), where a
    swapped attribution would read -80%."""
    import math
    from repro_torch.benchmarks import telemetry_drift as T
    out = T.overhead("cpu", fast=True)
    assert set(out["eager_sweep"]) == {"4", "512", str(T.GATE_N)}
    assert out["gate_n"] == T.GATE_N
    for row in out["eager_sweep"].values():
        assert row["disabled_us"] > 0 and row["enabled_us"] > 0
        assert math.isfinite(row["overhead"])
    assert not telemetry.enabled()
    pair = T._timed_pair(lambda: time.sleep(0.005 if telemetry.enabled()
                                            else 0.001),
                         batch=3, n_batches=4)
    assert 0.3 < pair["overhead"] < 10.0, pair
    assert not telemetry.enabled()
