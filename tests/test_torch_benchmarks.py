"""Port parity: the cost layer and the measurement suites on the CPU.

`repro_torch.core.contention` and `core.validation` give the reference's
floats (to 1e-12 relative); the engine's spec epoch and calibrated-spec
loader round-trip a file; `benchmarks.model_validation` gives the
reference's NRMSE and Table 2/3 rows on the same measurements;
`repro_torch.benchmarks.run --device cpu --fast` runs the paper's suites
and prints every row the reference prints; the plain chase ends where a
numpy walk of its cycle ends.  The kernels' own checks are in
`tests/test_torch_gpu.py`.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import contention as jcon
from repro.core import perf_model as jpm
from repro.core import validation as jval
from repro_torch.benchmarks import calibrate as tcal
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import latency as tlat
from repro_torch.benchmarks import model_validation as tmv
from repro_torch.benchmarks import run as trun
from repro_torch.core import contention as tcon
from repro_torch.core import perf_model as tpm
from repro_torch.core import rmw as trmw
from repro_torch.core import rmw_engine as teng
from repro_torch.core import validation as tval
from repro_torch.kernels.serial import kernel as XK

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:             # the reference's `benchmarks`
    sys.path.insert(0, str(ROOT))

SPECS = [("tpu", jpm.TPU_V5E, tpm.TPU_V5E),
         ("cpu", jpm.cpu_default_spec(), tpm.cpu_default_spec())]
WRITERS = (1, 2, 3, 8, 61, 256)


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0.0)


# ---------------------------------------------------------------------------
# core.contention and core.validation against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s[0])
@pytest.mark.parametrize("op", ["faa", "cas", "swp"])
def test_contention_matches_reference(spec, op):
    _, js, ts = spec
    for w in WRITERS:
        for nbytes in (4, 8, 16):
            _close(tcon.contended_bandwidth_serialized(ts, op, w,
                                                       operand_bytes=nbytes),
                   jcon.contended_bandwidth_serialized(js, op, w,
                                                       operand_bytes=nbytes))
            _close(tcon.contended_bandwidth_combining(
                ts, op, w, operand_bytes=nbytes, batch_per_writer=64),
                jcon.contended_bandwidth_combining(
                js, op, w, operand_bytes=nbytes, batch_per_writer=64))
        for pods in (1, 2, 5):
            _close(tcon.contended_bandwidth_hierarchical(ts, op, pods, w),
                   jcon.contended_bandwidth_hierarchical(js, op, pods, w))
        assert tcon.hierarchical_crossover_pods(ts, op, w, max_pods=16) \
            == jcon.hierarchical_crossover_pods(js, op, w, max_pods=16)
        for budget in (None, 1e-6, 1e-3):
            _close(tcon.hot_expert_capacity(ts, 4096, 64, 2, w,
                                            step_budget_s=budget),
                   jcon.hot_expert_capacity(js, 4096, 64, 2, w,
                                            step_budget_s=budget))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validation_matches_reference(seed):
    rng = np.random.default_rng(seed)
    obs = list(rng.uniform(1e-9, 1e-6, 12))
    pred = [o * rng.uniform(0.7, 1.3) for o in obs]
    _close(tval.nrmse(pred, obs), jval.nrmse(pred, obs))
    rows_t = [tval.ValidationRow(f"c{i}", p, o)
              for i, (p, o) in enumerate(zip(pred, obs))]
    rows_j = [jval.ValidationRow(f"c{i}", p, o)
              for i, (p, o) in enumerate(zip(pred, obs))]
    for rt, rj in zip(rows_t, rows_j):
        _close(rt.rel_err, rj.rel_err)
    got, want = tval.validate(rows_t), jval.validate(rows_j)
    _close(got.pop("nrmse"), want.pop("nrmse"))
    assert got == want
    assert tval.NRMSE_GATE == jval.NRMSE_GATE
    with pytest.raises(ValueError):
        tval.nrmse([1.0], [])


# ---------------------------------------------------------------------------
# the engine's spec epoch and calibrated spec
# ---------------------------------------------------------------------------

@pytest.fixture
def spec_file(tmp_path, monkeypatch):
    path = tmp_path / "calibrated_spec.json"
    monkeypatch.setenv("REPRO_TORCH_CALIBRATED_SPEC", str(path))
    teng._reset_spec_cache()
    yield path
    teng._reset_spec_cache()


def test_spec_epoch_bumps_on_install_and_clear():
    e0 = teng.spec_epoch()
    tuned = dataclasses.replace(tpm.H100, name="tuned")
    try:
        assert teng.set_live_spec(tuned) == e0 + 1 == teng.spec_epoch()
        assert teng.default_spec("cpu") is tuned
        assert teng.calibrated_spec("cpu").name == "cpu_host"
    finally:
        teng.clear_live_spec()
    assert teng.spec_epoch() == e0 + 2
    teng.clear_live_spec()                # nothing installed: no bump
    assert teng.spec_epoch() == e0 + 2


def test_calibrated_spec_loads_a_cpu_file(spec_file):
    assert teng.calibrated_spec_path() == str(spec_file)
    assert teng.calibrated_spec("cpu").gather_elem_s \
        == tpm.cpu_default_spec().gather_elem_s     # no file yet
    teng._reset_spec_cache()
    fitted = dataclasses.replace(tpm.cpu_default_spec(), gather_elem_s=7e-9,
                                 tier_latency_s={tpm.Tier.VMEM: 3e-9})
    spec_file.write_text(json.dumps({"device": "cpu",
                                     "spec": tpm.spec_to_dict(fitted)}))
    got = teng.calibrated_spec("cpu")
    assert got.gather_elem_s == 7e-9
    assert got.tier_latency_s[tpm.Tier.VMEM] == 3e-9
    assert got.tier_latency_s[tpm.Tier.HOST] \
        == tpm.cpu_default_spec().tier_latency_s[tpm.Tier.HOST]
    assert teng.default_spec("cpu") is got
    # the card keeps its priors whatever the file says
    assert teng.calibrated_spec("cuda") is tpm.H100
    assert teng.default_spec("cuda") is tpm.H100


@pytest.mark.parametrize("payload", [
    {"device": "cuda:NVIDIA H100 80GB HBM3", "spec": {"gather_elem_s": 7e-9}},
    {"spec": {"gather_elem_s": 7e-9}},
    "not json {",
])
def test_calibrated_spec_ignores_other_files(spec_file, payload):
    spec_file.write_text(payload if isinstance(payload, str)
                         else json.dumps(payload))
    assert teng.calibrated_spec("cpu").gather_elem_s \
        == tpm.cpu_default_spec().gather_elem_s
    assert teng.load_calibration(str(spec_file), "cpu",
                                 tpm.cpu_default_spec()) is None


def test_device_key():
    assert teng.device_key("cpu") == "cpu"
    assert teng.device_key(torch.device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# model_validation and calibrate
# ---------------------------------------------------------------------------

#: one latency suite's rows (ns), under the reference's tier names (the
#: first three: L1, L2, LLC) and the port's (L1, L2, HBM), which map to the
#: same model tiers (VREG, VMEM, HBM_LOCAL)
MEASURED = [{"read": 33.4, "faa": 206.2, "swp": 204.0, "cas": 206.5},
            {"read": 146.8, "faa": 203.0, "swp": 201.6, "cas": 204.2},
            {"read": 351.1, "faa": 353.4, "swp": 361.2, "cas": 354.6}]


def _rows(csv, prefix):
    return {r["name"]: r["us_per_call"] for r in csv.rows
            if r["name"].startswith(prefix)}


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_model_validation_matches_reference(scale):
    from benchmarks import common as jcommon
    from benchmarks import model_validation as jmv
    rows = [{k: v * scale for k, v in r.items()} for r in MEASURED]
    jcsv, tcsv = jcommon.Csv(), tcommon.Csv()
    want = jmv.run(jcsv, dict(zip(("L1", "L2", "LLC"), rows)))
    got = tmv.run(tcsv, dict(zip(("L1", "L2", "HBM"), rows)), device="cpu")
    _close(got["nrmse"], want["nrmse"])
    assert got["passes"] == want["passes"]
    assert [f.replace("HBM", "LLC") for f in got["flagged"]] \
        == want["flagged"]
    jr, tr = _rows(jcsv, "model_validation."), _rows(tcsv,
                                                     "model_validation.")
    assert sorted(jr) == sorted(tr)
    assert any(k.startswith("model_validation.O.") for k in tr)
    for k in jr:
        _close(tr[k], jr[k])


def test_calibrate_writes_and_reloads(spec_file):
    csv = tcommon.Csv()
    measured = dict(zip(("L1", "L2", "HBM"), MEASURED))
    out = tcal.run(csv, fast=True, device="cpu", measured=measured)
    payload = json.loads(spec_file.read_text())
    assert payload["device"] == "cpu"
    assert set(payload["fitted_engine_constants"]) \
        == set(tcal.ENGINE_CONSTANTS)
    assert set(payload["kept_priors"]) <= set(tcal.ENGINE_CONSTANTS)
    spec = out["spec"]
    # every selection the shoot-out's cells make stays as the priors make
    # it (on the CPU: onehot in every fetched FAA cell)
    assert tcal.selections(spec, True, "cpu") == tcal.selections(
        tpm.calibrate(tpm.cpu_default_spec(), *tmv.samples(measured)),
        True, "cpu")
    assert all(v == "onehot" for k, v in tcal.selections(
        spec, True, "cpu").items() if k[0] == "faa" and k[3])
    teng._reset_spec_cache()
    loaded = teng.calibrated_spec("cpu")
    assert tpm.spec_to_dict(loaded) == tpm.spec_to_dict(spec)
    assert loaded.tier_latency_s[tpm.Tier.VMEM] == MEASURED[1]["read"] * 1e-9


# ---------------------------------------------------------------------------
# the run module on the CPU
# ---------------------------------------------------------------------------

def _reference_row_names(scale):
    """Every row the reference's suites print, with its tier names mapped
    by role to the port's (its DRAM tier has no counterpart on the card)."""
    from benchmarks import contention as jcb
    from benchmarks import latency as jlb
    tier = {"L1": "L1", "L2": "L2", "LLC": "HBM"}
    names = {f"latency.{op}.{tier[t]}" for t in jlb.TABLE_SIZES if t in tier
             for op in ("read", "faa", "swp", "cas")}
    names |= {f"bandwidth.{op}.{mode}" for op in ("faa", "swp")
              for mode in ("serialized", "combining")}
    names |= {"bandwidth.write", "bandwidth.faa.kernel"}
    names |= {f"contention.faa.w{w}" for w in jcb.WRITERS}
    names |= {"contention.faa.serialized_hot"}
    names |= {f"operand_size.cas.{k}" for k in
              ("int32", "float32", "int64_pair", "int128_quad")}
    names |= {"operands_fetched.cas1", "operands_fetched.cas2",
              "model_validation.nrmse"}
    names |= {f"bfs.{op}.scale{scale}" for op in ("cas", "swp", "faa")}
    names |= {f"model_validation.R.{t}" for t in
              ("vreg", "vmem", "hbm_local", "host")}
    names |= {f"model_validation.E.{op}" for op in ("cas", "faa", "swp")}
    names |= {f"model_validation.O.{op}.{t}" for op in ("cas", "faa", "swp")
              for t in ("vreg", "vmem", "hbm_local")}
    return names


def test_run_cpu_fast_prints_the_reference_rows(capsys):
    suites = ("latency,bandwidth,contention,operand_size,operands_fetched,"
              "bfs,model_validation")
    assert trun.main(["--device", "cpu", "--fast", "--only", suites]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln.split(",", 2) for ln in lines[1:]]
    assert all(r[1] != "FAILED" and math.isfinite(float(r[1]))
               for r in rows), rows
    missing = _reference_row_names(10) - {r[0] for r in rows}
    assert not missing, sorted(missing)


def test_run_reports_a_failing_suite(monkeypatch, capsys):
    def boom(csv, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(trun.operands_fetched, "run", boom)
    assert trun.main(["--device", "cpu", "--only", "operands_fetched"]) == 1
    assert "operands_fetched,FAILED,RuntimeError('boom')" \
        in capsys.readouterr().out
    with pytest.raises(ValueError):
        trun.run_suites(["no_such_suite"], device="cpu")


def test_rmw_backends_cpu_writes_its_json(tmp_path, monkeypatch):
    from repro_torch.benchmarks import rmw_backends as trb
    monkeypatch.setattr(trb, "GRID_N_FAST", (256,))
    monkeypatch.setattr(trb, "GRID_M_FAST", (64,))
    csv, results, failures = trun.run_suites(
        ["rmw_backends"], fast=True, device="cpu", out_dir=str(tmp_path))
    assert not failures
    out = results["rmw_backends"]
    out_path = tmp_path / "rmw_backends.json"
    assert json.loads(out_path.read_text())["host"]["device"] == "cpu"
    assert {r["backend"] for r in out["rows"]} == {"sort", "onehot",
                                                   "serialized"}
    assert csv.rows[-1]["name"] == "rmw_backends.acceptance"


# ---------------------------------------------------------------------------
# the one-thread loops' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(XK.CHASE_MODES))
@pytest.mark.parametrize("m", [2, 64, 4096])
def test_plain_chase_ends_where_a_numpy_walk_ends(mode, m):
    table = XK.single_cycle(m, torch.Generator().manual_seed(m), "cpu")
    succ = table.words.numpy().copy()
    steps, start = 3 * m + 5, m // 3
    end = XK.chase(table, steps, mode, start)
    p, visits = start, np.zeros(m, np.int64)
    for _ in range(steps):
        visits[p] += 1
        p = int(succ[p])
    assert int(end) == p
    if mode == "faa":                       # the high bits count the visits
        want = (succ.astype(np.int64) + m * visits) & 0xFFFFFFFF
        np.testing.assert_array_equal(
            table.words.numpy().view(np.uint32), want.astype(np.uint32))
    else:                                   # the cycle is unchanged
        np.testing.assert_array_equal(table.words.numpy(), succ)
    seen, q = set(), 0                      # one cycle through every slot
    for _ in range(m):
        seen.add(q)
        q = int(succ[q])
    assert len(seen) == m and q == 0


def test_chase_refuses_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        XK.single_cycle(48, g, "cpu")
    table = XK.single_cycle(64, g, "cpu")
    with pytest.raises(ValueError):
        XK.chase(table, 10, "xor")
    with pytest.raises(ValueError):
        XK.chase(table, 10, "read", start=64)
    with pytest.raises(TypeError):
        XK.chase(table._replace(words=table.words.long()), 10)


def test_latency_cpu_rows_and_tiers():
    csv = tcommon.Csv()
    out = tlat.run(csv, device="cpu", fast=True)
    assert set(out) == set(tmv.TIER_MAP) == set(tlat.TABLE_SIZES)
    assert all(v > 0 for tier in out.values() for v in tier.values())
    assert tlat.steps_for("cuda") == tlat.MAX_STEPS


@pytest.mark.parametrize("op", list(XK.OP_CODES))
def test_serial_rmw_on_the_cpu_is_the_host_loop(op):
    rng = np.random.default_rng(5)
    m, n = 37, 300
    tab = torch.from_numpy(rng.integers(-8, 9, m).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-m - 3, m + 3, n).astype(np.int32))
    val = torch.from_numpy(rng.integers(-8, 9, n).astype(np.int32))
    exp = torch.from_numpy(rng.integers(-2, 3, n).astype(np.int32)) \
        if op == "cas" else None
    got = XK.serial_rmw(tab, idx, val, op, exp)
    for a, b in zip(got, trmw.rmw_serialized_host(tab, idx, val, op, exp)):
        assert torch.equal(a, b)
    for a, b in zip(got, trmw.rmw_serialized(tab, idx, val, op, exp)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        XK.serial_rmw(tab, idx, val, "xor")


# ---------------------------------------------------------------------------
# the sharded tier's suite
# ---------------------------------------------------------------------------

def _reference_sharded_grid(fast):
    """The reference's cells, from its own script: the grid section run
    with a recording `bench`."""
    from benchmarks import rmw_sharded as jrs
    script = jrs.SCRIPT % {"fast": fast}
    body = script[script.index("GRID_N = "):script.index('print("RESULT:')]
    cells = []
    exec(body, {"FAST": fast, "bench": lambda *a: cells.append(a)})
    return cells


@pytest.mark.parametrize("fast", [True, False])
def test_rmw_sharded_grid_is_the_references(fast):
    from repro_torch.benchmarks import rmw_sharded as trs
    assert trs.grid(fast) == _reference_sharded_grid(fast)


def test_rmw_sharded_cpu_fast_rows_and_acceptance(tmp_path, monkeypatch):
    """The suite on 8 CPU ranks in fast mode: every cell of the reference's
    fast grid once, in its order, finite; then the reference's own `run`,
    fed these rows in place of its subprocess's, must print the same CSV
    rows and compute the same speedups and acceptance row."""
    import subprocess
    import types

    from benchmarks import rmw_sharded as jrs
    from benchmarks.common import Csv as JCsv
    csv, results, failures = trun.run_suites(
        ["rmw_sharded"], fast=True, device="cpu", out_dir=str(tmp_path))
    assert not failures
    out = results["rmw_sharded"]
    rows = out["rows"]
    assert [(r["op"], r["strategy"], r["n_per_device"], r["m"], r["dist"],
             r["suite"] == "fetched") for r in rows] == \
        _reference_sharded_grid(True)
    assert all(math.isfinite(r["us_per_call"]) and r["us_per_call"] > 0
               for r in rows)
    assert json.loads((tmp_path / "rmw_sharded.json").read_text())[
        "host"]["ranks"] == 8
    fake = types.SimpleNamespace(returncode=0, stderr="",
                                 stdout="RESULT:" + json.dumps(rows))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: fake)
    jcsv = JCsv()
    want = jrs.run(jcsv, fast=True, out_path=str(tmp_path / "ref.json"))
    assert out["hierarchical_speedup_over_naive"] == \
        want["hierarchical_speedup_over_naive"]
    assert out["acceptance_hierarchical_beats_naive_on_hot"] == \
        want["acceptance_hierarchical_beats_naive_on_hot"]
    assert [(r["name"], r["us_per_call"], r["derived"]) for r in csv.rows[
        :-1]] == [(r["name"], r["us_per_call"], r["derived"])
                  for r in jcsv.rows[:-1]]
    assert csv.rows[-1]["derived"].split(" json=")[0] == \
        jcsv.rows[-1]["derived"].split(" json=")[0]
