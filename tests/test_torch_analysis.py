"""repro_torch.analysis: the atomics contract linter over a recorded eager run.

One bad and one good twin per rule (A001-A005), ported from
`tests/test_analysis.py`, each run on the CPU and held to the rule ids it
must give, for inputs from two seeds (`tests/_torch_analysis_twins.py`);
the same twins through the reference's `repro.analysis` in one
subprocess (`tests/_torch_analysis_worker.py`), so its trace caches
never reach the process that runs
`tests/test_analysis.py`; the nine registered entries; suppression;
telemetry; the CLI; the fixture; and that a check changes nothing.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import analysis, atomics, telemetry
from repro_torch.analysis import lint
from repro_torch.analysis.entries import ENTRY_POINTS
from repro_torch.analysis.findings import (ERROR, RULES, WARNING,
                                           _line_suppresses)
from repro_torch.analysis.pytest_plugin import torch_atomics_lint  # noqa: F401
from repro_torch.atomics import contracts

sys.path.insert(0, os.path.dirname(__file__))
import _torch_analysis_twins as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
I32 = torch.int32
spec = analysis.spec

#: the reference's entries that pass on this host, compared finding for
#: finding with the port's
LIVE_ENTRIES = ("train.step", "train.recovery", "serve.prefill",
                "serve.decode", "tuning.train_step", "tuning.serve_decode")
#: ... and those it fails here: the reference looks a scatter's frames up
#: with `source_info_util.user_frames(source_info)`, which jax 0.9.0 takes
#: a traceback for (an AttributeError it catches), so it sees no frame of a
#: sanctioned module and flags the engine's own scatters (ROADMAP queue 3)
NOT_LIVE_ENTRIES = ("bfs.local", "moe.local", "examples.sharded_atomics")
#: twins the reference cannot decide on this host, and why
NOT_LIVE_TWINS = {
    "a004_read_after": "jax 0.9.0 names the call primitive `jit`; the "
                       "reference's A004 reads `pjit` equations only",
}


def _rules(findings):
    return sorted(f.rule for f in findings)


@pytest.fixture(autouse=True)
def _stream_off():
    telemetry.disable()
    yield
    telemetry.disable()


@pytest.fixture(scope="module")
def parity():
    """The worker's JSON: every twin through both packages, and every
    entry's unsuppressed findings in both."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests/_torch_analysis_worker.py"), "0",
         ",".join(LIVE_ENTRIES + NOT_LIVE_ENTRIES)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(W.PORT_TWINS))
def test_twin_fires_its_rule_or_stays_quiet(name):
    want = W.PORT_TWINS[name][3]
    fs = W.run_port_twin(name, seed=0)
    assert _rules(fs) == want, [f.format() for f in fs]
    for f in fs:
        assert f.severity == RULES[f.rule][0]
        assert f.file is not None and f.line


@pytest.mark.parametrize("name", sorted(W.PORT_TWINS))
def test_twin_findings_same_for_two_seeds(name):
    def key(fs):
        return sorted((f.rule, f.file, f.line, f.message) for f in fs)

    assert key(W.run_port_twin(name, 1)) == key(W.run_port_twin(name, 2))


@pytest.mark.parametrize("name", sorted(W.PORT_TWINS))
def test_twin_matches_reference(parity, name):
    row = parity["twins"][name]
    assert row["port"] == W.PORT_TWINS[name][3]
    if name in NOT_LIVE_TWINS:
        # the reference gives nothing here (reason in NOT_LIVE_TWINS)
        assert row["ref"] == [], NOT_LIVE_TWINS[name]
        return
    # the reference's location-less A001s (NOT_LIVE_ENTRIES says why) are
    # set apart on twins whose only writes are `execute`'s: the engine's
    assert bool(row["ref_unlocated_a001"]) == (name in W.EXECUTE_ONLY
                                               and name != "a005_outside")
    assert row["ref"] == row["port"]


def test_twin_messages_name_the_remedy():
    def first(name):
        return W.run_port_twin(name, 0)[0]

    assert "atomics.execute" in first("a001_table").message
    a002 = first("a002_faa")
    assert a002.severity == WARNING and "Faa" in a002.message
    assert "inf" in a002.message and "2" in a002.message
    assert "Max" in first("a002_max").message
    assert "execute_until" in first("a003_unbounded").message
    assert "factory" in first("a004_recovery_captured").message
    assert "reverse_ranks" in first("a005_reverse_no_fetch").message
    a005 = first("a005_outside")
    assert a005.severity == ERROR and "mesh" in a005.message


def test_a001_quiet_in_backward_and_on_a_copy_into_a_slice():
    """Autograd's backward of a gather accumulates by index (no user
    frame, not checked); a ``copy_`` into a slice of a table carries its
    lineage and finds nothing, as the KV cache's writes do."""
    def fn(w, idx, t):
        for _ in range(2):
            w.grad = None
            (w[idx.long()] * 2).sum().backward()
        tbl = atomics.AtomicTable(t)
        tbl.data[2:4] = torch.ones(2, dtype=I32)
        return w.grad, tbl.data

    w = torch.ones(4, requires_grad=True)
    assert analysis.check(fn, w, torch.tensor([0, 0, 1, 1], dtype=I32),
                          torch.zeros(8, dtype=I32), device="cpu") == []


def test_a001_fires_on_a_second_commutative_write_and_a_view_of_a_table():
    def twice(buf, idx, v):
        out = buf.clone()
        out.index_add_(0, idx.long(), v)
        out.index_add_(0, idx.long(), v)
        return out

    def view_write(t, idx, v):
        tbl = atomics.AtomicTable(t)
        tbl.data.view(2, 4)[0].scatter_add_(0, idx.long(), v)
        return tbl.data

    i = torch.tensor([0, 1, 1, 3], dtype=I32)
    v = torch.ones(4, dtype=I32)
    fs = analysis.check(twice, spec((8,), I32), i, v, device="cpu")
    assert _rules(fs) == ["A001"] and "multiple" in fs[0].message
    fs = analysis.check(view_write, spec((8,), I32), i, v, device="cpu")
    assert _rules(fs) == ["A001"] and "AtomicTable" in fs[0].message


def test_a003_for_loops_and_execute_until_are_bounded():
    def for_loop(t, i, v):
        for _ in range(3):
            t = W._p_cas_once(t, i, v)[0]
        return t

    def until(t, i, v):
        def make_ops(slots, observed):
            if slots is None:
                return atomics.Cas(i, v, expected=0)
            return observed + 1
        return atomics.execute_until(atomics.AtomicTable(t), make_ops,
                                     max_rounds=4).table.data

    args = (torch.zeros(8, dtype=I32), torch.tensor([1, 2, 3, 4], dtype=I32),
            torch.ones(4, dtype=I32))
    assert analysis.check(for_loop, *args, device="cpu") == []
    assert "A003" not in _rules(analysis.check(until, *args, device="cpu"))


# ---------------------------------------------------------------------------
# suppression mechanics
# ---------------------------------------------------------------------------

def test_line_suppression_parser():
    assert _line_suppresses("x = 1  # atomics-lint: disable=A001", "A001")
    assert _line_suppresses("# atomics-lint: disable=A001,A003", "A003")
    assert _line_suppresses("# atomics-lint: disable=all", "A005")
    assert not _line_suppresses("# atomics-lint: disable=A001", "A002")
    assert not _line_suppresses("# just a comment", "A001")


def test_suppressed_findings_stay_visible_but_do_not_gate(tmp_path):
    mod = tmp_path / "bad_mod_torch.py"
    mod.write_text(
        "def racy(buf, idx, v):\n"
        "    out = buf.clone()\n"
        "    # atomics-lint: disable=A001\n"
        "    out[idx.long()] = v\n"
        "    return out\n")
    import importlib.util
    sp = importlib.util.spec_from_file_location("bad_mod_torch", mod)
    m = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(m)
    fs = analysis.check(m.racy, spec((8,)), torch.tensor([1, 1, 2, 3]),
                        torch.ones(4), device="cpu")
    assert _rules(fs) == ["A001"] and fs[0].suppressed
    assert all(f.suppressed for f in fs if f.severity == ERROR)


def test_port_suppressions_carry_a_reason():
    """Every suppression in the port says why, in the lines above it; the
    two in the MoE dispatch are the ones the sweep shows."""
    marks = []
    for path in sorted((ROOT / "src/repro_torch").rglob("*.py")):
        lines = path.read_text().splitlines()
        for i, ln in enumerate(lines):
            if "# atomics-lint: disable=" in ln and "`" not in ln:
                context = "\n".join(lines[max(0, i - 4):i + 1])
                assert "distinct" in context or "scratch row" in context, \
                    f"{path}:{i + 1} has no reason"
                marks.append((path.name, i + 1))
    assert [p for p, _ in marks] == ["moe.py", "moe.py"]
    sup = [f for f in ENTRY_POINTS["moe.local"](device="cpu")
           if f.suppressed]
    assert {f.line for f in sup} == {ln for _, ln in marks}


# ---------------------------------------------------------------------------
# telemetry + reporting
# ---------------------------------------------------------------------------

def test_findings_emit_telemetry_events():
    with telemetry.capture() as events:
        W.run_port_twin("a001_table", 0)
        analysis.check(W._p_a001_table, spec((8,), I32),
                       torch.tensor([1, 2]), torch.ones(2, dtype=I32),
                       entry="unit.bad", device="cpu")
    evs = [e for e in events.events if e["event"] == "analysis.finding"]
    assert [e["entry"] for e in evs] == [None, "unit.bad"]
    assert evs[1]["rule"] == "A001" and evs[1]["severity"] == ERROR
    assert evs[1]["suppressed"] is False and evs[1]["line"]


def test_report_renders_analysis_section():
    from repro_torch.telemetry.report import build_report, render_text

    with telemetry.capture() as events:
        W.run_port_twin("a002_faa", 0)
    rep = build_report(events.events, fit=False)
    assert rep["analysis"][0]["rule"] == "A002"
    text = render_text(rep)
    assert "static analysis" in text and "A002" in text
    assert "_torch_analysis_twins.py" in text


# ---------------------------------------------------------------------------
# CLI + sweep + fixture
# ---------------------------------------------------------------------------

def test_cli_list_and_single_entry(capsys):
    assert lint.main(["--list"]) == 0
    out = capsys.readouterr().out.split()
    assert out == list(ENTRY_POINTS) and len(out) == 9
    assert lint.main(["--entries", "bfs.local", "--device", "cpu"]) == 0
    assert "[bfs.local] clean" in capsys.readouterr().out


def test_cli_json_output(capsys):
    assert lint.main(["--entries", "moe.local", "--json",
                      "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["summary"]["errors"] == 0
    assert payload["summary"]["suppressed"] == 3
    assert len(payload["findings"]) == 3


def test_cli_unknown_entry_is_an_error(capsys):
    assert lint.main(["--entries", "no.such.entry", "--device", "cpu"]) == 1
    assert "A000" in capsys.readouterr().out


def test_sweep_crashing_entry_becomes_a000_finding(monkeypatch):
    from repro_torch.analysis import entries as entries_mod

    def boom(device="cuda"):
        raise RuntimeError("entry exploded")

    monkeypatch.setitem(entries_mod.ENTRY_POINTS, "unit.boom", boom)
    fs = lint.sweep(["unit.boom"], device="cpu")["unit.boom"]
    assert _rules(fs) == ["A000"] and "entry exploded" in fs[0].message


def test_run_that_raises_is_an_a000_finding():
    def broken(x):
        return x.view(3, 5)

    fs = analysis.check(broken, spec((8,)), device="cpu")
    assert _rules(fs) == ["A000"] and "RuntimeError" in fs[0].message


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_registered_entry_points_pass_clean(entry):
    findings = ENTRY_POINTS[entry](device="cpu")
    bad = [f for f in findings if f.severity == ERROR and not f.suppressed]
    assert bad == [], "\n".join(f.format() for f in bad)
    assert not any(f.rule == "A000" for f in findings)


@pytest.mark.parametrize("entry", LIVE_ENTRIES)
def test_live_entries_match_reference(parity, entry):
    row = parity["entries"][entry]
    assert row["ref"] == row["port"] == []


@pytest.mark.parametrize("entry", NOT_LIVE_ENTRIES)
def test_entries_the_reference_fails_here_are_clean_in_the_port(parity,
                                                               entry):
    """The reference reports location-less A001s on its own engine here
    (NOT_LIVE_ENTRIES says why), so it is no oracle: the port is held
    clean instead."""
    row = parity["entries"][entry]
    assert row["port"] == []
    assert isinstance(row["ref"], list) and row["ref"] and all(
        r == ["A001", "error"] for r in row["ref"])


def test_fixture_gates_and_returns(torch_atomics_lint):
    assert torch_atomics_lint(W._p_a001_unique, spec((8,)),
                              torch.ones(4)) == []
    with pytest.raises(pytest.fail.Exception):
        torch_atomics_lint(W._p_a001_table, spec((8,), I32),
                           torch.tensor([1, 2]), torch.ones(2, dtype=I32))
    assert torch_atomics_lint.check_recovery(
        *W.PORT_TWINS["a004_recovery_factory"][:1],
        lambda: torch.zeros(4)) == []


# ---------------------------------------------------------------------------
# analysis must not perturb production behavior
# ---------------------------------------------------------------------------

def test_no_marker_outside_observation():
    seen = []
    x = torch.zeros(4)
    assert contracts.mark(x, "table") is x
    analysis.check(W._p_sanctioned, torch.zeros(8, dtype=I32),
                   torch.tensor([1, 1, 2, 7], dtype=I32),
                   torch.tensor([1, 2, 3, 4], dtype=I32), device="cpu")
    assert not contracts.active()
    with contracts.observe(lambda site, f: seen.append(site)):
        assert contracts.mark(x, "table") is x
    assert seen == [contracts.MARKER]
    contracts.mark(x, "table")
    assert seen == [contracts.MARKER]


def test_checked_function_runs_as_a_plain_run_and_changes_no_argument():
    t = torch.zeros(8, dtype=I32)
    i = torch.tensor([1, 1, 2, 7], dtype=I32)
    v = torch.tensor([1, 2, 3, 4], dtype=I32)
    tbl = atomics.AtomicTable(torch.zeros(8, dtype=I32))
    before = W._p_sanctioned(t, i, v)[0].clone()
    got = []
    analysis.check(lambda *a: got.append(W._p_sanctioned(*a)), t, i, v,
                   device="cpu")
    analysis.check(W._p_a001_table_arg, tbl, i, v, device="cpu")
    assert torch.equal(got[0][0], before)
    assert torch.equal(before, torch.tensor([0, 3, 3, 0, 0, 0, 0, 4],
                                            dtype=I32))
    for x, want in ((t, torch.zeros(8, dtype=I32)),
                    (tbl.data, torch.zeros(8, dtype=I32)),
                    (i, torch.tensor([1, 1, 2, 7], dtype=I32))):
        assert torch.equal(x, want)


def test_rule_table_is_complete():
    assert set(RULES) == {"A000", "A001", "A002", "A003", "A004", "A005"}
    for rule, (sev, desc) in RULES.items():
        assert sev in (ERROR, WARNING)
        assert desc


def test_twins_module_imports_no_jax():
    """`chip_smoke.py`'s `analysis` phase imports the twins where no JAX
    is installed: importing them loads neither JAX nor the reference."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import _torch_analysis_twins; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]"
