"""The `unaligned` and `prefetcher` suites on the CPU, and the table
kernel's window and load-depth arguments.

On the card the suites sweep `kernels.rmw.kernel.table_combine`'s L2
window (on and off the 128-byte line) and its load depth; on the CPU the
plain version has neither, so each suite runs at the reference's sizes and
emits the same rows, each marked ``plain``.  The reference's suites run
its Pallas kernel in interpret mode and are not compared row for row (its
rows time another kernel); what is held against it is the registry's
order of the suites and the model row's formula.
"""

import re

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.benchmarks import prefetcher, unaligned
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks.common import Csv
from repro_torch.core.perf_model import H100, latency, unaligned_latency
from repro_torch.core.placement import PlacementState, Tier
from repro_torch.kernels.rmw import kernel as K


@pytest.fixture(scope="module")
def rows():
    csv = Csv()
    got = {"unaligned": unaligned.run(csv, device="cpu"),
           "prefetcher": prefetcher.run(csv, device="cpu")}
    return {r["name"]: r for r in csv.rows}, got


def test_unaligned_rows_on_the_cpu(rows):
    by_name, got = rows
    names = [f"unaligned.faa.window_{w}" for w in unaligned.WINDOWS]
    for name, w in zip(names, unaligned.WINDOWS):
        r = by_name[name]
        assert r["derived"].startswith("plain")
        assert f"line_aligned={w % 32 == 0}" in r["derived"]
        assert f"n={unaligned.CPU_N_OPS} m={unaligned.CPU_TABLE}" in \
            r["derived"]
        assert r["us_per_call"] > 0
        assert got["unaligned"][f"window_{w}"] == pytest.approx(
            r["us_per_call"] / 1e6)
    assert [w % 32 == 0 for w in unaligned.WINDOWS] == [True, False, False]
    assert [unaligned.passes(unaligned.TABLE, w)
            for w in unaligned.WINDOWS] == [4, 4, 6]


def test_unaligned_model_row_is_the_ports_model(rows):
    by_name, got = rows
    st = PlacementState(tier=Tier.HBM_LOCAL)
    want = unaligned_latency(H100, "cas", st)
    assert want == 2 * latency(H100, "cas", st) + H100.execute_s.get("cas",
                                                                     0.0)
    r = by_name["unaligned.model.cas"]
    assert r["us_per_call"] == want * 1e6 == got["unaligned"]["model_cas_s"] \
        * 1e6
    assert f"aligned={latency(H100, 'cas', st) * 1e9:.0f}ns" in r["derived"]


def test_prefetcher_rows_on_the_cpu(rows):
    by_name, got = rows
    for pattern in ("random", "sequential"):
        for d in K.DEPTHS:
            r = by_name[f"prefetch.faa.{pattern}.depth{d}"]
            assert r["derived"].startswith("plain")
            assert re.search(r"[0-9.]+ MB/s of operands", r["derived"])
            assert got["prefetcher"][f"{pattern}.depth{d}"] == \
                pytest.approx(r["us_per_call"] / 1e6)
    assert K.DEPTHS == (1, K.UNROLL, 32) and K.UNROLL == 8


def test_suites_registered_in_the_reference_order():
    """`unaligned` and `prefetcher` right after `operands_fetched`,
    `roofline` after `model_validation`, as in `benchmarks/run.py`; the
    CPU run of the three raises nothing."""
    import inspect

    import benchmarks.run as jrun
    src = inspect.getsource(jrun.main)
    ref = re.findall(r'^\s+"(\w+)":', src, re.M)
    for order in (ref, list(trun.SUITES)):
        i = order.index("operands_fetched")
        assert order[i + 1:i + 3] == ["unaligned", "prefetcher"]
        assert order.index("roofline") == order.index("model_validation") + 1
    csv, _, failures = trun.run_suites(["unaligned", "prefetcher",
                                        "roofline"], device="cpu")
    assert failures == []
    assert sum(r["name"].startswith("unaligned.") for r in csv.rows) == 4
    assert sum(r["name"].startswith("prefetch.") for r in csv.rows) == 6


@pytest.mark.parametrize("op,regime,depth", [
    ("min", "global", 32), ("swp", "windows", 1), ("faa", "smem", 1),
    ("faa", "global", 4), ("count", "global", 32)])
def test_table_combine_refuses_depths_the_library_lacks(op, regime, depth):
    """Depths other than `UNROLL` are built for FAA outside the smem
    regime only, at 1 and 32: anything else raises before a launch."""
    tab = torch.zeros(64, dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="depth"):
        K.table_combine(tab, idx, None if op == "count" else idx, op, regime,
                        depth=depth)


def test_table_combine_refuses_an_empty_window():
    tab = torch.zeros(64)
    with pytest.raises(ValueError, match="window"):
        K.table_combine(tab, torch.zeros(8, dtype=torch.int32),
                        torch.zeros(8), "faa", "windows", window=0)


@pytest.mark.parametrize("window,depth", [(40, 1), (32, 8), (8, 32)])
def test_table_combine_on_fake_tensors_launches_nothing(window, depth):
    K.reset_launches()
    with FakeTensorMode():
        out = torch.zeros(64, device="meta")
        got = K.table_combine(out, torch.zeros(8, dtype=torch.int32,
                                               device="meta"),
                              torch.zeros(8, device="meta"), "faa",
                              "windows", window=window, depth=depth)
    assert got is out and K.LIBRARY._built is None
    assert all(v == 0 for v in K.LAUNCHES.values())
