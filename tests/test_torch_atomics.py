"""Port parity: `repro_torch.atomics` (local tier) and `repro_torch.convert`.

`execute` with and without ``collect_stats`` matches `repro.atomics.execute`
on the same numpy inputs; the convert helpers carry tables and specs across;
and the port stays free of JAX and of the reference package.
"""

import dataclasses
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gpu import collision_heavy, same
from repro import atomics as jat
from repro.core import perf_model as jpm
from repro_torch import atomics as tat
from repro_torch import convert
from repro_torch.core import perf_model as tpm

RNG = np.random.default_rng(5)
ROOT = Path(__file__).resolve().parents[1]
OPS = ["faa", "swp", "min", "max", "cas"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ops(kind, idx, vals, lib):
    mk = {"jax": jnp.asarray, "torch": _t}[lib]
    ops = jat.OP_KINDS if lib == "jax" else tat.OP_KINDS
    if kind == "cas":
        return ops[kind](mk(idx), mk(vals), expected=mk(np.int32(0)))
    return ops[kind](mk(idx), mk(vals))


def _batch(kind, m=33, n=400):
    lo, hi = (-1, 2) if kind == "cas" else (-7, 8)
    return (RNG.integers(lo, hi, m).astype(np.int32),
            collision_heavy(RNG, n, m + 4),
            RNG.integers(lo, hi, n).astype(np.int32))


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("kind", OPS)
def test_execute_matches_reference(kind, backend):
    table, idx, vals = _batch(kind)
    want = jat.execute(jnp.asarray(table), _ops(kind, idx, vals, "jax"))
    got = tat.execute(convert.table_from_numpy(table, "cpu"),
                      _ops(kind, idx, vals, "torch"), backend=backend)
    same(got.table.data, want.table.data, "table")
    in_range = idx < table.shape[0]      # fetched is contracted in range only
    same(got.fetched[in_range], np.asarray(want.fetched)[in_range], "fetched")
    same(got.success[in_range], np.asarray(want.success)[in_range], "success")


@pytest.mark.parametrize("kind", OPS)
def test_execute_collect_stats_matches_reference(kind):
    table, idx, vals = _batch(kind)
    want = jat.execute(jnp.asarray(table), _ops(kind, idx, vals, "jax"),
                       collect_stats=True)
    for backend in ("auto", "cuda"):
        got = tat.execute(_t(table), _ops(kind, idx, vals, "torch"),
                          backend=backend, collect_stats=True)
        same(got.table.data, want.table.data)
        for name in tat.ContentionStats._fields:
            same(getattr(got.stats, name), getattr(want.stats, name), name)
        plain = tat.execute(_t(table), _ops(kind, idx, vals, "torch"),
                            backend=backend)
        assert plain.stats is None
        same(plain.table.data, got.table.data.numpy())


def test_execute_float_kernel_backend_stats_match_pallas():
    """fp32 table: the port's `cuda` backend (plain versions here) against
    the reference's Pallas backend in interpret mode, stats included."""
    m, n = 200, 500
    table = RNG.integers(-8, 9, m).astype(np.float32)
    idx = collision_heavy(RNG, n, m)
    vals = RNG.integers(-8, 9, n).astype(np.float32)
    want = jat.execute(jnp.asarray(table),
                       jat.Faa(jnp.asarray(idx), jnp.asarray(vals)),
                       backend="pallas", collect_stats=True)
    got = tat.execute(_t(table), tat.Faa(_t(idx), _t(vals)), backend="cuda",
                      collect_stats=True)
    same(got.table.data, want.table.data)
    same(got.fetched, want.fetched)
    for name in tat.ContentionStats._fields:
        same(getattr(got.stats, name), getattr(want.stats, name), name)


def test_execute_sequence_and_per_op_cas_match_reference():
    table = RNG.integers(-1, 2, 20).astype(np.int32)
    i1, i2 = collision_heavy(RNG, 100, 20), collision_heavy(RNG, 100, 20)
    v1, v2 = (RNG.integers(-1, 2, 100).astype(np.int32) for _ in range(2))
    exp = RNG.integers(-1, 2, 100).astype(np.int32)
    want = jat.execute(jnp.asarray(table), [
        jat.Faa(jnp.asarray(i1), jnp.asarray(v1)),
        jat.Cas(jnp.asarray(i2), jnp.asarray(v2), expected=jnp.asarray(exp))])
    got = tat.execute(_t(table), [tat.Faa(_t(i1), _t(v1)),
                                  tat.Cas(_t(i2), _t(v2), expected=_t(exp))])
    same(got.table.data, want.table.data)
    for k in range(2):
        same(got.fetched[k], want.fetched[k])
        same(got.success[k], want.success[k])


@pytest.mark.parametrize("num_keys", [None, 9])
def test_arrival_rank_matches_reference(num_keys):
    keys = RNG.integers(0, 9, 300).astype(np.int32)
    same(tat.arrival_rank(_t(keys), num_keys),
         jat.arrival_rank(jnp.asarray(keys), num_keys))


def test_table_and_op_validation():
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tat.AtomicTable(torch.zeros(4), axis="dev")
    with pytest.raises(ValueError):
        tat.AtomicTable(torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        tat.Faa(torch.zeros(3, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tat.Cas(torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32),
                expected=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        tat.execute(torch.zeros(4, dtype=torch.int32), "faa")
    t = tat.make_table(16, torch.int32, fill=-1, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (16,)
    assert int(t.data.sum()) == -16
    assert tat.Cas([0], [1], expected=-1).uniform_expected


def test_entry_points_default_to_cuda():
    from repro_torch.core import bfs
    assert inspect.signature(tat.make_table).parameters["device"].default \
        == "cuda"
    assert inspect.signature(bfs.bfs).parameters["device"].default == "cuda"
    assert inspect.signature(convert.table_from_numpy).parameters[
        "device"].default == "cuda"


def test_convert_tables_round_trip():
    arr = RNG.integers(-100, 100, 77).astype(np.int32)
    t = convert.table_from_numpy(arr, "cpu")
    arr[0] = 12345                        # the table holds its own copy
    assert t.dtype == torch.int32
    back = convert.table_to_numpy(t)
    assert back[0] != 12345
    np.testing.assert_array_equal(back[1:], arr[1:])


@pytest.mark.parametrize("spec", [jpm.TPU_V5E, jpm.cpu_default_spec()])
def test_spec_from_reference(spec):
    for d in (jpm.spec_to_dict(spec), dataclasses.asdict(spec)):
        got = convert.spec_from_reference(d)
        assert isinstance(got, tpm.HardwareSpec)
        assert got.name == spec.name
        for tier, v in spec.tier_latency_s.items():
            assert got.tier_latency_s[tpm.Tier[tier.name]] == v
        for tier, v in spec.tier_bandwidth_Bps.items():
            assert got.tier_bandwidth_Bps[tpm.Tier[tier.name]] == v
        for f in ("execute_s", "peak_flops", "hbm_Bps", "sort_elem_pass_s",
                  "gather_elem_s", "loop_step_s", "collective_launch_s"):
            assert getattr(got, f) == getattr(spec, f)


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{k}: {line.strip()}"
           for f in files
           for k, line in enumerate(f.read_text().splitlines(), 1)
           if _IMPORT.match(line)]
    assert not bad, bad
