"""Port parity: the RMW kernel wrappers (`repro_torch.kernels.rmw`).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package — the Pallas kernels in interpret mode
for fp32 at the reference tests' tolerance (tests/test_kernels_rmw.py:31),
the JAX oracles bit for bit for int32.  The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gpu import collision_heavy, same
from repro.kernels.rmw import ops as jops
from repro.kernels.rmw import ref as jref
from repro_torch.kernels.rmw import kernel as K
from repro_torch.kernels.rmw import ops as tops
from repro_torch.kernels.rmw import ref as tref

RNG = np.random.default_rng(7)
OPS4 = ["faa", "min", "max", "swp"]
# (table, n_ops, table_tile, block): two cases of the reference SWEEP
SWEEP = [(512, 1024, 512, 1024), (700, 3000, 512, 1024)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("op", OPS4)
@pytest.mark.parametrize("m,n,tile,block", SWEEP)
def test_rmw_apply_fp32_matches_pallas_interpret(op, m, n, tile, block):
    table = RNG.normal(size=m).astype(np.float32)
    idx = RNG.integers(0, m + 7, n).astype(np.int32)   # some dropped
    vals = RNG.normal(size=n).astype(np.float32)
    want = jops.rmw_apply(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(vals), op, table_tile=tile, block=block)
    got = tops.rmw_apply(_t(table), _t(idx), _t(vals), op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", OPS4)
def test_rmw_table_int32_matches_reference(op):
    table = RNG.integers(-9, 10, 300).astype(np.int32)
    idx = collision_heavy(RNG, 2000, 310)
    vals = RNG.integers(-9, 10, 2000).astype(np.int32)
    want = jref.rmw_table_ref(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(vals), op)
    same(K.rmw_table(_t(table), _t(idx), _t(vals), op), want)
    same(tref.rmw_table_ref(_t(table), _t(idx), _t(vals), op), want)


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_rmw_table_fetched_int32_matches_reference(op):
    """Vectorised plain version and the serialized port oracle, both
    bit-equal to the JAX drop-aware oracle."""
    m, n = 41, 600
    lo, hi = (-1, 2) if op == "cas" else (-8, 9)
    table = RNG.integers(lo, hi, m).astype(np.int32)
    idx = collision_heavy(RNG, n, m + 9)
    vals = RNG.integers(lo, hi, n).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jref.rmw_table_fetched_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        None if exp is None else jnp.int32(exp))
    for fn in (lambda *a: K.rmw_table_fetched(*a[:4], expected=a[4]),
               tref.rmw_table_fetched_ref):
        t, f, s = fn(_t(table), _t(idx), _t(vals), op, exp)
        same(t, want[0], "table")
        same(f, want[1], "fetched")
        same(s, want[2], "success")


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_rmw_apply_fetched_fp32_matches_pallas_interpret(op):
    """Integer-valued fp32: every partial sum exact, so bit-equal."""
    m, n = 256, 384
    lo, hi = (-1, 2) if op == "cas" else (-8, 9)
    table = RNG.integers(lo, hi, m).astype(np.float32)
    idx = collision_heavy(RNG, n, m + 9)
    vals = RNG.integers(lo, hi, n).astype(np.float32)
    exp = 0.0 if op == "cas" else None
    want = jops.rmw_apply_fetched(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        expected=None if exp is None else jnp.float32(exp),
        table_tile=128, block=128)
    got = tops.rmw_apply_fetched(_t(table), _t(idx), _t(vals), op,
                                 expected=exp)
    same(got.table, want.table, "table")
    same(got.fetched, want.fetched, "fetched")
    same(got.success, want.success, "success")


def test_rmw_apply_fetched_fp32_normal_faa_close():
    m, n = 128, 1024
    table = RNG.normal(size=m).astype(np.float32)
    idx = collision_heavy(RNG, n, m)
    vals = RNG.normal(size=n).astype(np.float32)
    want = jops.rmw_apply_fetched(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(vals), "faa", table_tile=128,
                                  block=512)
    got = tops.rmw_apply_fetched(_t(table), _t(idx), _t(vals), "faa")
    for g, w in ((got.table, want.table), (got.fetched, want.fetched)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    same(got.success, want.success)


def test_slot_occupancy_matches_reference():
    idx = RNG.integers(-3, 1100, 5000).astype(np.int32)
    want = jops.slot_occupancy(jnp.asarray(idx), 1000)
    got = tops.slot_occupancy(_t(idx), 1000)
    assert got.dtype == torch.int32
    same(got, want)


def test_histogram_is_faa_counter():
    idx = RNG.integers(0, 64, 5000).astype(np.int32)
    got = tops.histogram(_t(idx), 64)
    same(got, jref.histogram_ref(jnp.asarray(idx), 64))
    same(tref.histogram_ref(_t(idx), 64), np.asarray(got))
    assert float(got.sum()) == 5000


def test_out_of_range_dropped():
    table = torch.zeros(128, dtype=torch.float32)
    idx = torch.tensor([0, 127, 128, 10_000], dtype=torch.int32)
    vals = torch.ones(4, dtype=torch.float32)
    assert float(tops.rmw_apply(table, idx, vals, "faa").sum()) == 2.0
    res = tops.rmw_apply_fetched(table, torch.tensor([0, 0, 127, 128, 10_000],
                                                     dtype=torch.int32),
                                 torch.arange(1, 6, dtype=torch.float32))
    assert float(res.table.sum()) == 6.0
    same(res.fetched, [0.0, 1.0, 0.0, 0.0, 0.0])
    same(res.success, [True, True, True, False, False])


def test_cpu_runs_plain_versions_and_counts_no_launch():
    K.reset_launches()
    t = torch.zeros(8, dtype=torch.int32)
    i = torch.tensor([1, 2, 2], dtype=torch.int32)
    K.rmw_table(t, i, i, "faa")
    K.rmw_table_fetched(t, i, i, "cas", expected=0)
    K.slot_counts(i, 8)
    assert K.LAUNCHES == {"rmw_table": 0, "rmw_table_fetched": 0,
                          "slot_counts": 0}


@pytest.mark.parametrize("call", ["rmw_table", "rmw_table_fetched",
                                  "slot_counts"])
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """No fallback: a tensor off the CPU launches the kernel or raises."""
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    i = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, TypeError, ValueError)):
        if call == "rmw_table":
            K.rmw_table(t, i, i, "faa")
        elif call == "rmw_table_fetched":
            K.rmw_table_fetched(t, i, i, "faa")
        else:
            K.slot_counts(i, 8)


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):     # int64 indices
        K.rmw_table(t, torch.zeros(3, dtype=torch.int64, device="meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):     # values of another type
        K.rmw_table(t, torch.zeros(3, dtype=torch.int32, device="meta"),
                    torch.zeros(3, dtype=torch.float32, device="meta"))
    with pytest.raises(TypeError):     # float64 table
        K.rmw_table_fetched(torch.zeros(8, dtype=torch.float64,
                                        device="meta"),
                            torch.zeros(3, dtype=torch.int32, device="meta"),
                            torch.zeros(3, dtype=torch.float64,
                                        device="meta"))
    with pytest.raises(ValueError):
        K.rmw_table(t, t, t, "cas")
