"""Port parity: `repro_torch.core.rmw` against `repro.core.rmw`.

The same numpy inputs go through the JAX function and its port; integer
tables must agree bit for bit, including the reference's handling of
out-of-range indices (gather clamps, scatter drops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gpu import collision_heavy, same, same_bits, zeros_and_nans
from repro.core import rmw as jrmw
from repro_torch.core import rmw as trmw

RNG = np.random.default_rng(21)
OPS4 = ["faa", "swp", "min", "max"]


def _batch(m, n, hi_extra=0, dtype=np.int32):
    table = RNG.integers(-5, 6, m).astype(dtype)
    idx = collision_heavy(RNG, n, m + hi_extra)
    vals = RNG.integers(-6, 7, n).astype(dtype)
    return table, idx, vals


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("op", OPS4)
def test_serialized_matches_reference(op):
    table, idx, vals = _batch(37, 300, hi_extra=6)   # some out of range
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), op)
    got = trmw.rmw_serialized(_t(table), _t(idx), _t(vals), op)
    same(got.table, want.table, "table")
    same(got.fetched, want.fetched, "fetched")
    same(got.success, want.success, "success")


def test_serialized_cas_per_op_expected_matches_reference():
    table = RNG.integers(-1, 2, 11).astype(np.int32)
    idx = collision_heavy(RNG, 200, 11)
    vals = RNG.integers(-1, 2, 200).astype(np.int32)
    exp = RNG.integers(-1, 2, 200).astype(np.int32)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), "cas", jnp.asarray(exp))
    got = trmw.rmw_serialized(_t(table), _t(idx), _t(vals), "cas", _t(exp))
    same(got.table, want.table)
    same(got.fetched, want.fetched)
    same(got.success, want.success)


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_combining_matches_reference(op):
    """Sort + segmented scan, bit-equal to the JAX combiner (out-of-range
    ops included) and to the serialized oracle."""
    table, idx, vals = _batch(29, 400, hi_extra=5)
    if op == "cas":
        vals = RNG.integers(-1, 2, 400).astype(np.int32)
        table = RNG.integers(-1, 2, 29).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jrmw.rmw_combining(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        None if exp is None else jnp.int32(exp))
    got = trmw.rmw_combining(_t(table), _t(idx), _t(vals), op, exp)
    same(got.table, want.table, "table")
    same(got.fetched, want.fetched, "fetched")
    same(got.success, want.success, "success")
    ser = jrmw.rmw_serialized(
        jnp.asarray(table), jnp.asarray(idx % 29), jnp.asarray(vals), op,
        None if exp is None else jnp.zeros((400,), jnp.int32))
    got_in = trmw.rmw_combining(_t(table), _t(idx % 29), _t(vals), op, exp)
    same(got_in.table, ser.table)
    same(got_in.fetched, ser.fetched)
    same(got_in.success, ser.success)


def test_combining_float_faa_close_to_reference():
    m, n = 64, 2048
    table = RNG.normal(size=m).astype(np.float32)
    idx = collision_heavy(RNG, n, m)
    vals = RNG.normal(size=n).astype(np.float32)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), "faa")
    got = trmw.rmw_combining(_t(table), _t(idx), _t(vals), "faa")
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.fetched.numpy(), np.asarray(want.fetched),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["serialized", "combining"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_fp32_minmax_signed_zeros_and_nan_match_reference(op, path):
    """fp32 MIN/MAX in the reference's order: −0 below +0, and a NaN in the
    table or among the operands wins and stays.  Repeated slots, against
    the reference's oracle: NaN by isnan, every other value bit for bit."""
    rng = np.random.default_rng(61 + len(op + path))
    table, vals = zeros_and_nans(rng, 61), zeros_and_nans(rng, 300)
    idx = collision_heavy(rng, 300, 61)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), op)
    got = getattr(trmw, f"rmw_{path}")(_t(table), _t(idx), _t(vals), op)
    same_bits(got.table, want.table, "table")
    same_bits(got.fetched, want.fetched, "fetched")
    same(got.success, want.success, "success")


def test_order_key_orders_as_the_reference():
    """`order_key` sorts ±0 and NaN as XLA's min/max do, and
    `from_order_key` inverts it on every non-NaN value."""
    x = torch.tensor([np.nan, 1.0, -0.0, 0.0, -np.inf, -1.0, np.inf],
                     dtype=torch.float32)
    for op, f in (("min", jnp.minimum), ("max", jnp.maximum)):
        k = trmw.order_key(x, op)
        assert k.dtype == torch.int32
        same_bits(trmw.from_order_key(k, x.dtype)[1:], x[1:].numpy())
        for i in range(x.shape[0]):
            got = trmw.minmax(op, x[i].expand(7), x)
            same_bits(got, f(jnp.asarray(x[i].numpy()), jnp.asarray(
                x.numpy())), f"{op} {x[i]}")
    ints = torch.tensor([3, -2], dtype=torch.int32)
    assert trmw.order_key(ints, "min") is ints


@pytest.mark.parametrize("name", ["add", "minimum", "maximum"])
def test_segmented_scan_matches_reference(name):
    vals = RNG.integers(-50, 50, 333).astype(np.int32)
    starts = RNG.random(333) < 0.2
    scan = jax.jit(jrmw.segmented_scan, static_argnums=2)
    want = scan(jnp.asarray(vals), jnp.asarray(starts), getattr(jnp, name))
    got = trmw.segmented_scan(_t(vals), _t(starts), getattr(torch, name))
    same(got, want)


def test_arrival_rank_argsort_matches_reference():
    keys = RNG.integers(0, 9, 500).astype(np.int32)
    same(trmw._arrival_rank_argsort(_t(keys)),
         jax.jit(jrmw._arrival_rank_argsort)(jnp.asarray(keys)))


def test_int32_results_stay_int32():
    """torch builds int64 where JAX builds int32: the port must not."""
    table, idx, vals = _batch(16, 64)
    for op in OPS4:
        res = trmw.rmw_combining(_t(table), _t(idx), _t(vals), op)
        assert res.table.dtype == res.fetched.dtype == torch.int32
        assert res.success.dtype == torch.bool
    assert trmw._arrival_rank_argsort(_t(idx)).dtype == torch.int32


def test_unknown_op_and_missing_expected_raise():
    t = torch.zeros(4, dtype=torch.int32)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        trmw.rmw_combining(t, i, i, "xor")
    with pytest.raises(ValueError):
        trmw.rmw_combining(t, i, i, "cas")
    with pytest.raises(ValueError):
        trmw.rmw_serialized(t, i, i, "cas")
