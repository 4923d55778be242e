"""Port parity: `repro_torch.core.rmw_engine` against `repro.core.rmw_engine`.

Every backend of the port (on the CPU the ``cuda`` backend runs the kernels'
plain versions) agrees bit for bit with the JAX serialized oracle on
collision-heavy int32 batches; the cost models match the reference's floats
for the reference's specs; and with the H100 priors the selector picks the
kernels on a CUDA table.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gpu import collision_heavy, same
from repro.core import perf_model as jpm
from repro.core import rmw as jrmw
from repro.core import rmw_engine as jeng
from repro_torch.convert import spec_from_reference
from repro_torch.core import perf_model as tpm
from repro_torch.core import rmw_engine as teng

RNG = np.random.default_rng(11)
OPS4 = ["faa", "swp", "min", "max"]
BACKENDS = ["serialized", "sort", "onehot", "cuda"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_same(got, want, what):
    same(got.table, want.table, f"{what}: table")
    same(got.fetched, want.fetched, f"{what}: fetched")
    same(got.success, want.success, f"{what}: success")


@pytest.mark.parametrize("op", OPS4)
def test_backends_match_serialized_oracle(op):
    m, n = 37, 500
    idx = collision_heavy(RNG, n, m)
    vals = RNG.integers(-6, 7, n).astype(np.int32)
    table = RNG.integers(-5, 6, m).astype(np.int32)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), op)
    for backend in BACKENDS:
        got = teng.execute_backend(_t(table), _t(idx), _t(vals), op,
                                   backend=backend)
        _assert_same(got, want, f"{backend}:{op}")


def test_backends_cas_uniform_match_serialized_oracle():
    m, n = 11, 300
    idx = collision_heavy(RNG, n, m)
    vals = RNG.integers(-1, 2, n).astype(np.int32)
    table = RNG.integers(-1, 2, m).astype(np.int32)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), "cas",
                               jnp.zeros((n,), jnp.int32))
    for backend in BACKENDS:
        got = teng.execute_backend(_t(table), _t(idx), _t(vals), "cas", 0,
                                   backend=backend)
        _assert_same(got, want, f"{backend}:cas")


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_table_only_matches_reference_with_drops(op):
    """need_fetched=False: one scatter pass, out-of-range and negative
    indices dropped exactly as the reference's `_tables_only`."""
    m, n = 50, 700
    idx = RNG.integers(-4, m + 6, n).astype(np.int32)
    lo, hi = (-1, 2) if op == "cas" else (-6, 7)
    vals = RNG.integers(lo, hi, n).astype(np.int32)
    table = RNG.integers(lo, hi, m).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jeng.rmw_onehot(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(vals), op,
                           None if exp is None else jnp.int32(exp),
                           need_fetched=False)
    for backend in ("onehot", "cuda"):
        got = teng.execute_backend(_t(table), _t(idx), _t(vals), op, exp,
                                   backend=backend, need_fetched=False)
        same(got.table, want.table, backend)


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_onehot_blocks_match_reference(op):
    m, n = 9, 100
    idx = collision_heavy(RNG, n, m)
    lo, hi = (-1, 2) if op == "cas" else (-4, 5)
    vals = RNG.integers(lo, hi, n).astype(np.int32)
    table = RNG.integers(lo, hi, m).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jeng.rmw_onehot(jnp.asarray(table), jnp.asarray(idx),
                           jnp.asarray(vals), op,
                           None if exp is None else jnp.int32(exp), block=16)
    got = teng.rmw_onehot(_t(table), _t(idx), _t(vals), op, exp, block=16)
    _assert_same(got, want, f"onehot:{op}")


def test_float_faa_close_across_backends():
    m, n = 64, 2048
    idx = collision_heavy(RNG, n, m)
    vals = RNG.normal(size=n).astype(np.float32)
    table = RNG.normal(size=m).astype(np.float32)
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(vals), "faa")
    for backend in ("sort", "onehot", "cuda"):
        got = teng.execute_backend(_t(table), _t(idx), _t(vals), "faa",
                                   backend=backend)
        for g, w in ((got.table, want.table), (got.fetched, want.fetched)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=backend)


def test_slot_occupancy_matches_reference():
    idx = RNG.integers(-5, 130, 2000).astype(np.int32)
    got = teng.slot_occupancy(_t(idx), 120)
    assert got.dtype == torch.int32
    same(got, jeng.slot_occupancy(jnp.asarray(idx), 120))


@pytest.mark.parametrize("n,k", [(300, 7), (5000, 1000)])
def test_arrival_rank_sortfree_matches_reference(n, k):
    keys = RNG.integers(0, k, n).astype(np.int32)
    same(teng._arrival_rank_sortfree(_t(keys), k),
         jeng._arrival_rank_sortfree(jnp.asarray(keys), k))


@pytest.mark.parametrize("spec_name", ["tpu", "cpu"])
def test_cost_models_match_reference_floats(spec_name):
    jspec = jpm.TPU_V5E if spec_name == "tpu" else jpm.cpu_default_spec()
    tspec = spec_from_reference(jpm.spec_to_dict(jspec))
    for op in ("faa", "swp", "min", "max", "cas"):
        for n, m in ((64, 16), (4096, 1024), (1 << 20, 1 << 22)):
            for nf in (True, False):
                for name in ("serialized", "sort", "onehot"):
                    want = getattr(jeng, f"cost_{name}")(jspec, op, n, m, nf)
                    got = getattr(teng, f"cost_{name}")(tspec, op, n, m, nf)
                    assert got == pytest.approx(want, rel=1e-12), \
                        (name, op, n, m, nf)


@pytest.mark.parametrize("need_fetched", [True, False])
@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_auto_picks_the_kernels_on_cuda(op, need_fetched):
    """With the shipped H100 priors, every op at n >= 4096 on a CUDA table
    of up to 2**22 slots goes to the hand-written kernels — and never on a
    CPU table.  (Past that, at n near 4096, the reference's sort cost, which
    does not charge the table copy, undercuts the kernels' table bytes.)"""
    for dtype in (torch.int32, torch.float32):
        for n in (4096, 5000, 1 << 16, 1 << 25):
            for m in (64, 1024, 1 << 20, 1 << 22):
                kw = dict(dtype=dtype, need_fetched=need_fetched)
                assert teng.select_backend(op, n, m, tpm.H100,
                                           device="cuda", **kw) == "cuda"
                assert teng.select_backend(op, n, m, tpm.H100,
                                           device="cpu", **kw) != "cuda"
                assert teng.select_backend(op, n, m, device="cpu",
                                           **kw) != "cuda"


@pytest.mark.parametrize("op", OPS4)
def test_auto_picks_the_table_kernels_at_bfs_shape(op):
    """BFS's table-only batches (n = 2^25 edges over m = 2^20 vertices) go
    to the kernels on a CUDA table, priced by the L2's atomic rate, which
    bounds them there, not by their bytes."""
    n, m = 2 * 16 << 20, 1 << 20
    for dtype in (torch.int32, torch.float32):
        assert teng.select_backend(op, n, m, tpm.H100, device="cuda",
                                   dtype=dtype, need_fetched=False) == "cuda"
    assert teng.cost_cuda(tpm.H100, op, n, m, False, "cuda") == \
        pytest.approx(n / tpm.H100.l2_atomic_ops_per_s)
    # the contended shape combines in shared memory, at its rate
    assert teng.cost_cuda(tpm.H100, op, 1 << 22, 1024, False, "cuda") == \
        pytest.approx((1 << 22) / tpm.H100.smem_atomic_ops_per_s)


def test_selection_respects_dtypes_and_per_op_cas():
    assert not teng.BACKENDS["cuda"].supports("faa", dtype=torch.float64)
    assert teng.BACKENDS["cuda"].supports("faa", dtype=torch.int32)
    assert teng.select_backend("cas", 4096, 64, tpm.H100, device="cuda",
                               uniform_expected=False) == "serialized"
    assert teng.select_backend("faa", 4096, 64, tpm.H100, device="cuda",
                               dtype=torch.float64) != "cuda"
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        teng.execute_backend(t, t, t, "cas", t, backend="sort")
    with pytest.raises(ValueError):
        teng.execute_backend(t, t, t, "faa", backend="pallas")


def test_default_spec_by_device_and_live_override():
    assert teng.default_spec("cuda") is tpm.H100
    assert teng.default_spec("cpu").name == "cpu_host"
    assert teng.default_spec(torch.device("cuda", 0)) is tpm.H100
    tuned = dataclasses.replace(tpm.H100, name="tuned")
    try:
        teng.set_live_spec(tuned)
        assert teng.default_spec("cpu") is tuned
        assert teng.live_spec() is tuned
    finally:
        teng.clear_live_spec()
    assert teng.live_spec() is None
    assert teng.default_spec("cpu").name == "cpu_host"
    with pytest.raises(TypeError):
        teng.set_live_spec("h100")
