"""Port parity: `core.collective_model`, `core.planner`, `atomics.layout`.

The port's copies of the collective and planner cost models must give the
reference's floats (and choices) on the same inputs, over both packages'
`TPU_V5E` and the port's `H100` read as the reference's spec; the
`TableLayout` arithmetic (owners, rows, arrival order) and its JSON form
must equal the reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.atomics import layout as rlay
from repro.core import collective_model as rcm
from repro.core import perf_model as rpm
from repro.core import planner as rpl
from repro.core.placement import Tier as RTier
from repro_torch import convert
from repro_torch.atomics import layout as tlay
from repro_torch.core import collective_model as tcm
from repro_torch.core import perf_model as tpm
from repro_torch.core import planner as tpl
from repro_torch.core.placement import Tier

KINDS = rcm.COLLECTIVES
SIZES = (1, 2, 16)
TIERS = ("ICI_NEIGHBOR", "DCN_REMOTE_POD", "ICI_FAR")


def _specs():
    """(reference spec, port spec) pairs: TPU v5e in each package, and the
    port's H100 carried across into the reference's type (its fields the
    reference has; the atomic rates are the port's own)."""
    h100 = dataclasses.asdict(tpm.H100)
    ref_h100 = rpm.HardwareSpec(**{
        k: ({RTier[t.name]: x for t, x in v.items()}
            if isinstance(v, dict) and v and isinstance(next(iter(v)), Tier)
            else v) for k, v in h100.items()
        if k in rpm.HardwareSpec.__dataclass_fields__})
    return [(rpm.TPU_V5E, tpm.TPU_V5E), (ref_h100, tpm.H100)]


def _axes(name, size, tier):
    return (rcm.MeshAxis(name, size, RTier[tier]),
            tcm.MeshAxis(name, size, Tier[tier]))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_collective_time_equals_reference(kind, size, tier):
    rax, tax = _axes("x", size, tier)
    for rspec, tspec in _specs():
        for nbytes in (0, 1600, 1 << 30):
            for bidi in (True, False):
                assert tcm.collective_time_s(tspec, kind, nbytes, tax, bidi) \
                    == rcm.collective_time_s(rspec, kind, nbytes, rax, bidi)
            assert tcm.collective_bytes_on_wire(kind, nbytes, size) == \
                rcm.collective_bytes_on_wire(kind, nbytes, size)
    with pytest.raises(ValueError):             # (size 1 is free first)
        tcm.collective_time_s(tpm.TPU_V5E, "gossip", 10,
                              _axes("x", 2, tier)[1])


@pytest.mark.parametrize("grad_bytes", [1 << 20, 1 << 30])
def test_grad_sync_and_plans_equal_reference(grad_bytes):
    ici_r, ici_t = _axes("data", 16, "ICI_NEIGHBOR")
    dcn_r, dcn_t = _axes("pod", 2, "DCN_REMOTE_POD")
    for rspec, tspec in _specs():
        assert tcm.grad_sync_strategies(tspec, grad_bytes, ici_t) == \
            rcm.grad_sync_strategies(rspec, grad_bytes, ici_r)
        assert tcm.cross_pod_hierarchical(tspec, grad_bytes, ici_t, dcn_t) \
            == rcm.cross_pod_hierarchical(rspec, grad_bytes, ici_r, dcn_r)
        for pod in ((None, None), (dcn_r, dcn_t)):
            for comp in (True, False):
                want = rpl.plan_grad_sync(grad_bytes, ici_r, pod[0], rspec,
                                          comp)
                got = tpl.plan_grad_sync(grad_bytes, ici_t, pod[1], tspec,
                                         comp)
                assert (got.choice, got.priced, got.note) == \
                    (want.choice, want.priced, want.note)
        want = rpl.plan_fsdp_gather_dtype(grad_bytes, ici_r, rspec)
        got = tpl.plan_fsdp_gather_dtype(grad_bytes, ici_t, tspec)
        assert (got.choice, got.priced) == (want.choice, want.priced)


@pytest.mark.parametrize("ep", [1, 8, 64])
def test_moe_dispatch_plan_equals_reference(ep):
    for rspec, tspec in _specs():
        want = rpl.plan_moe_dispatch(65536, 64, 2, ep, 1e-3, spec=rspec)
        got = tpl.plan_moe_dispatch(65536, 64, 2, ep, 1e-3, spec=tspec)
        assert (got.choice, got.priced, got.note) == \
            (want.choice, want.priced, want.note)


def test_default_axes_equal_reference():
    shape = {"pod": 2, "data": 16, "model": 4, "other": 3}
    want, got = rpl.default_axes(shape), tpl.default_axes(shape)
    assert {k: (a.size, a.tier.name) for k, a in got.items()} == \
        {k: (a.size, a.tier.name) for k, a in want.items()}


LAYOUTS = [(64, ("pod", "dev"), ()), (64, ("dev",), ("pod",)),
           (96, ("dev", "pod"), ()), (48, ("pod",), ("dev",)),
           (32, (), ())]


@pytest.mark.parametrize("num_slots,axis,rep", LAYOUTS)
def test_table_layout_equals_reference(num_slots, axis, rep):
    mesh_axes = (("pod", 2), ("dev", 4))
    want = rlay.TableLayout(num_slots=num_slots, dtype="int32", axis=axis,
                            replica_axes=rep, mesh_axes=mesh_axes)
    got = tlay.TableLayout(num_slots=num_slots, dtype="int32", axis=axis,
                           replica_axes=rep, mesh_axes=mesh_axes)
    assert got.to_dict() == want.to_dict()
    assert tlay.TableLayout.from_dict(want.to_dict()) == got
    assert (got.n_shards, got.n_replicas, got.m_local, got.is_sharded) == \
        (want.n_shards, want.n_replicas, want.m_local, want.is_sharded)
    for flat in range(8):
        for f in ("shard_of_device", "replica_rank_of_device",
                  "arrival_rank_of_device"):
            assert getattr(got, f)(flat) == getattr(want, f)(flat), f
    np.testing.assert_array_equal(got.arrival_order(), want.arrival_order())
    for shard in range(got.n_shards):
        assert got.rows_of_shard(shard) == want.rows_of_shard(shard)
    if got.is_sharded:
        g = np.arange(-2, num_slots + 3)
        gidx = np.where((g < 0) | (g >= num_slots), num_slots, g)
        for shard in range(got.n_shards):
            np.testing.assert_array_equal(
                tlay.local_row(torch.as_tensor(gidx), shard, got.m_local,
                               num_slots).numpy(),
                np.asarray(rlay.local_row(jnp.asarray(gidx), shard,
                                          got.m_local, num_slots)))
        np.testing.assert_array_equal(
            tlay.owner_shard(torch.as_tensor(gidx), got.m_local,
                             got.n_shards).numpy(),
            np.asarray(rlay.owner_shard(jnp.asarray(gidx), got.m_local,
                                        got.n_shards)))


def test_layout_from_a_mesh_and_its_errors():
    class FakeMesh:                  # what `from_mesh` reads of a `Mesh`
        axis_names = ("pod", "dev")
        shape = {"pod": 2, "dev": 4}
    lay = tlay.TableLayout.from_mesh(FakeMesh(), num_slots=64,
                                     dtype=torch.int32, axis="dev",
                                     replica_axes="pod")
    assert lay.dtype == "int32" and lay.mesh_axes == (("pod", 2), ("dev", 4))
    with pytest.raises(ValueError, match="not on mesh"):
        tlay.TableLayout.from_mesh(FakeMesh(), num_slots=64, dtype="int32",
                                   axis="model")
    with pytest.raises(ValueError, match="divide"):
        tlay.TableLayout.from_mesh(FakeMesh(), num_slots=13, dtype="int32",
                                   axis=("pod", "dev"))
    table = convert.table_from_numpy(np.zeros(8, np.float32), "cpu")
    assert tlay.TableLayout.from_table(table).to_dict() == \
        rlay.TableLayout(num_slots=8, dtype="float32").to_dict()
