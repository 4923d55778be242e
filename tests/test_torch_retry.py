"""The port's `execute_until` against the reference's, on both tiers.

Local tier: the reference test's scenarios (`tests/test_retry.py`: fully
contended CAS increments, an uncontended batch, an exhausted budget, an
early give-up, values-only retries, a non-CAS batch) run through both
packages for every policy, with the same inputs; round count, per-op
rounds, fetched pre-images, success, the pending set and the final table
must be equal.  Sharded tier: one group of 8 gloo ranks on a 2x4 mesh
(`_torch_sharded_worker.py`, no JAX) runs the contended batch on a table
sharded over both axes, once per policy; every rank's round history and
the gathered table must equal the local tier's, and n ops resolve in at
most n rounds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.atomics as ratom
from repro_torch import atomics
from repro_torch.launch import ranks

HERE = os.path.dirname(os.path.abspath(__file__))
POLICY_NAMES = ("immediate", "shrink", "exponential")


def _policies(name):
    """The same policy, built in each package (exponential with a short
    base: the sleeps are recorded, not slept)."""
    if name == "exponential":
        return (ratom.ExponentialBackoff(base_s=1e-5, max_s=1e-4),
                atomics.ExponentialBackoff(base_s=1e-5, max_s=1e-4))
    return ratom.POLICIES[name](), atomics.POLICIES[name]()


def _scenario(name, n):
    """(table, make_ops_ref, make_ops_port, max_rounds) for one scenario."""
    table = np.zeros(8, np.int32)
    idx = np.zeros(n, np.int32)

    def contended(mod, cas, asarray):
        def make_ops(slots, observed):
            if slots is None:
                return cas(asarray(idx), asarray(np.ones(n, np.int32)),
                           expected=asarray(np.zeros(n, np.int32)))
            return cas(asarray(slots), asarray(observed) + 1,
                       expected=asarray(observed))
        return make_ops

    ref_arr = lambda a: jnp.asarray(np.asarray(a), jnp.int32)
    port_arr = lambda a: torch.as_tensor(np.asarray(a)).to(torch.int32) \
        if not isinstance(a, torch.Tensor) else a.to(torch.int32)
    mk_ref = contended(ratom, ratom.Cas, ref_arr)
    mk_port = contended(atomics, atomics.Cas, port_arr)
    budget = 4 * n
    if name == "uncontended":
        table = np.arange(8, dtype=np.int32)
        uidx = np.array([0, 3, 5], np.int32)
        mk_ref = lambda s, o: ratom.Cas(
            ref_arr(uidx), ref_arr([10, 13, 15]), expected=ref_arr(uidx))
        mk_port = lambda s, o: atomics.Cas(
            port_arr(uidx), port_arr([10, 13, 15]), expected=port_arr(uidx))
    elif name == "exhausted":
        budget = 5
    elif name == "give_up":
        base_r, base_p = mk_ref, mk_port
        mk_ref = lambda s, o: None if s is not None and len(s) <= n - 3 \
            else base_r(s, o)
        mk_port = lambda s, o: None if s is not None and len(s) <= n - 3 \
            else base_p(s, o)
    elif name == "values_only":
        def values_only(cas, arr):
            def make_ops(slots, observed):
                if slots is None:
                    return cas(arr(idx), arr(np.ones(n, np.int32)),
                               expected=arr(np.zeros(n, np.int32)))
                return arr(observed) + 1
            return make_ops
        mk_ref, mk_port = (values_only(ratom.Cas, ref_arr),
                           values_only(atomics.Cas, port_arr))
    elif name == "faa":
        fidx = np.array([1, 1, 2], np.int32)
        mk_ref = lambda s, o: ratom.Faa(ref_arr(fidx), ref_arr([1, 1, 1]))
        mk_port = lambda s, o: atomics.Faa(port_arr(fidx),
                                           port_arr([1, 1, 1]))
    return table, mk_ref, mk_port, budget


SCENARIOS = [("contended", 1), ("contended", 4), ("contended", 16),
             ("uncontended", 3), ("exhausted", 16), ("give_up", 8),
             ("values_only", 6), ("faa", 3)]


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("scenario,n", SCENARIOS)
def test_local_execute_until_matches_reference(scenario, n, policy):
    table, mk_ref, mk_port, budget = _scenario(scenario, n)
    p_ref, p_port = _policies(policy)
    slept_ref, slept_port = [], []
    want = ratom.execute_until(ratom.AtomicTable(jnp.asarray(table)),
                               mk_ref, max_rounds=budget, policy=p_ref,
                               sleep_fn=slept_ref.append)
    got = atomics.execute_until(atomics.AtomicTable(torch.from_numpy(table)),
                                mk_port, max_rounds=budget, policy=p_port,
                                sleep_fn=slept_port.append)
    assert got.n_rounds == want.n_rounds
    assert slept_port == slept_ref
    for f in ("rounds", "fetched", "success", "pending"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.table.data.numpy(),
                                  np.asarray(want.table.data))
    if scenario == "contended":
        assert got.pending.size == 0 and got.n_rounds <= budget
        if policy != "shrink":
            assert got.n_rounds <= n


def test_validation_errors_as_reference():
    t = atomics.AtomicTable(torch.zeros(4, dtype=torch.int32))
    _, _, mk, _ = _scenario("contended", 2)
    with pytest.raises(ValueError, match="max_rounds"):
        atomics.execute_until(t, mk, max_rounds=0)
    with pytest.raises(ValueError, match="unknown retry policy"):
        atomics.execute_until(t, mk, policy="warp-speed")
    with pytest.raises(TypeError, match="op batch"):
        atomics.execute_until(t, lambda s, o: "nope", max_rounds=2)
    with pytest.raises(ValueError, match="factor"):
        atomics.ShrinkBatch(factor=0.0)
    assert atomics.ShrinkBatch(min_batch=0).min_batch == 1
    assert set(atomics.POLICIES) == set(ratom.POLICIES)
    for p in atomics.POLICIES.values():
        assert isinstance(p(), atomics.RetryPolicy)


N_SHARDED, M_SHARDED = 16, 32


@pytest.fixture(scope="module")
def sharded():
    worker = os.path.join(HERE, "_torch_sharded_worker.py")
    return ranks.launch(f"{worker}:run_retry", 8,
                        mesh=((2, 4), ("pod", "dev")),
                        args=(N_SHARDED, M_SHARDED, POLICY_NAMES),
                        device="cpu", timeout=300)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_sharded_round_history_equals_local(sharded, policy):
    local = atomics.execute_until(
        atomics.make_table(M_SHARDED, torch.int32, device="cpu"),
        _scenario("contended", N_SHARDED)[2], max_rounds=4 * N_SHARDED,
        policy=policy, sleep_fn=lambda s: None)
    for rank, res in enumerate(sharded):
        got = res[policy]
        assert got["n_rounds"] == local.n_rounds, rank
        for f in ("rounds", "fetched", "success", "pending"):
            np.testing.assert_array_equal(got[f], getattr(local, f),
                                          err_msg=f"rank {rank} {f}")
        np.testing.assert_array_equal(got["shards"],
                                      local.table.data.numpy())
        assert got["pending"].size == 0
        if policy != "shrink":
            assert got["n_rounds"] <= N_SHARDED
            assert sorted(got["rounds"].tolist()) == \
                list(range(1, N_SHARDED + 1))
