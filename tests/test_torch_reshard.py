"""The port's elastic migration against the reference.

In-process: the migration cost tier, `plan_reshard`'s path and
predictions equal the reference's floats for the same layouts and spec;
plan validation errors; `restore_table` without an active mesh.

One module-scoped world of 8 gloo CPU ranks (`_torch_elastic_worker.py`,
which imports no JAX) runs the reference test's cases
(`tests/test_reshard.py`): grow 2 -> 4 and shrink 4 -> 2 with every op,
per-op-expected CAS included; the round trip 2 -> 4 -> 2; a replica-axis
change through the exchange path (and onto the ranks in reverse order);
checkpoint restore under another mesh (`ckpt.restore` under `use_mesh`,
and `elastic.reshard_restore`); `elastic.reshard_tables` over a state
tree.  Batches include out-of-range slots (dropped).  Every table,
fetched value and success flag is held bit for bit against the
reference's `repro.core.rmw.rmw_serialized` over the same history and
batches, in the mesh's rank order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.atomics import reshard as rreshard
from repro.atomics.layout import TableLayout as RLayout
from repro.core import perf_model as rpm
from repro.core.rmw import rmw_serialized
from repro_torch import atomics
from repro_torch.atomics import reshard as treshard
from repro_torch.atomics.layout import TableLayout as TLayout
from repro_torch.core import perf_model as tpm
from repro_torch.launch import ranks

HERE = os.path.dirname(os.path.abspath(__file__))
M, N = 64, 24


# ---------------------------------------------------------------------------
# in-process: the migration cost tier against the reference's floats
# ---------------------------------------------------------------------------

def _lays(axis=("pod", "dev"), rep=(), m=64, mesh=(("pod", 2), ("dev", 4))):
    kw = dict(num_slots=m, dtype="int32", axis=axis, replica_axes=rep,
              mesh_axes=mesh)
    return RLayout(**kw), TLayout(**kw)


# (source axis, destination axis, destination replicas, slots, mesh)
PAIRS = [
    (("pod", "dev"), ("dev",), ("pod",), 64, (("pod", 2), ("dev", 4))),
    (("pod", "dev"), ("dev",), (), 1 << 16, (("pod", 2), ("dev", 4))),
    (("dev",), ("dev",), (), 1 << 18, (("dev", 4),)),
    (("pod", "dev"), ("dev",), ("pod",), 1 << 24, (("pod", 2), ("dev", 2))),
]


def _specs():
    return [("cpu", rpm.cpu_default_spec(), tpm.cpu_default_spec()),
            ("tpu", rpm.TPU_V5E, tpm.TPU_V5E)]


@pytest.mark.parametrize("spec", _specs(), ids=lambda s: s[0])
@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_migration_costs_equal_reference(spec, pair):
    _, rs, ts = spec
    src_axis, dst_axis, rep, m, mesh = PAIRS[pair]
    rsrc, tsrc = _lays(src_axis, m=m, mesh=mesh)
    rdst, tdst = _lays(dst_axis, rep, m=m, mesh=mesh)
    for name in rreshard.MIGRATION_COSTS:
        assert treshard.MIGRATION_COSTS[name](ts, tsrc, tdst) == \
            rreshard.MIGRATION_COSTS[name](rs, rsrc, rdst), name
    for feasible in (True, False):
        assert treshard.select_migration(
            tsrc, tdst, exchange_feasible=feasible, spec=ts) == \
            rreshard.select_migration(rsrc, rdst,
                                      exchange_feasible=feasible, spec=rs)
    for n_ops, n_batches, nf in ((4 * 4096 * 4, 4, True),
                                 (1 << 22, 1, False)):
        assert treshard.cost_replay(
            ts, tdst, n_ops, n_batches=n_batches, need_fetched=nf,
            device_type="cpu") == rreshard.cost_replay(
            rs, rdst, n_ops, n_batches=n_batches, need_fetched=nf)


@pytest.mark.parametrize("spec", _specs(), ids=lambda s: s[0])
@pytest.mark.parametrize("live", [True, False])
def test_plan_reshard_path_and_predictions_equal_reference(spec, live):
    """Same member set on both sides (so `exchange` is feasible when the
    source is live), then a fleet change (device_put only)."""
    _, rs, ts = spec
    rsrc, tsrc = _lays()
    rdst, tdst = _lays(("dev",), ("pod",))

    class _RMesh:                     # the reference reads .devices.flat
        def __init__(self, devs):
            self.devices = np.array(devs)

    class _TMesh:                     # the port reads .ranks
        def __init__(self, ranks):
            self.ranks = tuple(ranks)

    for r_dst, t_dst in ((_RMesh(range(8)), _TMesh(range(8))),
                         (_RMesh(range(4)), _TMesh(range(4)))):
        want = rreshard.plan_reshard(rsrc, rdst, dst_mesh=r_dst,
                                     src_mesh=_RMesh(range(8)), live=live,
                                     spec=rs)
        got = treshard.plan_reshard(tsrc, tdst, dst_mesh=t_dst,
                                    src_mesh=_TMesh(range(8)), live=live,
                                    spec=ts)
        assert got.path == want.path
        assert got.predicted_s == want.predicted_s


def test_migration_model_beats_replay_at_64k_slots():
    """The reference's model-level mirror of its benchmark gate, on the
    port's cost tier with the card's priors too."""
    for spec in (tpm.cpu_default_spec(), tpm.H100):
        for m in (1 << 16, 1 << 18):
            lay = TLayout(num_slots=m, dtype="int32", axis=("dev",),
                          mesh_axes=(("dev", 4),))
            mig = treshard.cost_migrate_device_put(spec, lay, lay)
            rep = treshard.cost_replay(spec, lay, 4 * 4096 * 4,
                                       n_batches=4,
                                       device_type="cpu")
            assert mig < rep * 0.5, (spec.name, m, mig, rep)


def test_plan_reshard_validation():
    _, src = _lays()
    _, dst = _lays(m=128)
    with pytest.raises(ValueError, match="slot-count"):
        treshard.plan_reshard(src, dst, dst_mesh=None)
    _, dev = _lays(("dev",))
    with pytest.raises(ValueError, match="unknown path"):
        treshard.plan_reshard(src, dev, dst_mesh=None, path="teleport")
    with pytest.raises(ValueError, match="same device set"):
        treshard.plan_reshard(src, dev, dst_mesh=None, live=False,
                              path="exchange")


def test_restore_table_meshless_falls_back_local():
    host = np.arange(8, dtype=np.int32)
    like = atomics.AtomicTable(torch.zeros(8, dtype=torch.int32),
                               axis="model")
    tbl = treshard.restore_table(host, like=like)
    assert tbl.axis is None and tbl.device.type == "cpu"
    np.testing.assert_array_equal(tbl.data.numpy(), host)
    tbl2 = treshard.restore_table(host, meta={"axis": ["model"]},
                                  device="cpu")
    assert tbl2.axis is None
    np.testing.assert_array_equal(tbl2.data.numpy(), host)


# ---------------------------------------------------------------------------
# one world of 8 gloo CPU ranks for every migration case
# ---------------------------------------------------------------------------

def _batch(rng, k, n=N, cas=False):
    idx = rng.integers(-2, M + 3, (k, n)).astype(np.int32)  # OOR both sides
    vals = rng.integers(-3, 4, (k, n)).astype(np.int32)
    exps = rng.integers(-1, 2, (k, n)).astype(np.int32) if cas else None
    return idx, vals, exps


def _resplit(batch, k):
    return tuple(None if a is None else a.reshape(k, -1) for a in batch)


def _tab0(rng):
    return rng.integers(-1, 2, M).astype(np.int32)


def _cases(tmp):
    rng = np.random.default_rng(11)
    out = []
    for tag, src, dst, k_from, k_to, ops in (
            ("grow", "dev2", "dev4", 2, 4, ("faa", "swp", "min", "cas")),
            ("shrink", "dev4", "dev2", 4, 2, ("faa", "max", "cas"))):
        for op in ops:
            a = _batch(rng, k_from, cas=op == "cas")
            b = _batch(rng, k_to, cas=op == "cas")
            out.append(dict(name=f"{tag}/{op}", kind="resize", op=op,
                            src=src, dst=dst, tab0=_tab0(rng),
                            batches=(a, b), resplit=_resplit(a, k_to)))
    for op in ("faa", "swp", "min", "max", "cas"):
        a, b, c = (_batch(rng, k, cas=op == "cas") for k in (2, 4, 2))
        out.append(dict(name=f"roundtrip/{op}", kind="roundtrip", op=op,
                        tab0=_tab0(rng), batches=(a, b, c),
                        b_on_2=_resplit(b, 2)))
    out.append(dict(name="exchange", kind="exchange", tab0=_tab0(rng),
                    batches=(_batch(rng, 8, 16), _batch(rng, 8, 16))))
    out.append(dict(name="checkpoint", kind="checkpoint",
                    tab0=rng.integers(-9, 9, M).astype(np.int32),
                    dir=str(tmp / "ckpt")))
    out.append(dict(name="elastic", kind="elastic",
                    tab0=np.arange(M, dtype=np.int32)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases(tmp_path_factory.mktemp("reshard"))
    out = ranks.launch(
        f"{os.path.join(HERE, '_torch_elastic_worker.py')}:run_elastic", 8,
        mesh=((2, 4), ("pod", "dev")), args=(cases,), device="cpu",
        timeout=300)
    return {c["name"]: c for c in cases}, out


def oracle(table, batch, op):
    """The reference's `rmw_serialized` over a batch's rows in order, with
    out-of-range ops dropped (fetched 0, success False)."""
    idx, vals, exps = (None if a is None else a.reshape(-1) for a in batch)
    valid = (idx >= 0) & (idx < M)
    pad = jnp.concatenate([jnp.asarray(table), jnp.zeros((1,), jnp.int32)])
    ref = rmw_serialized(pad, jnp.asarray(np.where(valid, idx, M)),
                         jnp.asarray(vals), op,
                         None if exps is None else jnp.asarray(exps))
    return (np.asarray(ref.table)[:M],
            np.where(valid, np.asarray(ref.fetched), 0),
            np.asarray(ref.success) & valid)


def _shards_equal(results, key, want, layout, what):
    """Every member's shard of ``key`` equals its rows of ``want``, and
    every rank of the layout's mesh holds one."""
    seen = 0
    for rank, res in enumerate(results):
        if res[key] is None:
            continue
        flat, data = res[key]
        rows = slice(*layout.rows_of_shard(layout.shard_of_device(flat)))
        np.testing.assert_array_equal(data, want[rows],
                                      err_msg=f"{what}: rank {rank}")
        seen += 1
    assert seen == np.prod([s for _, s in layout.mesh_axes]), what


def _dev_layout(k):
    return TLayout(num_slots=M, dtype="int32", axis=("dev",),
                   mesh_axes=(("dev", k),))


def _by_flat(results, name, shard_key, key):
    """Per-member (fetched, success) concatenated by flat index."""
    got = [(r[name][shard_key][0], r[name][key]) for r in results
           if r[name][key] is not None]
    got.sort(key=lambda x: x[0])
    return (np.concatenate([g[1][0] for g in got]),
            np.concatenate([g[1][1] for g in got]))


@pytest.mark.parametrize("name", [f"grow/{op}" for op in
                                  ("faa", "swp", "min", "cas")]
                         + [f"shrink/{op}" for op in ("faa", "max", "cas")])
def test_resize_matches_oracle_and_replay(world, name):
    cases, out = world
    c = cases[name]
    k_to = 4 if name.startswith("grow") else 2
    t1, _, _ = oracle(c["tab0"], c["batches"][0], c["op"])
    t2, f2, s2 = oracle(t1, c["batches"][1], c["op"])
    lay = _dev_layout(k_to)
    results = [r[name] for r in out]
    _shards_equal(results, "migrated", t1, lay, f"{name} migrated")
    _shards_equal(results, "replay", t1, lay, f"{name} replayed")
    _shards_equal(results, "final", t2, lay, f"{name} after batch B")
    fetched, success = _by_flat(out, name, "final", "fetched")
    np.testing.assert_array_equal(fetched, f2)
    np.testing.assert_array_equal(success, s2)


@pytest.mark.parametrize("op", ["faa", "swp", "min", "max", "cas"])
def test_grow_then_shrink_roundtrip_bit_identical(world, op):
    cases, out = world
    name = f"roundtrip/{op}"
    c = cases[name]
    t1, _, _ = oracle(c["tab0"], c["batches"][0], op)
    t2, _, _ = oracle(t1, c["batches"][1], op)
    t3, f3, s3 = oracle(t2, c["batches"][2], op)
    results = [r[name] for r in out]
    _shards_equal(results, "final", t3, _dev_layout(2), f"{name} migrated")
    _shards_equal(results, "never", t3, _dev_layout(2), f"{name} never")
    for key, sk in (("fetched", "final"), ("never_fetched", "never")):
        fetched, success = _by_flat(out, name, sk, key)
        np.testing.assert_array_equal(fetched, f3, err_msg=key)
        np.testing.assert_array_equal(success, s3, err_msg=key)


def test_replica_change_takes_the_exchange_path(world):
    cases, out = world
    c = cases["exchange"]
    results = [r["exchange"] for r in out]
    assert all(r["path"] == "exchange" for r in results)
    pred = results[0]["predicted"]
    assert pred["exchange"] < pred["device_put"]
    rep = TLayout.from_dict(results[0]["layout"])
    assert rep.axis == ("dev",) and rep.replica_axes == ("pod",)
    _shards_equal(results, "exchanged", c["tab0"], rep, "exchanged")
    _shards_equal(results, "device_put", c["tab0"], rep, "device_put")
    _shards_equal(results, "unreplicated", c["tab0"], _lays()[1],
                  "exchange from the replicas back")
    t1, f1, s1 = oracle(c["tab0"], c["batches"][0], "faa")
    _shards_equal(results, "after", t1, rep, "FAA on the replicas")
    fetched, success = _by_flat(out, "exchange", "after", "fetched")
    np.testing.assert_array_equal(fetched, f1)
    np.testing.assert_array_equal(success, s1)
    # onto one dev axis over the ranks in reverse order: lanes by flat index
    assert all(r["reversed_path"] == "exchange" for r in results)
    lay8 = _dev_layout(8)
    _shards_equal(results, "reversed", c["tab0"], lay8, "reversed ranks")
    for rank, r in enumerate(results):
        assert r["reversed"][0] == 7 - rank
    _shards_equal(results, "reversed_back", c["tab0"], _lays()[1],
                  "device_put back from the reversed ranks")
    t2, f2, s2 = oracle(c["tab0"], c["batches"][1], "faa")
    _shards_equal(results, "reversed_after", t2, lay8, "reversed FAA")
    fetched, success = _by_flat(out, "exchange", "reversed_after",
                                "reversed_fetched")
    np.testing.assert_array_equal(fetched, f2)
    np.testing.assert_array_equal(success, s2)


def test_checkpoint_restores_under_another_mesh(world):
    cases, out = world
    c = cases["checkpoint"]
    results = [r["checkpoint"] for r in out]
    assert results[0]["meta"]["axis"] == ["model"]
    assert results[0]["meta"]["mesh_axes"] == [["pod", 2], ["model", 4]]
    lay = TLayout(num_slots=M, dtype="int32", axis=("model",),
                  mesh_axes=(("pod", 4), ("model", 2)))
    _shards_equal(results, "restored", c["tab0"], lay, "restored")
    _shards_equal(results, "reshard_restore", c["tab0"], lay,
                  "elastic.reshard_restore")
    for r in results:
        assert r["axis"] in ("model", ("model",))
        assert r["mesh_shape"] == {"pod": 4, "model": 2}
        np.testing.assert_array_equal(r["w"], np.arange(8.0))
        np.testing.assert_array_equal(r["reshard_restore_w"],
                                      np.arange(8.0))


def test_reshard_tables_moves_state_trees(world):
    cases, out = world
    c = cases["elastic"]
    results = [r["elastic"] for r in out]
    _shards_equal(results, "moved", c["tab0"], _dev_layout(4), "moved")
    for r in results:
        assert r["step"] == 7
        assert r["moved_shape"] == {"dev": 4}
        # 64 slots do not divide over 3 ranks: a local handle, whole
        assert r["local_axis"] is None
        np.testing.assert_array_equal(r["local"], c["tab0"])
        assert r["degraded"] == {"device_put": 0, "local": 0}


def test_ranks_outside_a_mesh_hold_no_shard(world):
    """Ranks 2-7 are outside the 2-rank mesh: their handles were empty
    (`shard` returned None) for every table placed there."""
    _, out = world
    for rank, r in enumerate(out):
        assert (r["grow/faa"]["replay"] is None) == (rank >= 4)
        assert (r["shrink/faa"]["final"] is None) == (rank >= 2)


def test_layouts_round_trip_across_packages():
    rl, tl = _lays(("dev",), ("pod",))
    assert TLayout.from_dict(rl.to_dict()) == tl
    assert tl.to_dict() == rl.to_dict()


def test_reshard_suite_on_the_cpu():
    """`python -m repro_torch.benchmarks.run --device cpu --fast --only
    reshard`: the reference's rows, each migration bit-identical."""
    from repro_torch.benchmarks import run as trun
    csv, results, failures = trun.run_suites(["reshard"], fast=True,
                                             device="cpu")
    assert not failures, failures
    names = [r["name"] for r in csv.rows]
    assert names == ["reshard.grow_2to4.m4096.migrate/device_put",
                     "reshard.grow_2to4.m4096.replay",
                     "reshard.refleet.m4096.migrate/exchange",
                     "reshard.refleet.m4096.migrate/device_put",
                     "reshard.acceptance_migration_beats_replay_ge_64k_slots"]
    rows = results["reshard"]["rows"]
    assert all(r["bit_identical"] for r in rows)
    assert [r["path"] for r in rows] == ["device_put", "exchange"]
    assert rows[1]["auto_path"] in ("exchange", "device_put")
    assert all(r["migrate_us"] > 0 and r["predicted_migrate_us"] > 0
               for r in rows)
