"""The port's sharded tier against the reference, on 8 gloo ranks.

One group of 8 CPU ranks on a 2x4 ``("pod", "dev")`` mesh runs every case
(`_torch_sharded_worker.py`, which imports no JAX), the analogue of the
reference's 8 fake devices.  Each case is held against the reference's
`repro.core.rmw.rmw_serialized` over the ranks' batches concatenated in
arrival order (descending and locally reversed with ``reverse_ranks``):
integer tables, fetched values and success bit for bit, fp32 MIN/MAX/SWP
bit for bit with NaN compared by ``isnan``, fp32 FAA within rtol 1e-5,
atol 1e-5·sqrt(occupancy).  The reference test's case list
(`tests/test_rmw_sharded.py`) comes first, then max, per-op CAS, fp32,
"auto" and contention-stats cases.  Three cases also run through the
reference's own `execute_sharded` in one subprocess with 8 fake devices,
which must give the same tables, fetched values, success and stats.
`bfs_sharded` on the 4 ranks of each pod must equal the port's local
`bfs` (the reference's `bfs_sharded` fails here at `core/bfs.py:211`, so
it is no oracle).  The exchange selector and its cost functions must
equal the reference's floats.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import atomics
from repro_torch.core import bfs as tbfs
from repro_torch.launch import ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NDEV, N_PER, M = 8, 48, 64
MESH = ((2, 4), ("pod", "dev"))
FULL = ("pod", "dev")


def _case(op, strategy, dist, *, need_fetched=True, replicated=False,
          reverse=False, perop=False, dtype="int32", stats=False):
    tag = "cas_perop" if perop else op
    name = (f"{tag}/{strategy}/nf={int(need_fetched)}/{dist}/"
            f"rep={replicated}/rev={reverse}/{dtype}/stats={stats}")
    return dict(name=name, op=op, strategy=strategy, dist=dist,
                need_fetched=need_fetched, replicated=replicated,
                reverse=reverse, perop=perop, dtype=dtype, stats=stats)


def _cases():
    out = []
    # the reference's list (tests/test_rmw_sharded.py:95-105)
    for op in ("faa", "swp", "cas", "min"):
        for strategy in ("oneshot", "hierarchical", "naive"):
            out.append(_case(op, strategy, "hot"))
        out.append(_case(op, "oneshot", "uniform"))
        out.append(_case(op, "oneshot", "uniform", need_fetched=False))
    out.append(_case("faa", "hierarchical", "uniform"))
    out.append(_case("faa", "dense", "hot", need_fetched=False))
    out.append(_case("faa", "dense", "uniform", need_fetched=False))
    for op in ("faa", "swp", "cas"):
        out.append(_case(op, "oneshot", "hot", replicated=True))
    out.append(_case("faa", "dense", "hot", need_fetched=False,
                     replicated=True))
    # ... its reverse_ranks list (:152-158)
    for strategy in ("oneshot", "hierarchical", "naive"):
        out.append(_case("swp", strategy, "uniform", reverse=True))
    out.append(_case("faa", "oneshot", "uniform", reverse=True))
    out.append(_case("cas", "oneshot", "uniform", reverse=True))
    out.append(_case("swp", "oneshot", "uniform", replicated=True,
                     reverse=True))
    out.append(_case("cas", "oneshot", "uniform", reverse=True, perop=True))
    out.append(_case("cas", "oneshot", "uniform", replicated=True,
                     reverse=True, perop=True))
    # ... and beyond it: max, per-op CAS forward, replicated hierarchical
    for strategy in ("oneshot", "hierarchical", "naive"):
        out.append(_case("max", strategy, "hot"))
    for dist in ("hot", "uniform"):
        out.append(_case("cas", "oneshot", dist, perop=True))
    out.append(_case("cas", "oneshot", "hot", perop=True, replicated=True))
    out.append(_case("min", "hierarchical", "hot", replicated=True))
    out.append(_case("swp", "hierarchical", "hot", reverse=True,
                     replicated=True))
    out.append(_case("cas", "auto", "hot", need_fetched=False))
    out.append(_case("faa", "auto", "uniform"))
    # fp32: MIN/MAX over ±0 and NaN, SWP, uniform CAS, FAA on normals
    for op in ("min", "max"):
        for strategy in ("oneshot", "hierarchical", "naive"):
            out.append(_case(op, strategy, "hot", dtype="float32"))
        out.append(_case(op, "oneshot", "uniform", dtype="float32",
                         replicated=True))
    out.append(_case("swp", "hierarchical", "hot", dtype="float32"))
    out.append(_case("cas", "oneshot", "hot", dtype="float32"))
    out.append(_case("cas", "oneshot", "hot", dtype="float32", perop=True))
    for strategy in ("oneshot", "hierarchical", "naive"):
        out.append(_case("faa", strategy, "hot", dtype="float32"))
    out.append(_case("faa", "dense", "hot", dtype="float32",
                     need_fetched=False))
    # replicated fp32 FAA onto ±inf slots: the reference's replica update
    # table + psum(new - table) gives NaN there; replica 0's broadcast not
    out.append(_case("faa", "oneshot", "inf", dtype="float32",
                     replicated=True))
    out.append(_case("faa", "dense", "inf", dtype="float32",
                     need_fetched=False, replicated=True))
    # contention stats, against the plain occupancy of the whole batch
    # (the first three also against the reference's execute_sharded)
    out.append(_case("faa", "oneshot", "hot", stats=True))
    out.append(_case("cas", "hierarchical", "hot", stats=True))
    out.append(_case("swp", "naive", "hot", stats=True))
    out.append(_case("faa", "hierarchical", "uniform", stats=True))
    out.append(_case("faa", "dense", "uniform", need_fetched=False,
                     stats=True))
    out.append(_case("cas", "oneshot", "hot", perop=True, stats=True))
    out.append(_case("swp", "oneshot", "hot", replicated=True, stats=True))
    return out


CASES = _cases()
#: the cases also run through the reference's `execute_sharded`
DIRECT = tuple(c["name"] for c in CASES if c["stats"])[:3]


def _zeros_and_nans(rng, size):
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.0, np.nan, -np.nan],
                    np.float32)
    return rng.choice(pool, size=size, p=[.25, .25, .12, .12, .12, .07, .07])


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    if c["dist"] in ("hot", "inf"):
        idx = rng.integers(0, M // 8, (NDEV, N_PER))
    else:
        idx = rng.integers(-2, M + 3, (NDEV, N_PER))   # includes OOR
    if c["dtype"] == "int32":
        lo, hi = (-1, 2) if c["op"] == "cas" else (-5, 6)
        vals = rng.integers(lo, hi, (NDEV, N_PER)).astype(np.int32)
        table = rng.integers(-2 if c["op"] != "cas" else -1,
                             3 if c["op"] != "cas" else 2, M)
        table = table.astype(np.int32)
        exps = rng.integers(-1, 2, (NDEV, N_PER)).astype(np.int32)
    elif c["op"] == "faa":
        vals = rng.normal(size=(NDEV, N_PER)).astype(np.float32)
        table = rng.normal(size=M).astype(np.float32)
        if c["dist"] == "inf":
            table[:4] = [np.inf, -np.inf, np.inf, -np.inf]
        exps = np.zeros((NDEV, N_PER), np.float32)
    else:
        vals = _zeros_and_nans(rng, (NDEV, N_PER))
        table = _zeros_and_nans(rng, M)
        exps = _zeros_and_nans(rng, (NDEV, N_PER))
    return dict(c, idx=idx.astype(np.int32), vals=vals, table=table,
                exps=exps, expected=np.zeros((), table.dtype),
                axis="dev" if c["replicated"] else FULL,
                replica_axes="pod" if c["replicated"] else ())


_JAX_DIRECT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import atomics
from repro.sharding import shard_map_compat

mesh = jax.make_mesh((2, 4), ("pod", "dev"))
SPEC = P(("pod", "dev"))
data = np.load(sys.argv[1])
out = {}
for k in range(int(data["n"])):
    op, strategy = str(data[f"op{k}"]), str(data[f"strategy{k}"])
    def fn(t, i, v):
        tbl = atomics.AtomicTable(t, axis=("pod", "dev"))
        if op == "cas":
            aop = atomics.Cas(i[0], v[0], expected=jnp.int32(0))
        else:
            aop = atomics.OP_KINDS[op](i[0], v[0])
        res = atomics.execute(tbl, aop, strategy=strategy,
                              collect_stats=True)
        return (res.table.data, res.fetched[None], res.success[None],
                res.stats)
    stats_spec = atomics.ContentionStats(*([P()] * 8))
    tab, fetched, success, st = jax.jit(shard_map_compat(
        fn, mesh, (SPEC, SPEC, SPEC), (SPEC, SPEC, SPEC, stats_spec)))(
        jnp.asarray(data[f"table{k}"]), jnp.asarray(data[f"idx{k}"]),
        jnp.asarray(data[f"vals{k}"]))
    out[f"table{k}"] = np.asarray(tab)
    out[f"fetched{k}"] = np.asarray(fetched)
    out[f"success{k}"] = np.asarray(success)
    for f in st._fields:
        out[f"{f}{k}"] = np.asarray(getattr(st, f))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 8-rank gloo group for every case, BFS and the selector-free
    checks; the reference's direct cases in a subprocess meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = [_inputs(c, 100 + k) for k, c in enumerate(CASES)]
    by_name = {c["name"]: c for c in cases}
    direct = [by_name[n] for n in DIRECT]
    payload = {"n": len(direct)}
    for k, c in enumerate(direct):
        payload.update({f"op{k}": c["op"], f"strategy{k}": c["strategy"],
                        f"table{k}": c["table"], f"idx{k}": c["idx"],
                        f"vals{k}": c["vals"]})
    np.savez(tmp / "direct_in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_DIRECT, str(tmp / "direct_in.npz"),
         str(tmp / "direct_out.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        worker = os.path.join(HERE, "_torch_sharded_worker.py")
        results = ranks.launch(f"{worker}:run_cases", NDEV, mesh=MESH,
                               args=(cases,), device="cpu", timeout=300)
        src, dst = tbfs.kronecker_graph(scale=10, edgefactor=8, seed=3)
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        root = int(s[0])
        bfs_out = ranks.launch(f"{worker}:run_bfs", NDEV, mesh=MESH,
                               args=(s, d, 1 << 10, root), device="cpu",
                               timeout=300)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    ref = np.load(tmp / "direct_out.npz")
    return dict(cases=by_name, results=results, direct=ref,
                bfs=(s, d, root, bfs_out))


def _oracle(c):
    """The reference's serialized oracle over the batches in arrival order
    (the mesh rank here; descending with ``reverse_ranks``, each batch in
    its local order); out-of-range ops go to a pad row."""
    import jax.numpy as jnp
    from repro.core.rmw import rmw_serialized
    flip = (lambda a: a[::-1]) if c["reverse"] else (lambda a: a)
    idx, vals, exps = (flip(c[k]).reshape(-1)
                       for k in ("idx", "vals", "exps"))
    valid = (idx >= 0) & (idx < M)
    pad = np.concatenate([c["table"], np.zeros(1, c["table"].dtype)])
    exp = None
    if c["op"] == "cas":
        exp = exps if c["perop"] else np.zeros_like(vals)
    res = rmw_serialized(jnp.asarray(pad), jnp.asarray(np.where(valid, idx,
                                                                 M)),
                         jnp.asarray(vals), c["op"],
                         None if exp is None else jnp.asarray(exp))
    fetched = np.where(valid, np.asarray(res.fetched), 0).astype(vals.dtype)
    success = np.asarray(res.success) & valid
    return (np.asarray(res.table)[:M], flip(fetched.reshape(NDEV, N_PER)),
            flip(success.reshape(NDEV, N_PER)))


def _check(got, want, what, c):
    if c["dtype"] == "float32" and c["op"] == "faa":
        occ = np.bincount(np.clip(c["idx"].reshape(-1), 0, M), minlength=M + 1)
        atol = 1e-5 * np.sqrt(max(occ[:M].max(), 1))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=what)
    elif c["dtype"] == "float32":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      want[~nan].view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _shard_rows(c, rank):
    n_shards = 4 if c["replicated"] else NDEV
    shard = rank % 4 if c["replicated"] else rank
    m_loc = M // n_shards
    return slice(shard * m_loc, (shard + 1) * m_loc)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_matches_serialized_oracle(run, name):
    c = run["cases"][name]
    table, fetched, success = _oracle(c)
    for rank, res in enumerate(run["results"]):
        got = res[name]
        _check(got["table"], table[_shard_rows(c, rank)],
               f"{name}: rank {rank} table", c)
        if c["need_fetched"]:
            _check(got["fetched"], fetched[rank],
                   f"{name}: rank {rank} fetched", c)
            np.testing.assert_array_equal(got["success"], success[rank],
                                          err_msg=f"{name}: rank {rank}")


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["stats"]])
def test_sharded_stats_match_whole_batch(run, name):
    """Mesh-global stats on every rank: the occupancy ones equal the plain
    occupancy of the whole batch; per-level ops in = every valid op, and a
    level's reps out are at most its ops in (naive and per-op CAS combine
    nothing)."""
    from repro_torch.atomics.stats import stats_from_occupancy
    c = run["cases"][name]
    idx = torch.from_numpy(c["idx"].reshape(-1)).long()
    valid = (idx >= 0) & (idx < M)
    want = stats_from_occupancy(torch.bincount(idx[valid], minlength=M),
                                int(valid.sum()))
    n_levels = {"dense": 0, "hierarchical": 2}.get(c["strategy"], 1) \
        + (c["replicated"] and c["strategy"] != "dense")
    for rank, res in enumerate(run["results"]):
        st = res[name]["stats"]
        for f in ("n_ops", "distinct_slots", "max_occupancy",
                  "occupancy_hist", "topk_slots", "topk_counts"):
            np.testing.assert_array_equal(st[f], getattr(want, f).numpy(),
                                          err_msg=f"{name}: rank {rank} {f}")
        assert st["level_ops_in"].shape == (n_levels,)
        assert st["level_ops_in"][:1].tolist() == \
            [int(valid.sum())] * min(n_levels, 1)
        assert (st["level_ops_out"] <= st["level_ops_in"]).all()
        if c["strategy"] == "naive" or c["perop"]:
            np.testing.assert_array_equal(st["level_ops_out"],
                                          st["level_ops_in"])


@pytest.mark.parametrize("k", range(len(DIRECT)))
def test_direct_matches_reference_execute_sharded(run, k):
    """The reference's `execute_sharded` (8 fake devices) and the port's
    gloo ranks on the same inputs: per-shard tables, fetched values,
    success and the contention stats, bit for bit."""
    name, ref = DIRECT[k], run["direct"]
    m_loc = M // NDEV
    for rank, res in enumerate(run["results"]):
        got = res[name]
        np.testing.assert_array_equal(
            got["table"], ref[f"table{k}"][rank * m_loc:(rank + 1) * m_loc])
        np.testing.assert_array_equal(got["fetched"], ref[f"fetched{k}"][rank])
        np.testing.assert_array_equal(got["success"], ref[f"success{k}"][rank])
        for f in got["stats"]:
            np.testing.assert_array_equal(got["stats"][f], ref[f"{f}{k}"],
                                          err_msg=f"{name}: rank {rank} {f}")


@pytest.mark.parametrize("op", ["cas", "swp"])
def test_sharded_bfs_matches_local(run, op):
    s, d, root, out = run["bfs"]
    local = tbfs.bfs(s, d, 1 << 10, root=root, op=op, device="cpu")
    assert tbfs.validate_parents(s, d, local.parent, root)
    for rank, res in enumerate(out):
        np.testing.assert_array_equal(res[op], local.parent.numpy(),
                                      err_msg=f"rank {rank}")


def test_live_layout_round_trips(run):
    name = CASES[0]["name"]
    for rank, res in enumerate(run["results"]):
        lay = atomics.TableLayout.from_dict(res[name]["layout"])
        assert lay.num_slots == M and lay.n_shards == NDEV
        assert lay.shard_of_device(rank) == rank
        assert lay.dtype == "int32"


# ---------------------------------------------------------------------------
# misuse errors (no ranks needed)
# ---------------------------------------------------------------------------

def test_sharded_table_without_mesh_raises():
    t = atomics.AtomicTable(torch.zeros(8, dtype=torch.int32), axis="dev")
    with pytest.raises(ValueError, match="no process group"):
        atomics.execute(t, atomics.Faa(torch.tensor([0]), torch.tensor([1])))


@pytest.mark.parametrize("kw", [{"strategy": "oneshot"},
                                {"distinct_slots": 4},
                                {"reverse_ranks": True}])
def test_sharded_only_arguments_on_local_table_raise(kw):
    t = atomics.AtomicTable(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        atomics.execute(t, atomics.Faa(torch.tensor([0]), torch.tensor([1])),
                        **kw)


def test_replica_axes_need_axis():
    with pytest.raises(ValueError, match="replica_axes requires axis"):
        atomics.AtomicTable(torch.zeros(8), replica_axes="pod")
    with pytest.raises(ValueError, match="without a mesh"):
        atomics.make_table(8, device="cpu", replica_axes="pod")


# ---------------------------------------------------------------------------
# the exchange selector and its cost functions, against the reference's
# floats (tests/test_rmw_sharded.py:242-296)
# ---------------------------------------------------------------------------

def _geo_specs():
    from repro.core import perf_model as rpm
    from repro.core.placement import Tier as RTier
    from repro_torch.core import perf_model as tpm
    from repro_torch.core.placement import Tier
    specs = []
    for pm, tier in ((rpm, RTier), (tpm, Tier)):
        base = pm.cpu_default_spec()
        specs.append(dataclasses.replace(
            base, tier_bandwidth_Bps={**base.tier_bandwidth_Bps,
                                      tier.DCN_REMOTE_POD: 1e8},
            collective_launch_s=1e-6))
    return specs


def _axes_pair(outer=2, inner=4):
    from repro.core.placement import Tier as RTier
    from repro.core.rmw_sharded import MeshAxis as RAxis
    from repro_torch.core.collective_model import MeshAxis
    from repro_torch.core.placement import Tier
    return ((RAxis("pod", outer, RTier.DCN_REMOTE_POD),
             RAxis("dev", inner, RTier.ICI_NEIGHBOR)),
            (MeshAxis("pod", outer, Tier.DCN_REMOTE_POD),
             MeshAxis("dev", inner, Tier.ICI_NEIGHBOR)))


SHAPES = [("faa", 65536, 1 << 19, True, None), ("faa", 65536, 4096, True,
                                                 None),
          ("faa", 4096, 1 << 19, True, None), ("faa", 65536, 4096, False,
                                               None),
          ("cas", 65536, 1 << 19, True, 16), ("swp", 1024, 4096, True, None),
          ("min", 65536, 1 << 19, False, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_exchange_costs_equal_reference(shape):
    from repro.core import rmw_sharded as rs
    from repro_torch.core import rmw_sharded as ts
    op, n, m, nf, hint = shape
    rspec, tspec = _geo_specs()
    raxes, taxes = _axes_pair()
    for name in rs.EXCHANGE_COSTS:
        for axes in ((raxes, taxes), (raxes[1:], taxes[1:])):
            want = rs.EXCHANGE_COSTS[name](rspec, op, n, m, axes[0], nf,
                                           distinct_slots=hint)
            got = ts.EXCHANGE_COSTS[name](tspec, op, n, m, axes[1], nf,
                                          distinct_slots=hint,
                                          device_type="cpu")
            assert got == want, (name, shape)
    for naive in (False, True):
        want = rs.select_exchange_with_cost(
            op, n, m, raxes, spec=rspec, need_fetched=nf,
            include_naive=naive, distinct_slots=hint)
        got = ts.select_exchange_with_cost(
            op, n, m, taxes, spec=tspec, need_fetched=nf,
            include_naive=naive, distinct_slots=hint, device="cpu")
        assert got.choice == want.choice and got.costs == want.costs


def test_selector_crossovers_as_reference():
    """The reference's selector tests (:242-283), on the port."""
    from repro_torch.core.rmw_sharded import (cost_exchange_hierarchical,
                                              cost_exchange_naive,
                                              select_exchange)
    _, spec = _geo_specs()
    _, axes = _axes_pair()
    sel = lambda *a, **k: select_exchange(*a, spec=spec, device="cpu", **k)
    assert sel("faa", 65536, 1 << 19, axes) == "hierarchical"
    assert sel("faa", 65536, 4096, axes) == "hierarchical"
    assert sel("faa", 4096, 1 << 19, axes) == "oneshot"
    assert sel("faa", 65536, 1 << 19, axes[1:]) == "oneshot"
    assert sel("faa", 65536, 4096, axes, need_fetched=False) == "dense"
    assert cost_exchange_hierarchical(spec, "faa", 65536, 4096, axes,
                                      device_type="cpu") \
        < cost_exchange_naive(spec, "faa", 65536, 4096, axes,
                              device_type="cpu")
    with pytest.raises(ValueError):
        select_exchange("cas", 1024, 4096, axes, uniform_expected=False)


def test_card_prices_the_kernels_into_selection():
    """On the card the engine passes are priced with the kernels
    (`cost_cuda`, infinite off the card): the combining strategies' costs
    there are finite and no more than the CPU pricing of the same spec."""
    from repro_torch.core import perf_model as tpm
    from repro_torch.core import rmw_sharded as ts
    _, axes = _axes_pair()
    on = ts.select_exchange_with_cost("faa", 1 << 22, 1 << 24, axes,
                                      spec=tpm.H100, device="cuda")
    off = ts.select_exchange_with_cost("faa", 1 << 22, 1 << 24, axes,
                                       spec=tpm.H100, device="cpu")
    for k in ("oneshot", "hierarchical"):
        assert np.isfinite(on.costs[k]) and on.costs[k] <= off.costs[k]
    assert on.costs["dense"] == off.costs["dense"] == float("inf")
