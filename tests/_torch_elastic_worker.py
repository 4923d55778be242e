"""Rank side of `tests/test_torch_reshard.py` (and its card case in
`tests/test_torch_gpu.py`).

Each function runs on every rank of a gloo world started by
`repro_torch.launch.ranks.launch` and returns host arrays for the test
process to hold against the reference: per table, each member rank's
``(flat index, shard)`` and, per batch, its fetched values and success.
It imports the port and numpy only: no JAX, and not the suite's conftest.
"""

import json
import os

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.atomics import reshard
from repro_torch.atomics.layout import TableLayout
from repro_torch.checkpoint import ckpt
from repro_torch.launch.mesh import Mesh, use_mesh
from repro_torch.runtime import elastic


def _np(t):
    return t.detach().cpu().numpy()


def place(mesh, tab0, axis="dev", rep=(), device="cpu"):
    """This rank's shard of the whole table ``tab0`` under ``mesh`` (empty
    outside it)."""
    lay = TableLayout.from_mesh(mesh, num_slots=tab0.shape[0],
                                dtype=tab0.dtype, axis=axis,
                                replica_axes=rep)
    data = np.zeros((0,), tab0.dtype)
    if mesh.is_member:
        data = tab0[slice(*lay.rows_of_shard(lay.shard_of_device(
            mesh.flat)))]
    return atomics.AtomicTable(torch.from_numpy(data.copy()).to(device),
                               axis=axis, replica_axes=rep, mesh=mesh)


def shard(table):
    """``(flat index, shard)`` on a member of the table's mesh, else
    None."""
    if not table.mesh.is_member:
        assert table.data.shape[0] == 0
        return None
    return table.mesh.flat, _np(table.data)


def run_batch(table, op, batch, device="cpu"):
    """One batch (rows by flat index on the table's mesh) through
    `atomics.execute` on its members; returns (table, (fetched, success)
    or None)."""
    mesh = table.mesh
    if not mesh.is_member:
        return table, None
    idx, vals, exps = (None if a is None else
                       torch.from_numpy(a[mesh.flat]).to(device)
                       for a in batch)
    aop = (atomics.Cas(idx, vals, expected=exps) if op == "cas"
           else atomics.OP_KINDS[op](idx, vals))
    res = atomics.execute(table, aop)
    return res.table, (_np(res.fetched), _np(res.success))


def _resize(meshes, c):
    """Grow or shrink: batch A on the source mesh, `migrate`, batch B on
    the destination; and A replayed on the destination from scratch."""
    src, dst = meshes[c["src"]], meshes[c["dst"]]
    tbl = place(src, c["tab0"])
    tbl, _ = run_batch(tbl, c["op"], c["batches"][0])
    mig = reshard.migrate(tbl, dst)
    out = dict(migrated=shard(mig))
    mig, out["fetched"] = run_batch(mig, c["op"], c["batches"][1])
    out["final"] = shard(mig)
    replay, _ = run_batch(place(dst, c["tab0"]), c["op"], c["resplit"])
    out["replay"] = shard(replay)
    return out


def _roundtrip(meshes, c):
    """2 -> 4 -> 2 with a batch on each mesh, beside the same three
    global streams on the 2-rank mesh that never resharded."""
    m2, m4 = meshes["dev2"], meshes["dev4"]
    a, b, cc = c["batches"]
    tbl, _ = run_batch(place(m2, c["tab0"]), c["op"], a)
    tbl, _ = run_batch(reshard.migrate(tbl, m4), c["op"], b)
    tbl, fc = run_batch(reshard.migrate(tbl, m2), c["op"], cc)
    ref, _ = run_batch(place(m2, c["tab0"]), c["op"], a)
    ref, _ = run_batch(ref, c["op"], c["b_on_2"])
    ref, fr = run_batch(ref, c["op"], cc)
    return dict(final=shard(tbl), fetched=fc, never=shard(ref),
                never_fetched=fr)


def _exchange(meshes, c):
    """(pod, dev)-sharded -> dev-sharded with pod replicas on the same
    ranks: the exchange path, against the device_put path; then an FAA
    batch on the replicated table.  And (pod, dev) -> one ``dev`` axis
    over the ranks in reverse order (`migrate`, auto)."""
    mesh = meshes["pod_dev"]
    tbl = place(mesh, c["tab0"], axis=("pod", "dev"))
    src = tbl.layout()
    dst = TableLayout.from_mesh(mesh, num_slots=src.num_slots,
                                dtype=src.dtype, axis=("dev",),
                                replica_axes=("pod",))
    plan = reshard.plan_reshard(src, dst, dst_mesh=mesh, src_mesh=mesh,
                                device="cpu")
    rep = plan.execute(tbl)
    put = reshard.plan_reshard(src, dst, dst_mesh=mesh, src_mesh=mesh,
                               path="device_put").execute(tbl)
    # ... and back: a replicated source, sent by its lowest holder only
    back = reshard.plan_reshard(dst, src, dst_mesh=mesh, src_mesh=mesh,
                                path="exchange").execute(rep)
    out = dict(path=plan.path, predicted=plan.predicted_s,
               exchanged=shard(rep), device_put=shard(put),
               unreplicated=shard(back), layout=rep.layout().to_dict())
    rep, out["fetched"] = run_batch(rep, "faa", c["batches"][0])
    out["after"] = shard(rep)
    rev = reshard.migrate(tbl, meshes["dev8_reversed"])
    out["reversed_path"] = reshard.plan_reshard(
        src, rev.layout(), dst_mesh=rev.mesh, src_mesh=mesh).path
    out["reversed"] = shard(rev)
    # ... and back by device_put, gathering from the reversed ranks
    out["reversed_back"] = shard(reshard.plan_reshard(
        rev.layout(), src, dst_mesh=mesh, src_mesh=rev.mesh,
        path="device_put").execute(rev))
    rev, out["reversed_fetched"] = run_batch(rev, "faa", c["batches"][1])
    out["reversed_after"] = shard(rev)
    return out


def _checkpoint(meshes, c):
    """A table sharded over ``model`` on a (2, 4) mesh, saved; restored
    under a (4, 2) mesh through `ckpt.restore` and `use_mesh`."""
    mesh_a, mesh_b = meshes["pod_model_2x4"], meshes["pod_model_4x2"]
    tbl = place(mesh_a, c["tab0"], axis="model")
    ckpt.save(c["dir"], 3, {"w": torch.arange(8.0), "counters": tbl})
    with open(os.path.join(c["dir"], "step-00000003",
                           "manifest.json")) as f:
        meta, = json.load(f)["atomic_tables"].values()
    like = {"w": torch.zeros(8),
            "counters": atomics.make_table(c["tab0"].shape[0], torch.int32,
                                           device="cpu", mesh=mesh_b,
                                           axis="model")}
    with use_mesh(mesh_b):
        restored, _ = ckpt.restore(c["dir"], 3, like)
    rt = restored["counters"]
    via_elastic, _ = elastic.reshard_restore(c["dir"], 3, like, mesh_b)
    return dict(meta=meta, restored=shard(rt), axis=rt.axis,
                mesh_shape=dict(rt.mesh.shape), w=_np(restored["w"]),
                reshard_restore=shard(via_elastic["counters"]),
                reshard_restore_w=_np(via_elastic["w"]))


def _elastic(meshes, c):
    """`reshard_tables` over a state tree (2 -> 4), and a migration onto
    3 ranks, which 64 slots do not divide: a local handle."""
    elastic.reset_degraded()
    live = {"step": torch.tensor(7),
            "tbl": place(meshes["dev2"], c["tab0"])}
    moved = elastic.reshard_tables(live, meshes["dev4"])
    loc = reshard.migrate(place(meshes["dev2"], c["tab0"]), meshes["dev3"])
    return dict(step=int(moved["step"]), moved=shard(moved["tbl"]),
                moved_shape=dict(moved["tbl"].mesh.shape),
                local_axis=loc.axis, local=_np(loc.data),
                degraded=dict(elastic.DEGRADED))


def run_elastic(mesh, cases):
    """Every case on this rank of an 8-rank world (``mesh``: its 2x4
    ``("pod", "dev")`` mesh); the other meshes are built here, by every
    rank in the same order."""
    meshes = {"pod_dev": mesh,
              "dev2": Mesh((2,), ("dev",), ranks=range(2)),
              "dev4": Mesh((4,), ("dev",), ranks=range(4)),
              "dev3": Mesh((3,), ("dev",), ranks=range(3)),
              "dev8_reversed": Mesh((8,), ("dev",), ranks=range(7, -1, -1)),
              "pod_model_2x4": Mesh((2, 4), ("pod", "model")),
              "pod_model_4x2": Mesh((4, 2), ("pod", "model"))}
    kinds = {"resize": _resize, "roundtrip": _roundtrip,
             "exchange": _exchange, "checkpoint": _checkpoint,
             "elastic": _elastic}
    return {c["name"]: kinds[c["kind"]](meshes, c) for c in cases}


def run_card_exchange(mesh, m):
    """Two ranks sharing the card: a table sharded over ``dev`` moves by
    the exchange path onto the same two ranks in reverse order, then takes
    one FAA batch through the card's kernels."""
    from repro_torch.kernels.rmw import kernel as K
    dev = torch.device("cuda")
    staged = mesh.probe(dev)
    rng = np.random.default_rng(9)
    tab0 = rng.integers(-9, 9, m).astype(np.int32)
    idx = rng.integers(-2, m + 3, (2, m)).astype(np.int32)
    vals = rng.integers(-3, 4, (2, m)).astype(np.int32)
    rev = Mesh((2,), ("dev",), ranks=(1, 0))
    tbl = place(mesh, tab0, device=dev)
    src = tbl.layout()
    plan = reshard.plan_reshard(src, TableLayout.from_mesh(
        rev, num_slots=m, dtype=torch.int32, axis="dev"), dst_mesh=rev,
        src_mesh=mesh)
    moved = plan.execute(tbl)
    K.reset_launches()
    after, fetched = run_batch(moved, "faa", (idx, vals, None), device=dev)
    return dict(inputs=(tab0, idx, vals), path=plan.path,
                host_staged=staged, moved=shard(moved), after=shard(after),
                fetched=fetched, launches=dict(K.LAUNCHES))
