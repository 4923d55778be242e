"""Elastic migration against full replay, predicted and measured.

Port of `benchmarks/reshard.py`.  Ownership is a pure function of (slot,
extent) (`repro_torch.atomics.reshard`), so moving a table to a new mesh
costs one slot exchange whatever the history that built it, while the only
alternative, replaying that history through the sharded tier on the new
mesh, grows with it.  One world of 4 ranks (`launch.ranks`; on the card,
4 ranks sharing it over gloo) measures both:

  migrate/device_put   the fleet changes: 2 -> 4 ranks (``grow_2to4``)
  migrate/exchange     the same 4 ranks, (pod, dev)-sharded -> dev-sharded
                       with pod replicas (``refleet``), beside device_put;
                       both paths run, and ``auto_path`` is the one the
                       model picks (on the card's priors, device_put below
                       2^19 slots on this mesh)
  replay               the recorded history (4 FAA batches) re-executed
                       through `atomics.execute` on the new mesh

Each migrated table is checked slot for slot against the replay (and the
exchange against device_put) on every rank before it is timed.  Predicted
times come from the migration tier of the cost model (`cost_migrate_*`,
`cost_replay`) over the device's spec.  The acceptance row: migration
beats replay on every table of >= 64K slots (`GATE_SLOTS`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.atomics import reshard
from repro_torch.atomics.layout import TableLayout
from repro_torch.benchmarks.common import Csv, time_s

#: acceptance gate: migration must beat replay from this table size up
GATE_SLOTS = 1 << 16
WORLD, MESH = 4, ((2, 2), ("pod", "dev"))
N_BATCHES = 4


def shard_of(mesh, full: torch.Tensor, axis, rep=()) -> atomics.AtomicTable:
    """This rank's shard of the whole table ``full`` under ``mesh`` (empty
    outside it)."""
    lay = TableLayout.from_mesh(mesh, num_slots=full.shape[0],
                                dtype=full.dtype, axis=axis,
                                replica_axes=rep)
    data = full[:0]
    if mesh.is_member:
        data = full[slice(*lay.rows_of_shard(lay.shard_of_device(
            mesh.flat)))]
    return atomics.AtomicTable(data.clone(), axis=axis, replica_axes=rep,
                               mesh=mesh)


def run_history(table: atomics.AtomicTable, history,
                need_fetched: bool = True) -> atomics.AtomicTable:
    """The FAA batches of ``history`` (each ``(idx, vals)``, one row a
    rank by flat index on the table's mesh) through `atomics.execute` on
    the mesh's members."""
    mesh = table.mesh
    if not mesh.is_member:
        return table
    for idx, vals in history:
        table = atomics.execute(table, atomics.Faa(idx[mesh.flat],
                                                   vals[mesh.flat]),
                                need_fetched=need_fetched).table
    return table


def everywhere(mesh, ok: bool) -> bool:
    """True iff ``ok`` holds on every rank of the world."""
    flag = torch.tensor([int(ok)], dtype=torch.int32)
    return bool(mesh.all_gather_world(flag).min())


def _rank(mesh, device: str, fast: bool) -> List[Dict]:
    """One rank of the suite's world; returns rank 0's rows."""
    from repro_torch.core import rmw_engine
    from repro_torch.launch.mesh import Mesh
    dev = torch.device(device)
    mesh.probe(dev)
    rng = np.random.default_rng(42)          # the same history everywhere
    spec = rmw_engine.default_spec(dev)
    n_per = 1024 if fast else 4096
    grid = (4096,) if fast else (4096, 65536, 262144)
    mesh2 = Mesh((2,), ("dev",), ranks=range(2))
    mesh4 = Mesh((4,), ("dev",))

    def history(k, m):
        return [(torch.from_numpy(rng.integers(0, m, (k, n_per)).astype(
            np.int32)).to(dev), torch.from_numpy(rng.integers(
                -3, 4, (k, n_per)).astype(np.int32)).to(dev))
            for _ in range(N_BATCHES)]

    rows = []
    n_ops = N_BATCHES * n_per
    for m in grid:                            # cell 1: 2 -> 4 ranks
        hist = history(2, m)
        tab0 = torch.zeros((m,), dtype=torch.int32, device=dev)
        built = run_history(shard_of(mesh2, tab0, "dev"), hist)
        src = reshard.live_layout(built)
        dst = TableLayout.from_mesh(mesh4, num_slots=m, dtype=torch.int32,
                                    axis="dev")
        plan = reshard.plan_reshard(src, dst, dst_mesh=mesh4,
                                    src_mesh=mesh2, device=dev)
        resplit = [(i.reshape(WORLD, -1), v.reshape(WORLD, -1))
                   for i, v in hist]

        def replay():
            return run_history(shard_of(mesh4, tab0, "dev"), resplit).data

        same = everywhere(mesh, torch.equal(plan.execute(built).data,
                                            replay()))
        t_mig = time_s(lambda: plan.execute(built).data, warmup=1,
                       device=dev)
        t_rep = time_s(replay, warmup=1, device=dev)
        rows.append(dict(
            cell="grow_2to4", path=plan.path, m=m, history_ops=n_ops * 2,
            migrate_us=t_mig * 1e6, replay_us=t_rep * 1e6,
            speedup_vs_replay=t_rep / t_mig, bit_identical=same,
            predicted_migrate_us=plan.predicted_s[plan.path] * 1e6,
            predicted_replay_us=reshard.cost_replay(
                spec, dst, n_ops * 2, n_batches=N_BATCHES,
                device_type=dev.type) * 1e6))
    for m in grid:                            # cell 2: the same 4 ranks
        tab0 = torch.zeros((m,), dtype=torch.int32, device=dev)
        built = run_history(shard_of(mesh, tab0, ("pod", "dev")),
                            history(WORLD, m))
        src = built.layout()
        dst = TableLayout.from_mesh(mesh, num_slots=m, dtype=torch.int32,
                                    axis=("dev",), replica_axes=("pod",))
        plan, host = (reshard.plan_reshard(src, dst, dst_mesh=mesh,
                                           src_mesh=mesh, path=p, device=dev)
                      for p in ("exchange", "device_put"))
        same = everywhere(mesh, torch.equal(plan.execute(built).data,
                                            host.execute(built).data))
        t_exc = time_s(lambda: plan.execute(built).data, warmup=1,
                       device=dev)
        t_put = time_s(lambda: host.execute(built).data, warmup=1,
                       device=dev)
        rows.append(dict(
            cell="refleet", path=plan.path, m=m,
            auto_path=min(plan.predicted_s, key=plan.predicted_s.get),
            history_ops=n_ops * WORLD, migrate_us=t_exc * 1e6,
            device_put_us=t_put * 1e6, speedup_vs_device_put=t_put / t_exc,
            bit_identical=same,
            predicted_migrate_us=plan.predicted_s[plan.path] * 1e6,
            predicted_device_put_us=plan.predicted_s["device_put"] * 1e6))
    return rows


def run(csv: Csv, fast: bool = False, device="cuda") -> Dict[str, object]:
    from repro_torch.launch import ranks
    rows = ranks.launch("repro_torch.benchmarks.reshard:_rank", WORLD,
                        mesh=MESH, args=(str(device), fast), device=str(
                            torch.device(device).type), timeout=900)[0]
    for r in rows:
        csv.add(f"reshard.{r['cell']}.m{r['m']}.migrate/{r['path']}",
                r["migrate_us"],
                f"pred={r['predicted_migrate_us']:.0f}us "
                f"bit_identical={r['bit_identical']}")
        if "replay_us" in r:
            csv.add(f"reshard.{r['cell']}.m{r['m']}.replay", r["replay_us"],
                    f"pred={r['predicted_replay_us']:.0f}us "
                    f"speedup={r['speedup_vs_replay']:.2f}x")
        else:
            csv.add(f"reshard.{r['cell']}.m{r['m']}.migrate/device_put",
                    r["device_put_us"],
                    f"pred={r['predicted_device_put_us']:.0f}us "
                    f"bit_identical={r['bit_identical']} "
                    f"auto={r['auto_path']}")
    if not all(r["bit_identical"] for r in rows):
        raise AssertionError(f"a migrated table differs: {rows}")
    gated = [r for r in rows
             if r["cell"] == "grow_2to4" and r["m"] >= GATE_SLOTS]
    acceptance = bool(gated) and all(r["speedup_vs_replay"] > 1.0
                                     for r in gated)
    csv.add("reshard.acceptance_migration_beats_replay_ge_64k_slots", 0.0,
            f"{acceptance} (gated cells: {len(gated)})")
    return {"rows": rows, "gate_slots": GATE_SLOTS,
            "acceptance_migration_beats_replay_ge_64k_slots": acceptance}
