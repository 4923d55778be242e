"""Elastic scaling: move state onto a different mesh.

Port of `repro.runtime.elastic`.  When ranks are lost (or added), the run
restarts on a new mesh.  A checkpoint stores the whole table on the host
with its layout, so restoring is placement under the *new* mesh, with no
dependence on the writer's topology (:func:`reshard_restore`).  Live
tables — no checkpoint in the loop — migrate with :func:`reshard_tables`
(`atomics.reshard.migrate` over a state tree), which the recovery loop
(`runtime.fault_tolerance`) calls on an elastic restart.
:func:`survivors_mesh` builds the smaller mesh after a loss.

Each step down :func:`reshard_tables`' degradation ladder is logged and
counted in `DEGRADED`, so a caller (the card's smoke run) can require
that none happened: a step down must never hide a broken path.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict

import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.atomics.table import AtomicTable
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch.mesh import Mesh, use_mesh

log = logging.getLogger("repro_torch.runtime")

#: steps down `reshard_tables`' ladder since `reset_degraded`: to the
#: ``device_put`` path, and to a ``local`` handle
DEGRADED: Dict[str, int] = {"device_put": 0, "local": 0}


def reset_degraded() -> None:
    for k in DEGRADED:
        DEGRADED[k] = 0


def _is_table(x) -> bool:
    return isinstance(x, AtomicTable)


def reshard_restore(ckpt_dir: str, step: int, like: Any, new_mesh: Mesh):
    """Restore ``like``-structured state under ``new_mesh``.

    `AtomicTable` leaves restore through `atomics.reshard.restore_table`
    under the new mesh (each rank keeps its shard); every other leaf lands
    whole on every rank, on its ``like`` tensor's device — the reference's
    placement for a leaf with no matching sharding.  The reference's
    per-parameter shardings (``cfg``, ``rules``) wait for the port's
    training stack.  Returns ``(state, extra)``.
    """
    with use_mesh(new_mesh):
        return ckpt_lib.restore(ckpt_dir, step, like)


def reshard_tables(state: Any, new_mesh: Mesh, *, path: str = "auto",
                   spec=None) -> Any:
    """Migrate every live sharded `AtomicTable` in a state tree onto
    ``new_mesh`` (every rank of the world calls it); other leaves pass
    through untouched.

    Degradation ladder, per table: the requested path (the in-collective
    ``exchange`` under ``"auto"`` when the ranks are unchanged) -> the
    ``device_put`` path -> a **local handle** holding the whole table (the
    contract dropped).  The data is bit-identical on every rung; each step
    down is logged and counted in `DEGRADED`.  The ranks must fail alike
    for the ladder to hold: a path that raises on one rank only leaves the
    others waiting in its collective.
    """
    from repro_torch.atomics import reshard as reshard_lib

    def one(x):
        if not _is_table(x) or not x.is_sharded:
            return x
        try:
            return reshard_lib.migrate(x, new_mesh, path=path, spec=spec)
        except Exception as e:  # noqa: BLE001 — mid-recovery, degrade
            log.warning("table migration (path=%s) onto %s failed (%s: %s); "
                        "degrading to device_put", path, new_mesh,
                        type(e).__name__, e)
        if path != "device_put":
            DEGRADED["device_put"] += 1
            try:
                return reshard_lib.migrate(x, new_mesh, path="device_put",
                                           spec=spec)
            except Exception as e:  # noqa: BLE001
                log.warning("device_put migration failed too (%s: %s); "
                            "degrading to a local handle",
                            type(e).__name__, e)
        DEGRADED["local"] += 1
        layout = reshard_lib.live_layout(x)
        return AtomicTable(reshard_lib.gather_table(x.data, layout, x.mesh))

    return tree_util.tree_map(one, state, is_leaf=_is_table)


def survivors_mesh(axis_sizes: Dict[str, int], lost_data_shards: int = 0,
                   *, axis: str = "data") -> Mesh:
    """The post-failure mesh: ``axis`` (the reference's ``data``) shrunk by
    the lost shards, over the world's first ranks (``jax.make_mesh`` takes
    the first devices).  Every rank of the world calls it."""
    sizes = dict(axis_sizes)
    sizes[axis] = sizes.get(axis, 1) - lost_data_shards
    if sizes[axis] < 1:
        raise ValueError(f"no {axis} shards left")
    names = tuple(sizes)
    shape = tuple(sizes[n] for n in names)
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {sizes} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return Mesh(shape, names, ranks=range(n))
