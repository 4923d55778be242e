"""Elastic scaling: move state onto a different mesh.

Port of `repro.runtime.elastic`.  When ranks are lost (or added), the run
restarts on a new mesh.  A checkpoint stores every leaf whole on the host
(a table with its layout), so restoring is placement under the *new* mesh,
with no dependence on the writer's topology (:func:`reshard_restore`,
:func:`placement`): each rank keeps its block of every parameter by
`launch.shardings.params_shardings`, of a table by its own contract.  Live
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
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.atomics.table import AtomicTable
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh, shard_of, use_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM

log = logging.getLogger("repro_torch.runtime")

#: steps down `reshard_tables`' ladder since `reset_degraded`: to the
#: ``device_put`` path, and to a ``local`` handle
DEGRADED: Dict[str, int] = {"device_put": 0, "local": 0}


def reset_degraded() -> None:
    for k in DEGRADED:
        DEGRADED[k] = 0


def _is_table(x) -> bool:
    return isinstance(x, AtomicTable)


def placement(like: Any, new_mesh: Mesh, *, cfg: ModelConfig,
              rules: Optional[Dict] = None, shape_kind: str = "train"
              ) -> Callable:
    """``ckpt.restore``'s ``sharding_fn`` that keeps this rank's block of
    each leaf of ``like``'s structure under ``new_mesh``, on the ``like``
    leaf's device and in its dtype.

    A leaf whose key is a parameter's name (``like["params"][name]``, and
    the master weights and moments AdamW keys by the same names) takes
    that parameter's spec by `launch.shardings.params_shardings` against
    the NEW mesh (`opt_state_shardings`).  Any other leaf takes, as the
    reference's shape heuristic, the spec of the first parameter of its
    stored shape and dtype (or of that shape in f32), and lands whole on
    every rank where none matches.  Table leaves never reach it."""
    rules = rules if rules is not None else sh.arch_rules(cfg, new_mesh,
                                                          shape_kind)
    abstract = dict(LM(cfg, device="meta").named_parameters())
    specs = sh.params_shardings(cfg, abstract, new_mesh, rules)
    by_shape: Dict[tuple, tuple] = {}
    for name, p in abstract.items():
        by_shape.setdefault((tuple(p.shape), p.dtype), specs[name])
    paths = [path for path, _ in tree_util.flatten_with_path(
        like, is_leaf=_is_table)]

    def sharding_fn(key: str, ref) -> Callable:
        name = paths[int(key.rsplit("_", 1)[1])][-1]

        def place(host: torch.Tensor) -> torch.Tensor:
            shape = tuple(host.shape)
            spec = specs.get(name) if isinstance(name, str) else None
            if spec is None:
                spec = (by_shape.get((shape, host.dtype))
                        or by_shape.get((shape, torch.float32)) or ())
            block = shard_of(host, spec, new_mesh)
            if isinstance(ref, torch.Tensor):
                block = block.to(device=ref.device, dtype=ref.dtype)
            return block
        return place

    return sharding_fn


def reshard_restore(ckpt_dir: str, step: int, like: Any, new_mesh: Mesh, *,
                    cfg: Optional[ModelConfig] = None,
                    rules: Optional[Dict] = None,
                    shape_kind: str = "train"):
    """Restore ``like``-structured state under ``new_mesh``.

    With ``cfg``, every rank keeps its block of each leaf by
    :func:`placement` (the parameters, and AdamW's state by name, by
    ``params_shardings`` against the new mesh under ``rules``, default
    ``arch_rules(cfg, new_mesh, shape_kind)``); without it every leaf lands
    whole on every rank.  Either way a leaf lands on its ``like`` tensor's
    device, and `AtomicTable` leaves restore through
    `atomics.reshard.restore_table` under the new mesh (each rank keeps
    its shard).  Returns ``(state, extra)``.
    """
    if cfg is None:
        with use_mesh(new_mesh):
            return ckpt_lib.restore(ckpt_dir, step, like)
    rules = rules if rules is not None else sh.arch_rules(cfg, new_mesh,
                                                          shape_kind)
    with use_mesh(new_mesh, rules):
        return ckpt_lib.restore(ckpt_dir, step, like, sharding_fn=placement(
            like, new_mesh, cfg=cfg, rules=rules))


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
