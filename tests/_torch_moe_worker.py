"""Rank side of `tests/test_torch_moe_sharded.py`.

Runs on every rank of a gloo group started by
`repro_torch.launch.ranks.launch` (8 ranks on a 2x2x2 ``("pod", "data",
"model")`` mesh): each case's global ``x`` and parameters go through
`repro_torch.models.moe.moe_ffn` under the mesh, which cuts this rank's
shards, runs expert parallelism and gathers the output back; its routing
is read by wrapping the module's functions (`observed`).  It imports
the port and numpy only: no JAX, and not the test suite's conftest.
"""

import contextlib
import dataclasses

import torch

from repro_torch import atomics
from repro_torch.configs import get_reduced
from repro_torch.kernels.rmw import kernel as K
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import moe


def case_config(c):
    """The reduced config of ``c["arch"]`` in f32 with the case's MoE
    overrides."""
    cfg = get_reduced(c["arch"]).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **c["moe"]))


def case_params(c):
    """The case's numpy parameters as the port's tree (``shared.*`` under
    ``shared``)."""
    params = {k: torch.from_numpy(v) for k, v in c["params"].items()
              if "." not in k}
    shared = {k.split(".")[1]: torch.from_numpy(v)
              for k, v in c["params"].items() if "." in k}
    if shared:
        params["shared"] = shared
    return params


@contextlib.contextmanager
def observed(mesh):
    """What `moe_ffn` did on this rank, read at the module's seams: the
    routing's expert ids, the local slot ranks, the fetched sharded FAA's
    global arrival ranks (None where none is taken) and the tensors sent
    through ``mesh.all_to_all`` (the dispatch buffer among them)."""
    seen = {"global_rank": None, "sent": []}
    route, rank, execute = moe._route, moe._priority_rank, atomics.execute

    def route_(*a):
        out = route(*a)
        seen["ids"] = out[1]
        return out

    def rank_(*a):
        seen["rank"] = rank(*a)
        return seen["rank"]

    def execute_(table, op, **kw):
        res = execute(table, op, **kw)
        if kw.get("need_fetched", True):
            seen["global_rank"] = res.fetched
        return res

    def all_to_all_(x, axis):
        seen["sent"].append(x)
        return type(mesh).all_to_all(mesh, x, axis)

    moe._route, moe._priority_rank, atomics.execute = route_, rank_, execute_
    mesh.all_to_all = all_to_all_
    try:
        yield seen
    finally:
        moe._route, moe._priority_rank, atomics.execute = route, rank, execute
        del mesh.all_to_all


def kept(seen, plan, cfg):
    """Which assignments the dispatch kept, from the buffer it sent: an
    assignment (expert e, local rank r < capacity) was kept iff its row
    (e's shard, e's local row, r) holds a token (x is never all zero)."""
    e_loc, cap = cfg.moe.n_experts // plan.ep, plan.capacity
    send = next(t for t in seen["sent"] if t.dim() == 3
                and t.shape[:2] == (plan.ep, e_loc * cap))
    full = send.abs().sum(-1) != 0
    flat, r = seen["ids"].reshape(-1).long(), seen["rank"].long()
    slot = (flat % e_loc) * cap + r.clamp(max=cap - 1)
    return (r < cap) & full[flat // e_loc, slot]


def run_moe(mesh, cases):
    """Every case: the global output and aux loss on this rank, its
    routing, and whether the rank's body given its pre-cut shards
    (`moe._ep_ffn` on `moe.shard_params`) gives the same."""
    out = []
    for c in cases:
        cfg = case_config(c)
        params = case_params(c)
        x = torch.from_numpy(c["x"])
        K.reset_launches()
        with use_mesh(mesh):
            with observed(mesh) as seen:
                y, aux = moe.moe_ffn(params, x, cfg)
            y2, aux2 = moe._ep_ffn(moe.shard_params(params, mesh, cfg), x,
                                   cfg, mesh)
            if "shared" in params:
                y2 = y2 + moe.mlp_apply(x, params["shared"], cfg.mlp_act)
        plan = moe.ep_plan(mesh, cfg, x.shape[0], x.shape[1])
        gr = seen["global_rank"]
        out.append(dict(
            y=y.numpy(), aux=float(aux), plan=plan,
            ids=seen["ids"].numpy(), keep=kept(seen, plan, cfg).numpy(),
            global_rank=None if gr is None else gr.numpy(),
            pre_cut_same=bool(torch.equal(y, y2) and float(aux2)
                              == float(aux)),
            launches=dict(K.LAUNCHES)))
    return out
