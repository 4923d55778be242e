"""Rank side of `tests/test_torch_moe_train.py`.

Runs on every rank of a gloo group of 8 on a 2x2x2 ``("pod", "data",
"model")`` mesh.  Each layer case's global ``x``, parameters and
cotangents go through the training variant of the expert-parallel layer
(`models.moe.training_blocks`, `_ep_train`) as the sharded train step runs
it: the rank's data cut of ``x`` and of the output's cotangent, its
blocks of the expert weights under P("model", ("pod", "data"), None), the
aux loss's cotangent weighted by the cut's share (1 / 4); the replicated
leaves' gradients then summed over the data cuts, as the step sums them.
Then the (2,2,2) training runs (`_torch_train_sharded_moe_worker.
run_cube`).  It imports the port and numpy only: no JAX.
"""

import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_moe_worker import case_config, case_params  # noqa: E402
from _torch_train_sharded_moe_worker import run_cube  # noqa: E402
from repro_torch.launch.mesh import use_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

DP = ("pod", "data")


def _layer(mesh, c):
    """One case on this rank: its cut of the output and of dx, the router's
    and the shared expert's gradients summed over the data cuts, its
    blocks' gradients, the aux loss."""
    cfg = case_config(c)
    params = case_params(c)
    n_cuts, i = mesh.size(DP), mesh.index(DP)
    b_loc = c["x"].shape[0] // n_cuts
    rows = slice(i * b_loc, (i + 1) * b_loc)
    x = torch.from_numpy(c["x"][rows]).requires_grad_()
    ct = torch.from_numpy(c["ct"][rows])
    blocks = {k: v.requires_grad_()
              for k, v in moe.shard_params(params, mesh, cfg).items()
              if k != "router"}
    params["router"].requires_grad_()
    shared = params.get("shared", {})
    for w in shared.values():
        w.requires_grad_()
    with use_mesh(mesh), moe.training_blocks([(params, blocks)], DP):
        y, aux = moe.moe_ffn(params, x, cfg)
    obj = (y * ct).sum() + aux * (float(c["ct_aux"]) / n_cuts)
    leaves = [x, params["router"], *blocks.values(), *shared.values()]
    grads = torch.autograd.grad(obj, leaves)
    dx, router = grads[0], grads[1]
    g_blocks = dict(zip(blocks, grads[2:5]))
    g_shared = dict(zip(shared, grads[5:]))
    summed = {"router": mesh.all_reduce(router, DP),
              **{f"shared.{k}": mesh.all_reduce(g, DP)
                 for k, g in g_shared.items()}}
    return dict(y=y.detach().numpy(), dx=dx.numpy(), aux=float(aux),
                rows=(rows.start, rows.stop),
                coords=mesh.coords, blocks={k: g.numpy()
                                            for k, g in g_blocks.items()},
                summed={k: g.numpy() for k, g in summed.items()})


def run(mesh, cases, tmp):
    """Every layer case, then the (2,2,2) training runs."""
    return {"layer": [_layer(mesh, c) for c in cases],
            "cube": run_cube(mesh, tmp)}
