"""Rank side of `tests/test_torch_train_tp_ssm.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (1, 4) ``("data",
"model")``.  It imports the port only: no JAX, and not the test suite's
conftest.

The partitioned step (`launch.steps.make_sharded_train_step`) runs
`STEPS` steps from the local trainer's initial weights and batches, under
the mesh and rules as `launch.train.train` installs them, on Mamba-2 and
the MoE configs: mamba2_780m (its Mamba mixers on the rank's
heads, `models.mamba`) and the MoE configs, whose GQA attention, dense
MLPs, Mamba mixers and vocabulary are cut beside the expert-parallel
layer.  Rank 0 gathers the parameters and AdamW's first moments and runs
the local step (`make_train_step`) on a model of the same seed.  The MoE
configs run at the no-drop capacity factor E / k, where the sharded
function is the local one, and jamba in f64
(`_torch_train_sharded_moe_worker.F64`).  Each rank also reports whether
its model's own ``in_proj`` leaves still hold their initial values: the
step hands the mixers their blocks and never gathers a whole ``in_proj``
into the model.
"""

import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_sharded_moe_worker import no_drop  # noqa: E402
from _torch_train_tp_worker import (  # noqa: E402
    OPT, STEPS, batch, local_run, model_of)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.mesh import (Mesh, gather_full, shard_of,  # noqa: E402
                                     use_mesh)
from repro_torch.launch.shardings import arch_rules  # noqa: E402
from repro_torch.launch.steps import make_sharded_train_step  # noqa: E402
from repro_torch.launch.train import deterministic_algorithms  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_state  # noqa: E402

#: case -> (arch, mesh, remat policy, step kwargs)
CASES = {
    "mamba2_780m/2x2": ("mamba2_780m", "2x2", "full", {}),
    "mamba2_780m/2x2/none": ("mamba2_780m", "2x2", "none", {}),
    # 8 heads over 4 ranks: in_proj's 296 columns in blocks of 74
    "mamba2_780m/1x4": ("mamba2_780m", "1x4", "full", {}),
    "mamba2_780m/2x2/unsummed": ("mamba2_780m", "2x2", "full",
                                 dict(sum_partial=False)),
    "jamba_1_5_large_398b/2x2": ("jamba_1_5_large_398b", "2x2", "full", {}),
    "dbrx_132b/2x2": ("dbrx_132b", "2x2", "full", {}),
    "deepseek_v3_671b/2x2": ("deepseek_v3_671b", "2x2", "full", {}),
}


def config(arch):
    """The reduced config the cases train: f32 (jamba f64), the MoE
    configs at the no-drop factor."""
    if get_reduced(arch).moe is not None:
        return no_drop(arch)
    return get_reduced(arch).replace(dtype="float32")


def sharded_run(mesh, arch, remat, kw):
    """The partitioned step's `STEPS` steps under ``use_mesh``: (history,
    {name: mode}, params and m gathered on rank 0 (else None), whether
    every ``in_proj`` of the model still holds its initial value)."""
    cfg = config(arch)
    model = model_of(cfg, remat)
    opt = AdamWConfig(**OPT)
    rules = arch_rules(cfg, mesh, "train")
    step = make_sharded_train_step(model, opt, mesh, rules, **kw)
    specs = step.specs
    params = {n: shard_of(p.detach(), specs[n], mesh)
              for n, p in model.named_parameters()}
    initial = {n: p.detach().clone() for n, p in model.named_parameters()
               if n.endswith(".in_proj")}
    state = init_state(params, opt)
    hist = []
    with deterministic_algorithms(True), use_mesh(mesh, rules):
        for i in range(STEPS):
            params, state, m = step(params, state, batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    whole = {key: {n: gather_full(x, specs[n], mesh) for n, x in tree.items()}
             for key, tree in (("params", params), ("m", state["m"]))}
    own = dict(model.named_parameters())
    stale = all(torch.equal(own[n], x) for n, x in initial.items())
    modes = {n: c.mode for n, c in step.cuts.items()}
    return hist, modes, (whole if mesh.rank == 0 else None), stale


def run(mesh):
    torch.manual_seed(0)
    meshes = {"2x2": mesh, "1x4": Mesh((1, 4), ("data", "model"))}
    out = {"sharded": {}, "local": {}}
    for case, (arch, tag, remat, kw) in CASES.items():
        out["sharded"][case] = sharded_run(meshes[tag], arch, remat, kw)
        key = f"{arch}/{remat}"
        if mesh.rank == 0 and key not in out["local"]:
            out["local"][key] = local_run(arch, remat, config(arch))
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out
