"""Rank side of `tests/test_torch_train_sharded.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (4,) ``("data",)``.
Every run trains in f32 (the reduced configs are bf16), through
`launch.train.train` with ``mesh=``.  It imports the port only: no JAX,
and not the test suite's conftest, so the card's test
(`tests/test_torch_gpu.py`) uses it too, with the comparisons below.

Tolerances, PR 22's (`tests/_torch_train.py`): losses and gradient norms
within rtol 1e-5; every element of the final checkpoint's parameters and
master weights within 5% of the run's summed learning rates, each moment
leaf within relative L2 1e-3.  Not relative L2 1e-4 on the parameters, as
the card's full-width check: Adam moves an element by about lr whatever
its gradient's size, so where a gradient element is near eps the rounding
of the ranks' sums moves it by a share of lr, and a leaf that starts at
zero (qwen2_vl's biases) is nothing but such steps (observed: 9e-4
relative L2 for ``attn.bk``, 0.2% of lr per element).
"""

import functools
import os
import shutil

import torch

from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_reduced
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh, gather_full, shard_of
from repro_torch.launch.shardings import arch_rules
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime import elastic
from repro_torch.runtime.chaos import FaultPlan

ARCHS = ("gemma_2b", "mamba2_780m", "qwen2_vl_2b", "whisper_small")
TRAIN = dict(steps=3, seq_len=16, global_batch=8, device="cpu",
             log_every=1)
CHAOS = "seed=3,step=1.0@2,ckpt_save=1.0@1"
LOSS_RTOL, PARAM_SHARE, MOMENT_TOL = 1e-5, 0.05, 1e-3


_synthetic_batch = train_mod.synthetic_batch


def f32(arch):
    return get_reduced(arch).replace(dtype="float32")


def masked_batch(cfg, step, **kw):
    """The synthetic batch with the first half of its rows 90% masked: on
    the 2x2 mesh the cut of data index 0 holds about a tenth of the
    other's valid labels."""
    batch = _synthetic_batch(cfg, step, **kw)
    labels = batch["labels"].clone()
    b, s = labels.shape
    labels[: b // 2, : (9 * s) // 10] = -100
    return dict(batch, labels=labels)


def ckpt_dir(tmp, case):
    return os.path.join(tmp, case.replace("/", "-"))


def final_state(path, arch):
    """(step, {"params", "master", "m", "v"} of {name: tensor}) of the
    newest checkpoint under ``path``, on the host."""
    model = train_mod.build_model(f32(arch), device="cpu")
    params = dict(model.named_parameters())
    like = {"params": params, "opt": init_state(params, AdamWConfig())}
    step = ckpt_lib.latest_step(path)
    tree, _ = ckpt_lib.restore(path, step, like)
    return step, {"params": tree["params"],
                  **{k: tree["opt"][k] for k in ("master", "m", "v")}}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def leaves_off(a, b, lr_sum):
    """The leaves of state ``a`` off state ``b``'s beyond their bounds:
    [(key, leaf, error)], empty where every leaf is close."""
    bad = []
    for key in ("params", "master"):
        err, leaf = max((float((a[key][n].double() - b[key][n].double())
                               .abs().max()), n) for n in b[key])
        if err > PARAM_SHARE * lr_sum:
            bad.append((key, leaf, err))
    for key in ("m", "v"):
        err, leaf = max((_rel_l2(a[key][n], b[key][n]), n) for n in b[key])
        if err > MOMENT_TOL:
            bad.append((key, leaf, err))
    return bad


def runs_off(got, want, arch="gemma_2b"):
    """Two runs, each (history, failures, checkpoint dir): the steps whose
    loss or gradient norm is off, [(step, metric, got, want)], then the
    final checkpoints' leaves off (`leaves_off`)."""
    (hg, _, pg), (hw, _, pw) = got, want
    if len(hg) != len(hw):
        return [("steps", len(hg), len(hw))]
    bad = [(i, k, g[k], w[k]) for i, (g, w) in enumerate(zip(hg, hw))
           for k in ("loss", "grad_norm")
           if abs(g[k] - w[k]) > LOSS_RTOL * abs(w[k])]
    (sg, a), (sw, b) = final_state(pg, arch), final_state(pw, arch)
    if sg != sw:
        return bad + [("checkpoint step", sg, sw)]
    return bad + leaves_off(a, b, sum(h["lr"] for h in hw))


def _run(out, case, mesh, arch, tmp, **kw):
    """`train` under ``mesh`` into ``out[case]``: (history, failures); its
    checkpoints under `ckpt_dir`."""
    got = train_mod.train(arch, mesh=mesh, ckpt_dir=ckpt_dir(tmp, case),
                          **{**TRAIN, **kw})
    out[case] = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
                  for h in got["history"]], got["failures"])


def run(mesh, tmp, ref_params, ref_batch, opt_kw):
    """Every case, in one world; returns {case: result} (each rank's)."""
    train_mod.get_reduced = f32
    flat = Mesh((4,), ("data",))
    meshes = {"2x2": mesh, "4": flat}
    out = {"blocks": _blocks(meshes)}
    # 1. each config on both meshes, 3 steps, the final checkpoint kept
    for arch in ARCHS:
        for tag, m in meshes.items():
            _run(out, f"{arch}/{tag}", m, arch, tmp, checkpoint_every=3)
    # 2. two microbatches (each the global batch's cut, shared out)
    for tag, m in meshes.items():
        _run(out, f"micro/{tag}", m, "gemma_2b", tmp, microbatches=2,
             checkpoint_every=3)
    # 3. an unevenly masked batch, weighted by counts and as the control
    train_mod.synthetic_batch = masked_batch
    try:
        _run(out, "masked", mesh, "gemma_2b", tmp, checkpoint_every=3)
        train_mod.make_sharded_train_step = functools.partial(
            steps_mod.make_sharded_train_step, mean_of_means=True)
        _run(out, "mean_of_means", mesh, "gemma_2b", tmp,
             checkpoint_every=3)
    finally:
        train_mod.synthetic_batch = _synthetic_batch
        train_mod.make_sharded_train_step = \
            steps_mod.make_sharded_train_step
    # 4. chaos against a clean run, 6 steps, a checkpoint every 2
    for tag, chaos in (("clean", None), ("chaos", CHAOS)):
        _run(out, f"recovery/{tag}", mesh, "gemma_2b", tmp, steps=6,
             checkpoint_every=2,
             chaos=FaultPlan.from_spec(chaos) if chaos else None)
    # 5. 4 steps on 2x2, checkpoints at 2 and 4; step 2 restored onto (4,):
    #    this rank's blocks, then the run resumed from it
    _run(out, "elastic/2x2", mesh, "gemma_2b", tmp, steps=4,
         checkpoint_every=2)
    out["restored"] = _restored(flat, ckpt_dir(tmp, "elastic/2x2"))
    if mesh.rank == 0:
        shutil.copytree(
            os.path.join(ckpt_dir(tmp, "elastic/2x2"), "step-00000002"),
            os.path.join(ckpt_dir(tmp, "resumed/4"), "step-00000002"))
    torch.distributed.barrier()
    _run(out, "resumed/4", flat, "gemma_2b", tmp, steps=4,
         checkpoint_every=2)
    # 6. tuning under the mesh (the controller is given it), through the
    #    launcher's entry point
    got = train_mod.train_on_mesh(mesh, "gemma_2b",
                                  {**TRAIN, "steps": 2, "tuning": True})
    out["tuning"] = ([h["loss"] for h in got["history"]],
                     got["tuning"]["updates"])
    # 7. one step from the reference's weights, against its local step
    out["reference_step"] = _reference_step(mesh, ref_params, ref_batch,
                                            opt_kw)
    return out


def run_card(mesh, tmp):
    """The card's case: reduced gemma_2b in f32 on ``mesh``, 3 steps."""
    train_mod.get_reduced = f32
    out = {}
    _run(out, "card", mesh, "gemma_2b", tmp, device="cuda",
         checkpoint_every=3)
    return out["card"]


BLOCK_SPECS = {"2x2": [(), ("data",), (None, "model"), ("data", "model"),
                       (("data", "model"),), ("model", None, "data"),
                       (None, ("model", "data"))],
               "4": [(), ("data",), (None, "data"), (None, None, "data")]}


def _blocks(meshes):
    """`shard_of` then `gather_full` of an (8, 12, 4) leaf for each spec:
    [(mesh, spec, the block's shape, gathered whole equal)]."""
    base = torch.arange(8 * 12 * 4, dtype=torch.float32).reshape(8, 12, 4)
    got = []
    for tag, mesh in meshes.items():
        for spec in BLOCK_SPECS[tag]:
            block = shard_of(base, spec, mesh)
            got.append((tag, spec, tuple(block.shape),
                        torch.equal(gather_full(block, spec, mesh), base)))
    return got


def _restored(mesh, ckpt_dir):
    """`reshard_restore(cfg=...)` of step 2 onto ``mesh``: this rank's
    block of every leaf, as numpy."""
    cfg = f32("gemma_2b")
    model = train_mod.build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    opt_cfg = AdamWConfig()
    like = {"params": params, "opt": init_state(params, opt_cfg)}
    state, _ = elastic.reshard_restore(ckpt_dir, 2, like, mesh, cfg=cfg)
    return {"params": {n: x.numpy() for n, x in state["params"].items()},
            "master": {n: x.numpy()
                       for n, x in state["opt"]["master"].items()},
            "m": {n: x.numpy() for n, x in state["opt"]["m"].items()},
            "step": int(state["opt"]["step"])}


def _reference_step(mesh, ref_params, batch, opt_kw):
    """One sharded step on the reference's weights and numpy batch:
    (loss, grad_norm, the gathered master weights in the reference's
    layout)."""
    cfg = f32("gemma_2b")
    model = train_mod.build_model(cfg, device="cpu", use_kernel=False,
                                  attn_impl="chunked", remat_policy="none",
                                  loss_chunk=8)
    convert.lm_params_from_reference(ref_params, cfg, model=model)
    opt_cfg = AdamWConfig(**opt_kw)
    rules = arch_rules(cfg, mesh, "train")
    step = steps_mod.make_sharded_train_step(model, opt_cfg, mesh, rules)
    params = {n: shard_of(p.detach(), step.specs[n], mesh)
              for n, p in model.named_parameters()}
    state = init_state(params, opt_cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, state, metrics = step(params, state, batch)
    master = {n: gather_full(x, step.specs[n], mesh)
              for n, x in state["master"].items()}
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            convert.to_reference_layout(master, model)
            if mesh.rank == 0 else None)
