"""Rank side of `tests/test_torch_train_sharded_moe.py` and of the (2,2,2)
runs of `tests/test_torch_moe_train.py`.

`launch.train.train(mesh=...)` on the MoE configs (deepseek_v3, jamba,
dbrx, reduced, in f32) through the expert-parallel layer's training
variant (`models.moe._ep_train`).  Every run but the finite-loss ones
takes the no-drop capacity factor E / k, where each rank's cut keeps
every assignment and the sharded step's function is the local trainer's.
It imports the port only: no JAX, and not the test suite's conftest.

Tolerances: losses and gradient norms within rtol 1e-5 (`LOSS_RTOL`),
every leaf of the final checkpoint (parameters, master weights and both
moments, gathered by rank 0) within relative L2 1e-4 (`LEAF_TOL`).

jamba runs in f64 on both sides (`F64`): an f64 model has f64 master
weights, moments, norms and loss.  Partitioned along "model" in f32, its
Mamba leaves' first-step gradient elements near eps round differently on
the ranks' cut than on the whole layer, and AdamW divides them by their
own size: its masked run moved ``blocks.7.ssm.conv_b`` to 1.57e-4
relative L2 of the local run's (Mamba gathered whole) and
``blocks.5.ssm.dt_bias``'s first moment to 5.8e-5 (Mamba cut), where f64
leaves every leaf within 2.2e-6.
"""

import dataclasses
import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_train_sharded_worker import (  # noqa: E402
    CHAOS, ckpt_dir, f32, final_state, masked_batch, _rel_l2)
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime import elastic
from repro_torch.runtime.chaos import FaultPlan

ARCHS = ("deepseek_v3_671b", "jamba_1_5_large_398b", "dbrx_132b")
TRAIN = dict(steps=3, seq_len=16, global_batch=8, device="cpu",
             log_every=1)
#: the finite-loss runs at the configs' own capacity: enough steps and
#: a large enough rate for the loss to fall on the synthetic batches
FALLING = dict(steps=8, lr=3e-3)
CONTROLS = ("gather_reduce_scatter", "router_partial")
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
#: the configs compared in f64 on both sides (module docstring)
F64 = ("jamba_1_5_large_398b",)

_synthetic_batch = train_mod.synthetic_batch


def no_drop(arch):
    """The f32 reduced config (f64 for `F64`) at capacity factor E / k:
    every token's k assignments fit, on a rank's cut as on the whole
    batch."""
    cfg = f32(arch)
    if arch in F64:
        cfg = cfg.replace(dtype="float64")
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def leaves_off(a, b, tol=LEAF_TOL):
    """[(key, leaf, relative L2)] of the leaves of state ``a`` off state
    ``b``'s by more than ``tol``."""
    return [(key, n, err) for key in ("params", "master", "m", "v")
            for n in b[key]
            for err in (_rel_l2(a[key][n], b[key][n]),) if err > tol]


def runs_off(got, want, arch):
    """Two runs, each (history, failures, checkpoint dir): the steps whose
    loss or gradient norm is off, [(step, metric, got, want)], then the
    final checkpoints' leaves off (`leaves_off`)."""
    (hg, _, pg), (hw, _, pw) = got, want
    if len(hg) != len(hw):
        return [("steps", len(hg), len(hw))]
    bad = [(i, k, g[k], w[k]) for i, (g, w) in enumerate(zip(hg, hw))
           for k in ("loss", "grad_norm")
           if abs(g[k] - w[k]) > LOSS_RTOL * abs(w[k])]
    (sg, a), (sw, b) = (final_state(p, arch, no_drop(arch))
                        for p in (pg, pw))
    if sg != sw:
        return bad + [("checkpoint step", sg, sw)]
    return bad + leaves_off(a, b)


def _run(out, case, mesh, arch, tmp, **kw):
    """`train` under ``mesh`` into ``out[case]``: (history, failures); its
    checkpoints under `ckpt_dir`."""
    got = train_mod.train(arch, mesh=mesh, ckpt_dir=ckpt_dir(tmp, case),
                          **{**TRAIN, "checkpoint_every": 3, **kw})
    out[case] = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
                  for h in got["history"]], got["failures"])


def run(mesh, tmp):
    """Every 4-rank case, in one world on a 2x2 ``("data", "model")``
    mesh and (4,) ``("data",)`` over the same ranks; returns {case:
    result} (each rank's)."""
    flat = Mesh((4,), ("data",))
    out = {}
    train_mod.get_reduced = no_drop
    try:
        # 1. each config on both meshes, 3 steps
        for arch in ARCHS:
            for tag, m in (("2x2", mesh), ("4", flat)):
                _run(out, f"{arch}/{tag}", m, arch, tmp)
        # two microbatches, each the global batch's cut shared out: the
        # loss scaled by 1 / 2 before each backward as well
        _run(out, "micro", mesh, ARCHS[0], tmp, microbatches=2)
        # 2. the masked batch (one data cut holds a tenth of the other's
        #    labels): the weights scale the loss before the backward
        train_mod.synthetic_batch = masked_batch
        try:
            for arch in ARCHS:
                _run(out, f"masked/{arch}", mesh, arch, tmp)
        finally:
            train_mod.synthetic_batch = _synthetic_batch
        # 3. the controls, each of which must break the step
        for control in CONTROLS:
            moe._CONTROLS = frozenset({control})
            try:
                _run(out, f"control/{control}", mesh, ARCHS[0], tmp)
            finally:
                moe._CONTROLS = frozenset()
        # 4. chaos against a clean run, 6 steps, a checkpoint every 2
        for tag, chaos in (("clean", None), ("chaos", CHAOS)):
            _run(out, f"recovery/{tag}", mesh, ARCHS[0], tmp, steps=6,
                 checkpoint_every=2,
                 chaos=FaultPlan.from_spec(chaos) if chaos else None)
    finally:
        train_mod.get_reduced = f32
    # 5. the configs' own capacity, where drops happen: finite and falling
    for arch in ARCHS:
        _run(out, f"own/{arch}", mesh, arch, tmp, **FALLING)
    return out


def run_card(mesh, tmp):
    """The card's case: reduced deepseek_v3 in f32 at the no-drop factor
    on ``mesh``, 3 steps (the MoE layer's counts through the card's
    `rmw_table` kernel inside each rank)."""
    train_mod.get_reduced = no_drop
    out = {}
    try:
        _run(out, "card", mesh, ARCHS[0], tmp, device="cuda")
    finally:
        train_mod.get_reduced = f32
    return out["card"]


def run_cube(mesh, tmp):
    """The 8-rank cases on (2,2,2) ``("pod", "data", "model")``: each
    config at the no-drop factor, 3 steps, and deepseek_v3 on the masked
    batch; then deepseek_v3's step-3 checkpoint restored onto a 2x2
    ``("data", "model")`` mesh of each half of the world
    (`reshard_restore`): this rank's block of every leaf."""
    halves = [Mesh((2, 2), ("data", "model"), ranks=range(k, k + 4))
              for k in (0, 4)]
    out = {}
    train_mod.get_reduced = no_drop
    try:
        for arch in ARCHS:
            _run(out, f"{arch}/2x2x2", mesh, arch, tmp)
        train_mod.synthetic_batch = masked_batch
        try:
            _run(out, "masked/2x2x2", mesh, ARCHS[0], tmp)
        finally:
            train_mod.synthetic_batch = _synthetic_batch
        half = next(h for h in halves if h.is_member)
        out["restored"] = _restored(half, ckpt_dir(tmp, f"{ARCHS[0]}/2x2x2"))
    finally:
        train_mod.get_reduced = f32
    return out


def _restored(mesh, path):
    """`reshard_restore(cfg=...)` of step 3 onto ``mesh``: this rank's
    index on it and its block of every leaf, as numpy."""
    cfg = no_drop(ARCHS[0])
    model = train_mod.build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    like = {"params": params, "opt": init_state(params, AdamWConfig())}
    state, _ = elastic.reshard_restore(path, 3, like, mesh, cfg=cfg)
    return {"coords": mesh.coords, "step": int(state["opt"]["step"]),
            **{key: {n: x.numpy() for n, x in tree.items()}
               for key, tree in (("params", state["params"]),
                                 ("master", state["opt"]["master"]),
                                 ("m", state["opt"]["m"]))}}


def chaos_equal(tmp):
    """The clean and the chaos run's final checkpoints: (steps, [leaves
    that differ])."""
    (sa, a), (sb, b) = (final_state(ckpt_dir(tmp, f"recovery/{t}"),
                                    ARCHS[0]) for t in ("clean", "chaos"))
    differ = [(k, n) for k in a for n in a[k]
              if not torch.equal(a[k][n], b[k][n])]
    return (sa, sb), differ
