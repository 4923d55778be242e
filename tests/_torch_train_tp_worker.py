"""Rank side of `tests/test_torch_train_tp.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (1, 4) ``("data",
"model")``.  It imports the port only: no JAX, and not the test suite's
conftest.

The partitioned step (`launch.steps.make_sharded_train_step`, each GQA,
MLP and vocabulary leaf the rules cut computed on the rank's ``"model"``
cut) runs `STEPS` steps in f32 from the local trainer's initial weights
and batches; rank 0 gathers the parameters and AdamW's first moments
(the clipped gradients times 0.1 after one step) and runs the local step
(`make_train_step`) on a model of the same seed.  Cases: reduced
gemma_2b on 2x2 (its one kv head whole: the partial-gradient path) under
``remat_policy`` "full" and "none", under rules mapping ``qkv``,
``kv_qkv``, ``ffn`` and ``vocab`` to None (every leaf whole) and
unpartitioned (``partitioned=False``: the same blocks, every leaf
gathered whole); reduced stablelm_12b on 2x2 (kv heads cut, layernorm
with biases) and on (1, 4) (query heads cut, its 2 kv heads whole: the
head-grouping case); each partial case again with ``sum_partial=False``,
the control.

Beside them: the vocab-parallel cross-entropy and embedding lookup
against the plain ones (softcap on and off, -100 labels); `global_norm`
over the blocks of a tree laid out by the partitioned step's specs; the
partitioned MLP on numpy inputs the test also hands the reference.
"""

import os
import sys

import numpy as np
import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, batch_kwargs_for, synthetic_batch)
from repro_torch.launch.mesh import Mesh, gather_full, shard_of  # noqa: E402
from repro_torch.launch.shardings import (arch_rules,  # noqa: E402
                                          params_shardings)
from repro_torch.launch.steps import (make_sharded_train_step,  # noqa: E402
                                      make_train_step)
from repro_torch.launch.train import deterministic_algorithms  # noqa: E402
from repro_torch.models import tensor_parallel  # noqa: E402
from repro_torch.models.layers import (chunked_softmax_xent,  # noqa: E402
                                       embed_lookup, mlp_apply)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, global_norm,  # noqa: E402
                                     init_state)

STEPS = 2
DATA = dict(seq_len=16, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
#: rules that cut nothing a module computes on along "model"
PARENT = {"qkv": None, "kv_qkv": None, "ffn": None, "vocab": None}
#: case -> (arch, mesh, remat policy, rules over arch_rules, step kwargs)
CASES = {
    "gemma_2b/2x2": ("gemma_2b", "2x2", "full", {}, {}),
    "gemma_2b/2x2/none": ("gemma_2b", "2x2", "none", {}, {}),
    "gemma_2b/2x2/parent": ("gemma_2b", "2x2", "full", PARENT, {}),
    "gemma_2b/2x2/unpartitioned": ("gemma_2b", "2x2", "full", {},
                                   dict(partitioned=False)),
    "gemma_2b/2x2/unsummed": ("gemma_2b", "2x2", "full", {},
                              dict(sum_partial=False)),
    "stablelm_12b/2x2": ("stablelm_12b", "2x2", "full", {}, {}),
    "stablelm_12b/1x4": ("stablelm_12b", "1x4", "full", {}, {}),
    "stablelm_12b/1x4/unsummed": ("stablelm_12b", "1x4", "full", {},
                                  dict(sum_partial=False)),
}


def f32(arch):
    return get_reduced(arch).replace(dtype="float32")


def batch(cfg, step):
    data = DataConfig(vocab_size=cfg.vocab_size, seed=0, **DATA)
    return synthetic_batch(data, step, device="cpu", **batch_kwargs_for(cfg))


def model_of(cfg, remat):
    return LM(cfg, device="cpu", seed=0, use_kernel=False,
              attn_impl="chunked", remat_policy=remat, loss_chunk=8)


def local_run(arch, remat, cfg=None):
    """The local trainer's `STEPS` steps on ``cfg`` (default `f32` of
    ``arch``): (history, params, m)."""
    cfg = cfg or f32(arch)
    model = model_of(cfg, remat)
    opt = AdamWConfig(**OPT)
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    state = init_state(params, opt)
    hist = []
    with deterministic_algorithms(True):
        for i in range(STEPS):
            params, state, m = step(params, state, batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return (hist, {n: p.detach().clone() for n, p in params.items()},
            {n: x.clone() for n, x in state["m"].items()})


def sharded_run(mesh, arch, remat, rules, kw):
    """The partitioned step's `STEPS` steps: (history, {name: mode},
    params and m gathered on rank 0, else None)."""
    cfg = f32(arch)
    model = model_of(cfg, remat)
    opt = AdamWConfig(**OPT)
    step = make_sharded_train_step(
        model, opt, mesh, {**arch_rules(cfg, mesh, "train"), **rules}, **kw)
    specs = step.specs
    params = {n: shard_of(p.detach(), specs[n], mesh)
              for n, p in model.named_parameters()}
    state = init_state(params, opt)
    hist = []
    with deterministic_algorithms(True):
        for i in range(STEPS):
            params, state, m = step(params, state, batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    whole = {key: {n: gather_full(x, specs[n], mesh) for n, x in tree.items()}
             for key, tree in (("params", params), ("m", state["m"]))}
    modes = {n: c.mode for n, c in step.cuts.items()}
    return hist, modes, (whole if mesh.rank == 0 else None)


def run(mesh, mlp_inputs):
    torch.manual_seed(0)
    meshes = {"2x2": mesh, "1x4": Mesh((1, 4), ("data", "model"))}
    out = {"sharded": {}, "local": {}}
    for case, (arch, tag, remat, rules, kw) in CASES.items():
        out["sharded"][case] = sharded_run(meshes[tag], arch, remat, rules,
                                           kw)
        key = f"{arch}/{remat}"
        if mesh.rank == 0 and key not in out["local"]:
            out["local"][key] = local_run(arch, remat)
    out["xent"] = xent_case(mesh)
    out["embed"] = embed_case(mesh)
    out["global_norm"] = global_norm_case(mesh)
    out["mlp"] = [mlp_case(mesh, c) for c in mlp_inputs]
    out["coords"] = dict(mesh.coords)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _model_cut(full, mesh, dim):
    """This rank's cut of ``full`` along ``dim`` over ``"model"``."""
    n = full.shape[dim] // mesh.size("model")
    return full.narrow(dim, mesh.index("model") * n, n)


def xent_case(mesh):
    """The vocab-parallel chunked cross-entropy against the plain one on
    one seeded input (chunks of 5 over 12 positions, a quarter of the
    labels -100), softcap off and on: {cap: (loss, plain loss, dh
    relative L2, the head's gradient relative L2 on this rank's
    slice)}."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(2, 12, 16)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 64, size=(2, 12)))
    labels[rng.random((2, 12)) < 0.25] = -100
    got = {}
    for cap in (0.0, 5.0):
        hp, ep = h.clone().requires_grad_(), emb.clone().requires_grad_()
        plain = chunked_softmax_xent(hp, ep, labels, chunk=5,
                                     logit_softcap=cap)
        dh, de = torch.autograd.grad(plain, (hp, ep))
        hc = h.clone().requires_grad_()
        ec = _model_cut(emb, mesh, 1).clone().requires_grad_()
        loss = chunked_softmax_xent(hc, ec, labels, chunk=5,
                                    logit_softcap=cap, mesh=mesh)
        gh, ge = torch.autograd.grad(loss, (hc, ec))
        got[cap] = (float(loss), float(plain), _rel(gh, dh),
                    _rel(ge, _model_cut(de, mesh, 1)))
    return got


def embed_case(mesh):
    """The vocab-parallel lookup against ``table[ids]`` (ids on both
    slices' edges included): (outputs equal, the slice's gradient
    relative L2 against the plain gradient's rows)."""
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    ids = torch.from_numpy(np.concatenate([
        rng.integers(0, 64, size=20), [0, 15, 16, 31, 32, 47, 48, 63]])
    ).reshape(4, 7)
    ct = torch.from_numpy(rng.normal(size=(4, 7, 8)).astype(np.float32))
    tp_ = table.clone().requires_grad_()
    plain = embed_lookup(tp_, ids)
    (g_plain,) = torch.autograd.grad(plain, tp_, ct)
    cut = _model_cut(table, mesh, 0).clone().requires_grad_()
    got = embed_lookup(cut, ids, mesh)
    (g,) = torch.autograd.grad(got, cut, ct)
    return (torch.equal(got, plain.detach()),
            _rel(g, _model_cut(g_plain, mesh, 0)))


def global_norm_case(mesh):
    """`global_norm` of a seeded tree laid out by the partitioned step's
    specs for reduced gemma_2b on 2x2 (leaves cut over "model", over
    "data" and both, and whole ones): (blocks' norm, whole tree's)."""
    cfg = f32("gemma_2b")
    model = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(model.named_parameters()), mesh,
                             arch_rules(cfg, mesh, "train"))
    gen = torch.Generator().manual_seed(7)
    tree = {n: torch.randn(p.shape, generator=gen)
            for n, p in model.named_parameters()}
    blocks = {n: shard_of(x, specs[n], mesh) for n, x in tree.items()}
    return (float(global_norm(blocks, mesh, specs)),
            float(global_norm(tree)))


def mlp_case(mesh, c):
    """The MLP on each rank's data cut of ``x`` and its blocks (the
    leaves `params_shardings` cuts over "model" gathered over "data" and
    kept cut, as the partitioned step hands them; the others whole):
    this rank's output rows and dx, and each leaf's gradient summed over
    the data cuts and gathered whole."""
    cfg = f32("gemma_2b")
    params = {n: torch.from_numpy(v) for n, v in c["params"].items()}
    specs = params_shardings(cfg, params, mesh, arch_rules(cfg, mesh))
    x = shard_of(torch.from_numpy(c["x"]), ("data",), mesh)
    ct = shard_of(torch.from_numpy(c["ct"]), ("data",), mesh)
    module = torch.nn.ParameterDict({n: torch.nn.Parameter(v.clone())
                                     for n, v in params.items()})
    cut = {n: [i for i, e in enumerate(specs[n]) if e == "model"]
           for n in params}
    wrt = {n: (gather_full(shard_of(params[n], specs[n], mesh), specs[n],
                           mesh, ("data",)).requires_grad_()
               if cut[n] else module[n]) for n in params}
    xs = x.clone().requires_grad_()
    with tensor_parallel.cuts(mesh, {id(module[n]): wrt[n]
                                     for n in params if cut[n]}):
        y = mlp_apply(xs, module, c["act"])
    grads = torch.autograd.grad(y, [xs] + list(wrt.values()), ct)
    summed = {}
    for n, g in zip(wrt, grads[1:]):
        g = mesh.all_reduce(g, "data")
        if cut[n]:
            dim = cut[n][0]
            g = mesh.all_gather(g.movedim(dim, 0).contiguous(), "model"
                                ).movedim(0, dim)
        summed[n] = g.numpy()
    rows = x.shape[0]
    return {"rows": (mesh.index("data") * rows,
                     (mesh.index("data") + 1) * rows),
            "specs": {n: specs[n] for n in params},
            "y": y.detach().numpy(), "dx": grads[0].numpy(),
            "grads": summed}
