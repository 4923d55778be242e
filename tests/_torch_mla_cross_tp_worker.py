"""Rank side of `tests/test_torch_mla_cross_tp.py`.

Runs on every rank of a gloo group of 2 started by
`repro_torch.launch.ranks.launch` on a ``("model",)`` mesh.  It imports
the port only: no JAX, and not the test suite's conftest.

Each case is one MLA layer (reduced deepseek_v3) or one cross-attention
layer (reduced whisper_small) in f32 with the test's numpy weights, run
on the rank's ``"model"`` cut as the partitioned train step runs it: the
leaves `launch.shardings.model_cuts` marks "cut" handed in as the rank's
blocks of the reference's specs through `models.tensor_parallel.cuts`
(``wq_b`` / ``wkv_b`` / ``wq`` / ``wk`` / ``wv`` by columns, ``wo`` by
rows), every other leaf whole.  The rank returns the output, the inputs'
gradients and every leaf's gradient reassembled: the blocks' gathered
over ``"model"``, the whole leaves' its own (each rank's is the whole
gradient), beside how far the ranks' whole-leaf gradients spread.  The
same again under each control of `models.attention._CONTROLS` that
touches the layer.  For MLA's whole leaves, the rank's gradient summed as
the partitioned train step sums it (`launch.steps.grad_axes`) under the
mark `launch.shardings.model_cuts` gives the leaf, and under "partial"
(the control).
"""

import sys

import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import RecordingMesh, shard_of
from repro_torch.launch.shardings import (arch_rules, model_cuts,
                                          params_shardings)
from repro_torch.launch.steps import grad_axes
from repro_torch.models import attention, tensor_parallel
from repro_torch.models.model import LM

#: kind -> (arch, {leaf: the spec its block is cut by}, its whole leaves,
#: its inputs besides x, its controls)
KINDS = {
    "mla": ("deepseek_v3_671b",
            {"wq_b": (None, "model"), "wkv_b": (None, "model"),
             "wo": ("model",)},
            ("wq_a", "q_norm.w", "wkv_a", "kv_norm.w"), (),
            ("krope_unsummed",)),
    "cross": ("whisper_small",
              {"wq": (None, "model"), "wk": (None, "model"),
               "wv": (None, "model"), "wo": ("model",)}, (), ("enc",),
              ("cross_unsummed_wo",)),
}


def config(kind):
    return get_reduced(KINDS[kind][0]).replace(dtype="float32")


def leaves(kind):
    _, blocks, whole, _, _ = KINDS[kind]
    return tuple(blocks) + whole


def layer(kind):
    """The case's module, its weights still the initial ones."""
    gen = torch.Generator().manual_seed(0)
    init = attention.mla_init if kind == "mla" else attention.cross_attn_init
    return init(gen, config(kind), torch.float32)


def layer_case(mesh, c, control=None):
    """One case (``c``: its kind, weights, inputs and the output's
    cotangent, numpy) on this rank's cut: {"y", "d<input>", "grads",
    "spread"} as numpy; ``spread``, the largest relative L2 between this
    rank's and the other's gradient of a whole leaf."""
    kind = c["kind"]
    cfg = config(kind)
    _, specs, whole, extra, _ = KINDS[kind]
    module = layer(kind)
    with torch.no_grad():
        for name in leaves(kind):
            module.get_parameter(name).copy_(torch.from_numpy(
                c["params"][name]))
    blocks = {n: shard_of(module.get_parameter(n).detach(), spec, mesh)
              .requires_grad_() for n, spec in specs.items()}
    inputs = {k: torch.from_numpy(c[k]).requires_grad_()
              for k in ("x",) + extra}
    attention._CONTROLS = frozenset({control} if control else ())
    try:
        with tensor_parallel.cuts(mesh, {id(module.get_parameter(n)): b
                                         for n, b in blocks.items()}):
            if kind == "mla":
                y, _ = attention.mla_forward(module, inputs["x"], cfg)
            else:
                y = attention.cross_attn_forward(module, inputs["x"],
                                                 inputs["enc"], cfg)
    finally:
        attention._CONTROLS = frozenset()
    wrt = list(inputs.values()) + [blocks.get(n, module.get_parameter(n))
                                   for n in leaves(kind)]
    grads = torch.autograd.grad(y, wrt, torch.from_numpy(c["ct"]))
    out = {f"d{k}": g.numpy() for k, g in zip(inputs, grads)}
    full, spread = {}, 0.0
    for name, g in zip(leaves(kind), grads[len(inputs):]):
        if name in specs:
            dim = specs[name].index("model")
            g = mesh.all_gather(g.movedim(dim, 0).contiguous(), "model"
                                ).movedim(0, dim)
        else:
            both = mesh.all_gather(g[None].contiguous(), "model")
            spread = max(spread, float(
                torch.linalg.vector_norm(both[0] - both[1])
                / torch.linalg.vector_norm(g)))
        full[name] = g.numpy()
    return {"y": y.detach().numpy(), "grads": full, "spread": spread, **out}


def marks(kind):
    """{leaf: its `model_cuts` mode} for the layer's leaves in the first
    block of the reduced config, on a mesh of 2 along "model"."""
    cfg = config(kind)
    shape = RecordingMesh((1, 2), ("data", "model"))
    model = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(model.named_parameters()), shape,
                             arch_rules(cfg, shape, "train"))
    module = "attn" if kind == "mla" else "cross"
    return {n: c.mode for n, c in model_cuts(cfg, specs, shape).items()
            if n.startswith(f"blocks.0.{module}.")}


def step_summed(mesh, case, kind):
    """The rank's gradient of each whole leaf of ``case`` summed over the
    axes the train step sums it over (no batch axes here): {leaf: (its
    mark, summed under the mark, summed as a "partial" leaf)}."""
    mode = marks(kind)
    prefix = "blocks.0.attn." if kind == "mla" else "blocks.0.cross."
    out = {}
    for name in KINDS[kind][2]:
        g = torch.from_numpy(case["grads"][name])
        m = mode[prefix + name]
        out[name] = (m, mesh.all_reduce(g, grad_axes(m, ())).numpy(),
                     mesh.all_reduce(g, grad_axes("partial", ())).numpy())
    return out


def run(mesh, cases):
    torch.manual_seed(0)
    out = {"cases": [layer_case(mesh, c) for c in cases],
           "controls": {(k, control): layer_case(mesh, c, control)
                        for k, c in enumerate(cases)
                        for control in KINDS[c["kind"]][4]}}
    out["summed"] = step_summed(mesh, out["cases"][0], cases[0]["kind"])
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out
