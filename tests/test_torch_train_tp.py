"""Tensor-parallel compute along "model" in the sharded train step, on 4
gloo CPU ranks, against the port's local step and the reference's MLP.

One world of 4 ranks (module-scoped) runs every sharded case, rank side
`tests/_torch_train_tp_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh and on (1, 4) over the same ranks, all in f32: the
partitioned step (`launch.steps.make_sharded_train_step`) against the
local step on the same weights and batches, its control (the partial
gradients left unsummed over "model"), the vocab-parallel cross-entropy
and lookup, `global_norm` under the partitioned layout, and the
partitioned MLP.  Meanwhile one reference subprocess with 4 fake devices
runs `jax.vjp` of the reference's `mlp_apply` under `jax.jit`, its
weights placed by the reference's `params_shardings` on a mesh of Auto
axes (jax 0.9.0 makes Explicit ones, on which the row product's sharded
contraction raises `ShardingTypeError`; the reference's
whole sharded model is no live oracle on jax 0.9.0: `jnp.take` under a
mesh, ROADMAP queue 3).  `RecordingMesh`'s log of the step, in this
process, shows which leaves are gathered over "model".

Tolerances (the sharded tests'): loss and gradient norm within rtol
1e-5, each leaf of the parameters and of AdamW's first moment (0.1 times
the clipped gradient after the first step) within relative L2 1e-4; the
layer checks within rtol = atol = 1e-5.
"""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import _torch_train_tp_worker as W
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import ranks
from repro_torch.launch.mesh import RecordingMesh, gather_full, shard_of
from repro_torch.launch.shardings import (ModelCut, arch_rules, model_cuts,
                                          params_shardings)
from repro_torch.launch.steps import make_sharded_train_step
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, init_state

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_train_tp_worker.py")
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
MATCHING = ("gemma_2b/2x2", "gemma_2b/2x2/none", "gemma_2b/2x2/parent",
            "gemma_2b/2x2/unpartitioned", "stablelm_12b/2x2",
            "stablelm_12b/1x4")
ACTS = ("swiglu", "gelu")


def _mlp_inputs(act, seed):
    """Seeded numpy inputs of one MLP case: d 32, d_ff 64, x (4, 8, 32)
    and its output's cotangent; biases on the plain MLP."""
    rng = np.random.default_rng(seed)
    nrm = lambda *shape: rng.normal(size=shape).astype(np.float32)
    params = {"w1": nrm(32, 64) * 32 ** -0.5, "w2": nrm(64, 32) * 0.125}
    if act == "swiglu":
        params["w3"] = nrm(32, 64) * 32 ** -0.5
    else:
        params.update(b1=nrm(64) * 0.1, b2=nrm(32) * 0.1)
    return dict(act=act, params=params, x=nrm(4, 8, 32), ct=nrm(4, 8, 32))


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.launch.shardings import arch_rules, params_shardings
from repro.models.layers import mlp_apply
from repro.sharding import use_mesh

# the reference's sharding propagation (Auto axes): jax 0.9.0's default,
# Explicit, refuses its row product's sharded contraction
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = get_reduced("gemma_2b").replace(dtype="float32")
rules = arch_rules(cfg, mesh, "train")
data = np.load(sys.argv[1], allow_pickle=True)
out = {}
for k in range(int(data["n"])):
    act = str(data[f"act{k}"])
    params = {n: jnp.asarray(v) for n, v in data[f"params{k}"].item().items()}
    params = jax.device_put(params, params_shardings(cfg, params, mesh,
                                                     rules))
    x = jax.device_put(jnp.asarray(data[f"x{k}"]),
                       NamedSharding(mesh, P("data")))

    def vjp(params, x, ct):
        y, back = jax.vjp(lambda p, x: mlp_apply(x, p, act), params, x)
        return y, back(ct)

    with use_mesh(mesh, rules):
        y, (gp, gx) = jax.jit(vjp)(params, x, jnp.asarray(data[f"ct{k}"]))
    out[f"y{k}"] = np.asarray(y)
    out[f"dx{k}"] = np.asarray(gx)
    out[f"specs{k}"] = np.array(
        {n: tuple(p.sharding.spec) for n, p in params.items()}, dtype=object)
    for n, g in gp.items():
        out[f"g{k}.{n}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-rank world's results and the reference's MLP, run side by
    side."""
    tmp = tmp_path_factory.mktemp("train_tp")
    mlp = [_mlp_inputs(act, 40 + k) for k, act in enumerate(ACTS)]
    payload = {"n": len(mlp)}
    for k, c in enumerate(mlp):
        payload.update({f"act{k}": c["act"], f"x{k}": c["x"],
                        f"ct{k}": c["ct"],
                        f"params{k}": np.array(c["params"], dtype=object)})
    np.savez(tmp / "in.npz", **payload)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = ranks.launch(f"{WORKER}:run", 4,
                           mesh=((2, 2), ("data", "model")), device="cpu",
                           args=(mlp,), timeout=600)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return mlp, out, np.load(tmp / "out.npz", allow_pickle=True)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _off(out, case):
    """What of a sharded case is off the local step: [(step, metric)]
    past rtol 1e-5, then [(tree, leaf, relative L2)] past 1e-4."""
    arch, _, remat, _, _ = W.CASES[case]
    hist, _, whole = out[0]["sharded"][case]
    l_hist, l_params, l_m = out[0]["local"][f"{arch}/{remat}"]
    bad = [(i, k) for i, (g, w) in enumerate(zip(hist, l_hist))
           for k in ("loss", "grad_norm")
           if abs(g[k] - w[k]) > LOSS_RTOL * abs(w[k])]
    for key, want in (("params", l_params), ("m", l_m)):
        for n, x in want.items():
            err = _rel(whole[key][n], x)
            if err > LEAF_TOL:
                bad.append((key, n, err))
    return bad


@pytest.mark.parametrize("case", MATCHING)
def test_partitioned_step_matches_local(run, case):
    """Two partitioned steps against the local step on the same weights
    and batches: the losses and gradient norms, and every leaf of the
    parameters and first moments; every rank reports the same history."""
    _, out, _ = run
    assert _off(out, case) == []
    hists = [o["sharded"][case][0] for o in out]
    assert all(h == hists[0] for h in hists), case


EXPECTED_MODES = {
    # one kv head stays whole beside the cut query heads: partial
    "gemma_2b/2x2": dict(cut={"wq", "wo", "w1", "w3", "w2", "embed"},
                         partial={"wk", "wv"}),
    "stablelm_12b/2x2": dict(cut={"wq", "wk", "wv", "wo", "w1", "w3", "w2",
                                  "embed", "lm_head"}, partial=set()),
    # 4 query heads cut over 4 ranks, the 2 kv heads whole
    "stablelm_12b/1x4": dict(cut={"wq", "wo", "w1", "w3", "w2", "embed",
                                  "lm_head"}, partial={"wk", "wv"}),
    "gemma_2b/2x2/parent": dict(cut=set(), partial=set()),
    "gemma_2b/2x2/unpartitioned": dict(cut=set(), partial=set()),
}


@pytest.mark.parametrize("case", sorted(EXPECTED_MODES))
def test_leaves_computed_on_the_model_cut(run, case):
    """Which leaves the step computes on the "model" cut, which are
    partial and which whole (norms, and everything under the parent's
    rules or unpartitioned)."""
    _, out, _ = run
    modes = out[0]["sharded"][case][1]
    by = {m: {n.rpartition(".")[2] for n, v in modes.items() if v == m}
          for m in ("cut", "partial", "whole")}
    assert by["cut"] == EXPECTED_MODES[case]["cut"]
    assert by["partial"] == EXPECTED_MODES[case]["partial"]
    assert not {n for n, v in modes.items()
                if v != "whole" and ("ln" in n or "norm" in n)}


@pytest.mark.parametrize("case", ["gemma_2b/2x2/unsummed",
                                  "stablelm_12b/1x4/unsummed"])
def test_control_partial_gradients_unsummed_fails(run, case):
    """The control: the partial leaves' gradients summed over the batch's
    axes only.  The gradient norm is off the local step, and the moments
    of ``wk`` and ``wv`` are off the most (the clipping scale moves every
    other leaf's a little)."""
    _, out, _ = run
    bad = _off(out, case)
    assert any(b[1] == "grad_norm" for b in bad if isinstance(b[0], int))
    moments = sorted((b[2], b[1].rpartition(".")[2]) for b in bad
                     if b[0] == "m")
    assert {"wk", "wv"} <= {leaf for _, leaf in moments}
    assert moments[-1][1] in ("wk", "wv")


def test_vocab_parallel_xent_and_embedding(run):
    """The vocab-parallel chunked cross-entropy against the plain one,
    softcap off and on, a quarter of the labels -100: the loss, dh and
    each rank's slice of the head's gradient; the lookup equal to
    ``table[ids]`` and its slice's gradient the plain one's rows."""
    _, out, _ = run
    for o in out:
        for cap, (loss, plain, dh, de) in o["xent"].items():
            assert loss == pytest.approx(plain, rel=1e-6), cap
            assert dh < 1e-6 and de < 1e-6, (cap, dh, de)
        equal, grad = o["embed"]
        assert equal and grad == 0.0
    assert out[0]["xent"][0.0][1] != out[0]["xent"][5.0][1]


def test_global_norm_under_the_partitioned_layout(run):
    """`global_norm` over the blocks of a tree laid out by the
    partitioned step's specs (leaves cut over "model", "data", both or
    none) equals the whole tree's."""
    _, out, _ = run
    for o in out:
        blocks, whole = o["global_norm"]
        assert blocks == pytest.approx(whole, rel=1e-6)


@pytest.mark.parametrize("k", range(len(ACTS)), ids=ACTS)
def test_mlp_matches_reference_vjp(run, k):
    """The partitioned MLP on each rank's data cut and "model" blocks
    against `jax.vjp` of the reference's `mlp_apply` under `jax.jit`, its
    weights placed by the reference's `params_shardings`: the output and
    dx rows, every leaf's gradient summed over the data cuts; the specs
    the two packages give the leaves agree."""
    _, out, ref = run
    specs = ref[f"specs{k}"].item()
    for o in out:
        got = o["mlp"][k]
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["y"], ref[f"y{k}"][rows], **TOL)
        np.testing.assert_allclose(got["dx"], ref[f"dx{k}"][rows], **TOL)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, ref[f"g{k}.{name}"], **TOL,
                                       err_msg=name)
            want = tuple(specs[name])
            while want and want[-1] is None:
                want = want[:-1]
            assert got["specs"][name] == want, name


def test_ranks_import_no_jax(run):
    """The ranks ran the port alone: no module of jax or of the
    reference was imported."""
    _, out, _ = run
    assert all(o["modules"] == [] for o in out)


def _recorded(arch, shape):
    """One partitioned step of reduced ``arch`` in f32 on a
    `RecordingMesh` of ``shape``: (the step, its parameters, the mesh's
    log)."""
    cfg = get_reduced(arch).replace(dtype="float32")
    mesh = RecordingMesh(shape, ("data", "model"))
    model = LM(cfg, device="cpu", seed=0, use_kernel=False)
    opt = AdamWConfig()
    step = make_sharded_train_step(model, opt, mesh,
                                   arch_rules(cfg, mesh, "train"))
    params = {n: shard_of(p.detach(), step.specs[n], mesh)
              for n, p in model.named_parameters()}
    step(params, init_state(params, opt), W.batch(cfg, 0))
    return step, params, mesh.log


@pytest.mark.parametrize("arch", ["gemma_2b", "stablelm_12b",
                                  "whisper_small"])
def test_no_all_gather_over_model_of_a_cut_leaf(arch):
    """From `RecordingMesh`'s log of one step on 2x2: every leaf the step
    computes on its "model" cut is all-gathered over "data" alone, and
    the all-gathers over "model" are exactly those of the leaves gathered
    whole whose spec names it: none for any of the three (whisper's
    cross-attention, gathered whole before, is cut now)."""
    step, params, log = _recorded(arch, (2, 2))
    gathers = [(axes, shape) for kind, axes, shape in log
               if kind == "all-gather"]
    over_model = Counter(s for a, s in gathers if "model" in a)
    over_data = Counter(s for a, s in gathers if a == ("data",))
    named = {n for n, s in step.specs.items()
             if "model" in str(s) and n in step.cuts}
    cut = {n for n in named if step.cuts[n].mode == "cut"}
    whole = named - cut
    assert cut
    assert over_model == Counter((1, *params[n].shape) for n in whole)
    want = Counter((1, *params[n].shape) for n in cut
                   if "data" in str(step.specs[n]))
    assert not want - over_data
    assert not whole
    assert (arch == "whisper_small") == any(".cross." in n for n in cut)


def _modes(arch, shape, names=("data", "model")):
    cfg = get_reduced(arch) if shape != (16, 16) else get_config(arch)
    mesh = RecordingMesh(shape, names)
    model = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(model.named_parameters()), mesh,
                             arch_rules(cfg, mesh, "train"))
    return specs, model_cuts(cfg, specs, mesh)


def test_model_cuts_on_the_production_mesh():
    """gemma_2b on (16, 16): its 8 query heads do not divide, so the
    attention stays whole (the reference's divisibility rule); the MLP and
    the tied vocabulary are cut, each on the dim its spec puts "model"
    on."""
    specs, cuts = _modes("gemma_2b", (16, 16))
    for name, c in cuts.items():
        key = name.rpartition(".")[2]
        if key in ("w1", "w3", "w2", "embed"):
            assert c.mode == "cut", name
            assert specs[name][c.dim] == "model", name
        else:
            assert c == ModelCut(None, "whole"), name


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "dbrx_132b",
                                  "jamba_1_5_large_398b"])
def test_model_cuts_keep_moe_configs_whole(arch):
    """A config with MoE layers keeps its MoE leaves whole (the experts,
    which the step keeps as blocks apart, and the router), while every
    leaf its rules cut over "model" outside them (attention, MLP, Mamba,
    vocabulary) is computed on the cut; deepseek_v3's MLA too (its
    ``wq_b``, ``wkv_b`` and ``wo``; ``wq_a`` and ``wkv_a`` stay whole)."""
    specs, cuts = _modes(arch, (2, 2))
    dense = {n for n, s in specs.items()
             if "model" in str(s) and ".moe." not in n}
    assert dense
    assert {c.mode for n, c in cuts.items() if ".moe." in n} == {"whole"}
    cut = {n for n, c in cuts.items() if c.mode == "cut"}
    assert cut == dense
    mla = {n.rpartition(".")[2] for n in cut if ".attn." in n}
    assert mla == ({"wq_b", "wkv_b", "wo"} if arch.startswith("deepseek")
                   else {"wq", "wk", "wv", "wo"})


def test_model_cuts_without_a_model_axis_or_with_parent_rules():
    """On (4,) ``("data",)`` nothing is cut; under rules that map qkv,
    kv_qkv, ffn and vocab to None neither."""
    _, cuts = _modes("stablelm_12b", (4,), ("data",))
    assert {c.mode for c in cuts.values()} == {"whole"}
    cfg = get_reduced("stablelm_12b")
    mesh = RecordingMesh((2, 2), ("data", "model"))
    model = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(model.named_parameters()), mesh,
                             {**arch_rules(cfg, mesh, "train"),
                              **W.PARENT})
    assert {c.mode for c in model_cuts(cfg, specs, mesh).values()} == \
        {"whole"}


@pytest.mark.parametrize("spec", [("data", "model"), ("model", "data"),
                                  (("data", "model"),), ("data",), ()])
def test_gather_and_cut_over_some_axes(spec):
    """`gather_full(..., axes=)` gathers only the dims ``spec`` shards
    over those axes and `shard_of(..., axes=)` cuts only those (a dim over
    both axes raises); on a `RecordingMesh` the shapes and the log show
    it."""
    mesh = RecordingMesh((2, 2), ("data", "model"), rank=3)
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    if spec == (("data", "model"),):
        with pytest.raises(ValueError, match="not within"):
            shard_of(full, spec, mesh, ("data",))
        return
    block = shard_of(full, spec, mesh)
    part = shard_of(full, spec, mesh, ("data",))
    want = [n // 2 if e == "data" else n for n, e in
            zip(full.shape, spec + (None,) * (2 - len(spec)))]
    assert list(part.shape) == want
    got = gather_full(block, spec, mesh, ("data",))
    assert got.shape == shard_of(full, spec, mesh, ("model",)).shape
    assert [a for _, a, _ in mesh.log] == ([("data",)] if "data" in spec
                                           else [])
