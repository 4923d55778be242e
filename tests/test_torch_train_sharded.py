"""Sharded training: `launch.train.train(mesh=...)` on 4 gloo CPU ranks,
against the port's local trainer and the reference's local step.

One world of 4 ranks (module-scoped) runs every sharded case, rank side
`tests/_torch_train_sharded_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh and on (4,) ``("data",)`` over the same ranks, all in f32.
The local runs and the reference's step run here.  Tolerances: the
worker's (PR 22's), and the reference's step as `_torch_train` holds the
local one (the master weights within 5% of the step's learning rate).
The sharded model is not a live oracle on the reference's side
(`jnp.take` under a mesh, ROADMAP queue 3), so the reference's step is
its local one on the same weights.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_train as tt
import _torch_train_sharded_worker as W
from repro import sharding as jsharding
from repro.launch import shardings as jshardings
from repro.models.model import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import apply_updates as japply_updates
from repro.optim.adamw import init_state as jinit_state
from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch import ranks
from repro_torch.launch import train as ttrain
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, init_state

WORKER = str(Path(__file__).with_name("_torch_train_sharded_worker.py"))


@pytest.fixture(scope="module")
def reference_step():
    """The reference's weights, batch and local first step (f32 reduced
    gemma_2b): (params, batch, loss, grad_norm, lr, master)."""
    jcfg, _ = tt.configs("gemma_2b")
    model = jbuild(jcfg, attn_impl="chunked", remat_policy="none",
                   loss_chunk=tt.LOSS_CHUNK)
    params = model.init(jax.random.PRNGKey(1))
    batch = tt.batches(jcfg.vocab_size, n=1)[0]
    opt = JAdamWConfig(**tt.OPT)
    loss, grads = jax.value_and_grad(model.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, st, m = japply_updates(params, grads, jinit_state(params, opt), opt)
    return dict(params=tt._np(params), batch=batch, loss=float(loss),
                grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                master=convert.flatten_reference(tt._np(st["master"])))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, reference_step):
    tmp = tmp_path_factory.mktemp("train_sharded")
    out = ranks.launch(
        f"{WORKER}:run", 4, mesh=((2, 2), ("data", "model")), device="cpu",
        args=(str(tmp), reference_step["params"], reference_step["batch"],
              tt.OPT), timeout=600)
    return str(tmp), out


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """The local trainer's runs the sharded ones are held to, in f32, with
    their final checkpoints: {case: (history, failures, ckpt dir)}."""
    tmp = tmp_path_factory.mktemp("train_local")
    runs = {"plain/" + arch: (arch, {}) for arch in W.ARCHS}
    runs.update({"micro": ("gemma_2b", dict(microbatches=2)),
                 "masked": ("gemma_2b", {}),
                 "elastic": ("gemma_2b", dict(steps=4))})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "get_reduced", W.f32)
        for case, (arch, kw) in runs.items():
            if case == "masked":
                mp.setattr(ttrain, "synthetic_batch", W.masked_batch)
            path = str(tmp / case.replace("/", "-"))
            got = ttrain.train(arch, ckpt_dir=path,
                               checkpoint_every=kw.get("steps", 3),
                               **{**W.TRAIN, **kw})
            out[case] = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
                          for h in got["history"]], got["failures"], path)
            mp.setattr(ttrain, "synthetic_batch", W._synthetic_batch)
    return out


def _sharded_case(sharded, case):
    tmp, out = sharded
    hist, failures = out[0][case]
    assert all(o[case] == out[0][case] for o in out), case  # ranks agree
    return hist, failures, W.ckpt_dir(tmp, case)


def test_block_helpers_cut_and_gather(sharded):
    """`shard_of` keeps a block of each sharded dim's size over its axes'
    and `gather_full` puts the leaf back, for specs over one axis, two
    axes on two dims, two axes on one dim (either order) and none, on
    both meshes."""
    _, out = sharded
    split = {None: 1, "data": 2, "model": 2, ("data", "model"): 4,
             ("model", "data"): 4}
    for o in out:
        assert len(o["blocks"]) == sum(map(len, W.BLOCK_SPECS.values()))
        for tag, spec, shape, whole in o["blocks"]:
            spec = spec + (None,) * (3 - len(spec))
            want = tuple(n // (4 if tag == "4" and e else split[e])
                         for n, e in zip((8, 12, 4), spec))
            assert whole and shape == want, (tag, spec, shape)


@pytest.mark.parametrize("mesh", ["2x2", "4"])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_matches_local(sharded, local, arch, mesh):
    """Every config on both meshes: 3 steps, the losses, gradient norms
    and every leaf of the final checkpoint (gathered, written by rank 0)
    against the local trainer."""
    assert W.runs_off(_sharded_case(sharded, f"{arch}/{mesh}"),
                  local[f"plain/{arch}"], arch) == []


@pytest.mark.parametrize("mesh", ["2x2", "4"])
def test_microbatches_match_local(sharded, local, mesh):
    """Two microbatches, each the global batch's cut shared among the
    ranks, against the local trainer's two microbatches."""
    assert W.runs_off(_sharded_case(sharded, f"micro/{mesh}"),
                  local["micro"]) == []


def test_uneven_mask_weighted_by_counts(sharded, local):
    """Half the rows 90% masked, so one data cut holds a tenth of the
    other's valid labels: weighting by the all-reduced counts matches the
    local trainer; the control, a mean of the ranks' means, fails."""
    assert W.runs_off(_sharded_case(sharded, "masked"),
                      local["masked"]) == []
    bad = W.runs_off(_sharded_case(sharded, "mean_of_means"),
                     local["masked"])
    assert {b[1] for b in bad if isinstance(b[0], int)} >= {"loss",
                                                            "grad_norm"}


def test_clipping_is_active(sharded):
    """The comparisons above cover clipping: gemma_2b's gradient norm is
    over `grad_clip` (1.0) in every step of its runs on both meshes, with
    two microbatches and under the mask (AdamW's default clip)."""
    _, out = sharded
    for case in ("gemma_2b/2x2", "gemma_2b/4", "micro/2x2", "micro/4",
                 "masked"):
        assert min(h["grad_norm"] for h in out[0][case][0]) > 1.0, case


def test_first_step_matches_reference_step(sharded, reference_step):
    """gemma_2b's first sharded step on 2x2, on the reference's weights
    and batch (one row a data cut), against the reference's local
    `apply_updates` step: the loss, the gradient norm and every master
    leaf within 5% of the step's learning rate."""
    _, out = sharded
    loss, gnorm, master = out[0]["reference_step"]
    assert loss == pytest.approx(reference_step["loss"], rel=tt.LOSS_RTOL)
    assert gnorm == pytest.approx(reference_step["grad_norm"], rel=1e-5)
    err, leaf = tt.max_abs(master, reference_step["master"])
    assert err <= 0.05 * reference_step["lr"], (leaf, err)


def test_chaos_run_is_bit_equal_to_a_clean_one(sharded):
    """A step fault and a save fault on every rank (one `FaultPlan`):
    failures, and every leaf of the final checkpoint bit-equal to the
    clean sharded run's."""
    tmp, out = sharded
    clean, chaos = (_sharded_case(sharded, f"recovery/{t}")
                    for t in ("clean", "chaos"))
    assert clean[1] == 0 and chaos[1] >= 2
    assert clean[0][-1]["loss"] == chaos[0][-1]["loss"]
    (sa, a), (sb, b) = (W.final_state(c[2], "gemma_2b")
                        for c in (clean, chaos))
    assert sa == sb == 6
    for key in a:
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def _reference_specs():
    """The reference's spec for each port parameter of f32 reduced
    gemma_2b on (4,) ``("data",)``, by the reference's own functions
    against an abstract mesh (no devices), stacked leaves with their
    leading entry removed."""
    jcfg, cfg = tt.configs("gemma_2b")
    mesh = AbstractMesh((4,), ("data",))
    rules = jshardings.arch_rules(jcfg, mesh, "train")
    abstract = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    state = jsharding._state
    prev = (getattr(state, "mesh", None), getattr(state, "rules", {}))
    state.mesh, state.rules = mesh, rules
    try:
        specs = {".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                          for k in path):
                 tuple(jsharding.logical_to_physical(
                     jshardings._leaf_axes(path, x), x.shape))
                 for path, x in jax.tree_util.tree_flatten_with_path(
                     abstract)[0]}
    finally:
        state.mesh, state.rules = prev
    out = {}
    for port, (path, r) in convert.name_map(LM(cfg, device="meta")).items():
        spec = specs[path]
        out[port] = spec[1:] if r is not None else spec
    return out


def test_restore_onto_another_mesh_is_exact_per_block(sharded):
    """The 2x2 run's step-2 checkpoint restored by
    `reshard_restore(cfg=...)` onto (4,) ``("data",)``: each rank's block
    of every parameter, master weight and moment is bit-equal to the
    stored array's slice at the reference's spec."""
    tmp, out = sharded
    path = W.ckpt_dir(tmp, "elastic/2x2")
    model = LM(W.f32("gemma_2b"), device="cpu")
    params = dict(model.named_parameters())
    like = {"params": params, "opt": init_state(params, AdamWConfig())}
    tree, _ = ckpt_lib.restore(path, 2, like)
    specs = _reference_specs()
    sharded_some = 0
    for rank, got in enumerate(o["restored"] for o in out):
        assert got["step"] == 2
        for key, host in (("params", tree["params"]),
                          ("master", tree["opt"]["master"]),
                          ("m", tree["opt"]["m"])):
            for name, full in host.items():
                want = full.numpy()
                for dim, entry in enumerate(specs[name]):
                    if entry is None:
                        continue
                    assert entry == "data", (name, specs[name])
                    n = want.shape[dim] // 4
                    want = want.take(range(rank * n, (rank + 1) * n),
                                     axis=dim)
                    sharded_some += 1
                np.testing.assert_array_equal(got[key][name], want,
                                              err_msg=f"{key} {name}")
    assert sharded_some > 0


def test_resumed_run_matches_uninterrupted(sharded, local):
    """From the 2x2 run's step-2 checkpoint, two more steps on (4,)
    ``("data",)``: the final checkpoint against the uninterrupted 2x2
    run's and the local one's."""
    tmp, out = sharded
    resumed = _sharded_case(sharded, "resumed/4")
    whole = _sharded_case(sharded, "elastic/2x2")
    assert [h["loss"] for h in resumed[0]] == pytest.approx(
        [h["loss"] for h in whole[0][2:]], rel=1e-5)
    assert W.runs_off(whole, local["elastic"]) == []
    (sa, a), (sb, b) = (W.final_state(c[2], "gemma_2b")
                        for c in (resumed, whole))
    assert sa == sb == 4
    assert W.leaves_off(a, b, sum(h["lr"] for h in whole[0])) == []


def test_tuning_under_a_mesh(sharded):
    """`tuning=True` under a mesh, through `train_on_mesh` (the launcher's
    target): the controller runs on the mesh (every rank
    steps it alike) and the losses are bit-equal to the untuned run's
    (the same first two learning rates)."""
    _, out = sharded
    losses, updates = out[0]["tuning"]
    assert all(o["tuning"] == out[0]["tuning"] for o in out)
    assert losses == [h["loss"] for h in out[0]["gemma_2b/2x2"][0][:2]]
    assert updates >= 0


class _Mesh:
    """What `train` reads of a mesh before any rank starts work."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("arch", ["deepseek_v3_671b",
                                  "jamba_1_5_large_398b", "dbrx_132b"])
def test_moe_configs_under_a_mesh_raise(arch):
    with pytest.raises(NotImplementedError, match="sharded MoE training"):
        ttrain.train(arch, steps=1, mesh=_Mesh((2, 2), ("data", "model")),
                     device="cpu")


def test_unknown_mesh_axes_and_rules_without_mesh_raise():
    """A mesh axis no rule names, rules without a mesh, and a mesh without
    deterministic algorithms all raise before any rank starts work."""
    with pytest.raises(NotImplementedError, match=r"\['dev'\]"):
        ttrain.train("gemma_2b", steps=1, mesh=_Mesh((2, 2), ("pod", "dev")),
                     device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        ttrain.train("gemma_2b", steps=1, mesh=_Mesh((2, 2), ("data",
                                                              "model")),
                     device="cpu", deterministic=False)
    with pytest.raises(ValueError, match="needs a mesh"):
        ttrain.train("gemma_2b", steps=1, rules={}, device="cpu")
