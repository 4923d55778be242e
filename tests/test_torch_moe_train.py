"""The training variant of the port's expert-parallel MoE layer against
`jax.vjp` of the reference's sharded `moe_ffn`, and sharded MoE training
on a (2,2,2) mesh against the local trainer.

One world of 8 gloo ranks on a 2x2x2 ``("pod", "data", "model")`` mesh
(`_torch_moe_train_worker.py`, which imports no JAX) runs every case;
one reference subprocess with 8 fake devices on the same mesh runs
`jax.vjp` of the reference's `moe_ffn` under `repro.sharding.use_mesh`
with the training rules, on the same numpy inputs and cotangents (the
output's and the aux loss's).  Each rank holds its data cut of ``x`` and
its blocks of the expert weights, as the sharded step does (`moe.
training_blocks`); the cases cover both overflow policies at the
config's capacity (where assignments drop) and at the no-drop factor E /
k, and a shared expert.  The output, ``dx``, the router's and the shared
expert's gradients (summed over the data cuts) and each rank's expert
blocks' gradients within rtol = atol = 1e-5.

The same world then trains deepseek_v3, jamba and dbrx (reduced, f32 and
jamba f64, the no-drop factor) for 3 steps on (2,2,2), and deepseek_v3 on
the masked batch, against the local trainer run here (the bounds of
`_torch_train_sharded_moe_worker`), and restores deepseek_v3's (2,2,2)
checkpoint onto 2x2 meshes through `reshard_restore`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_train_sharded_moe_worker as TW
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch import ranks
from repro_torch.launch import train as ttrain
from repro_torch.launch.shardings import arch_rules, params_shardings
from repro_torch.optim.adamw import AdamWConfig, init_state

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NDEV = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
TOL = dict(rtol=1e-5, atol=1e-5)
DEFAULT = 1.25     # the reduced configs' capacity factor
NO_DROP = 2.0      # E / k of reduced dbrx (4 experts, top 2)


def _case(name, policy, cf, shared=0):
    return dict(name=name, arch="dbrx_132b", shape=(4, 16),
                moe=dict(overflow_policy=policy, capacity_factor=cf,
                         n_shared_experts=shared))


CASES = [_case(f"{policy}/{'nodrop' if cf == NO_DROP else 'default'}",
               policy, cf)
         for policy in ("swp_drop_newest", "cas_keep_top_gate")
         for cf in (DEFAULT, NO_DROP)]
CASES += [_case("swp/default/shared", "swp_drop_newest", DEFAULT,
                shared=1)]


def _inputs(c, seed):
    from _torch_moe_worker import case_config
    cfg = case_config(c)
    m, d = cfg.moe, cfg.d_model
    e, f = m.n_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)
    nrm = lambda shape, scale: (rng.normal(size=shape) * scale).astype(
        np.float32)
    params = {"router": nrm((d, e), d ** -0.5),
              "w1": nrm((e, d, f), d ** -0.5), "w3": nrm((e, d, f), d ** -0.5),
              "w2": nrm((e, f, d), f ** -0.5)}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        params.update({"shared.w1": nrm((d, fs), d ** -0.5),
                       "shared.w3": nrm((d, fs), d ** -0.5),
                       "shared.w2": nrm((fs, d), fs ** -0.5)})
    return dict(c, params=params, x=nrm((*c["shape"], d), 1.0),
                ct=nrm((*c["shape"], d), 1.0), ct_aux=np.float32(3.0))


_JAX = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.shardings import arch_rules
from repro.models.moe import moe_ffn
from repro.sharding import use_mesh

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
data = np.load(sys.argv[1], allow_pickle=True)
out = {}
for k in range(int(data["n"])):
    arch = str(data[f"arch{k}"])
    over = data[f"moe{k}"].item()
    cfg = get_reduced(arch).replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **over))
    flat = data[f"params{k}"].item()
    params = {n: jnp.asarray(v) for n, v in flat.items() if "." not in n}
    if cfg.moe.n_shared_experts:
        params["shared"] = {n.split(".")[1]: jnp.asarray(v)
                            for n, v in flat.items() if "." in n}
    x = jnp.asarray(data[f"x{k}"])

    def vjp(params, x, ct, ct_aux):
        (y, aux), back = jax.vjp(lambda p, x: moe_ffn(p, x, cfg), params, x)
        return y, aux, back((ct, ct_aux))

    # jitted: the eager transpose of cas_keep_top_gate's segmented scan
    # trips a sharding override (`associative_scan` under the mesh)
    with use_mesh(mesh, arch_rules(cfg, mesh, "train")):
        y, aux, (gp, gx) = jax.jit(vjp)(params, x,
                                        jnp.asarray(data[f"ct{k}"]),
                                        jnp.asarray(data[f"ct_aux{k}"]))
    out[f"y{k}"] = np.asarray(y)
    out[f"aux{k}"] = np.asarray(aux)
    out[f"dx{k}"] = np.asarray(gx)
    for n, g in gp.items():
        if isinstance(g, dict):
            for m, h in g.items():
                out[f"g{k}.{n}.{m}"] = np.asarray(h)
        else:
            out[f"g{k}.{n}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 8-rank world for every case; the reference's subprocess
    meanwhile."""
    tmp = tmp_path_factory.mktemp("moe_train")
    cases = [_inputs(c, 70 + k) for k, c in enumerate(CASES)]
    payload = {"n": len(cases)}
    for k, c in enumerate(cases):
        payload.update({f"arch{k}": c["arch"], f"moe{k}": c["moe"],
                        f"params{k}": c["params"], f"x{k}": c["x"],
                        f"ct{k}": c["ct"], f"ct_aux{k}": c["ct_aux"]})
    np.savez(tmp / "in.npz", **{k: (np.array(v, dtype=object)
                                    if isinstance(v, dict) else v)
                                for k, v in payload.items()})
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
        worker = os.path.join(HERE, "_torch_moe_train_worker.py")
        results = ranks.launch(f"{worker}:run", NDEV, mesh=MESH,
                               args=(cases, str(tmp / "cube")),
                               device="cpu", timeout=600)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return cases, results, np.load(tmp / "out.npz"), str(tmp / "cube")


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_layer_matches_reference_vjp(run, k):
    """The training variant on each rank's cut and blocks against
    `jax.vjp` of the reference's sharded `moe_ffn` on the whole batch:
    output and dx rows, aux loss, the router's (and the shared expert's)
    gradient summed over the data cuts, and every rank's expert blocks'
    gradients."""
    cases, results, ref, _ = run
    cfg_moe = cases[k]["moe"]
    e_loc = 4 // 2
    for o in results:
        got = o["layer"][k]
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["y"], ref[f"y{k}"][rows], **TOL)
        np.testing.assert_allclose(got["dx"], ref[f"dx{k}"][rows], **TOL)
        assert got["aux"] == pytest.approx(float(ref[f"aux{k}"]), rel=1e-5)
        for name, g in got["summed"].items():
            np.testing.assert_allclose(g, ref[f"g{k}.{name}"], **TOL,
                                       err_msg=name)
        i = got["coords"]["model"]
        j = 2 * got["coords"]["pod"] + got["coords"]["data"]
        for name, g in got["blocks"].items():
            full = ref[f"g{k}.{name}"]
            r = full.shape[1] // 4
            want = full[i * e_loc:(i + 1) * e_loc, j * r:(j + 1) * r]
            np.testing.assert_allclose(g, want, **TOL, err_msg=name)
    assert ("shared" in cases[k]["name"]) == bool(
        cfg_moe["n_shared_experts"])


def test_cases_drop_at_the_default_capacity(run):
    """The default-capacity cases drop assignments where the reference
    does (their outputs differ from the no-drop ones'), so the gradient
    check covers the dispatch's filter."""
    cases, _, ref, _ = run
    names = [c["name"] for c in cases]
    for policy in ("swp_drop_newest", "cas_keep_top_gate"):
        a = names.index(f"{policy}/default")
        b = names.index(f"{policy}/nodrop")
        assert not np.allclose(ref[f"y{a}"], ref[f"y{b}"], **TOL), policy


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """The local trainer's runs at the no-drop factor: {case: (history,
    failures, ckpt dir)}."""
    tmp = tmp_path_factory.mktemp("moe_train_local")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "get_reduced", TW.no_drop)
        runs = [(arch, arch, TW._synthetic_batch) for arch in TW.ARCHS]
        runs.append(("masked", TW.ARCHS[0], TW.masked_batch))
        for case, arch, batch in runs:
            mp.setattr(ttrain, "synthetic_batch", batch)
            path = str(tmp / case)
            got = ttrain.train(arch, ckpt_dir=path, checkpoint_every=3,
                               **TW.TRAIN)
            out[case] = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
                          for h in got["history"]], got["failures"], path)
    return out


def _cube(run, case):
    _, results, _, tmp = run
    hist, failures = results[0]["cube"][case]
    assert all(o["cube"][case] == results[0]["cube"][case]
               for o in results), case
    return hist, failures, TW.ckpt_dir(tmp, case)


@pytest.mark.parametrize("arch", TW.ARCHS)
def test_sharded_moe_on_2x2x2_matches_local(run, local, arch):
    """Each MoE config on (2,2,2), 3 steps at the no-drop factor: losses,
    gradient norms and every leaf of the final checkpoint against the
    local trainer; every rank reports the same run."""
    assert TW.runs_off(_cube(run, f"{arch}/2x2x2"), local[arch],
                       arch) == []


def test_masked_batch_on_2x2x2_matches_local(run, local):
    """deepseek_v3 on the masked batch on (2,2,2): four data cuts with
    unequal label counts, weighted before the backward."""
    assert TW.runs_off(_cube(run, "masked/2x2x2"), local["masked"],
                       TW.ARCHS[0]) == []


class _Mesh:
    """What the spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def test_restore_2x2x2_checkpoint_onto_2x2(run):
    """deepseek_v3's step-3 checkpoint, written on (2,2,2), restored by
    `reshard_restore(cfg=...)` onto a 2x2 ``("data", "model")`` mesh of
    each half of the world: every rank's block of every parameter, master
    weight and first moment equals the stored leaf's slice at the 2x2
    spec (the expert leaves over "model" and "data" among them)."""
    _, results, _, tmp = run
    cfg = TW.no_drop(TW.ARCHS[0])
    model = ttrain.build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    like = {"params": params, "opt": init_state(params, AdamWConfig())}
    tree, _ = ckpt_lib.restore(TW.ckpt_dir(tmp, f"{TW.ARCHS[0]}/2x2x2"), 3,
                               like)
    mesh = _Mesh((2, 2), ("data", "model"))
    specs = params_shardings(cfg, params, mesh, arch_rules(cfg, mesh))
    assert specs["blocks.1.moe.w1"] == ("model", "data")
    for o in results:
        got = o["cube"]["restored"]
        assert got["step"] == 3
        for key, host in (("params", tree["params"]),
                          ("master", tree["opt"]["master"]),
                          ("m", tree["opt"]["m"])):
            for name, full in host.items():
                want = full.numpy()
                for dim, entry in enumerate(specs[name]):
                    if entry is None:
                        continue
                    axes = (entry,) if isinstance(entry, str) else entry
                    idx, n = 0, 1
                    for a in axes:
                        idx = idx * mesh.shape[a] + got["coords"][a]
                        n *= mesh.shape[a]
                    size = want.shape[dim] // n
                    want = want.take(range(idx * size, (idx + 1) * size),
                                     axis=dim)
                np.testing.assert_array_equal(got[key][name], want,
                                              err_msg=f"{key} {name}")
