"""The port's expert-parallel MoE against the reference's sharded `moe_ffn`.

One world of 8 gloo ranks on a 2x2x2 ``("pod", "data", "model")`` mesh
(`_torch_moe_worker.py`, which imports no JAX) runs every case through
`repro_torch.models.moe.moe_ffn` under the mesh; one reference subprocess
with 8 fake devices on the same mesh runs the reference's `moe_ffn` under
`repro.sharding.use_mesh` with the serving rules, jitted, on the same
numpy inputs.  Both policies at the default capacity (where each shard
keeps its own capacity, and `swp_drop_newest` drops by the global arrival
rank of a sharded fetched FAA) and at a capacity where nothing drops; a
decode-shaped batch whose sequence does not split, and one whose batch
does not split over the data axes.  Outputs and aux losses within
rtol = atol = 1e-5 (f32 sums in another order); where nothing drops the
output also equals the port's local `moe_ffn`.  Each rank's global
arrival ranks must equal a host recount of the assignments in the
reference's (fsdp-major, model-minor) rank order.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import ranks
from repro_torch.models import moe

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from _torch_moe_worker import case_config, case_params  # noqa: E402

NDEV = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
TOL = dict(rtol=1e-5, atol=1e-5)
NO_DROP = 16.0     # capacity >= every token's k assignments to one expert


def _case(name, arch, policy, cf, shape, shared=0):
    return dict(name=name, arch=arch, shape=shape,
                moe=dict(overflow_policy=policy, capacity_factor=cf,
                         n_shared_experts=shared))


CASES = [_case(f"{policy}/{'nodrop' if cf == NO_DROP else 'default'}",
               "dbrx_132b", policy, cf, (4, 16))
         for policy in ("swp_drop_newest", "cas_keep_top_gate")
         for cf in (1.25, NO_DROP)]
CASES += [_case("jamba/decode/swp", "jamba_1_5_large_398b", "swp_drop_newest",
                1.25, (4, 1)),
          _case("dbrx/batch2/swp/shared", "dbrx_132b", "swp_drop_newest",
                1.25, (2, 16), shared=1)]


def _inputs(c, seed):
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
    return dict(c, params=params, x=nrm((*c["shape"], d), 1.0))


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
    with use_mesh(mesh, arch_rules(cfg, mesh, "serve")):
        y, aux = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(params, x)
    out[f"y{k}"] = np.asarray(y)
    out[f"aux{k}"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 8-rank world for every case; the reference's subprocess
    meanwhile."""
    tmp = tmp_path_factory.mktemp("moe_sharded")
    cases = [_inputs(c, 40 + k) for k, c in enumerate(CASES)]
    payload = {"n": len(cases)}
    for k, c in enumerate(cases):
        payload.update({f"arch{k}": c["arch"], f"moe{k}": c["moe"],
                        f"params{k}": c["params"], f"x{k}": c["x"]})
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
        worker = os.path.join(HERE, "_torch_moe_worker.py")
        results = ranks.launch(f"{worker}:run_moe", NDEV, mesh=MESH,
                               args=(cases,), device="cpu", timeout=300)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return cases, results, np.load(tmp / "out.npz")


IDS = [c["name"] for c in CASES]


@pytest.mark.parametrize("k", range(len(CASES)), ids=IDS)
def test_expert_parallel_matches_reference_sharded(run, k):
    cases, results, ref = run
    for r in results:                     # every rank holds the global out
        np.testing.assert_allclose(r[k]["y"], ref[f"y{k}"], **TOL)
        np.testing.assert_allclose(r[k]["aux"], float(ref[f"aux{k}"]), **TOL)
        assert r[k]["pre_cut_same"]
    assert np.abs(ref[f"y{k}"]).max() > 0.1


@pytest.mark.parametrize("k", [k for k, c in enumerate(CASES)
                               if c["moe"]["capacity_factor"] == NO_DROP],
                         ids=[c["name"] for c in CASES
                              if c["moe"]["capacity_factor"] == NO_DROP])
def test_expert_parallel_without_drops_equals_local(run, k):
    """Where no expert overflows, sharding changes no assignment: the
    output equals the port's local path on the same x."""
    cases, results, _ = run
    c = cases[k]
    cfg = case_config(c)
    want, aux = moe.moe_ffn(case_params(c), torch.from_numpy(c["x"]), cfg)
    for r in results:
        assert r[k]["keep"].all()
        np.testing.assert_allclose(r[k]["y"], want.numpy(), **TOL)
        np.testing.assert_allclose(r[k]["aux"], float(aux), **TOL)


@pytest.mark.parametrize("k", [k for k, c in enumerate(CASES)
                               if c["moe"]["overflow_policy"]
                               == "swp_drop_newest"],
                         ids=[c["name"] for c in CASES
                              if c["moe"]["overflow_policy"]
                              == "swp_drop_newest"])
def test_global_arrival_ranks_are_a_host_recount(run, k):
    """The sharded fetched FAA's ranks, exactly: each assignment's count
    of earlier assignments to its expert over the writers in mesh order
    (pod, data major; model minor), where the sequence splits (else no
    global rank is taken).  Where the batch splits every rank writes into
    one table; where it does not, each (pod, data) group's model ranks
    share a table of their own.  No assignment past the global capacity
    is kept."""
    cases, results, _ = run
    plan = results[0][k]["plan"]
    if not plan.seq_split:
        assert all(r[k]["global_rank"] is None for r in results)
        return
    group = NDEV if plan.b_split else plan.ep
    for lo in range(0, NDEV, group):
        mine = results[lo:lo + group]          # world rank = mesh order
        ids = np.concatenate([r[k]["ids"].reshape(-1) for r in mine])
        want = np.zeros_like(ids)
        seen = {}
        for i, e in enumerate(ids):
            want[i] = seen.get(int(e), 0)
            seen[int(e)] = want[i] + 1
        got = np.concatenate([r[k]["global_rank"] for r in mine])
        np.testing.assert_array_equal(got, want)
    for r in results:
        assert not (r[k]["keep"]
                    & (r[k]["global_rank"] >= plan.global_capacity)).any()


def test_plans_follow_the_reference_specs(run):
    """Sequence and batch splits as the reference decides them."""
    _, results, _ = run
    plans = {c["name"]: results[0][k]["plan"] for k, c in enumerate(CASES)}
    assert plans["swp_drop_newest/default"].b_split
    assert plans["swp_drop_newest/default"].seq_split
    assert plans["jamba/decode/swp"].b_split
    assert not plans["jamba/decode/swp"].seq_split
    assert not plans["dbrx/batch2/swp/shared"].b_split
    assert plans["dbrx/batch2/swp/shared"].replica_axes == ()
    assert results[0][0]["launches"] == {"rmw_table": 0,
                                         "rmw_table_fetched": 0,
                                         "slot_counts": 0}   # CPU: none
