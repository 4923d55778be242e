"""The partitioned train step on Mamba-2 and the MoE configs' dense
leaves, on 4 gloo CPU ranks, against the port's local step.

One world of 4 ranks (module-scoped), rank side
`tests/_torch_train_tp_ssm_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh and on (1, 4) over the same ranks: mamba2_780m with its
mixers on the rank's heads (remat "full" and "none", 2 and 4 heads a
rank), jamba (Mamba, GQA, dense MLP, MoE and vocabulary; in f64, as
`tests/_torch_train_sharded_moe_worker.py` runs it), dbrx and
deepseek_v3 with their dense leaves cut beside the expert-parallel
layer; the control leaves the Mamba leaves' partial gradients unsummed
over "model".  The mixer itself against the reference is
`tests/test_torch_mamba_tp.py`'s.  `RecordingMesh`'s log of one step, in
this process, shows ``in_proj``'s blocks all-gathered over "model" at
use and never whole.

Tolerances (the sharded tests'): loss and gradient norm within rtol
1e-5, each leaf of the parameters and of AdamW's first moment within
relative L2 1e-4.
"""

from collections import Counter

import pytest
import torch

import _torch_train_tp_ssm_worker as W
from repro_torch.configs import get_reduced
from repro_torch.launch import ranks
from repro_torch.launch.mesh import RecordingMesh, shard_of, use_mesh
from repro_torch.launch.shardings import arch_rules
from repro_torch.launch.steps import make_sharded_train_step
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, init_state

LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
MATCHING = [c for c in W.CASES if not c.endswith("/unsummed")]
SSM_PARTIAL = {"conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w"}


@pytest.fixture(scope="module")
def run():
    return ranks.launch(f"{W.__file__}:run", 4,
                        mesh=((2, 2), ("data", "model")), device="cpu",
                        timeout=600)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _off(out, case):
    """What of a sharded case is off the local step: [(step, metric)]
    past rtol 1e-5, then [(tree, leaf, relative L2)] past 1e-4."""
    arch, _, remat, _ = W.CASES[case]
    hist, _, whole, _ = out[0]["sharded"][case]
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
    assert _off(run, case) == []
    hists = [o["sharded"][case][0] for o in run]
    assert all(h == hists[0] for h in hists), case


@pytest.mark.parametrize("case", MATCHING)
def test_in_proj_never_gathered_whole_into_the_model(run, case):
    """On every rank the model's own ``in_proj`` leaves keep their initial
    values through the steps: the mixers computed on the blocks the step
    handed them."""
    assert all(o["sharded"][case][3] for o in run)


@pytest.mark.parametrize("case", ["mamba2_780m/2x2",
                                  "jamba_1_5_large_398b/2x2",
                                  "dbrx_132b/2x2"])
def test_leaves_computed_on_the_model_cut(run, case):
    """Which leaves the step computes on the "model" cut: each Mamba
    mixer's ``in_proj`` and ``out_proj``, its other leaves partial; the
    MoE configs' GQA attention, dense MLPs and vocabulary, their expert
    leaves never cut."""
    modes = run[0]["sharded"][case][1]
    by = {m: {n.rpartition(".")[2] for n, v in modes.items() if v == m}
          for m in ("cut", "partial")}
    want = {"mamba2_780m/2x2": ({"embed", "in_proj", "out_proj"},
                                SSM_PARTIAL),
            "jamba_1_5_large_398b/2x2": (
                {"embed", "lm_head", "in_proj", "out_proj", "wq", "wk", "wv",
                 "wo", "w1", "w3", "w2"}, SSM_PARTIAL),
            "dbrx_132b/2x2": ({"embed", "lm_head", "wq", "wk", "wv", "wo"},
                              set())}[case]
    assert (by["cut"], by["partial"]) == want
    assert not [n for n, v in modes.items() if ".moe." in n and v == "cut"]


def test_control_partial_ssm_gradients_unsummed_fails(run):
    """The control: the Mamba leaves whose specs keep them whole get their
    gradients summed over the batch's axes only.  The gradient norm is
    off the local step, and the first moment most off is one of those
    leaves'."""
    bad = _off(run, "mamba2_780m/2x2/unsummed")
    assert any(b[1] == "grad_norm" for b in bad if isinstance(b[0], int))
    moments = sorted((b[2], b[1].rpartition(".")[2]) for b in bad
                     if b[0] == "m")
    assert moments and moments[-1][1] in SSM_PARTIAL


def test_ranks_import_no_jax(run):
    """The ranks ran the port alone: no module of jax or of the
    reference was imported."""
    assert all(o["modules"] == [] for o in run)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_in_proj_gathered_over_model_at_use(remat):
    """From `RecordingMesh`'s log of one partitioned step of reduced
    mamba2_780m on 2x2: each mixer all-gathers its ``in_proj`` block's
    transpose over "model" once a forward (twice with remat "full": the
    recomputation), and no all-gather puts a whole ``in_proj`` together
    over both axes."""
    cfg = get_reduced("mamba2_780m").replace(dtype="float32")
    mesh = RecordingMesh((2, 2), ("data", "model"))
    model = LM(cfg, device="cpu", seed=0, use_kernel=False,
               remat_policy=remat)
    opt = AdamWConfig()
    rules = arch_rules(cfg, mesh, "train")
    step = make_sharded_train_step(model, opt, mesh, rules)
    params = {n: shard_of(p.detach(), step.specs[n], mesh)
              for n, p in model.named_parameters()}
    with use_mesh(mesh, rules):
        step(params, init_state(params, opt), W.batch(cfg, 0))
    names = [n for n in params if n.endswith(".in_proj")]
    d, width = model.get_parameter(names[0]).shape
    gathers = Counter((axes, shape) for kind, axes, shape in mesh.log
                      if kind == "all-gather")
    per = 2 if remat == "full" else 1
    assert gathers[(("model",), (width // 2, d))] == per * len(names)
    assert not [s for a, s in gathers if a != ("model",)
                and s == (1, *params[names[0]].shape)
                and len(a) == 2]
