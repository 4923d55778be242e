"""MLA and cross-attention on the "model" cut in the sharded train and
serving steps, on 4 gloo CPU ranks, against the port's local paths.

One world of 4 ranks (module-scoped), rank side
`tests/_torch_mla_cross_sharded_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh and on (1, 4) over the same ranks, all in f32:

* training: the partitioned step (`launch.steps.make_sharded_train_step`)
  on reduced deepseek_v3 (MLA's ``wq_b`` / ``wkv_b`` / ``wo`` cut, its
  MoE layers at the no-drop factor) and whisper_small (its decoder's
  ``cross.*`` cut) on 2x2, two steps against the local step on the same
  weights and batches; the control sums deepseek_v3's ``wq_a`` gradients
  over "model" a second time;
* serving: `make_sharded_prefill_step` / `make_sharded_decode_step` on
  reduced deepseek_v3 (MLA's latent cache cut by sequence) and
  whisper_small (the encoder on the rank's batch and heads, its output
  in the cache, cross-attention on the rank's heads) against
  `LM.prefill` / `decode_step` on the whole model, decodes that cross
  the segments' boundaries from prompts shorter than a segment, and a
  cache whole along the sequence; the control expands a rank's latent
  segment with its own heads' columns of ``wkv_b`` only.

The layers themselves are held to the reference's `jax.vjp` in
`tests/test_torch_mla_cross_tp.py`; the reference's sharded model is no
live oracle on jax 0.9.0 (ROADMAP queue 3), so the steps are held to the
local path.

Tolerances: training's loss and gradient norm within rtol 1e-5, each
leaf of the parameters and of AdamW's first moment within relative L2
1e-4 (`tests/test_torch_train_tp.py`'s); serving's logits within relative
L2 1e-5 at the prefill and every decode step, their greedy tokens equal,
each cache block within 1e-6 (`tests/test_torch_serve_sharded.py`'s).
Each control must be off by more than 1e-3.
"""

import os

import pytest

import _torch_mla_cross_sharded_worker as W
from repro_torch.launch import ranks

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mla_cross_sharded_worker.py")
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
LOGIT_TOL, CACHE_TOL, CONTROL_MIN = 1e-5, 1e-6, 1e-3
MATCHING = sorted(c for c, (_, _, *rest) in W.SERVE.items()
                  if rest[-1] is None)


@pytest.fixture(scope="module")
def run():
    return ranks.launch(f"{WORKER}:run", 4, mesh=((2, 2), ("data", "model")),
                        device="cpu", timeout=600)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _off(run, case):
    """What of a training case is off the local step: [(step, metric)]
    past rtol 1e-5, then [(tree, leaf, relative L2)] past 1e-4."""
    arch = W.TRAIN[case][0]
    hist, _, whole = run[0]["train"][case]
    l_hist, l_params, l_m = run[0]["local"][arch]
    bad = [(i, k) for i, (g, w) in enumerate(zip(hist, l_hist))
           for k in ("loss", "grad_norm")
           if abs(g[k] - w[k]) > LOSS_RTOL * abs(w[k])]
    for key, want in (("params", l_params), ("m", l_m)):
        for n, x in want.items():
            err = _rel(whole[key][n], x)
            if err > LEAF_TOL:
                bad.append((key, n, err))
    return bad


@pytest.mark.parametrize("case", ["deepseek_v3_671b", "whisper_small"])
def test_partitioned_step_matches_local(run, case):
    """Two partitioned steps against the local step: the losses and
    gradient norms, every leaf of the parameters and first moments;
    every rank reports the same history."""
    assert _off(run, case) == []
    hists = [o["train"][case][0] for o in run]
    assert all(h == hists[0] for h in hists)


#: the leaves each layer computes on the cut; the rest of it is whole
CUT = {"deepseek_v3_671b": ({"wq_b", "wkv_b", "wo"}, ".attn."),
       "whisper_small": ({"wq", "wk", "wv", "wo"}, ".cross.")}


@pytest.mark.parametrize("case", sorted(CUT))
def test_mla_and_cross_leaves_computed_on_the_cut(run, case):
    """deepseek_v3's MLA leaves ``wq_b``, ``wkv_b`` and ``wo`` and
    whisper_small's ``cross.*`` leaves are "cut" in every layer; MLA's
    ``wq_a``, ``wkv_a`` and norms "whole" (never "partial": their
    gradients are whole on every rank)."""
    modes = run[0]["train"][case][1]
    want, module = CUT[case]
    mine = {n: m for n, m in modes.items() if module in n}
    assert mine
    for name, mode in mine.items():
        leaf = name.rpartition(".")[2] if ".attn.q_norm" not in name and \
            ".attn.kv_norm" not in name else "norm"
        assert mode == ("cut" if leaf in want else "whole"), (name, mode)


def test_control_wq_a_summed_twice_fails(run):
    """The control: deepseek_v3's ``wq_a`` marked "partial", so the step
    sums its whole gradient over "model" again.  The gradient norm is off
    the local step, and ``wq_a``'s first moments most of all."""
    bad = _off(run, "deepseek_v3_671b/wq_a_twice")
    assert any(b[1] == "grad_norm" for b in bad if isinstance(b[0], int))
    moments = sorted((b[2], b[1]) for b in bad if b[0] == "m")
    assert moments and moments[-1][1].endswith(".wq_a")
    assert moments[-1][0] > CONTROL_MIN


@pytest.mark.parametrize("case", MATCHING)
def test_sharded_serving_matches_local_path(run, case):
    """The prefill's last logits and every decode step's, on each rank's
    cut of the batch, within relative L2 1e-5 of the local path's, the
    greedy tokens equal; each cache block (MLA's ckv and krope, k and v,
    the encoder's output) within 1e-6 of the local cache's block; ``len``
    global."""
    _, _, _, prompt, _, steps, _ = W.SERVE[case]
    for o in run:
        got = o["serve"][case]
        assert max(got["logit_rel"]) <= LOGIT_TOL, got["logit_rel"]
        assert all(got["tokens_equal"])
        assert len(got["logit_rel"]) == 1 + steps
        assert got["cache_rel"] <= CACHE_TOL
        assert got["len"] == prompt + steps


@pytest.mark.parametrize("case,seq,blocks,enc", [
    ("deepseek_v3_671b/2x2", ("model",), {"ckv": (2, 8, 16),
                                          "krope": (2, 8, 8)}, None),
    ("deepseek_v3_671b/1x4", ("model",), {"ckv": (2, 4, 16),
                                          "krope": (2, 4, 8)}, None),
    ("deepseek_v3_671b/2x2/s_max_15", (), {"ckv": (2, 15, 16),
                                           "krope": (2, 15, 8)}, None),
    ("whisper_small/2x2", ("model",), {"k": (2, 8, 4, 16),
                                       "v": (2, 8, 4, 16)}, (2, 24, 64)),
    ("whisper_small/1x4", ("model",), {"k": (2, 4, 4, 16),
                                       "v": (2, 4, 4, 16)}, (2, 24, 64))])
def test_cache_block_layouts(run, case, seq, blocks, enc):
    """MLA's latent cut by sequence over "model" where s_max divides
    (whole along it where it does not), by batch over "data"; whisper's
    KV cache by sequence with every head (4 heads do not divide against
    the sequence's claim) and its encoder's output the rank's batch rows,
    whole along "model" (the reference's ``("batch", None, None)``)."""
    for o in run:
        got = o["serve"][case]
        assert got["seq"] == seq
        assert got["block_shapes"] == blocks
        assert got["enc_shape"] == enc


@pytest.mark.parametrize("case", MATCHING)
def test_no_whole_copy_of_a_cut_leaf_but_wkv_b(run, case):
    """Every leaf the steps compute on the cut is placed smaller than the
    whole leaf, but MLA's ``wkv_b``, placed whole on purpose (a decode
    step expands the rank's segment for every head)."""
    for o in run:
        got = o["serve"][case]
        assert got["cut"]
        assert all(n.endswith(".attn.wkv_b") for n in got["placed_whole"])
        assert bool(got["placed_whole"]) == case.startswith("deepseek")


def test_control_mla_decode_with_own_wkv_b_fails(run):
    """The control: each rank expands its latent segment for its own
    heads only and merges the partials across ranks that hold other
    heads.  The prefill holds (it attends over the prompt on the rank's
    heads); the decode steps' logits are off by more than 1e-3."""
    for o in run:
        got = o["serve"]["deepseek_v3_671b/2x2/own_wkv_b"]
        assert got["logit_rel"][0] <= LOGIT_TOL
        assert min(got["logit_rel"][1:]) > CONTROL_MIN


def test_ranks_import_no_jax(run):
    assert all(o["modules"] == [] for o in run)
