"""Sharded serving of Mamba-2 and the hybrid config on 4 gloo CPU ranks,
against the port's local serving path.

One world of 4 ranks (module-scoped), rank side
`tests/_torch_serve_sharded_ssm_worker.py` (no JAX), in f32: reduced
mamba2_780m on 2x2 ``("data", "model")`` (4 heads a rank), on (1, 4) (2
heads a rank) and under the long_500k cell's rules (the batch whole
along "data", the state by heads), and reduced jamba on 2x2 (Mamba
layers on the rank's heads, attention on the sequence-cut cache, the
dense MLP and vocabulary cut, the expert-parallel MoE layer), each a
prefill and several decode steps through
`launch.steps.make_sharded_prefill_step` / `make_sharded_decode_step`
against `LM.prefill` / `decode_step` on the whole model.  The SSM state
is cut by heads as the reference's ``_CACHE_AXES["ssm"]``; the conv
window keeps the rank's channels (its x channels and every B and C
channel), where the reference replicates it.

Tolerance: relative L2 1e-5 on every step's logits and every cache block,
the greedy tokens equal.
"""

import pytest

import _torch_serve_sharded_ssm_worker as W
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import ranks
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.shardings import arch_rules
from repro_torch.launch.steps import make_sharded_prefill_step
from repro_torch.models.model import LM

REL_TOL = 1e-5


@pytest.fixture(scope="module")
def run():
    return ranks.launch(f"{W.__file__}:run", 4,
                        mesh=((2, 2), ("data", "model")), device="cpu",
                        timeout=600)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_sharded_steps_match_local_path(run, case):
    """Prefill and every decode step's logits of the rank's cut of the
    batch within relative L2 1e-5 of the local path's, the greedy tokens
    equal, on every rank."""
    for o in run:
        r = o["serve"][case]
        assert max(r["logit_rel"]) <= REL_TOL, (case, r["logit_rel"])
        assert all(r["tokens_equal"]), case


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_cache_blocks_match_local_cache(run, case):
    """Every cache block against the local cache's block: the SSM state by
    heads, the conv window's rows of the rank's batch and the channels
    it convolves, and jamba's k and v by sequence; each layer's ``len``
    the global one."""
    arch, _, b, prompt, _, steps, _ = W.CASES[case]
    for o in run:
        r = o["serve"][case]
        want = {"ssm", "conv"} | ({"k", "v"} if "jamba" in arch else set())
        assert set(r["cache_rel"]) == want, case
        assert max(r["cache_rel"].values()) <= REL_TOL, (case, r)
        assert r["lens"] == [prompt + steps]


@pytest.mark.parametrize("case,ssm_spec,ssm_block,conv_block", [
    ("mamba2_780m/2x2", ("data", "model"), (2, 4, 16, 16), (2, 3, 96)),
    ("mamba2_780m/1x4", (None, "model"), (2, 2, 16, 16), (2, 3, 64)),
    ("mamba2_780m/2x2/long", (None, "model"), (2, 4, 16, 16), (2, 3, 96)),
    ("jamba_1_5_large_398b/2x2", ("data", "model"), (2, 4, 16, 16),
     (2, 3, 96)),
])
def test_state_cut_by_heads_and_window_by_channels(run, case, ssm_spec,
                                                   ssm_block, conv_block):
    """The state's spec cuts its batch where the rules do and its heads
    over "model" (reduced: 8 heads of 16 x 16); the window keeps the rank's
    d_inner / "model" x channels and the 32 of B and C."""
    r = run[0]["serve"][case]
    assert (r["ssm_spec"], r["ssm_block"], r["conv_block"]) == \
        (ssm_spec, ssm_block, conv_block)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_in_proj_placed_as_its_heads_columns(run, case):
    """Each rank places ``in_proj``'s columns of its heads (z, x, dt of
    its heads and every B and C column), once, and no whole copy of a
    leaf the steps compute on the cut."""
    cfg = get_reduced(W.CASES[case][0])
    s = cfg.ssm
    parts = 2 if "2x2" in case else 4
    width = (2 * s.d_inner(cfg.d_model) + s.n_heads(cfg.d_model)) // parts \
        + 2 * s.n_groups * s.d_state
    for o in run:
        r = o["serve"][case]
        assert r["in_proj"] == [(cfg.d_model, width)]
        assert r["cut_placed_whole"] == []


def test_ranks_import_no_jax(run):
    """The ranks ran the port alone: no module of jax or of the
    reference was imported."""
    assert all(o["modules"] == [] for o in run)


@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b"])
def test_full_width_cache_specs(arch):
    """The sharded steps' cache specs of the full config on the (16, 16)
    production mesh: each Mamba layer's state over ("data", "model") by
    batch and heads, its window by batch; jamba's attention layers' k and
    v by sequence over "model"."""
    cfg = get_config(arch)
    mesh = RecordingMesh((16, 16), ("data", "model"))
    model = LM(cfg, device="meta")
    step = make_sharded_prefill_step(model, 4096, mesh,
                                     arch_rules(cfg, mesh, "prefill"))
    specs = step.cache_specs(32, 4096)["layers"]
    for block, spec in zip(model.blocks, specs):
        if block.kind == "attn":
            assert spec["k"][:2] == ("data", "model"), spec
        else:
            assert (spec["ssm"], spec["conv"]) == (("data", "model"),
                                                   ("data",)), spec
