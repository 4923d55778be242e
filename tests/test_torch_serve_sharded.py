"""Sharded serving: the prefill and decode steps on a mesh, on 4 gloo CPU
ranks, against the port's local serving path and the reference's
attention.

One world of 4 ranks (module-scoped) runs every sharded case, rank side
`tests/_torch_serve_sharded_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh and on (1, 4) over the same ranks, all in f32:
`launch.steps.make_sharded_prefill_step` / `make_sharded_decode_step`
(GQA attention, dense MLP and vocabulary computed on the rank's
``"model"`` cut, the KV cache cut by sequence over ``"model"``, decode's
partials combined by `launch.mesh.combine_partials`) against `LM.prefill`
/ `LM.decode_step` on the whole model of the same seed, for reduced
gemma_2b, qwen2_vl_2b (M-RoPE) and dbrx_132b on 2x2 and stablelm_12b on
(1, 4), a decode that crosses the segments' boundaries from a prompt
shorter than a segment, and the layouts where ``s_max`` or the batch does
not divide; `combine_partials` over the 4 ranks beside its control (the
partials averaged without their log-sum-exps).  In this process: the
partials of an in-process cut of a cache merged (`merge_partials`)
against the reference's `repro.models.attention._sdpa(..., impl="ref")`
on the whole cache (the reference's sharded model is no live oracle on
jax 0.9.0, ROADMAP queue 3); the flash kernel's plain versions' new
log-sum-exp and f32 output against a float64 softmax; `RecordingMesh`'s
log of the steps; the dry run's layout per config.

Tolerances: logits within relative L2 1e-5 at the prefill and at every
decode step, their greedy tokens equal; each cache block within relative
L2 1e-6 of `shard_of` of the local cache by the step's ``.cache_specs``;
the merged partials within 1e-6 of the reference; the plain versions
within 1e-6 (f32) and one bf16 rounding (bf16) of float64.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_sharded_worker as W
from repro.models.attention import _sdpa as ref_sdpa
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import dryrun, ranks
from repro_torch.launch.mesh import RecordingMesh, merge_partials, shard_of
from repro_torch.launch.shardings import arch_rules
from repro_torch.launch.steps import (make_sharded_decode_step,
                                      make_sharded_prefill_step)
from repro_torch.models.attention import _sdpa
from repro_torch.models.model import LM

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_serve_sharded_worker.py")
LOGIT_TOL, CACHE_TOL, COMBINE_TOL = 1e-5, 1e-6, 1e-6


@pytest.fixture(scope="module")
def run():
    return ranks.launch(f"{WORKER}:run", 4, mesh=((2, 2), ("data", "model")),
                        device="cpu", timeout=600)


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_sharded_steps_match_local_path(run, case):
    """The prefill's last logits and every decode step's, on each rank's
    cut of the batch, against the local path's: relative L2 within 1e-5,
    the greedy tokens equal."""
    for o in run:
        got = o["serve"][case]
        assert max(got["logit_rel"]) <= LOGIT_TOL, (o["coords"],
                                                    got["logit_rel"])
        assert all(got["tokens_equal"]), got["tokens_equal"]
        assert len(got["logit_rel"]) == 1 + W.CASES[case][5]


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_cache_blocks_match_local_cache(run, case):
    """After the last decode step each rank's k and v blocks of every
    layer within relative L2 1e-6 of `shard_of` of the local cache by
    ``.cache_specs``; ``len`` global."""
    arch, _, _, prompt, _, steps = W.CASES[case]
    for o in run:
        got = o["serve"][case]
        assert got["cache_rel"] <= CACHE_TOL, (o["coords"], got["cache_rel"])
        assert got["len"] == prompt + steps


def test_decode_crosses_segments_from_empty_ones(run):
    """stablelm_12b on (1, 4): segments of 4 rows, a prompt of 2, then
    2 * 4 + 1 decode steps: ``len`` crosses two boundaries, the ranks
    past the prompt start with empty segments and the last one stays
    empty, and the logits hold at every step."""
    arch, tag, b, prompt, s_max, steps = W.CASES["stablelm_12b/1x4"]
    s_loc = s_max // 4
    assert prompt < s_loc and steps >= 2 * s_loc + 1
    for o in run:
        got = o["serve"]["stablelm_12b/1x4"]
        assert got["seq"] == ("model",)
        assert got["block_shape"] == (b, s_loc, 2, 16)
        assert max(got["logit_rel"]) <= LOGIT_TOL


@pytest.mark.parametrize("case,seq,shape", [
    ("gemma_2b/2x2", ("model",), (2, 8, 1, 32)),
    ("gemma_2b/2x2/s_max_15", (), (2, 15, 1, 32)),
    ("qwen2_vl_2b/2x2/s_max_15", (), (2, 15, 1, 16)),
    ("gemma_2b/2x2/batch_3", ("model",), (3, 8, 1, 32))])
def test_cache_layouts_where_cuts_do_not_divide(run, case, seq, shape):
    """`logical_to_physical` drops a cut that does not divide: s_max 15
    leaves the sequence whole (qwen2_vl's kv heads take "model" then), a
    batch of 3 stays whole on every rank; the steps serve both."""
    for o in run:
        got = o["serve"][case]
        assert got["seq"] == seq and got["block_shape"] == shape


@pytest.mark.parametrize("case", sorted(W.CASES))
def test_no_whole_copy_of_a_cut_leaf_is_placed(run, case):
    """Each leaf the steps compute on its "model" cut (and each expert
    block) is placed smaller than the whole leaf; the selection is not
    empty."""
    for o in run:
        got = o["serve"][case]
        assert got["cut"] and got["cut_placed_whole"] == []
        assert {"decode_s", "exchange_s", "compute_s"} <= set(got["metrics"])


def test_combine_partials_across_ranks(run):
    """`combine_partials` over the 4 ranks' segments equals the whole
    cache's attention within 1e-6, with the same bits on every rank; the
    rank whose segment holds no valid key contributes lse = -inf."""
    for o in run:
        assert o["combine"]["err"] <= COMBINE_TOL
        assert torch.equal(o["combine"]["bits"], run[0]["combine"]["bits"])
    assert run[3]["combine"]["empty_lse"] == float("-inf")


def test_control_partials_without_lse_weights_fails(run):
    """The control: the same partials averaged with equal weights is far
    off the whole cache's attention."""
    for o in run:
        assert o["combine"]["control_err"] > 1e-2


def test_ranks_import_no_jax(run):
    assert all(o["modules"] == [] for o in run)


def _cut_cache(seed, kv_len, n=4, s_loc=8):
    gen = torch.Generator().manual_seed(seed)
    b, h, hkv, d = 2, 4, 2, 16
    q = torch.randn((b, 1, h, d), generator=gen)
    k, v = (torch.randn((b, n * s_loc, hkv, d), generator=gen)
            for _ in range(2))
    return q, k, v, n, s_loc


@pytest.mark.parametrize("kv_len", [1, 8, 9, 21, 32])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["math", "kernel_plain"])
def test_merged_partials_match_reference_sdpa(kv_len, use_kernel):
    """Each of 4 segments' partial (`_sdpa(..., return_lse=True)`, through
    the full-score math or the flash kernel's plain version), merged in
    segment order, against the reference's `_sdpa(..., impl="ref")` on the
    whole cache, within 1e-6 in f32; segments past ``kv_len`` are
    empty."""
    q, k, v, n, s_loc = _cut_cache(kv_len, kv_len)
    kw = dict(causal=True, scale=16 ** -0.5, impl="ref")
    outs, lses = [], []
    for r in range(n):
        seg = slice(r * s_loc, (r + 1) * s_loc)
        out, lse = _sdpa(q, k[:, seg], v[:, seg], return_lse=True,
                         use_kernel=use_kernel,
                         kv_len=min(max(kv_len - r * s_loc, 0), s_loc),
                         q_offset=kv_len - 1 - r * s_loc, **kw)
        outs.append(out)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    want = np.asarray(ref_sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), kv_len=kv_len,
                               q_offset=kv_len - 1, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)


def _f64_attention(q, k, v, kv_valid, kv_offset):
    """Float64 softmax attention with each row's log-sum-exp (-inf and a
    zero row where no key is valid)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.double().reshape(b, hkv, hq // hkv, sq, d) * d ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, :kv_valid].double())
    kpos = torch.arange(kv_valid)
    ok = kpos[None, :] <= (torch.arange(sq) + kv_offset)[:, None]
    s = torch.where(ok, s, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.nan_to_num(torch.exp(s - lse[..., None]))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, :kv_valid].double())
    return out.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


@pytest.mark.parametrize("kv_valid", [0, 1, 65, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fn", ["split_plain", "plain"])
def test_plain_versions_lse_and_f32_output(fn, dtype, kv_valid):
    """The decode body's new outputs in its plain versions: each row's
    log-sum-exp and the f32 output of a bf16 call against a float64
    softmax of the same (rounded) inputs, within 1e-6 of the scale;
    ``kv_valid = 0`` gives out = 0 and lse = -inf."""
    gen = torch.Generator().manual_seed(kv_valid)
    q = torch.randn((2, 8, 1, 32), generator=gen).to(dtype)
    k, v = (torch.randn((2, 2, 160, 32), generator=gen).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, kv_valid=kv_valid, kv_offset=kv_valid - 1,
              return_lse=True)
    if fn == "plain":
        out, lse = FK.flash_attention_plain(q, k, v, **kw)
    else:
        out, lse = FK.flash_attention_split_plain(q, k, v, splits=3, **kw)
    want, want_lse = _f64_attention(q, k, v, kv_valid, kv_valid - 1)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (2, 8, 1)
    if kv_valid == 0:
        assert torch.equal(out, torch.zeros_like(out))
        assert bool((lse == float("-inf")).all())
        return
    np.testing.assert_allclose(out.double(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lse.double(), want_lse, rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_passes_lse_through_and_refuses_empty():
    """On a CPU tensor `flash_attention` returns its plain version's
    (out, lse) and launches nothing; ``kv_valid = 0`` is a partial's
    only."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 1, 32), generator=gen)
    k, v = (torch.randn((1, 1, 64, 32), generator=gen) for _ in range(2))
    FK.reset_launches()
    out, lse = FK.flash_attention(q, k, v, kv_valid=0, kv_offset=-1,
                                  return_lse=True)
    assert bool((lse == float("-inf")).all()) and not out.any()
    got = FK.flash_attention(q, k, v, kv_valid=40, kv_offset=39,
                             return_lse=True)
    want = FK.flash_attention_plain(q, k, v, kv_valid=40, kv_offset=39,
                                    return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FK.LAUNCHES == FK.LSE_LAUNCHES == {"flash_attention": 0}
    with pytest.raises(ValueError, match="kv_valid=0"):
        FK.flash_attention(q, k, v, kv_valid=0, kv_offset=-1)


def _recorded(arch, shape, b=4, prompt=5, s_max=16, steps=2):
    """The sharded steps of reduced ``arch`` in f32 on a `RecordingMesh`
    of ``shape`` (rank 0): a prefill, then ``steps`` decode steps; (the
    prefill step, the log after the prefill, each decode step's log)."""
    cfg = W.f32(arch)
    mesh = RecordingMesh(shape, ("data", "model"))
    model = LM(cfg, device="meta", seed=0)
    prefill = make_sharded_prefill_step(model, s_max, mesh,
                                        arch_rules(cfg, mesh, "prefill"))
    decode = make_sharded_decode_step(model, mesh,
                                      arch_rules(cfg, mesh, "decode"))
    whole = LM(cfg, device="cpu", seed=0)
    blocks = {n: shard_of(p.detach(), prefill.specs[n], mesh)
              for n, p in whole.named_parameters()}
    batches = W.inputs(cfg, b, prompt, steps)
    cache, _ = prefill(blocks, batches[0])
    logs = [list(mesh.log)]
    for bt in batches[1:]:
        mesh.log.clear()
        cache, _ = decode(blocks, cache, bt)
        logs.append(list(mesh.log))
    return prefill, blocks, logs


@pytest.mark.parametrize("arch,shape", [("gemma_2b", (2, 2)),
                                        ("qwen2_vl_2b", (2, 2)),
                                        ("stablelm_12b", (1, 4))])
def test_recording_mesh_log(arch, shape):
    """From `RecordingMesh`'s log: the placement gathers every cut leaf
    over "data" alone (no gather of a block over "model"), and every
    decode step runs exactly one `combine_partials` a layer, over
    "model", and no placement again."""
    step, blocks, logs = _recorded(arch, shape)
    cut = {n for n, c in step.cuts.items() if c.mode == "cut"}
    assert cut
    block_shapes = {(1,) + tuple(blocks[n].shape) for n in cut}
    for log in logs:
        for op, axes, in_shape in log:
            if op == "all-gather" and axes and "model" in axes:
                assert in_shape not in block_shapes, (op, axes, in_shape)
    n_layers = W.f32(arch).n_layers
    for log in logs[1:]:
        combines = [a for op, a, _ in log if op == "combine_partials"]
        assert combines == [("model",)] * n_layers
        assert not [s for op, _, s in log if s in block_shapes]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_serving_layout_per_config(arch):
    """The dry run's serving layout of a prefill or decode cell: sharded
    for every config, deepseek_v3 (MLA) and whisper_small
    (cross-attention) among them; a long_500k cell whole where the config
    has attention layers (jamba: the ("data", "model") sequence cut waits
    for a later slice)."""
    cfg = get_config(arch)
    assert dryrun.serve_layout(cfg) == ("sharded_serve", None)
    layout, reason = dryrun.serve_layout(cfg, "long_500k")
    if cfg.n_layers and any(cfg.layer_kind(i) == "attn"
                            for i in range(cfg.n_layers)):
        assert layout == "serve_whole_params" and "later slice" in reason
    else:
        assert (layout, reason) == ("sharded_serve", None)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_sharded_serve_cell(kind):
    """A reduced gemma_2b cell on (2, 2) under ``sharded_serve``: its
    record counts the mesh's collectives (decode: a combine's all-gather
    each layer beside q's); so does whisper_small's (its encoder and
    cross-attention on the rank's heads: the row products' all-reduces of
    both stacks, and a combine each decoder layer in decode), which ran
    with whole parameters and no collective before."""
    cell = dryrun.ShapeCell(f"{kind}_t", 64, 8, kind)
    mesh = ((2, 2), ("data", "model"))
    rec = dryrun.run_cell("gemma_2b", cell, False,
                          cfg=get_reduced("gemma_2b"), mesh_shape=mesh)
    assert rec["layout"] == "sharded_serve"
    gathers = rec["collectives"]["all-gather"]["count"]
    assert rec["collectives"]["all-reduce"]["count"] > 0
    if kind == "decode":
        assert gathers >= 2 * get_reduced("gemma_2b").n_layers
    other = dryrun.run_cell("whisper_small", cell, False,
                            cfg=get_reduced("whisper_small"),
                            mesh_shape=mesh)
    assert other["layout"] == "sharded_serve"
    assert "layout_reason" not in other
    wcfg = get_reduced("whisper_small")
    reduces = other["collectives"]["all-reduce"]["count"]
    if kind == "prefill":                 # encoder: attn and mlp; decoder:
        assert reduces >= 2 * wcfg.encoder.n_layers + 3 * wcfg.n_layers
    else:                                 # decoder: self, cross and mlp
        assert reduces >= 3 * wcfg.n_layers
        assert other["collectives"]["all-gather"]["count"] >= \
            2 * wcfg.n_layers


@pytest.mark.parametrize("arch", ["whisper_small", "deepseek_v3_671b"])
def test_sharded_steps_refuse_later_slices(arch):
    """The configs these steps refused at make time (MLA's latent cache,
    cross-attention) are served now: the steps make, and their cache
    specs cut MLA's ckv and krope by batch and sequence
    (``("data", "model")``, the reference's `_CACHE_AXES`) and keep the
    encoder's output by batch alone (``("data", None, None)``)."""
    cfg = get_reduced(arch)
    mesh = RecordingMesh((2, 2), ("data", "model"))
    model = LM(cfg, device="meta")
    step = make_sharded_prefill_step(model, 16, mesh,
                                     arch_rules(cfg, mesh, "prefill"))
    specs = step.cache_specs(4, 16)
    layer = specs["layers"][0]
    if cfg.mla is not None:
        assert layer["ckv"] == layer["krope"] == ("data", "model")
        assert specs["enc_out"] == ()
    else:
        assert layer["k"] == ("data", "model") and "ckv" not in layer
        assert specs["enc_out"] == ("data",)
