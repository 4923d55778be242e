"""Port parity: the Mamba-2 serving path (`repro_torch.models`, `.launch`).

The reference's weights (`LM.init` / `mamba_init` from a PRNGKey) are
carried into the port with `convert.lm_params_from_reference`, the same
numpy tokens go through both, and the outputs are compared on the CPU at
the reduced `mamba2_780m` config:
- f32 (`dtype="float32"`): prefill logits at rtol = atol = 1e-3 and decode
  logits at 2e-3, as tests/test_models.py:80-86 holds the reference's own
  prefill and decode to its teacher-forced pass;
- bf16 (the config's own dtype): prefill logits at atol 2e-2, with logits
  up to about 0.5 in magnitude, since bf16 rounds at other places in the
  two frameworks (its 8-bit mantissa: about 4e-3 relative per rounding,
  over three layers of projections, conv, norm and SSD; the largest error
  seen at this seed is 6e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.models import mamba as jmamba
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba as tmamba
from repro_torch.models.model import LM

ARCH = "mamba2_780m"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: keep each of these tests on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg32():
    return get_reduced(ARCH).replace(dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _ref_lm(cfg):
    model = jbuild(jget_reduced(ARCH).replace(dtype=cfg.dtype),
                   attn_impl="ref", remat_policy="none", loss_chunk=64)
    params = model.init(KEY)
    return model, params, convert.lm_params_from_reference(
        _np_tree(params), cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_registry_is_the_references(arch):
    """The port's copy of the registry gives field-equal configs, full and
    reduced, under both spellings of the name."""
    dash = arch.replace("_", "-")
    assert ALIASES[dash] == arch
    for port, ref in ((get_config(dash), jget_config(dash)),
                      (get_reduced(arch), jget_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.stages() == ref.stages()
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_block_matches_reference(with_cache):
    """One block, f32: stateless over 24 steps, or prefill of 20 steps (one
    chunk of 16 plus 4 padded) followed by two decode steps."""
    cfg = _cfg32()
    jparams = jmamba.mamba_init(KEY, cfg, jnp.float32)
    block = tmamba.Mamba2(cfg, torch.Generator().manual_seed(0),
                          torch.float32)
    for name, arr in jparams.items():
        getattr(block, name).data.copy_(torch.from_numpy(np.array(arr)))
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    tol = dict(rtol=1e-3, atol=1e-3)
    with torch.no_grad():
        if not with_cache:
            want, _ = jmamba.mamba_forward(jparams, jnp.asarray(x), cfg)
            got, cache = block(torch.from_numpy(x))
            assert cache is None
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            return
        jc = jmamba.make_ssm_cache(cfg, 2, jnp.float32)
        tc = tmamba.make_ssm_cache(cfg, 2, torch.float32, "cpu")
        for lo, hi in ((0, 20), (20, 21), (21, 22)):
            want, jc = jmamba.mamba_forward(jparams, jnp.asarray(x[:, lo:hi]),
                                            cfg, cache=jc)
            got, tc = block(torch.from_numpy(x[:, lo:hi]), tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            for k in ("conv", "ssm"):
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                           **tol)
            assert tc["len"] == int(jc["len"]) == hi


def test_lm_prefill_and_decode_match_reference():
    """Reduced mamba2_780m in f32: prefill of 20 tokens (not a multiple of
    the chunk) through the kernel composition and the plain chunked path,
    then four decode steps, against the reference LM."""
    cfg = _cfg32()
    jmodel, jparams, model = _ref_lm(cfg)
    toks = _tokens(2, 2, 24, cfg.vocab_size)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :20])}, s_max=24)
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        cache, logits = model.prefill(
            {"tokens": torch.from_numpy(toks[:, :20]).long()}, s_max=24)
        assert logits.dtype == torch.float32
        assert logits.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-3, atol=1e-3)
    for t in range(20, 24):
        jcache, jlogits = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        cache, logits = model.decode_step(
            cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=2e-3, atol=2e-3)
    assert all(c["len"] == 24 for c in cache["layers"])


def test_lm_prefill_bf16_matches_reference():
    cfg = get_reduced(ARCH)
    assert cfg.dtype == "bfloat16"
    jmodel, jparams, model = _ref_lm(cfg)
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(3, 2, 40, cfg.vocab_size)
    _, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                s_max=40)
    _, logits = model.prefill({"tokens": torch.from_numpy(toks).long()},
                              s_max=40)
    want = np.asarray(jlogits)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=2e-2)


def test_weights_carry_over_exactly_and_mismatches_raise():
    cfg = _cfg32()
    _, jparams, model = _ref_lm(cfg)
    ref = _np_tree(jparams)
    stacked = ref["stages"][0][0]["ssm"]["in_proj"]
    assert stacked.shape[0] == cfg.n_layers
    for layer in range(cfg.n_layers):
        np.testing.assert_array_equal(
            model.blocks[layer].ssm.in_proj.detach().numpy(), stacked[layer])
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  ref["embed"])
    bad = dict(ref, embed=ref["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_reference(bad, cfg, device="cpu")
    missing = dict(ref)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_reference(missing, cfg, device="cpu")


def test_unported_layer_kinds_raise():
    """No layer kind is refused any more: M-RoPE (qwen2_vl) and the
    encoder with learned positions (whisper) build with their parameters;
    MoE (dbrx, jamba) and MLA with MoE (deepseek_v3) build."""
    qwen = LM(get_reduced("qwen2_vl_2b"), device="cpu")
    assert not hasattr(qwen, "enc_blocks") and not hasattr(qwen,
                                                           "pos_embed")
    cfg = get_reduced("whisper_small")
    whisper = LM(cfg, device="cpu")
    assert len(whisper.enc_blocks) == cfg.encoder.n_layers
    assert tuple(whisper.enc_pos.shape) == (cfg.encoder.n_frames,
                                            cfg.d_model)
    assert tuple(whisper.pos_embed.shape) == (cfg.max_seq_len, cfg.d_model)
    assert all(b.has_cross for b in whisper.blocks)
    for arch in ("dbrx_132b", "jamba_1_5_large_398b", "deepseek_v3_671b"):
        assert any(b.is_moe for b in LM(get_reduced(arch),
                                        device="cpu").blocks)


def test_batch_server_matches_reference(monkeypatch):
    """The slice as a whole: `BatchServer.run` on the reduced f32 model, the
    reference's weights, 2 slots and 4 requests of 3 to 37 tokens: the same
    stats and the same greedy tokens as the reference's server."""
    cfg = _cfg32()
    jcfg = jget_reduced(ARCH).replace(dtype="float32")
    monkeypatch.setattr(jserve, "get_reduced", lambda arch: jcfg)
    monkeypatch.setattr(tserve, "get_reduced", lambda arch: cfg)
    jsrv = jserve.BatchServer(ARCH, slots=2, s_max=64, seed=0)
    tsrv = tserve.BatchServer(ARCH, slots=2, s_max=64, seed=0, device="cpu")
    convert.lm_params_from_reference(_np_tree(jsrv.params), cfg,
                                     model=tsrv.model)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 37, 16, 21)]
    jreqs = [jserve.Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    treqs = [tserve.Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    jstats = jsrv.run(jreqs)
    tstats = tsrv.run(treqs)
    for k in ("requests", "tokens", "completed"):
        assert tstats[k] == jstats[k], k
    assert set(tstats) == set(jstats)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tsrv.timing["prefills"] == 4
    assert tsrv.timing["decode_steps"] == tstats["tokens"] == 16
    for r in treqs:
        assert r.prefill_logits.shape == (cfg.vocab_size,)
        assert r.done and r.out[0] == int(torch.argmax(r.prefill_logits))
