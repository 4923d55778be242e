"""Port parity: the dense-attention serving path (gemma_2b and the other
dense configs), `repro_torch.models.{layers,attention,transformer,model}`
and `repro_torch.launch.serve`.

The same numpy inputs go through the JAX package and the port, with the
reference's weights carried across (`convert.lm_params_from_reference`, or
leaf by leaf for one layer).  Each attention case runs both port paths on
the CPU: the kernel's wrapper (``use_kernel=True``, whose CPU tensors run
`flash_attention_plain`, p kept in f32) and the reference's ref/chunked
math (``use_kernel=False``, p rounded to the operands' dtype).
Tolerances:
- RoPE and the MLP in f32: rtol = atol = 1e-5 (f32 sums and cos/sin in
  another order or implementation); RoPE in bf16: 2e-2 (one bf16 rounding
  of values up to about 4);
- attention (`_sdpa`, `gqa_forward`) in f32: rtol = atol = 3e-5, the flash
  kernel tests' tolerance; in bf16: 2e-2;
- the reduced LMs in f32: prefill and decode logits at rtol = atol = 1e-3,
  as tests/test_models.py:80-86 holds the reference's own prefill and
  decode; in bf16: atol 2e-2 on logits up to about 0.5 (bf16 rounds at
  other places in the two frameworks, 8-bit mantissa);
- `BatchServer.run` on the reduced f32 gemma: tokens equal, stats equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

ARCH = "gemma_2b"
KEY = jax.random.PRNGKey(0)
F32_ATTN = dict(rtol=3e-5, atol=3e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: keep each of these tests on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg32(arch=ARCH):
    return get_reduced(arch).replace(dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(tree) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.from_numpy(
        np.array(v, np.float32))) for k, v in _np_tree(tree).items()})


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _ref_lm(arch, cfg):
    model = jbuild(jget_reduced(arch).replace(dtype=cfg.dtype),
                   attn_impl="ref", remat_policy="none", loss_chunk=64)
    params = model.init(KEY)
    return model, params, convert.lm_params_from_reference(
        _np_tree(params), cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction,theta", [(1.0, 10_000.0),
                                            (0.25, 10_000.0),
                                            (1.0, 75_000_000.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(fraction, theta, dtype):
    """Full and partial (stablelm's 0.25) rotary, positions offset as after
    a cached prefix of 30 rows."""
    x = _normal(1, 2, 6, 3, 32)
    pos = np.arange(30, 36, dtype=np.int32)[None].repeat(2, 0)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = jlayers.rope_apply(jnp.asarray(x, jd), jnp.asarray(pos), theta,
                              fraction)
    got = tlayers.rope_apply(torch.from_numpy(x).to(td),
                             torch.from_numpy(pos), theta, fraction)
    assert got.dtype == td and got.shape == x.shape
    tol = LAYER_TOL if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if fraction < 1.0:      # the unrotated tail passes through untouched
        np.testing.assert_array_equal(got[..., 8:].float().numpy(),
                                      np.asarray(want, np.float32)[..., 8:])


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    """The gated MLPs and the plain gelu MLP with biases (set non-zero)."""
    jp = jlayers.mlp_init(KEY, 64, 128, act, jnp.float32, bias=True)
    if act == "gelu":
        jp = dict(jp, b1=jnp.asarray(_normal(2, 128)),
                  b2=jnp.asarray(_normal(3, 64)))
    assert ("b1" in jp) == (act == "gelu")
    x = _normal(4, 2, 5, 64)
    want = jlayers.mlp_apply(jnp.asarray(x), jp, act)
    got = tlayers.mlp_apply(torch.from_numpy(x), _params(jp), act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    port = tlayers.mlp_init(torch.Generator().manual_seed(0), 64, 128, act,
                            torch.float32, bias=True)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in jlayers.mlp_init(
            KEY, 64, 128, act, jnp.float32, bias=True).items()}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("impl", ["ref", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_reference(impl, use_kernel, dtype):
    """40 query rows at offset 10 over a 56-row cache with 50 valid rows,
    GQA 4:2; chunked in query blocks of 16 (three blocks, the last short)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    q, k, v = _normal(5, 2, 40, 4, 32), _normal(6, 2, 56, 2, 32), \
        _normal(7, 2, 56, 2, 32)
    kw = dict(causal=True, kv_len=50, q_offset=10, scale=32 ** -0.5,
              impl=impl, q_chunk=16)
    want = jattn._sdpa(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
    got = tattn._sdpa(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                      use_kernel=use_kernel, **kw)
    assert got.dtype == td and got.shape == (2, 40, 4, 32)
    tol = F32_ATTN if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _gqa_setup():
    cfg = _cfg32()
    jp = jattn.attn_init(KEY, cfg, jnp.float32)
    return cfg, jp, _params(jp)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_forward_without_cache_matches_reference(use_kernel):
    cfg, jp, tp = _gqa_setup()
    x = _normal(8, 2, 24, cfg.d_model)
    want, jc = jattn.gqa_forward(jp, jnp.asarray(x), cfg, impl="ref")
    with torch.no_grad():
        got, tc = tattn.gqa_forward(tp, torch.from_numpy(x), cfg,
                                    impl="ref", use_kernel=use_kernel)
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ATTN)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_forward_with_cache_matches_reference(use_kernel):
    """A 20-row prompt into a 32-row cache (kv_valid = 20 < s_max, the
    diagonal at offset 0), a 5-row chunk after it (kv_offset 20), then two
    single-token steps; outputs and cache rows against the reference, and a
    write past s_max raises where the reference would clamp."""
    cfg, jp, tp = _gqa_setup()
    x = _normal(9, 2, 27, cfg.d_model)
    jc = jattn.make_kv_cache(cfg, 2, 32, jnp.float32)
    tc = tattn.make_kv_cache(cfg, 2, 32, torch.float32, "cpu")
    with torch.no_grad():
        for lo, hi in ((0, 20), (20, 25), (25, 26), (26, 27)):
            want, jc = jattn.gqa_forward(jp, jnp.asarray(x[:, lo:hi]), cfg,
                                         cache=jc, impl="chunked")
            got, tc = tattn.gqa_forward(tp, torch.from_numpy(x[:, lo:hi]),
                                        cfg, cache=tc, impl="chunked",
                                        use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **F32_ATTN)
            assert tc["len"] == int(jc["len"]) == hi
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(),
                                           np.asarray(jc[name]), **F32_ATTN)
        over = torch.from_numpy(_normal(10, 2, 6, cfg.d_model))
        with pytest.raises(ValueError, match="overflow"):
            tattn.gqa_forward(tp, over, cfg, cache=tc, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# the LM and the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_lm_prefill_and_decode_match_reference(use_kernel):
    """Reduced gemma_2b in f32: a 20-token prompt into 24-row caches, then
    four decode steps, against the reference LM."""
    cfg = _cfg32()
    jmodel, jparams, model = _ref_lm(ARCH, cfg)
    model.use_kernel = use_kernel
    toks = _tokens(2, 2, 24, cfg.vocab_size)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :20])}, s_max=24)
    cache, logits = model.prefill(
        {"tokens": torch.from_numpy(toks[:, :20]).long()}, s_max=24)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LM_TOL)
    for t in range(20, 24):
        jcache, jlogits = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        cache, logits = model.decode_step(
            cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LM_TOL)
    assert [c["len"] for c in cache["layers"]] == [24] * cfg.n_layers
    assert cache["layers"][0]["k"].shape == (2, 24, cfg.n_kv_heads,
                                             cfg.head_dim)


def test_lm_prefill_bf16_matches_reference():
    cfg = get_reduced(ARCH)
    assert cfg.dtype == "bfloat16"
    jmodel, jparams, model = _ref_lm(ARCH, cfg)
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(3, 2, 40, cfg.vocab_size)
    _, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                s_max=48)
    want = np.asarray(jlogits)
    assert np.abs(want).max() > 0.1
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        _, logits = model.prefill({"tokens": torch.from_numpy(toks).long()},
                                  s_max=48)
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "stablelm_12b",
                                  "command_r_plus_104b"])
def test_other_dense_configs_prefill_logits(arch):
    """The dense configs that build now (reduced, f32): GQA 4:1 with swiglu
    (phi3), partial rotary and layernorm (stablelm), the parallel residual
    with a tied head and rope_theta 7.5e7 (command-r), each with head_dim
    16, which the kernel path pads to 32."""
    cfg = _cfg32(arch)
    jmodel, jparams, model = _ref_lm(arch, cfg)
    toks = _tokens(4, 2, 18, cfg.vocab_size)
    _, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                s_max=24)
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        _, logits = model.prefill({"tokens": torch.from_numpy(toks).long()},
                                  s_max=24)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LM_TOL)


def test_batch_server_matches_reference(monkeypatch):
    """The slice as a whole: `BatchServer.run` on the reduced f32 gemma_2b
    (the port's default arch, as the reference's), the reference's weights,
    2 slots and 4 requests of 3 to 37 tokens: the same stats and the same
    greedy tokens as the reference's server."""
    cfg = _cfg32()
    jcfg = jget_reduced(ARCH).replace(dtype="float32")
    monkeypatch.setattr(jserve, "get_reduced", lambda arch: jcfg)
    monkeypatch.setattr(tserve, "get_reduced", lambda arch: cfg)
    jsrv = jserve.BatchServer(ARCH, slots=2, s_max=64, seed=0)
    tsrv = tserve.BatchServer(ARCH, slots=2, s_max=64, seed=0, device="cpu")
    assert tsrv.model.attn_impl == jsrv.model.attn_impl == "ref"
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
    FK.reset_launches()
    tstats = tsrv.run(treqs)
    assert FK.LAUNCHES == {"flash_attention": 0}      # CPU: no launch
    for k in ("requests", "tokens", "completed"):
        assert tstats[k] == jstats[k], k
    assert set(tstats) == set(jstats)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tsrv.timing["prefills"] == 4
    assert tsrv.timing["decode_steps"] == tstats["tokens"] == 16
    for r in treqs:
        assert r.prefill_logits.shape == (cfg.vocab_size,)
        assert r.done and r.out[0] == int(torch.argmax(r.prefill_logits))


def test_serve_main_defaults_to_gemma(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve` takes the reference's default
    arch, gemma_2b (src/repro/launch/serve.py:104)."""
    seen = {}
    real = tserve.BatchServer

    def spy(arch, **kw):
        seen["arch"] = arch
        return real(arch, **kw)

    monkeypatch.setattr(tserve, "BatchServer", spy)
    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu",
                                     "--requests", "2", "--max-new", "3"])
    tserve.main()
    assert seen["arch"] == "gemma_2b"
    assert '"completed": 2' in capsys.readouterr().out
