"""Port parity: DeepSeek MLA and deepseek_v3, serving and training.

The same numpy inputs go through the JAX package's `repro.models.attention`
MLA and `repro_torch.models.attention`, with the reference's weights
carried across.  Tolerances:
- the MLA layer in f32: output and the gradients of x and every weight
  within rtol = atol = 1e-5 (f32 sums in another order); the latent cache's
  rows equal to the reference's within the same;
- decode through the latent cache against a prefill of the same tokens:
  rtol = atol = 1e-5;
- the reduced deepseek_v3 LM (a dense first layer, then MoE layers with a
  shared expert) in f32: prefill and decode logits at rtol = atol = 1e-3,
  as tests/test_models.py holds the reference's own;
- training: `tests/_torch_train.py`'s loss, gradient and three-step
  tolerances, each with a control that must fail.
MLA runs `_sdpa`'s plain math with Dv != D on every device: the kernel is
never asked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.models import attention as jattn
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import attention as tattn

ARCH = "deepseek_v3_671b"
TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    return T.reference_run(ARCH)


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, port cfg, reference MLA params, the port's MLA
    module on them)."""
    jcfg, cfg = T.configs(ARCH)
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = tattn.attn_init(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    own = dict(p.named_parameters())
    assert set(own) == set(convert.flatten_reference(jp))
    for name, arr in convert.flatten_reference(jp).items():
        assert tuple(own[name].shape) == arr.shape, name
        own[name].data.copy_(torch.from_numpy(np.array(arr)))
    return jcfg, cfg, jp, p


def _x(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def test_mla_layer_forward_and_backward_match_reference(layer):
    """x (2, 11, d) without a cache: the output and the gradients of a
    fixed projection of it against `jax.grad`, for x and every weight."""
    jcfg, cfg, jp, p = layer
    x = _x(1, 2, 11, cfg.d_model)
    g = _x(2, 2, 11, cfg.d_model)

    def jf(params, x):
        out, _ = jattn.mla_forward(params, x, jcfg)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = tattn.mla_forward(p, tx, cfg)
    assert cache is None
    own = dict(p.named_parameters())
    grads = torch.autograd.grad(out, [tx] + list(own.values()),
                                torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    want = convert.flatten_reference(jax.tree.map(np.asarray, jgp))
    for name, gr in zip(own, grads[1:]):
        np.testing.assert_allclose(gr.numpy(), want[name], err_msg=name,
                                   **TOL)


def test_mla_prefill_and_decode_through_the_latent_cache(layer):
    """A 9-token prompt into 16-row latent caches, then three decode
    steps: every output and the cache's written rows against the
    reference's `mla_forward` with its cache."""
    jcfg, cfg, jp, p = layer
    x = _x(4, 2, 12, cfg.d_model)
    jcache = jattn.make_kv_cache(jcfg, 2, 16, jnp.float32)
    cache = tattn.make_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "len"} \
        == {k: v.shape for k, v in jcache.items() if k != "len"}
    spans = [(0, 9), (9, 10), (10, 11), (11, 12)]
    step = jax.jit(lambda x, c: jattn.mla_forward(jp, x, jcfg, cache=c))
    with torch.no_grad():
        for lo, hi in spans:
            jout, jcache = step(jnp.asarray(x[:, lo:hi]), jcache)
            out, cache = tattn.mla_forward(p, torch.from_numpy(x[:, lo:hi]),
                                           cfg, cache=cache)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            assert cache["len"] == int(jcache["len"]) == hi
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(cache[key][:, :12].numpy(),
                                   np.asarray(jcache[key])[:, :12], **TOL)
        assert not cache[key][:, 12:].any()


def test_decode_matches_a_prefill_of_the_same_tokens(layer):
    """Prefill 8 tokens then decode 4 against one prefill of all 12: the
    decoded outputs equal the prefill's last 4 rows within 1e-5; the
    control, a decode whose cache skipped a row, does not."""
    _, cfg, _, p = layer
    x = torch.from_numpy(_x(5, 1, 12, cfg.d_model))
    with torch.no_grad():
        full, _ = tattn.mla_forward(p, x, cfg)
        cache = tattn.make_kv_cache(cfg, 1, 12, torch.float32, device="cpu")
        _, cache = tattn.mla_forward(p, x[:, :8], cfg, cache=cache)
        steps = []
        for t in range(8, 12):
            out, cache = tattn.mla_forward(p, x[:, t:t + 1], cfg,
                                           cache=cache)
            steps.append(out)
        torch.testing.assert_close(torch.cat(steps, 1), full[:, 8:], **TOL)
        bad = tattn.make_kv_cache(cfg, 1, 12, torch.float32, device="cpu")
        _, bad = tattn.mla_forward(p, x[:, :7], cfg, cache=bad)
        out, _ = tattn.mla_forward(p, x[:, 8:9], cfg, cache=bad)
        assert not torch.allclose(out, full[:, 8:9], **TOL)


def test_latent_cache_overflow_raises(layer):
    _, cfg, _, p = layer
    cache = tattn.make_kv_cache(cfg, 1, 4, torch.float32, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="overflow"):
        tattn.mla_forward(p, torch.zeros((1, 5, cfg.d_model)), cfg,
                          cache=cache)


def test_mla_takes_the_plain_math_even_when_asked_for_the_kernel(layer):
    """``use_kernel=True`` reaches no flash call: MLA's Dv != D runs the
    plain math, as the reference's MLA runs its jnp math."""
    _, cfg, _, p = layer
    x = torch.from_numpy(_x(6, 1, 7, cfg.d_model))
    before = FK.LAUNCHES["flash_attention"]
    calls = []
    real = tattn.fa_ops.flash
    tattn.fa_ops.flash = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            a, _ = tattn.mla_forward(p, x, cfg, use_kernel=True)
            b, _ = tattn.mla_forward(p, x, cfg, use_kernel=False)
    finally:
        tattn.fa_ops.flash = real
    assert not calls and FK.LAUNCHES["flash_attention"] == before
    assert torch.equal(a, b)


def test_mla_triangular_path_matches_chunked(layer):
    """The training paths: ``tri`` (bands of 512 over 11 rows) against
    ``chunked``, forward and backward, within 1e-5."""
    _, cfg, _, p = layer
    outs = []
    for impl in ("chunked", "tri"):
        x = torch.from_numpy(_x(7, 2, 11, cfg.d_model)).requires_grad_()
        out, _ = tattn.mla_forward(p, x, cfg, impl=impl)
        outs.append((out.detach(), torch.autograd.grad(out.sum(), x)[0]))
    torch.testing.assert_close(outs[1][0], outs[0][0], **TOL)
    torch.testing.assert_close(outs[1][1], outs[0][1], **TOL)


@pytest.fixture(scope="module")
def lm():
    """The reference's reduced deepseek_v3 in f32, its prefill of 20
    tokens into 24-row caches and four decode logits; the port's LM on its
    weights."""
    jcfg, cfg = T.configs(ARCH)
    jmodel = jbuild(jcfg, attn_impl="ref", remat_policy="none",
                    loss_chunk=64)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    prefill = jax.jit(jmodel.prefill, static_argnames="s_max")
    decode = jax.jit(jmodel.decode_step)
    jcache, jl = prefill(jparams, {"tokens": jnp.asarray(toks[:, :20])},
                         s_max=24)
    want = [np.asarray(jl)]
    for t in range(20, 24):
        jcache, jl = decode(jparams, jcache,
                            {"tokens": jnp.asarray(toks[:, t:t + 1])})
        want.append(np.asarray(jl))
    return model, toks, want


def test_lm_prefill_and_decode_match_reference(lm):
    model, toks, want = lm
    kinds = [(b.kind, b.is_moe) for b in model.blocks]
    assert kinds == [("attn", False), ("attn", True), ("attn", True)]
    assert isinstance(model.blocks[0].attn, tattn.MLA)
    cache, logits = model.prefill(
        {"tokens": torch.from_numpy(toks[:, :20]).long()}, s_max=24)
    assert set(cache["layers"][0]) == {"ckv", "krope", "len"}
    np.testing.assert_allclose(logits.numpy(), want[0], **LM_TOL)
    for t in range(20, 24):
        cache, logits = model.decode_step(
            cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(logits.numpy(), want[t - 19], **LM_TOL)


def test_loss_and_gradients_match_jax_grad(ref):
    T.check_loss_and_grads(ref)


def test_three_train_steps_match_reference(ref):
    T.check_three_steps(ref)
