"""Port parity: M-RoPE and qwen2_vl_2b (embedding inputs, positions3).

The same numpy inputs go through the JAX package's `repro.models.layers.
mrope_apply` and reduced qwen2_vl `LM`, and the port's, with the
reference's weights carried across.  Every check uses positions whose three
axes differ — text tokens with t = h = w = i, then an image as a grid of
patches with one temporal id and its own row and column ids — since one
arange on all three axes reduces M-RoPE to RoPE and hides a band error.
Tolerances:
- `mrope_apply` in f32: 1e-6 absolute (angles in f32 on both sides);
- the LM in f32: prefill logits rtol = atol = 1e-3, decode 2e-3 (as
  tests/test_models.py holds the reference's own); the loss rtol 1e-5 and
  every gradient leaf within relative L2 1e-4 (`tests/_torch_train.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import layers as tlayers

ARCH = "qwen2_vl_2b"
ATOL = 1e-6
LM_TOL = dict(rtol=1e-3, atol=1e-3)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def positions3(b, n_text, grid):
    """(3, b, n_text + gh * gw + 2) int32: ``n_text`` text tokens at
    t = h = w = i, an image of ``grid`` = (gh, gw) patches at t = n_text,
    h = n_text + row, w = n_text + col, then two text tokens after the
    image's largest id."""
    gh, gw = grid
    t = list(range(n_text))
    h, w = list(t), list(t)
    for r in range(gh):
        for c in range(gw):
            t.append(n_text)
            h.append(n_text + r)
            w.append(n_text + c)
    nxt = n_text + max(gh, gw)
    for i in range(2):
        t.append(nxt + i)
        h.append(nxt + i)
        w.append(nxt + i)
    p = np.array([t, h, w], np.int32)
    return np.ascontiguousarray(np.broadcast_to(p[:, None], (3, b,
                                                             p.shape[1])))


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_apply_matches_reference(sections, head_dim):
    p3 = positions3(2, 5, (3, 4))
    assert len({tuple(a.ravel()) for a in p3}) == 3     # axes differ
    s = p3.shape[-1]
    x = np.random.default_rng(0).normal(size=(2, s, 3, head_dim)).astype(
        np.float32)
    want = np.asarray(jlayers.mrope_apply(jnp.asarray(x), jnp.asarray(p3),
                                          1_000_000.0, sections))
    got = tlayers.mrope_apply(torch.from_numpy(x), torch.from_numpy(p3),
                              1_000_000.0, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the bands: a section error (the axes swapped) moves the result
    swapped = tlayers.mrope_apply(torch.from_numpy(x),
                                  torch.from_numpy(p3[[0, 2, 1]]),
                                  1_000_000.0, sections)
    assert np.abs(swapped.numpy() - want).max() > 1e-3


def test_mrope_with_one_arange_is_rope():
    """The control: all three axes on one arange, M-RoPE is RoPE."""
    s, d = 11, 16
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, s, 4, d)).astype(np.float32))
    pos = torch.arange(s, dtype=torch.int32).expand(2, s)
    got = tlayers.mrope_apply(x, pos[None].expand(3, 2, s), 10_000.0,
                              (4, 2, 2))
    torch.testing.assert_close(got, tlayers.rope_apply(x, pos, 10_000.0),
                               rtol=0, atol=ATOL)


def test_mrope_sections_must_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope_apply(x, torch.zeros((3, 1, 2), dtype=torch.int32),
                            1e4, (4, 2, 1))


@pytest.fixture(scope="module")
def lm():
    """The reference's reduced qwen2_vl in f32 and the port's LM on its
    weights, plus one batch: tokens, embeddings, labels and positions3."""
    jcfg, cfg = T.configs(ARCH)
    jmodel = jbuild(jcfg, attn_impl="ref", remat_policy="none",
                    loss_chunk=64)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model.attn_impl, model.remat_policy, model.loss_chunk = "ref", "none", 64
    model.use_kernel = False
    p3 = positions3(2, 4, (2, 3))
    s = p3.shape[-1]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    batch = {"tokens": toks,
             "embeds": (rng.normal(size=(2, s, cfg.d_model)) * 0.02
                        ).astype(np.float32),
             "labels": np.concatenate([toks[:, 1:], np.full((2, 1), -100,
                                                            np.int32)], 1),
             "positions3": p3}
    return jmodel, jparams, model, batch


def _sub(batch, keys, lo, hi):
    out = {k: batch[k][:, lo:hi] for k in keys}
    if "positions3" in batch:
        out["positions3"] = batch["positions3"][:, :, lo:hi]
    return out


@pytest.mark.parametrize("inp", ["tokens", "embeds"])
def test_prefill_and_decode_match_reference(lm, inp):
    """Prefill 8 positions into caches of the batch's length, then decode
    the rest one at a time with their positions3: every logit against the
    reference's.  From ``embeds``, and from ``tokens`` (the port embeds
    them from its table; the reference's prefill reads ``embeds`` only, so
    its side takes the same table rows as ``embeds``)."""
    jmodel, jparams, model, batch = lm
    s = batch["positions3"].shape[-1]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if inp == "tokens":
        jb["embeds"] = jnp.take(jparams["embed"], jb["tokens"], axis=0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    keys = [inp]
    jcache, jlog = jmodel.prefill(jparams, _sub(jb, ["embeds"], 0, 8),
                                  s_max=s)
    cache, log = model.prefill(_sub(tb, keys, 0, 8), s)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **LM_TOL)
    for t in range(8, s):
        jcache, jlog = jmodel.decode_step(jparams, jcache,
                                          _sub(jb, ["embeds"], t, t + 1))
        cache, log = model.decode_step(cache, _sub(tb, keys, t, t + 1))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **DECODE_TOL)
    # control: decode without positions3 (1-D positions on every axis)
    # leaves the reference
    cache, _ = model.prefill(_sub(tb, keys, 0, 8), s)
    _, bad = model.decode_step(cache, {inp: tb[inp][:, 8:9]})
    _, want = jmodel.prefill(jparams, _sub(jb, ["embeds"], 0, 9), s_max=s)
    assert np.abs(bad.numpy() - np.asarray(want)).max() > 1e-3


def test_loss_and_gradients_match_reference(lm):
    """One loss from ``embeds`` with positions3, and every gradient leaf,
    against `jax.value_and_grad` of the reference's loss."""
    jmodel, jparams, model, batch = lm
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
    loss, grads = loss_and_grads(model, {
        k: torch.from_numpy(v) for k, v in batch.items() if k != "tokens"})
    assert float(loss) == pytest.approx(float(jloss), rel=T.LOSS_RTOL)
    got = convert.to_reference_layout(grads, model)
    err, leaf = T.worst_leaf(got, convert.flatten_reference(
        jax.tree.map(np.asarray, jgrads)))
    assert err <= T.GRAD_TOL, (leaf, err)
