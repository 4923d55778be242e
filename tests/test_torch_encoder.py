"""Port parity: the encoder, cross-attention and whisper_small.

The same numpy inputs go through the JAX package's reduced whisper (its
`cross_attn_forward`, `LM._encode`, the teacher-forced prefill and decode
of tests/test_models.py, its loss) and the port's, with the reference's
weights carried across; and the trainer takes steps on both multimodal
configs with their batch keys, as the reference's tests train them.
Tolerances (f32): the layer and the encoder rtol = atol = 1e-5 (sums in
another order); logits rtol = atol = 1e-3 at prefill and 2e-3 at decode
(tests/test_models.py:81-90); the loss rtol 1e-5 and every gradient leaf
within relative L2 1e-4 (`tests/_torch_train.py`).
"""

import math

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
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import attention as tattn

ARCH = "whisper_small"
TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-3)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    """The reference's reduced whisper in f32, the port's LM on its
    weights, and one batch: 12 decoder tokens, labels and 24 frames."""
    jcfg, cfg = T.configs(ARCH)
    jmodel = jbuild(jcfg, attn_impl="ref", remat_policy="none",
                    loss_chunk=64)
    jparams = jmodel.init(jax.random.PRNGKey(6))
    model = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model.attn_impl, model.remat_policy, model.loss_chunk = "ref", "none", 64
    model.use_kernel = False
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            1)
    labels[0, 3] = -100
    frames = (rng.normal(size=(2, cfg.encoder.n_frames, cfg.d_model))
              * 0.02).astype(np.float32)
    return jmodel, jparams, model, {"tokens": toks, "labels": labels,
                                    "frames": frames}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cross_attention_matches_reference(lm, use_kernel):
    """Block 0's cross-attention over 24 encoder rows, 7 query rows (not a
    square: no causal diagonal could hide): the plain math, and the
    kernel's plain version (``use_kernel=True`` on CPU tensors), against
    the reference's."""
    _, jparams, model, _ = lm
    cfg = model.cfg
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.encoder.n_frames, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["stages"][0][0]["cross"])
    want = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(enc),
                                    T.configs(ARCH)[0], impl="ref")
    with torch.no_grad():
        got = tattn.cross_attn_forward(
            model.blocks[0].cross, torch.from_numpy(x), torch.from_numpy(enc),
            cfg, impl="ref", use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # control: a causal mask over the encoder rows changes the output
    q = (torch.from_numpy(x) @ model.blocks[0].cross["wq"]).reshape(
        2, 7, cfg.n_heads, cfg.head_dim)
    k = (torch.from_numpy(enc) @ model.blocks[0].cross["wk"]).reshape(
        2, -1, cfg.n_heads, cfg.head_dim)
    v = (torch.from_numpy(enc) @ model.blocks[0].cross["wv"]).reshape(
        2, -1, cfg.n_heads, cfg.head_dim)
    causal = tattn._sdpa(q, k, v, causal=True, kv_len=k.shape[1],
                         q_offset=0, scale=cfg.head_dim ** -0.5, impl="ref",
                         use_kernel=False)
    open_ = tattn._sdpa(q, k, v, causal=False, kv_len=k.shape[1],
                        q_offset=0, scale=cfg.head_dim ** -0.5, impl="ref",
                        use_kernel=False)
    assert not torch.allclose(causal, open_, **TOL)


def test_encoder_matches_reference(lm):
    jmodel, jparams, model, batch = lm
    want = jmodel._encode(jparams, jnp.asarray(batch["frames"]))
    with torch.no_grad():
        got = model._encode(torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_teacher_forced_prefill_and_decode_match_reference(lm):
    """tests/test_models.py's check on the port: prefill 8 tokens with the
    frames, decode 4 from the cache (learned positions sliced at the
    cache's length, the encoder's output kept in the cache): every logit
    against the reference's prefill and decode, and against the
    reference's teacher-forced forward of all 12 tokens."""
    jmodel, jparams, model, batch = lm
    jb = _jax(batch)
    enc_out = jmodel._encode(jparams, jb["frames"])
    x = jmodel._embed_in(jparams, jb, 0)
    h, _, _ = jmodel._backbone(jparams, x, caches=None, enc_out=enc_out,
                               positions3=None)
    full = np.asarray(h.astype(jnp.float32)
                      @ jmodel._head(jparams).astype(jnp.float32))
    pre = {"tokens": batch["tokens"][:, :8], "frames": batch["frames"]}
    jcache, jlog = jmodel.prefill(jparams, _jax(pre), s_max=12)
    cache, log = model.prefill(_torch(pre), 12)
    assert cache["enc_out"].shape == (2, model.cfg.encoder.n_frames,
                                      model.cfg.d_model)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **LM_TOL)
    np.testing.assert_allclose(log.numpy(), full[:, 7], **LM_TOL)
    for t in range(8, 12):
        step = {"tokens": batch["tokens"][:, t:t + 1]}
        jcache, jlog = jmodel.decode_step(jparams, jcache, _jax(step))
        cache, log = model.decode_step(cache, _torch(step))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **DECODE_TOL)
        np.testing.assert_allclose(log.numpy(), full[:, t], **DECODE_TOL)


def test_decode_through_the_kernel_wrapper_matches_plain(lm):
    """The same prefill and decode with ``use_kernel=True`` (the flash
    wrapper's plain version on CPU tensors: causal self-attention and
    non-causal cross-attention, Sq 1 over 24 rows, through `ops.flash`)
    against the plain math: decode logits within 1e-5."""
    _, _, model, batch = lm
    pre = _torch({"tokens": batch["tokens"][:, :8],
                  "frames": batch["frames"]})
    logs = []
    before = FK.LAUNCHES["flash_attention"]
    for use_kernel in (False, True):
        model.use_kernel = use_kernel
        cache, log = model.prefill(pre, 12)
        out = [log]
        for t in range(8, 12):
            cache, log = model.decode_step(cache, {"tokens": torch.from_numpy(
                batch["tokens"][:, t:t + 1])})
            out.append(log)
        logs.append(torch.stack(out))
    model.use_kernel = False
    assert FK.LAUNCHES["flash_attention"] == before     # no card: no launch
    torch.testing.assert_close(logs[1], logs[0], **TOL)


def test_loss_with_frames_and_gradients_match_reference(lm):
    jmodel, jparams, model, batch = lm
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams,
                                                             _jax(batch))
    loss, grads = loss_and_grads(model, _torch(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=T.LOSS_RTOL)
    err, leaf = T.worst_leaf(convert.to_reference_layout(grads, model),
                             convert.flatten_reference(
                                 jax.tree.map(np.asarray, jgrads)))
    assert err <= T.GRAD_TOL, (leaf, err)
    # control: other frames move the loss
    other = dict(batch, frames=batch["frames"][::-1].copy())
    with torch.no_grad():
        moved = float(model.loss(_torch(other)))
    assert moved != pytest.approx(float(jloss), rel=T.LOSS_RTOL)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "whisper_small"])
def test_trainer_trains_the_multimodal_configs(arch):
    """`launch.train.train` on the reduced config with the reference's
    batch keys (embeds and positions3; frames): finite losses that fall
    over 12 steps, as tests/test_system.py trains qwen2_vl."""
    out = ttrain.train(arch, steps=12, seq_len=16, global_batch=2,
                       lr=3e-3, log_every=1, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert out["steps_done"] == 12 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0]
