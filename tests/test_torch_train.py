"""Port parity: training (`LM.loss`, its gradients, the train step) and the
trainer's own contracts.

Against the JAX package, for the dense and SSM configs the port's `LM`
accepts (gemma_2b, mamba2_780m, phi3, stablelm, command_r; the MoE configs
are in `test_torch_train_moe.py`, deepseek_v3 in `test_torch_mla.py`), on
the reference's reduced sizes in f32, with the reference's parameters
carried across and the same numpy batches (`tests/_torch_train.py` states
the tolerances):
- the loss, and `LM.loss`'s gradient leaf by leaf against `jax.grad`; a
  control with the -100 label mask dropped must fail both;
- three `make_train_step` steps: params, master, m and v leaf by leaf, and
  the step metrics; a control without weight decay must fail;
- the chunked cross-entropy against the reference's, with softcap and
  masks (rtol 1e-5); `_sdpa`'s chunked and triangular paths against its
  ``ref`` path, forward and backward (rtol = atol = 1e-5), and the
  triangular path against the reference's; every remat policy against
  "none" (bit for bit: recomputing runs the same ops).

The trainer, as `tests/test_system.py` states its contracts for the
reference, on the CPU: the loss falls; a crash is absorbed; a resumed run
is bit-equal to an uninterrupted one, and a run under chaos to one
without; microbatches give the first step's loss and update of a full
batch.  Unported options raise; a backward through the kernels' wrappers
raises, and the trainer's model does not reach them.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.models import attention as jattn
from repro.models.layers import chunked_softmax_xent as jxent
from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.examples import quickstart, train_100m
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.chaos import FaultPlan

ARCHS = ("gemma_2b", "mamba2_780m", "phi3_medium_14b", "stablelm_12b",
         "command_r_plus_104b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return T.reference_run(request.param)


# ---------------------------------------------------------------------------
# loss, gradients and three steps against the reference
# ---------------------------------------------------------------------------

def test_loss_and_gradients_match_jax_grad(ref):
    T.check_loss_and_grads(ref)


def test_three_train_steps_match_reference(ref):
    T.check_three_steps(ref)


def test_adamw_state_carries_across(ref):
    """The reference's AdamW state after three steps, carried into the
    port's layout (`convert.adamw_state_from_reference`) and back, bit for
    bit, on the port's parameter names."""
    model = T.port_model(ref)
    tree = {"step": ref.stepped["step"], **{k: ref.stepped[k] for k in
                                            ("master", "m", "v")}}
    state = convert.adamw_state_from_reference(tree, model)
    assert int(state["step"]) == 3
    assert set(state["master"]) == set(dict(model.named_parameters()))
    back = convert.adamw_state_to_reference(state, model)
    for key in ("master", "m", "v"):
        for path, arr in ref.stepped[key].items():
            np.testing.assert_array_equal(back[key][path], arr,
                                          err_msg=f"{key} {path}")


def test_microbatches_match_one_batch():
    """Two microbatches against one batch whose rows hold equal counts of
    labels (only the last is masked), so the mean of the halves' means is
    the batch mean: the first step's loss within rtol 1e-5 (the
    reference's test allows 2e-2) and every updated parameter within 2%
    of the step's learning rate (`_torch_train.PARAM_ATOL` says why a
    share of a step)."""
    _, cfg = T.configs("gemma_2b")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (4, T.SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -100, np.int32)],
                            axis=1)
    batch = T.torch_batch({"tokens": toks, "labels": labels})
    out = []
    for mb in (1, 2):
        model = LM(cfg, device="cpu", seed=3, use_kernel=False,
                   remat_policy="none", loss_chunk=T.LOSS_CHUNK)
        opt = AdamWConfig(**T.OPT)
        step = tsteps.make_train_step(model, opt, microbatches=mb)
        params = dict(model.named_parameters())
        params, _, m = step(params, init_state(params, opt), batch)
        out.append((float(m["loss"]), {n: p.detach().clone()
                                        for n, p in params.items()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    lr = 0.005                    # step 1 of `_torch_train.OPT`
    for name, p in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], p, rtol=0,
                                   atol=0.02 * lr)


# ---------------------------------------------------------------------------
# the pieces: cross-entropy, attention paths, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("chunk", [5, 64])
def test_chunked_softmax_xent_matches_reference(softcap, chunk):
    """(B 2, S 13, d 16, vocab 40): chunks of 5 (the last one short; the
    reference pads it with masked rows) and one chunk; a third of the
    labels -100, the rest in range; value and the gradients of h and the
    head within rtol 1e-5, atol 1e-6.  Control: the same loss with no
    mask differs."""
    rng = np.random.default_rng(11)
    h = rng.normal(size=(2, 13, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 13)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.33] = -100

    def jloss(h, w):
        return jxent(h, w, jnp.asarray(labels), chunk=chunk,
                     logit_softcap=softcap)

    want, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = chunked_softmax_xent(th, tw, torch.from_numpy(labels),
                               chunk=chunk, logit_softcap=softcap)
    gh, gw = torch.autograd.grad(got, (th, tw))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.detach()), float(want), **tol)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **tol)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **tol)
    unmasked = chunked_softmax_xent(th, tw, torch.from_numpy(
        np.maximum(labels, 0)), chunk=chunk, logit_softcap=softcap)
    assert not np.isclose(float(unmasked.detach()), float(want), **tol)


def _qkv(seed, b, s, hq, hkv, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv or d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("impl,kv_len", [("chunked", 37), ("chunked", 30),
                                         ("tri", 37), ("tri", 30)])
def test_sdpa_paths_match_ref_forward_and_backward(impl, kv_len):
    """Causal GQA (4 query heads over 2, D 8, Dv 12 as MLA's), S 37 with
    query blocks of 8 (chunked) or bands of 16 (tri, padded to 48), all
    keys valid or the last 7 masked: output and the gradients of q, k and
    v against the ``ref`` path within rtol = atol = 1e-5."""
    q, k, v = _qkv(2, 2, 37, 4, 2, 8, dv=12)
    outs = []
    for path in ("ref", impl):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        kw = dict(causal=True, kv_len=kv_len, q_offset=0, scale=8 ** -0.5,
                  use_kernel=False)
        if path == "tri":
            out = tattn._sdpa_tri(*ts, kv_len=kv_len, scale=8 ** -0.5,
                                  block=16)
        else:
            out = tattn._sdpa(*ts, impl=path, q_chunk=8, **kw)
        g = torch.from_numpy(np.random.default_rng(3).normal(
            size=out.shape).astype(np.float32))
        outs.append((out.detach(), torch.autograd.grad(out, ts, g)))
    (o_ref, g_ref), (o, gs) = outs
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(gs, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_sdpa_tri_matches_reference():
    """The triangular path against the reference's `_sdpa_tri` (S 40,
    bands of 16, 6 query heads over 3, D 8), rtol = atol = 1e-5."""
    q, k, v = _qkv(5, 1, 40, 6, 3, 8)
    tri = jax.jit(jattn._sdpa_tri, static_argnames=("scale", "block"))
    want = tri(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=40,
               scale=0.3, block=16)
    got = tattn._sdpa_tri(*(torch.from_numpy(a) for a in (q, k, v)),
                          kv_len=40, scale=0.3, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "deepseek_v3_671b"])
def test_remat_policies_match_none(arch):
    """Every remat policy gives the loss and gradients of "none", bit for
    bit, on the hybrid (attention, SSM, MoE) and the MLA config; a control
    on another batch differs."""
    _, cfg = T.configs(arch)
    b = T.batches(cfg.vocab_size, n=2, seed=4)
    results = {}
    for policy in ("none", "full", "dots", "dots_no_batch"):
        model = LM(cfg, device="cpu", seed=2, use_kernel=False,
                   remat_policy=policy, loss_chunk=T.LOSS_CHUNK)
        results[policy] = tsteps.loss_and_grads(model, T.torch_batch(b[0]))
    base_loss, base = results["none"]
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, base_loss), policy
        for name, g in grads.items():
            assert torch.equal(g, base[name]), (policy, name)
    other = LM(cfg, device="cpu", seed=2, use_kernel=False,
               remat_policy="full", loss_chunk=T.LOSS_CHUNK)
    assert not torch.equal(other.loss(T.torch_batch(b[1])).detach(),
                           base_loss)


def test_kernel_wrappers_have_no_backward():
    """`ops.flash` and `ops.ssd`'s kernel call are forward-only: a backward
    through them raises (here through their plain versions on CPU
    tensors), while their forward takes tensors that require grad."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
               for a in _qkv(1, 1, 16, 2, 1, 32))
    out = fops.flash(q, k, v, causal=True, scale=None, kv_valid=16,
                     kv_offset=0)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        out.sum().backward()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 64, 2, 64)).astype(
        np.float32)).requires_grad_()
    dt = torch.full((1, 64, 2), 0.1)
    A = -torch.ones(2)
    B = torch.from_numpy(rng.normal(size=(1, 64, 1, 32)).astype(np.float32))
    y = sops.ssd(x, dt, A, B, B.clone(), chunk=64, use_kernel=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        y.sum().backward()
    with pytest.raises(ValueError, match="Dv != D"):
        fops.flash(q, k, v[..., :16], causal=True, scale=None,
                   kv_valid=16, kv_offset=0)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_runs_the_plain_paths():
    """`train` builds its model with the kernels off (they have no
    backward) and the chunked attention, as the reference's trainer."""
    seen = {}
    real = ttrain.build_model

    def spy(cfg, **kw):
        seen.update(kw)
        return real(cfg, **kw)

    ttrain.build_model, saved = spy, ttrain.build_model
    try:
        ttrain.train("gemma_2b", steps=1, seq_len=16, global_batch=2,
                     device="cpu")
    finally:
        ttrain.build_model = saved
    assert seen["use_kernel"] is False and seen["attn_impl"] == "chunked"


def test_training_reduces_loss(tmp_path):
    out = ttrain.train("gemma_2b", steps=30, seq_len=64, global_batch=4,
                       ckpt_dir=str(tmp_path), checkpoint_every=10, lr=3e-3,
                       log_every=5, seed=0, device="cpu")
    hist = out["history"]
    assert out["steps_done"] == 30 and out["failures"] == 0
    assert math.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 30


def test_training_survives_injected_failure(tmp_path):
    crashes = {12: 1}

    def injector(step):
        if crashes.get(step):
            crashes[step] -= 1
            raise RuntimeError("simulated chip loss")

    out = ttrain.train("stablelm_12b", steps=20, seq_len=32, global_batch=4,
                       ckpt_dir=str(tmp_path), checkpoint_every=5,
                       failure_injector=injector, log_every=5, device="cpu")
    assert out["steps_done"] == 20 and out["failures"] == 1
    assert math.isfinite(out["final_loss"])


def _final_checkpoint(path):
    step = ckpt_lib.latest_step(path)
    _, data = ckpt_lib._load_validated(ckpt_lib._step_path(path, step))
    return step, {k: np.asarray(v) for k, v in data.items()}


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """A crash at step 9 and a resume from step 8's checkpoint end
    bit-equal to the straight run: the loss, and every parameter and
    optimizer leaf of the final checkpoint (the reference's test allows
    1e-4 on the loss)."""
    kw = dict(steps=16, seq_len=32, global_batch=2, lr=1e-3, log_every=1,
              seed=3, checkpoint_every=4, device="cpu")
    a = ttrain.train("mamba2_780m", ckpt_dir=str(tmp_path / "a"), **kw)
    crashes = {9: 1}

    def injector(step):
        if crashes.get(step):
            crashes[step] -= 1
            raise RuntimeError("boom")

    b = ttrain.train("mamba2_780m", ckpt_dir=str(tmp_path / "b"),
                     failure_injector=injector, **kw)
    assert b["failures"] == 1
    assert a["final_loss"] == b["final_loss"]
    sa, ca = _final_checkpoint(str(tmp_path / "a"))
    sb, cb = _final_checkpoint(str(tmp_path / "b"))
    assert sa == sb == 16 and ca.keys() == cb.keys()
    for key in ca:
        np.testing.assert_array_equal(ca[key], cb[key], err_msg=key)


def test_chaos_run_is_bit_equal_to_a_clean_one(tmp_path):
    """The end-to-end recipe: gemma_2b, 8 steps, a checkpoint directory and
    ``seed=3,step=1.0@2,ckpt_save=1.0@1``: failures > 0, and the final
    loss and every leaf of the final checkpoint bit-equal to the run
    without faults."""
    kw = dict(steps=8, seq_len=32, global_batch=2, device="cpu")
    clean = ttrain.train("gemma_2b", ckpt_dir=str(tmp_path / "a"), **kw)
    chaos = ttrain.train("gemma_2b", ckpt_dir=str(tmp_path / "b"),
                         chaos=FaultPlan.from_spec(
                             "seed=3,step=1.0@2,ckpt_save=1.0@1"), **kw)
    assert clean["failures"] == 0 < chaos["failures"]
    assert clean["final_loss"] == chaos["final_loss"]
    _, ca = _final_checkpoint(str(tmp_path / "a"))
    _, cb = _final_checkpoint(str(tmp_path / "b"))
    assert ca.keys() == cb.keys()
    for key in ca:
        np.testing.assert_array_equal(ca[key], cb[key], err_msg=key)


def test_unported_options_raise(monkeypatch, capsys):
    """A mesh raises for a config with MoE layers only where its
    expert-parallel layer cannot cut the sequence over "model" (sharded
    MoE training runs, `test_torch_train_sharded_moe.py`; sharded dense
    training, `test_torch_train_sharded.py`); the tuning options, which
    raised until the tuning slice, now run: a controller per call, its
    stats in the result, no live spec left."""
    from repro_torch.core import rmw_engine

    class _Mesh:
        axis_names, shape = ("data", "model"), {"data": 1, "model": 2}

    with pytest.raises(NotImplementedError, match="sharded MoE training"):
        ttrain.train("deepseek_v3_671b", steps=1, seq_len=15, mesh=_Mesh(),
                     device="cpu")
    kw = dict(steps=1, seq_len=8, global_batch=2, device="cpu")
    assert "tuning" in ttrain.train("gemma_2b", tuning=True, **kw)
    monkeypatch.setenv("REPRO_TUNING", "on")
    assert "tuning" in ttrain.train("gemma_2b", **kw)
    monkeypatch.delenv("REPRO_TUNING")
    assert "tuning" not in ttrain.train("gemma_2b", **kw)
    ttrain.main(["--arch", "gemma_2b", "--device", "cpu", "--tuning",
                 "--steps", "1", "--seq-len", "8", "--global-batch", "2"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["tuning"]["updates"] >= 0
    assert rmw_engine.live_spec() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ttrain.train("gemma_2b", steps=1)


def test_cli_trains_on_the_cpu(capsys):
    ttrain.main(["--arch", "gemma_2b", "--steps", "3", "--seq-len", "16",
                 "--global-batch", "2", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["steps_done"] == 3 and math.isfinite(got["final_loss"])


def test_prefill_and_decode_steps_load_the_params():
    """`make_prefill_step` / `make_decode_step` run the model on the
    parameters they are handed (a copy here, as a checkpoint restores):
    the same logits as the model's own prefill and decode."""
    _, cfg = T.configs("gemma_2b")
    model = LM(cfg, device="cpu", seed=1, use_kernel=False)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    want_cache, want = model.prefill({"tokens": toks[:, :8]}, 16)
    _, want_next = model.decode_step(want_cache, {"tokens": toks[:, 8:]})
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    cache, got = tsteps.make_prefill_step(model, 16)(
        params, {"tokens": toks[:, :8]})
    _, got_next = tsteps.make_decode_step(model)(
        params, cache, {"tokens": toks[:, 8:]})
    assert torch.equal(got, want) and torch.equal(got_next, want_next)


def test_abstract_train_state_is_meta():
    _, cfg = T.configs("deepseek_v3_671b")
    model = LM(cfg, device="cpu", use_kernel=False)
    params, opt = tsteps.abstract_train_state(model, AdamWConfig())
    own = dict(model.named_parameters())
    assert params.keys() == own.keys() == opt["master"].keys()
    for n, p in params.items():
        assert p.device.type == "meta"
        assert (p.shape, p.dtype) == (own[n].shape, own[n].dtype), n
        assert opt["m"][n].dtype == torch.float32


def test_quickstart_example_runs(capsys):
    out = quickstart.main(["--device", "cpu", "--steps", "12"])
    assert out["train"]["steps_done"] == 12
    assert out["serve"]["completed"] == 3
    assert "serving 3 batched requests" in capsys.readouterr().out


def test_train_100m_small_runs_and_resumes(tmp_path):
    argv = ["--small", "--steps", "2", "--seq-len", "32", "--global-batch",
            "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = train_100m.main(argv)
    assert first["start"] == 0 and math.isfinite(first["final_loss"])
    argv[2] = "3"
    again = train_100m.main(argv)
    assert again["start"] == 2 and math.isfinite(again["final_loss"])
