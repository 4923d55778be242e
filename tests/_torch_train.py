"""Shared pieces of the training parity tests (`tests/test_torch_train*.py`,
`tests/test_torch_mla.py`).

`reference_run(arch)` runs the JAX package once per config: the reduced f32
model's parameters, the loss and `jax.grad` of `LM.loss` on one numpy
batch, and three train steps over three batches, composed as the
reference's `make_train_step` composes one (`value_and_grad`, then
`apply_updates`) so that the model's gradient compiles once; every leaf
comes back as numpy in `repro_torch.convert.flatten_reference`'s dotted
layout.  `port_run(ref)` does the same in the port from the reference's
parameters.  Tolerances, stated once for every config:
- loss: rtol 1e-5 (f32 sums in another order);
- each gradient leaf: relative L2 error 1e-4 (observed up to 4e-6);
- after three AdamW steps: every element of params and master within
  `PARAM_ATOL` = 5% of the three steps' summed learning rates.  Adam moves
  an element by about lr a step whatever its gradient's size, and steps 2
  and 3 take their gradients at parameters that already differ by
  rounding, so an element whose gradient is small moves by a share of a
  step that the two packages round apart (observed: up to 0.7% of the
  sum; 3.7% for one element of jamba's untied embedding, a row one token
  touches once).  Given the same parameters the gradients agree within
  `GRAD_TOL`.  Each leaf of m and v within relative L2 1e-3 (observed up
  to 1.7e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models.model import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import apply_updates as japply_updates
from repro.optim.adamw import init_state as jinit_state
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, init_state

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MOMENT_TOL = 1e-3
BATCH, SEQ, LOSS_CHUNK, STEPS = 2, 24, 8, 3
#: eps 1e-6, not the default 1e-8: Adam's step is g / (|g| + eps) per
#: element, so an element whose gradient is near eps moves by a share of a
#: step that rounding in the gradient changes (jamba's untied embedding:
#: a row touched by one token moved 0.3 of a step apart with 1e-8)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
           eps=1e-6)
#: the learning rates of the three steps: 0.005, 0.01, 0.009657
PARAM_ATOL = 0.05 * (0.005 + 0.01 + 0.009657)


def batches(vocab, n=STEPS, seed=0):
    """``n`` numpy batches: tokens, next-token labels, a few -100 masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((BATCH, 1), -100, np.int32)], axis=1)
        labels[rng.random(labels.shape) < 0.1] = -100
        out.append({"tokens": toks, "labels": labels})
    return out


def configs(arch):
    """(reference, port) reduced configs in f32."""
    return (jget_reduced(arch).replace(dtype="float32"),
            get_reduced(arch).replace(dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@dataclasses.dataclass
class ReferenceRun:
    arch: str
    params: dict          # the reference's initial tree (numpy)
    batches: list
    loss: float
    grads: dict           # dotted path -> array
    stepped: dict         # "params", "master", "m", "v" -> {path: array}
    metrics: list         # per step: loss, lr, grad_norm


def reference_run(arch, moment_dtype="float32"):
    jcfg, _ = configs(arch)
    model = jbuild(jcfg, attn_impl="chunked", remat_policy="none",
                   loss_chunk=LOSS_CHUNK)
    params = model.init(jax.random.PRNGKey(1))
    bs = batches(jcfg.vocab_size)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
    value_and_grad = jax.jit(jax.value_and_grad(model.loss))
    loss, grads = value_and_grad(params, jb[0])
    opt_cfg = JAdamWConfig(moment_dtype=moment_dtype, **OPT)
    update = jax.jit(japply_updates, static_argnames="cfg")
    p, st, metrics = params, jinit_state(params, opt_cfg), []
    for b in jb:
        step_loss, g = value_and_grad(p, b)
        p, st, m = update(p, g, st, cfg=opt_cfg)
        metrics.append({"loss": float(step_loss),
                        **{k: float(v) for k, v in m.items()}})
    stepped = {"params": convert.flatten_reference(_np(p))}
    for key in ("master", "m", "v"):
        stepped[key] = convert.flatten_reference(_np(st[key]))
    stepped["step"] = int(st["step"])
    return ReferenceRun(arch, _np(params), bs, float(loss),
                        convert.flatten_reference(_np(grads)), stepped,
                        metrics)


def port_model(ref: ReferenceRun, **kw) -> LM:
    _, cfg = configs(ref.arch)
    model = LM(cfg, device="cpu", use_kernel=False, attn_impl="chunked",
               remat_policy=kw.pop("remat_policy", "none"),
               loss_chunk=LOSS_CHUNK, **kw)
    return convert.lm_params_from_reference(ref.params, cfg, model=model)


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_loss_and_grads(model: LM, batch):
    loss, grads = loss_and_grads(model, torch_batch(batch))
    return float(loss), convert.to_reference_layout(grads, model)


def port_steps(ref: ReferenceRun, moment_dtype="float32", microbatches=1,
               **opt_over):
    """Three port train steps from the reference's parameters: (state in
    the reference's layout, per-step metrics).  ``opt_over`` overrides
    `OPT` (the controls)."""
    model = port_model(ref)
    opt_cfg = AdamWConfig(moment_dtype=moment_dtype, **{**OPT, **opt_over})
    step = make_train_step(model, opt_cfg, microbatches=microbatches)
    params = dict(model.named_parameters())
    st, metrics = init_state(params, opt_cfg), []
    for b in ref.batches:
        params, st, m = step(params, st, torch_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    out = convert.adamw_state_to_reference(st, model)
    out["params"] = convert.to_reference_layout(params, model)
    return out, metrics


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def max_abs(got: dict, want: dict):
    """(largest elementwise |got - want| over the leaves, its path)."""
    assert set(got) == set(want), set(got) ^ set(want)
    return max((float(np.max(np.abs(np.asarray(got[k], np.float64)
                                    - np.asarray(want[k], np.float64)))), k)
               for k in want)


def worst_leaf(got: dict, want: dict):
    """(largest relative L2 error over the leaves, its path); the two
    dicts must hold the same leaves with the same shapes."""
    assert set(got) == set(want), set(got) ^ set(want)
    worst = (0.0, None)
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        worst = max(worst, (rel_l2(got[k], want[k]), k))
    return worst


def check_loss_and_grads(ref):
    """The loss and every gradient leaf; the control without the mask
    must fail both."""
    model = port_model(ref)
    loss, grads = port_loss_and_grads(model, ref.batches[0])
    assert loss == pytest.approx(ref.loss, rel=LOSS_RTOL)
    err, leaf = worst_leaf(grads, ref.grads)
    assert err <= GRAD_TOL, (leaf, err)
    # control: the -100 mask dropped (masked labels read as token 0)
    unmasked = dict(ref.batches[0])
    unmasked["labels"] = np.maximum(unmasked["labels"], 0)
    bad_loss, bad = port_loss_and_grads(model, unmasked)
    assert bad_loss != pytest.approx(ref.loss, rel=LOSS_RTOL)
    assert worst_leaf(bad, ref.grads)[0] > GRAD_TOL


def check_three_steps(ref):
    """Params, master, m, v and the step metrics after three steps; the
    control without weight decay must fail."""
    got, metrics = port_steps(ref)
    assert got["step"] == ref.stepped["step"] == 3
    for key in ("params", "master"):
        err, leaf = max_abs(got[key], ref.stepped[key])
        assert err <= PARAM_ATOL, (key, leaf, err)
    for key in ("m", "v"):
        err, leaf = worst_leaf(got[key], ref.stepped[key])
        assert err <= MOMENT_TOL, (key, leaf, err)
    for g, w in zip(metrics, ref.metrics):
        for k in ("loss", "lr", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    control, _ = port_steps(ref, weight_decay=0.0)
    assert max_abs(control["params"], ref.stepped["params"])[0] \
        > PARAM_ATOL
