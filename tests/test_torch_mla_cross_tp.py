"""MLA and cross-attention computed on a rank's "model" cut of their heads,
on 2 gloo CPU ranks, against the reference's `mla_forward` and
`cross_attn_forward` and their `jax.vjp` on whole weights.

One world of 2 ranks on a ``("model",)`` mesh (module-scoped), rank side
`tests/_torch_mla_cross_tp_worker.py` (no JAX): each rank gets the
reference specs' blocks of the leaves `launch.shardings.model_cuts`
marks "cut" (MLA's ``wq_b`` and ``wkv_b`` by columns, which are whole
heads, and ``wo`` by rows; cross-attention's ``wq`` / ``wk`` / ``wv`` by
columns and ``wo`` by rows), every other leaf whole, and computes on its
heads (`models.attention`): the column products' inputs and MLA's shared
rotated key ``krope`` through `launch.mesh.sum_grad`, the encoder's
output once for both of its products, ``wo`` a row product.  The same
numpy inputs, made from a seed, go through the reference in this process
unsharded: its sharded model paths are no live oracles on jax 0.9.0
(`ShardingTypeError` at `src/repro/models/model.py:79`, ROADMAP queue 3).

Tolerance: relative L2 1e-5 in f32 on the output, the inputs' gradients
and every leaf's gradient reassembled from the ranks (`REL_TOL`; the
whole leaves' the rank's own, equal on both ranks within 1e-6).  The
controls (``krope`` without its gradient's sum; cross-attention without
``wo``'s row sum; MLA's whole leaves marked "partial", so that the train
step's summation, `launch.steps.grad_axes`, sums them over "model" once
more) must be off by more than 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mla_cross_tp_worker as W
from repro.configs import get_reduced as jget_reduced
from repro.models.attention import cross_attn_forward, mla_forward
from repro_torch.launch import ranks

REL_TOL, SPREAD_TOL, CONTROL_MIN = 1e-5, 1e-6, 1e-3
#: (kind, batch, query rows, encoder rows)
CASES = (("mla", 2, 12, 0), ("cross", 2, 6, 10))


def _inputs(kind, b, s, se, seed):
    """Seeded numpy weights (the norms' away from 1), inputs and the
    output's cotangent for one layer of ``kind``."""
    cfg = W.config(kind)
    rng = np.random.default_rng(seed)
    nrm = lambda *shape: rng.normal(size=shape).astype(np.float32)
    module = W.layer(kind)
    params = {}
    for name in W.leaves(kind):
        shape = tuple(module.get_parameter(name).shape)
        params[name] = (1 + nrm(*shape) * 0.3 if len(shape) == 1
                        else nrm(*shape) * shape[0] ** -0.5)
    c = dict(kind=kind, params=params, x=nrm(b, s, cfg.d_model),
             ct=nrm(b, s, cfg.d_model))
    if se:
        c["enc"] = nrm(b, se, cfg.d_model)
    return c


def _nested(params):
    """The reference's parameter tree: a norm's weight under its dict."""
    out = {}
    for name, v in params.items():
        head, _, leaf = name.partition(".")
        if leaf:
            out.setdefault(head, {})[leaf] = jnp.asarray(v)
        else:
            out[name] = jnp.asarray(v)
    return out


def _reference(c):
    """The reference's output, the inputs' gradients and every leaf's:
    `jax.vjp` of `mla_forward` / `cross_attn_forward` on whole weights."""
    cfg = jget_reduced(W.KINDS[c["kind"]][0]).replace(dtype="float32")
    params = _nested(c["params"])
    if c["kind"] == "mla":
        fn = lambda p, x: mla_forward(p, x, cfg)[0]
        args = (params, jnp.asarray(c["x"]))
    else:
        fn = lambda p, x, e: cross_attn_forward(p, x, e, cfg)
        args = (params, jnp.asarray(c["x"]), jnp.asarray(c["enc"]))
    y, back = jax.vjp(fn, *args)
    gp, *gin = back(jnp.asarray(c["ct"]))
    grads = {}
    for name in c["params"]:
        head, _, leaf = name.partition(".")
        grads[name] = np.asarray(gp[head][leaf] if leaf else gp[name])
    out = {"y": np.asarray(y), "grads": grads}
    out.update({f"d{k}": np.asarray(g)
                for k, g in zip(("x", "enc"), gin)})
    return out


@pytest.fixture(scope="module")
def run():
    cases = [_inputs(kind, b, s, se, 70 + k)
             for k, (kind, b, s, se) in enumerate(CASES)]
    out = ranks.launch(f"{W.__file__}:run", 2, mesh=((2,), ("model",)),
                       device="cpu", args=(cases,), timeout=300)
    return cases, out, [_reference(c) for c in cases]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _errors(got, want):
    """{what: relative L2} of the output, the inputs' gradients and every
    leaf's gradient."""
    errs = {k: _rel(got[k], want[k]) for k in want if k != "grads"}
    errs.update({n: _rel(got["grads"][n], want["grads"][n])
                 for n in want["grads"]})
    return errs


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[kind for kind, *_ in CASES])
def test_cut_layer_matches_reference_vjp(run, k):
    """On each rank: the output and the inputs' gradients (x; the
    encoder's output for cross-attention) against the reference's, every
    leaf's gradient against `jax.vjp`'s (MLA's ``q_norm``, ``kv_norm``,
    ``wq_a`` and ``wkv_a``, whose ``krope`` columns carry the shared
    key's path, among them), within relative L2 1e-5; a whole leaf's
    gradient equal on both ranks, so the step counts it once."""
    _, out, ref = run
    for o in out:
        errs = _errors(o["cases"][k], ref[k])
        assert set(errs) >= set(ref[k]["grads"]) | {"y", "dx"}
        assert max(errs.values()) <= REL_TOL, errs
        assert o["cases"][k]["spread"] <= SPREAD_TOL


@pytest.mark.parametrize("k,control", [(0, "krope_unsummed"),
                                       (1, "cross_unsummed_wo")])
def test_controls_fail_the_check(run, k, control):
    """``krope``'s gradient left unsummed over "model" leaves the forward
    alone but puts ``wkv_a``'s gradient and dx off; cross-attention
    without ``wo``'s row sum puts the output off: each by more than
    1e-3."""
    _, out, ref = run
    errs = _errors(out[0]["controls"][(k, control)], ref[k])
    assert max(errs.values()) > CONTROL_MIN, errs
    if control == "krope_unsummed":
        assert errs["y"] <= REL_TOL
        assert errs["wkv_a"] > CONTROL_MIN and errs["dx"] > CONTROL_MIN
    else:
        assert errs["y"] > CONTROL_MIN


@pytest.mark.parametrize("leaf", ["wq_a", "wkv_a", "q_norm.w", "kv_norm.w"])
def test_control_whole_leaf_summed_twice_fails(run, leaf):
    """MLA's whole leaves already hold the whole gradient on each rank
    (their outputs pass `sum_grad`): `model_cuts` marks each "whole", and
    the train step's summation under that mark (`launch.steps.grad_axes`)
    leaves it within 1e-5 of `jax.vjp`'s; marked "partial", the same
    summation adds the ranks' once more and puts it off by more than
    1e-3 (twice the gradient on 2 ranks)."""
    _, out, ref = run
    for o in out:
        mode, summed, as_partial = o["summed"][leaf]
        assert mode == "whole"
        assert _rel(summed, ref[0]["grads"][leaf]) <= REL_TOL
        assert _rel(as_partial, ref[0]["grads"][leaf]) > CONTROL_MIN


def test_ranks_import_no_jax(run):
    """The ranks ran the port alone: no module of jax or of the
    reference was imported."""
    _, out, _ = run
    assert all(o["modules"] == [] for o in out)
