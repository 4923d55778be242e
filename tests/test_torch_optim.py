"""Port parity: AdamW (`repro_torch.optim.adamw`), the int8 error-feedback
compression (`repro_torch.optim.compression`) and `core.scatter_add_grads`.

The same numpy inputs go through the JAX package and the port.
Tolerances:
- the schedule: rtol 1e-6 (f32 on both sides);
- `apply_updates` on the same gradients, three steps: f32 master weights,
  f32 parameters and f32 moments within rtol 1e-6, atol 1e-8 (the global
  norm sums its leaves in another order, and m cancels where a gradient
  changes sign); bf16 parameters and moments within one bf16 rounding of the
  reference's (rtol 2^-7); the metrics within rtol 1e-6.  A control that
  decays every leaf, the 1-D ones too, must fail;
- compression: the int8 payload, the scales, the carried error and the
  decompressed gradient bit-equal (``torch.round`` and ``jnp.round`` both
  round half to even); a control that rounds half away from zero differs
  on exact halves;
- `scatter_add_grads`: int32 bit-equal, f32 within rtol 1e-6, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scatter_add_grads as jscatter
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.core import scatter_add_grads
from repro_torch.optim import adamw, compression

SHAPES = {"w": (8, 16), "b": (16,), "e": (32, 8)}


def _tree(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(dtype)
            for k, s in SHAPES.items()}


def _to_torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _np(x):
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ---------------------------------------------------------------- AdamW

def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for step in range(0, 45):
        want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                     jnp.int32(step)))
        got = float(adamw.schedule(adamw.AdamWConfig(**cfg),
                                   torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), step


def _run_reference(params, grads_seq, cfg_kw, pdtype):
    cfg = jadamw.AdamWConfig(**cfg_kw)
    p = {k: jnp.asarray(v).astype(pdtype) for k, v in params.items()}
    st = jadamw.init_state(p, cfg)
    metrics = []
    for g in grads_seq:
        p, st, m = jadamw.apply_updates(
            p, {k: jnp.asarray(v).astype(pdtype) for k, v in g.items()},
            st, cfg)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, st, metrics


def _run_port(params, grads_seq, cfg_kw, pdtype, ndims=None):
    cfg = adamw.AdamWConfig(**cfg_kw)
    p = _to_torch(params, pdtype)
    st = adamw.init_state(p, cfg)
    metrics = []
    for g in grads_seq:
        p, st, m = adamw.apply_updates(p, _to_torch(g, pdtype), st, cfg,
                                       ndims)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, st, metrics


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("pdtype,moments", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_apply_updates_match_reference(pdtype, moments, clip):
    """Three steps on the same gradients (their norm about 20, so the clip
    at 1.0 scales them); weight decay 0.1 on the 2-D leaves only."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
                  moment_dtype=moments)
    params = _tree(0)
    grads = [_tree(s, scale=0.5) for s in (1, 2, 3)]
    jd = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    jp, jst, jm = _run_reference(params, grads, cfg_kw, jd)
    tp, tst, tm = _run_port(params, grads, cfg_kw, td)
    assert int(tst["step"]) == int(jst["step"]) == 3
    bf16 = dict(rtol=2 ** -7, atol=1e-9)
    f32 = dict(rtol=1e-6, atol=1e-8)
    for k in SHAPES:
        np.testing.assert_allclose(_np(tst["master"][k]),
                                   np.asarray(jst["master"][k]), **f32)
        np.testing.assert_allclose(_np(tp[k]), np.asarray(
            jp[k], np.float32), **(bf16 if pdtype == "bfloat16" else f32))
        assert tp[k].dtype == td
        for key in ("m", "v"):
            want = np.asarray(jst[key][k], np.float32)
            np.testing.assert_allclose(
                _np(tst[key][k]), want,
                **(bf16 if moments == "bfloat16" else f32))
            assert tst[key][k].dtype == (torch.bfloat16
                                         if moments == "bfloat16"
                                         else torch.float32)
    for g, w in zip(tm, jm):
        for key in ("lr", "grad_norm"):
            assert g[key] == pytest.approx(w[key], rel=1e-6)
    # control: weight decay on every leaf, the 1-D "b" too
    _, cst, _ = _run_port(params, grads, cfg_kw, td,
                          ndims={k: 2 for k in SHAPES})
    assert not np.allclose(_np(cst["master"]["b"]),
                           np.asarray(jst["master"]["b"]), **f32)


def test_global_norm_matches_reference():
    t = _tree(5)
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in t.items()}))
    assert float(adamw.global_norm(_to_torch(t))) == pytest.approx(
        want, rel=1e-6)
    assert float(adamw.global_norm({"a": torch.tensor([3.0]),
                                    "b": torch.tensor([4.0])})) == 5.0


def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0, grad_clip=0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params, cfg)
    for _ in range(150):
        params, state, _ = adamw.apply_updates(params,
                                               {"w": 2 * params["w"]},
                                               state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_grad_clip_reports_the_raw_norm():
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                            total_steps=10)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params, cfg)
    _, _, metrics = adamw.apply_updates(params, {"w": torch.full((3,), 1e6)},
                                        state, cfg)
    assert float(metrics["grad_norm"]) > 1e5


def test_master_weights_carry_precision():
    """bf16 parameters, f32 master: updates below bf16's step at 256
    accumulate in the master; bf16 moments and an f64 model's widened
    state."""
    cfg = adamw.AdamWConfig(lr=1e-5, warmup_steps=0, total_steps=1000,
                            weight_decay=0.0, grad_clip=0)
    params = {"w": torch.full((1,), 256.0, dtype=torch.bfloat16)}
    state = adamw.init_state(params, cfg)
    for _ in range(20):
        params, state, _ = adamw.apply_updates(
            params, {"w": torch.ones((1,), dtype=torch.bfloat16)}, state,
            cfg)
    assert float(state["master"]["w"][0]) < 256.0
    assert float(params["w"][0]) == 256.0
    st = adamw.init_state({"w": torch.zeros(4, dtype=torch.bfloat16)},
                          adamw.AdamWConfig(moment_dtype="bfloat16"))
    assert st["m"]["w"].dtype == torch.bfloat16
    assert st["master"]["w"].dtype == torch.float32
    st = adamw.init_state({"w": torch.zeros(4, dtype=torch.float64)},
                          adamw.AdamWConfig())
    assert st["master"]["w"].dtype == st["m"]["w"].dtype == torch.float64


# ---------------------------------------------------------- compression

def _same(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (257,), (1000,),
                                   (7, 300), (4, 64, 3)])
def test_compress_bit_equal_to_reference(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.normal(size=shape) * 0.01).astype(np.float32)
    err = (rng.normal(size=shape) * 1e-4).astype(np.float32)
    for e in (None, err):
        jc, jerr = jcomp.compress(jnp.asarray(g),
                                  None if e is None else jnp.asarray(e))
        tc, terr = compression.compress(
            torch.from_numpy(g), None if e is None else torch.from_numpy(e))
        _same(tc.q, jc.q, "q")
        _same(tc.scales, jc.scales, "scales")
        _same(terr, jerr, "error")
        _same(compression.decompress(tc, shape),
              jcomp.decompress(jc, shape), "decompressed")
        assert compression.wire_bytes(tc) == jcomp.wire_bytes(jc)


def test_error_feedback_loop_bit_equal():
    """Twenty steps of compress -> decompress with the carried error, as
    the reference's own feedback test runs them."""
    g = np.full((256,), 1e-4, np.float32)
    g[0] += 1.0
    jerr = terr = None
    for _ in range(20):
        jc, jerr = jcomp.compress(jnp.asarray(g), jerr)
        tc, terr = compression.compress(torch.from_numpy(g), terr)
        _same(tc.q, jc.q, "q")
        _same(terr, jerr, "error")


def test_compress_tree_bit_equal():
    grads = _tree(9, scale=0.1)
    jc, je = jcomp.compress_tree({k: jnp.asarray(v)
                                  for k, v in grads.items()}, None)
    tc, te = compression.compress_tree(_to_torch(grads), None)
    assert set(tc) == set(jc) == set(te) == set(SHAPES)
    for k in SHAPES:
        _same(tc[k].q, jc[k].q, k)
        _same(tc[k].scales, jc[k].scales, k)
        _same(te[k], je[k], k)
    tc2, _ = compression.compress_tree(_to_torch(grads), te)
    jc2, _ = jcomp.compress_tree({k: jnp.asarray(v)
                                  for k, v in grads.items()}, je)
    for k in SHAPES:
        _same(tc2[k].q, jc2[k].q, k)


def test_rounding_is_half_to_even():
    """A block with max-abs 127 has scale 1, so x.5 values sit on exact
    halves: both packages round them to even; a control rounding half away
    from zero differs."""
    g = np.zeros(256, np.float32)
    g[0] = 127.0
    g[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5]
    jc, _ = jcomp.compress(jnp.asarray(g))
    tc, _ = compression.compress(torch.from_numpy(g))
    _same(tc.q, jc.q, "q")
    assert tc.q[1:9].tolist() == [0, 2, 2, 0, -2, -2, 4, 4]
    away = np.sign(g[1:9]) * np.floor(np.abs(g[1:9]) + 0.5)
    assert not np.array_equal(away, np.asarray(jc.q[1:9]))


# -------------------------------------------------------- scatter_add_grads

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scatter_add_grads_matches_reference(dtype):
    """(B 3, S 50) token ids, negative ones too, over a 40-row table of
    width 8: the embedding gradient's FAA batch."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-40, 40, (3, 50)).astype(np.int32)
    if dtype == np.int32:
        table = rng.integers(-5, 5, (40, 8)).astype(dtype)
        grads = rng.integers(-9, 9, (3, 50, 8)).astype(dtype)
    else:
        table = rng.normal(size=(40, 8)).astype(dtype)
        grads = rng.normal(size=(3, 50, 8)).astype(dtype)
    want = np.asarray(jscatter(jnp.asarray(table), jnp.asarray(ids),
                               jnp.asarray(grads)))
    got = scatter_add_grads(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(grads)).numpy()
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
