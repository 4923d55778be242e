"""The Mamba-2 mixer computed on a rank's "model" cut of its heads, on 2
gloo CPU ranks, against the reference's `mamba_forward` and its
`jax.vjp` on whole weights.

One world of 2 ranks on a ``("model",)`` mesh (module-scoped), rank side
`tests/_torch_mamba_tp_worker.py` (no JAX): each rank gets the reference
specs' contiguous blocks of ``in_proj`` (columns) and ``out_proj``
(rows), every other leaf whole, and computes on its heads
(`models.mamba`): ``in_proj``'s columns of its heads taken from the
all-gathered block, the conv on its x channels and every B and C
channel, the SSD on its heads, the gated norm's sum of squares summed
over "model", ``out_proj`` a row product.  The same numpy inputs, made
from a seed, go through the reference in this process.

Tolerance: relative L2 1e-5 in f32 on the output, dx and every leaf's
gradient reassembled from the ranks (`REL_TOL`).  The controls (the
columns at the contiguous block's offset; the norm over the rank's slice
alone) must be off by more than 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mamba_tp_worker as W
from repro.configs import get_reduced as jget_reduced
from repro.models.mamba import mamba_forward
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import ranks
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.launch.shardings import (ModelCut, arch_rules, model_cuts,
                                          params_shardings)
from repro_torch.models.mamba import head_columns
from repro_torch.models.model import LM

REL_TOL = 1e-5
#: (arch, batch, seq): 24 and 40 positions over chunks of 16, both padded
CASES = (("mamba2_780m", 2, 24), ("jamba_1_5_large_398b", 1, 40))


def _inputs(arch, b, s, seed):
    """Seeded numpy weights (every leaf away from its initial value), x
    and the output's cotangent for one mixer of reduced ``arch``."""
    cfg = get_reduced(arch)
    sc = cfg.ssm
    d, di = cfg.d_model, sc.d_inner(cfg.d_model)
    g, n, h = sc.n_groups, sc.d_state, sc.n_heads(cfg.d_model)
    rng = np.random.default_rng(seed)
    nrm = lambda *shape: rng.normal(size=shape).astype(np.float32)
    params = {"in_proj": nrm(d, 2 * di + 2 * g * n + h) * d ** -0.5,
              "conv_w": nrm(sc.conv_kernel, di + 2 * g * n) * 0.2,
              "conv_b": nrm(di + 2 * g * n) * 0.3,
              "A_log": nrm(h) * 0.3, "D": 1 + nrm(h) * 0.3,
              "dt_bias": nrm(h) * 0.3, "norm_w": 1 + nrm(di) * 0.3,
              "out_proj": nrm(di, d) * di ** -0.5}
    return dict(arch=arch, params=params, x=nrm(b, s, d), ct=nrm(b, s, d))


def _reference(c):
    """The reference's output, dx and every leaf's gradient: `jax.vjp`
    of `mamba_forward` on whole weights."""
    cfg = jget_reduced(c["arch"]).replace(dtype="float32")
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    y, back = jax.vjp(lambda p, x: mamba_forward(p, x, cfg)[0], params,
                      jnp.asarray(c["x"]))
    gp, gx = back(jnp.asarray(c["ct"]))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}


@pytest.fixture(scope="module")
def run():
    cases = [_inputs(arch, b, s, 60 + k)
             for k, (arch, b, s) in enumerate(CASES)]
    out = ranks.launch(f"{W.__file__}:run", 2, mesh=((2,), ("model",)),
                       device="cpu", args=(cases,), timeout=300)
    return cases, out, [_reference(c) for c in cases]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _errors(got, want):
    """{what: relative L2} of the output, dx and every leaf's gradient."""
    errs = {k: _rel(got[k], want[k]) for k in ("y", "dx")}
    errs.update({n: _rel(got["grads"][n], want["grads"][n])
                 for n in W.LEAVES})
    return errs


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[f"{a}-{b}x{s}" for a, b, s in CASES])
def test_cut_mixer_matches_reference_vjp(run, k):
    """On each rank: the output and dx against `mamba_forward`'s, every
    leaf's gradient (the blocks' gathered, the whole leaves' summed over
    "model") against `jax.vjp`'s, within relative L2 1e-5."""
    _, out, ref = run
    for o in out:
        errs = _errors(o["cases"][k], ref[k])
        assert max(errs.values()) <= REL_TOL, errs


@pytest.mark.parametrize("control", W.CONTROLS)
def test_controls_fail_the_check(run, control):
    """``in_proj``'s columns taken at the rank's contiguous block's
    offset, not its heads', and the gated norm without the all-reduce:
    each is off the reference's output by more than 1e-3."""
    _, out, ref = run
    errs = _errors(out[0]["controls"][control], ref[0])
    assert errs["y"] > 1e-3, errs


def test_ranks_import_no_jax(run):
    """The ranks ran the port alone: no module of jax or of the
    reference was imported."""
    _, out, _ = run
    assert all(o["modules"] == [] for o in out)


def _ssm_modes(arch, shape):
    cfg = get_reduced(arch) if shape == (2, 2) else get_config(arch)
    mesh = RecordingMesh(shape, ("data", "model"))
    model = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(model.named_parameters()), mesh,
                             arch_rules(cfg, mesh, "train"))
    cuts = model_cuts(cfg, specs, mesh)
    return specs, {n: c for n, c in cuts.items() if ".ssm." in n}


@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b"])
def test_model_cuts_mark_mamba_leaves(arch, shape):
    """Every Mamba mixer of the reduced config on 2x2 and the full one on
    (16, 16): ``out_proj`` cut on its rows and ``in_proj`` on its
    columns, each where its spec puts "model"; the leaves whose specs keep
    them whole partial."""
    specs, cuts = _ssm_modes(arch, shape)
    assert cuts
    for name, c in cuts.items():
        key = name.rpartition(".")[2]
        if key in ("in_proj", "out_proj"):
            assert c == ModelCut(1 if key == "in_proj" else 0, "cut"), name
            assert specs[name][c.dim] == "model", name
        else:
            assert c == ModelCut(None, "partial"), name
            assert "model" not in str(specs[name]), name


@pytest.mark.parametrize("parts", [2, 4])
def test_head_columns_cover_in_proj(parts):
    """Over the ranks, `head_columns` takes each column of z, x and dt
    once and every column of B and C on every rank; each rank's columns
    come in the order z, x, B and C, dt."""
    cfg = get_reduced("mamba2_780m")
    sc = cfg.ssm
    di, gn = sc.d_inner(cfg.d_model), sc.n_groups * sc.d_state
    h = sc.n_heads(cfg.d_model)
    cols = [head_columns(cfg, parts, r).tolist() for r in range(parts)]
    bc = list(range(2 * di, 2 * di + 2 * gn))
    own = sorted(c for rank in cols for c in rank if c not in bc)
    assert own == [c for c in range(2 * di + 2 * gn + h) if c not in bc]
    for r, rank in enumerate(cols):
        dr, hr = di // parts, h // parts
        assert rank == (list(range(r * dr, (r + 1) * dr))
                        + list(range(di + r * dr, di + (r + 1) * dr)) + bc
                        + list(range(2 * di + 2 * gn + r * hr,
                                     2 * di + 2 * gn + (r + 1) * hr)))


def test_chunked_ssd_gradient_finite_where_the_reference_overflows():
    """At a chunk of 256 and dt near softplus(0) (the configs' initial
    dt_bias), the decays above a chunk's diagonal overflow f32: the
    reference's `ssd_chunked_jnp` takes the exponent before its mask, so
    its gradient for dt and A is NaN there, while `ops.ssd_chunked` masks
    first.  The port's output stays within relative L2 1e-5 of the
    reference's, every gradient is finite, and those the overflow does
    not reach (x, B, C) agree with the reference's within 1e-5."""
    import torch
    from repro.kernels.ssd.ops import ssd_chunked_jnp
    from repro_torch.kernels.ssd.ops import ssd_chunked
    rng = np.random.default_rng(70)
    b, s, h, p, n = 1, 256, 2, 8, 8
    nrm = lambda *shape: rng.normal(size=shape).astype(np.float32)
    args = (nrm(b, s, h, p), np.log1p(np.exp(nrm(b, s, h))),
            -np.ones(h, np.float32), nrm(b, s, h, n), nrm(b, s, h, n))
    ct = nrm(b, s, h, p)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ssd_chunked(*ts, chunk=256)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(ct))
    want, back = jax.vjp(lambda *a: ssd_chunked_jnp(*a, chunk=256),
                         *map(jnp.asarray, args))
    ref = [np.asarray(g) for g in back(jnp.asarray(ct))]
    assert _rel(y.detach().numpy(), want) <= REL_TOL
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not np.isfinite(ref[1]).all() and not np.isfinite(ref[2]).all()
    for k in (0, 3, 4):
        assert _rel(grads[k].numpy(), ref[k]) <= REL_TOL, k
