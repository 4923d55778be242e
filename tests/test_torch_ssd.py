"""Port parity: the Mamba-2 SSD (`repro_torch.kernels.ssd`).

The same numpy inputs go through the JAX package and the port.  On the CPU
`ssd_chunk` runs its plain version, held here against the Pallas kernel in
interpret mode; `ops.ssd` (kernel composition) and `ops.ssd_chunked` (head
axis explicit) against their JAX counterparts and the sequential oracle.
Tolerance: the reference tests' rtol = atol = 3e-4
(tests/test_kernels_ssd.py:32) for f32 chunked results, whose sums run in
another order than the oracle's recurrence.  The CUDA kernel is held
against `ssd_chunk_plain` on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jk
from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import ref as tref

TOL = dict(rtol=3e-4, atol=3e-4)
# (b, s, h, p, n, chunk): the reference's SWEEP (tests/test_kernels_ssd.py)
SWEEP = [(2, 64, 3, 16, 8, 16), (1, 100, 2, 8, 4, 32), (1, 32, 1, 4, 4, 32),
         (2, 48, 4, 8, 16, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: keep each of these tests on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, s, h, p, n):
    """The reference tests' distributions: dt in [0.01, 0.2], A in
    -[0.5, 2], x/B/C standard normal; f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            rng.uniform(0.01, 0.2, size=(b, s, h)).astype(f),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(f),
            rng.normal(size=(b, s, h, n)).astype(f),
            rng.normal(size=(b, s, h, n)).astype(f))


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args):
    return tuple(torch.from_numpy(a) for a in args)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_ssd_chunk_plain_matches_pallas_interpret(b, s, h, p, n, chunk):
    sp = -(-s // chunk) * chunk               # the kernel takes S % Q == 0
    rng = np.random.default_rng(s + chunk)
    f = np.float32
    xdt = (rng.normal(size=(b * h, sp, p))
           * rng.uniform(0.01, 0.2, size=(b * h, sp, 1))).astype(f)
    adt = (-rng.uniform(0.005, 0.4, size=(b * h, sp))).astype(f)
    B = rng.normal(size=(b * h, sp, n)).astype(f)
    C = rng.normal(size=(b * h, sp, n)).astype(f)
    want_y, want_st = jk.ssd_chunk(*_j((xdt, adt, B, C)), chunk=chunk,
                                   interpret=True)
    for fn in (K.ssd_chunk, K.ssd_chunk_plain):
        y, st = fn(*_t((xdt, adt, B, C)), chunk=chunk)
        assert y.shape == (b * h, sp, p) and y.dtype == torch.float32
        assert st.shape == (b * h, sp // chunk, n, p)
        _close(y, want_y, f"{fn.__name__} y_intra")
        _close(st, want_st, f"{fn.__name__} states")


# (BH, heads_per_group, S, P, N, chunk): groups of heads sharing B and C
GROUPED = [(6, 3, 64, 16, 8, 16), (8, 4, 96, 8, 16, 32), (4, 2, 48, 8, 4, 8),
           (3, 1, 32, 4, 4, 32)]


@pytest.mark.parametrize("bh,hpg,s,p,n,chunk", GROUPED)
def test_grouped_ssd_chunk_matches_pallas_on_repeated_groups(bh, hpg, s, p,
                                                             n, chunk):
    """`ssd_chunk` on B and C per group (head i reads group i // hpg)
    against the Pallas kernel in interpret mode fed B and C repeated to
    every head (`jnp.repeat`): the reference's interface."""
    rng = np.random.default_rng(bh * s + hpg)
    f = np.float32
    xdt = (rng.normal(size=(bh, s, p))
           * rng.uniform(0.01, 0.2, size=(bh, s, 1))).astype(f)
    adt = (-rng.uniform(0.005, 0.4, size=(bh, s))).astype(f)
    B = rng.normal(size=(bh // hpg, s, n)).astype(f)
    C = rng.normal(size=(bh // hpg, s, n)).astype(f)
    want_y, want_st = jk.ssd_chunk(
        jnp.asarray(xdt), jnp.asarray(adt), jnp.repeat(jnp.asarray(B), hpg, 0),
        jnp.repeat(jnp.asarray(C), hpg, 0), chunk=chunk, interpret=True)
    for fn in (K.ssd_chunk, K.ssd_chunk_plain):
        y, st = fn(*_t((xdt, adt, B, C)), chunk=chunk, heads_per_group=hpg)
        assert y.shape == (bh, s, p) and st.shape == (bh, s // chunk, n, p)
        _close(y, want_y, f"{fn.__name__} y_intra")
        _close(st, want_st, f"{fn.__name__} states")


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssd_takes_groups_of_heads(g, use_kernel):
    """`ops.ssd` (the kernel composition, its plain version on the CPU) and
    `ops.ssd_chunked` with B and C on G groups of H = 4 heads, against
    `ssd_chunked_jnp` on B and C repeated to the heads, final state too;
    37 steps pad to 40."""
    b, s, h, p, n, chunk = 2, 37, 4, 8, 16, 8
    x, dt, A, B4, C4 = _inputs(g * 11, b, s, h, p, n)
    B, C = B4[:, :, :g], C4[:, :, :g]
    rep = (x, dt, A, np.repeat(B, h // g, 2), np.repeat(C, h // g, 2))
    y_want, h_want = jops.ssd_chunked_jnp(*_j(rep), chunk=chunk,
                                          return_final_state=True)
    fn = (lambda *a, **k: tops.ssd(*a, use_kernel=use_kernel, **k))
    K.reset_launches()
    for f in (fn, tops.ssd_chunked):
        y, hf = f(*_t((x, dt, A, B, C)), chunk=chunk,
                  return_final_state=True)
        assert y.shape == (b, s, h, p) and hf.shape == (b, h, n, p)
        _close(y, y_want, "y")
        _close(hf, h_want, "h_final")
    assert K.LAUNCHES == {"ssd_chunk": 0}
    with pytest.raises(ValueError, match="divides H"):
        tops.ssd(*_t((x, dt, A, B4[:, :, :3], C4[:, :, :3])), chunk=chunk)


def _split_tf32(a):
    """The kernel's operand split: a = hi + lo, both TF32 (`cvt.rna`)."""
    hi = K.tf32_round(a)
    return hi, K.tf32_round(a - hi)


def _mm3(a, b):
    """a @ b as the kernel forms it on TF32 tensor cores: lo·hi, hi·lo, then
    hi·hi into one f32 sum (each TF32 product is exact in f32)."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _chunk(xdt, adt, B, C, chunk, mm=_mm3):
    """`ssd_chunk_plain`'s function with its three products formed by
    ``mm``: by default split as the kernel splits them."""
    bh, s, p = xdt.shape
    n, nc = B.shape[-1], s // chunk
    x = xdt.reshape(bh, nc, chunk, p)
    Bc, Cc = B.reshape(bh, nc, chunk, n), C.reshape(bh, nc, chunk, n)
    l = torch.cumsum(adt.reshape(bh, nc, chunk), dim=-1)
    m = torch.where(torch.ones((chunk, chunk), dtype=torch.bool).tril(),
                    torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    y = mm(mm(Cc, Bc.transpose(-1, -2)) * m, x)
    states = mm(Bc.transpose(-1, -2),
                x * torch.exp(l[..., -1:] - l)[..., None])
    return y.reshape(bh, s, p), states


def test_split_tf32_products_hold_the_f32_tolerance():
    """The kernel's arithmetic mirrored in plain torch at mamba2_780m's
    widths (P 64, N 128) and the reference tests' distributions: three
    TF32 products per f32 product stay within 3e-4 of the f64 function,
    and one TF32 pass (`tf32_operands=True`, the control) is measurably
    worse."""
    bh, s, chunk = 2, 256, 128
    rng = np.random.default_rng(12)
    f = np.float32
    xdt = (rng.normal(size=(bh, s, 64))
           * rng.uniform(0.01, 0.2, size=(bh, s, 1))).astype(f)
    adt = (-rng.uniform(0.005, 0.4, size=(bh, s))).astype(f)
    B = rng.normal(size=(bh, s, 128)).astype(f)
    C = rng.normal(size=(bh, s, 128)).astype(f)
    args = _t((xdt, adt, B, C))
    truth = _chunk(*(t.double() for t in args), chunk, mm=torch.matmul)
    split = _chunk(*args, chunk)
    one_pass = K.ssd_chunk_plain(*args, chunk=chunk, tf32_operands=True)
    errs = {}
    for name, got in (("3xtf32", split), ("1xtf32", one_pass),
                      ("f32", K.ssd_chunk_plain(*args, chunk=chunk))):
        errs[name] = max(float((g.double() - w).abs().max())
                         for g, w in zip(got, truth))
    for g, w in zip(split, truth):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert errs["1xtf32"] > 10 * max(errs["3xtf32"], errs["f32"]), errs


def test_tf32_round_is_round_to_nearest_on_13_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3])
    got = K.tf32_round(x)
    assert got.tolist()[:4] == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                -(1.0 + 2.0 ** -10), 1.0]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[4]) / 3.0e-3 - 1) <= 2.0 ** -11


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_ssd_matches_reference_ssd_and_oracle(b, s, h, p, n, chunk):
    """The kernel composition (padding, flattening, cross-chunk recurrence)
    against JAX `ssd(use_kernel=True)` and the sequential oracle, and the
    plain chunked path against `ssd_chunked_jnp`."""
    args = _inputs(s * 7 + h, b, s, h, p, n)
    want = jops.ssd(*_j(args), chunk=chunk, use_kernel=True)
    oracle = jref.ssd_ref(*_j(args))
    got = tops.ssd(*_t(args), chunk=chunk, use_kernel=True)
    assert got.shape == (b, s, h, p)
    _close(got, want, "ssd vs ssd(use_kernel=True)")
    _close(got, oracle, "ssd vs ssd_ref")
    chunked = tops.ssd_chunked(*_t(args), chunk=chunk)
    _close(chunked, jops.ssd_chunked_jnp(*_j(args), chunk=chunk),
           "ssd_chunked vs ssd_chunked_jnp")
    _close(tref.ssd_ref(*_t(args)), oracle, "ssd_ref")


@pytest.mark.parametrize("s,chunk", [(40, 8), (37, 16)])
def test_final_state_matches_reference(s, chunk):
    """return_final_state through both paths (37 pads by 11 steps of dt = 0)
    against the JAX kernel path's final state."""
    args = _inputs(s, 1, s, 2, 8, 4)
    y_want, h_want = jops.ssd(*_j(args), chunk=chunk, use_kernel=True,
                              return_final_state=True)
    for use_kernel in (True, False):
        y, hf = tops.ssd(*_t(args), chunk=chunk, use_kernel=use_kernel,
                         return_final_state=True)
        assert hf.shape == (1, 2, 4, 8) and hf.dtype == torch.float32
        _close(y, y_want, f"y use_kernel={use_kernel}")
        _close(hf, h_want, f"h_final use_kernel={use_kernel}")


def test_decode_step_continues_the_prefix():
    """ssd_decode_step against the reference's, and prefix state + one
    decode step against the oracle over the longer sequence."""
    x, dt, A, B, C = _inputs(5, 1, 41, 2, 8, 4)
    pre = [a[:, :40] if a.ndim > 1 else a for a in (x, dt, A, B, C)]
    _, h_pre = tops.ssd(*_t(pre), chunk=8, return_final_state=True)
    last = (x[:, 40], dt[:, 40], A, B[:, 40], C[:, 40])
    h_step, y_last = tops.ssd_decode_step(h_pre, *_t(last))
    jh, jy = jops.ssd_decode_step(jnp.asarray(h_pre.numpy()), *_j(last))
    _close(h_step, jh, "decode state")
    _close(y_last, jy, "decode y")
    y_full = jref.ssd_ref(*_j((x, dt, A, B, C)))
    np.testing.assert_allclose(y_last.numpy(), np.asarray(y_full[:, -1]),
                               rtol=1e-3, atol=1e-4)


def test_dt_zero_is_identity_step():
    """dt = 0 => exp(0) h + 0: the state is unchanged (padding)."""
    x, dt, A, B, C = _inputs(9, 1, 16, 2, 8, 4)
    h0 = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 2, 4, 8)).astype(np.float32))
    h1, _ = tops.ssd_decode_step(h0, *_t((x[:, 0], np.zeros_like(dt[:, 0]),
                                          A, B[:, 0], C[:, 0])))
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-6)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    K.reset_launches()
    args = _inputs(3, 1, 64, 2, 64, 32)
    tops.ssd(*_t(args), chunk=64)
    tops.ssd(*_t(args), chunk=64, use_kernel=True)
    assert K.LAUNCHES == {"ssd_chunk": 0}


@pytest.mark.parametrize("p,n,chunk", [(16, 32, 64), (64, 48, 64),
                                       (64, 32, 96), (64, 160, 64),
                                       (64, 32, 320)])
def test_kernel_shape_check_refuses_what_the_kernel_cannot_take(p, n, chunk):
    """The CUDA path validates before it launches: P == 64, N % 32 == 0 up
    to 128, chunk % 64 == 0 up to 256 (checked here on host tensors, which
    never launch)."""
    bh, s = 2, 192
    z = torch.zeros
    with pytest.raises(ValueError, match="ssd_chunk kernel takes"):
        K._check(z((bh, s, p)), z((bh, s)), z((bh, s, n)), z((bh, s, n)),
                 chunk)
    K._check(z((bh, s, 64)), z((bh, s)), z((bh, s, 128)), z((bh, s, 128)),
             64)
    K._check(z((bh, s, 64)), z((bh, s)), z((1, s, 128)), z((1, s, 128)),
             128, heads_per_group=2)


@pytest.mark.parametrize("hpg,groups", [(3, 1), (2, 1), (0, 1)])
def test_kernel_check_refuses_groups_that_do_not_match(hpg, groups):
    """B and C must hold BH / heads_per_group groups, heads_per_group >= 1
    dividing BH."""
    bh, s, z = 4, 128, torch.zeros
    with pytest.raises(ValueError, match="heads_per_group|shape"):
        K._check(z((bh, s, 64)), z((bh, s)), z((groups, s, 128)),
                 z((groups, s, 128)), 64, heads_per_group=hpg)
