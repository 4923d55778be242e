"""Port parity: flash attention (`repro_torch.kernels.flash_attention`).

The same numpy inputs go through the JAX package and the port.  On the CPU
`kernel.flash_attention` runs its plain version, `flash_attention_plain`;
`ops.attention` is held against the reference's `ops.attention` (its Pallas
kernel in interpret mode, as tests/test_kernels_attention.py runs it) and
against both packages' `attention_ref`.  Tolerances are the reference
tests': rtol = atol = 3e-5 in f32 (sums in another order) and 2e-2 in bf16
(one bf16 rounding of the output, about 4e-3 relative, plus the inputs'
roundings).  The CUDA kernel is held against `flash_attention_plain` on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (B, Hq, Hkv, Sq, Skv, D, causal, bq, bk): tests/test_kernels_attention.py
CASES = [
    (2, 4, 2, 128, 128, 64, True, 64, 64),
    (1, 8, 1, 100, 100, 32, True, 64, 64),     # MQA + padding
    (2, 4, 4, 64, 192, 64, True, 64, 64),      # cached decode-style kv
    (1, 2, 2, 50, 70, 16, True, 32, 32),
    (1, 4, 2, 96, 96, 64, False, 32, 64),
    (1, 3, 3, 33, 47, 8, False, 32, 32),
    (1, 1, 1, 1, 64, 32, True, 32, 32),        # single-query decode
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: keep each of these tests on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _t(arrs, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


def _j(arrs, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrs)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bq,bk", CASES)
def test_attention_matches_reference_kernel(b, hq, hkv, sq, skv, d, causal,
                                            bq, bk):
    """The port's `ops.attention` (the kernel's function, unpadded along
    the sequence, D padded to 32) against the reference's padded Pallas
    kernel in interpret mode."""
    args = _qkv(hq * sq + d, b, hq, hkv, sq, skv, d)
    want = jops.attention(*_j(args), causal=causal, block_q=bq, block_k=bk)
    K.reset_launches()
    got = tops.attention(*_t(args), causal=causal)
    assert K.LAUNCHES == {"flash_attention": 0}    # a CPU tensor: no launch
    assert got.shape == (b, hq, sq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bq,bk", CASES)
def test_oracle_and_plain_version_match_reference_oracle(b, hq, hkv, sq, skv,
                                                         d, causal, bq, bk):
    args = _qkv(hq * sq + d, b, hq, hkv, sq, skv, d)
    want = np.asarray(jref.attention_ref(*_j(args), causal=causal))
    got = tref.attention_ref(*_t(args), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    plain = K.flash_attention_plain(*_t(args), causal=causal)
    np.testing.assert_allclose(plain.numpy(), want, **F32)
    ref_path = tops.attention(*_t(args), causal=causal, use_kernel=False)
    np.testing.assert_allclose(ref_path.numpy(), want, **F32)


def test_bf16_tolerance():
    args = _qkv(5, 1, 4, 2, 64, 64, 64)
    want = jops.attention(*_j(args, jnp.bfloat16), causal=True, block_q=32,
                          block_k=32)
    got = tops.attention(*_t(args, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
    oracle = jref.attention_ref(*_j(args, jnp.bfloat16), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), **BF16)


def test_scale_override():
    args = _qkv(6, 1, 2, 2, 32, 32, 16)
    want = jops.attention(*_j(args), causal=False, scale=0.5, block_q=32,
                          block_k=32)
    got = tops.attention(*_t(args), causal=False, scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        tref.attention_ref(*_t(args), causal=False, scale=0.5).numpy(),
        np.asarray(jref.attention_ref(*_j(args), causal=False, scale=0.5)),
        **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_cached_prefill_valid_prefix_and_offset(causal):
    """A prompt of 24 rows after 40 cached ones, in a 128-row cache: keys
    past kv_valid = 64 hold garbage (NaN), the diagonal sits at kv_offset =
    40.  Against the reference's Pallas kernel given the same kv_valid and
    kv_offset (interpret mode, Sq padded to its block), and against the
    oracle on the valid prefix, whose default diagonal is the same."""
    b, hq, hkv, sq, skv, d, valid, off = 2, 4, 1, 24, 128, 32, 64, 40
    q, k, v = _qkv(7, b, hq, hkv, sq, skv, d)
    k[:, :, valid:] = np.nan
    v[:, :, valid:] = np.nan
    got = K.flash_attention(*_t((q, k, v)), causal=causal, kv_valid=valid,
                            kv_offset=off)
    assert torch.isfinite(got).all()
    qp = np.pad(q, ((0, 0), (0, 0), (0, 32 - sq), (0, 0)))
    want = jk.flash_attention(*_j((qp, k, v)), causal=causal, block_q=32,
                              block_k=32, kv_valid=valid, kv_offset=off,
                              interpret=True)[:, :, :sq]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = jref.attention_ref(*_j((q, k[:, :, :valid], v[:, :, :valid])),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)
    via_ops = tops.flash(*_t((q, k, v)), causal=causal, scale=None,
                         kv_valid=valid, kv_offset=off)
    np.testing.assert_allclose(via_ops.numpy(), got.numpy(), rtol=0, atol=0)


def test_strided_views_give_the_contiguous_result():
    """The model hands the kernel transposed views of (B, S, H, D) tensors;
    the result is the one of contiguous copies."""
    q, k, v = _t(_qkv(8, 1, 4, 2, 40, 40, 64))
    qv, kv_, vv = (t.permute(0, 2, 1, 3).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    got = K.flash_attention(qv, kv_, vv, causal=True)
    want = K.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_shapes_are_checked_on_every_device():
    q, k, v = _t(_qkv(9, 1, 3, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        K.flash_attention(q, k, v)
    q, k, v = _t(_qkv(9, 1, 4, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="do not match"):
        K.flash_attention(q, k, v[..., :16])
    with pytest.raises(ValueError, match="kv_valid"):
        K.flash_attention(q, k, v, kv_valid=9)
    with pytest.raises(ValueError, match="kv_valid"):
        K.flash_attention(q, k, v, kv_valid=0)


# ---------------------------------------------------------------------------
# decode: the KV walk split across CTAs (`flash_attention_split_plain` is the
# kernel's algorithm), and the three-part bf16 p of the tensor-core prefill
# ---------------------------------------------------------------------------

def _decode_args(seed, b, hq, hkv, sq, skv, d, valid):
    """q of ``sq`` rows after ``valid - sq`` cached ones; the cache rows past
    ``valid`` hold NaN, which no version may read."""
    q, k, v = _qkv(seed, b, hq, hkv, sq, skv, d)
    k[:, :, valid:] = np.nan
    v[:, :, valid:] = np.nan
    return (q, k, v), dict(causal=True, kv_valid=valid,
                           kv_offset=valid - sq)


def _reference_kernel(q, k, v, kw):
    """The reference's Pallas kernel in interpret mode, Sq padded to its
    block of 32 rows.  It multiplies the rows past kv_valid in its last
    block of keys by p = 0, so it is given them as zeros, not NaN."""
    sq = q.shape[2]
    qp = np.pad(q, ((0, 0), (0, 0), (0, 32 - sq), (0, 0)))
    k, v = np.nan_to_num(k), np.nan_to_num(v)
    return np.asarray(jk.flash_attention(*_j((qp, k, v)), block_q=32,
                                         block_k=32, interpret=True,
                                         **kw))[:, :, :sq]


@pytest.mark.parametrize("kv_valid", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("splits", [1, 2, 7, "tiles"])
def test_split_plain_matches_plain_and_reference_kernel(splits, kv_valid):
    """A decode step (2 batches, 2 KV heads of 2 query heads) split into
    1, 2, 7 or one split per 64-key tile: against `flash_attention_plain`
    and the reference's kernel.  7 splits of at most 5 tiles leave splits
    that hold no key at all, which must weigh nothing."""
    (q, k, v), kw = _decode_args(kv_valid, 2, 4, 2, 1, 320, 32, kv_valid)
    if splits == "tiles":
        splits = -(-kv_valid // K.BN)
    got = K.flash_attention_split_plain(*_t((q, k, v)), splits=splits, **kw)
    assert torch.isfinite(got).all()
    plain = K.flash_attention_plain(*_t((q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), _reference_kernel(q, k, v, kw),
                               **F32)


@pytest.mark.parametrize("splits", [2, 3])
def test_split_plain_with_a_split_some_rows_cannot_see(splits):
    """Two positions of 8 query heads (16 rows, the most a decode call
    takes) after 127 cached rows: the walk is 129 keys, 3 tiles, and the
    last split holds key 128 only, which position 0 may not see: its
    partial for those rows is m = -1e30, l = 0."""
    (q, k, v), kw = _decode_args(9, 1, 8, 1, 2, 192, 64, 129)
    got = K.flash_attention_split_plain(*_t((q, k, v)), splits=splits, **kw)
    assert torch.isfinite(got).all()
    plain = K.flash_attention_plain(*_t((q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), _reference_kernel(q, k, v, kw),
                               **F32)


def test_split_plain_non_causal_and_bf16():
    """Without the causal mask, and in bf16 (inputs rounded, f32 inside,
    one rounding of the output)."""
    (q, k, v), kw = _decode_args(10, 1, 4, 1, 3, 256, 64, 200)
    kw["causal"] = False
    got = K.flash_attention_split_plain(*_t((q, k, v)), splits=3, **kw)
    want = jref.attention_ref(*_j((q, k[:, :, :200], v[:, :, :200])),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got16 = K.flash_attention_split_plain(
        *_t((q, k, v), torch.bfloat16), splits=3, **kw)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want),
                               **BF16)


@pytest.mark.parametrize("kv_end,groups,want", [
    (1600, 1, 25),       # gemma's decode at the served mix: 25 tiles
    (3600, 1, 57),       # and at its longest prompt: 57 tiles
    (4112, 1, 65),       # the whole cache: 65 tiles
    (64, 1, 1), (65, 1, 2), (1, 1, 1),
    (1600, 4, 25),       # 4 row groups of 25 still fit 132 SMs
    (4112, 16, 8),       # 16 row groups: 132 // 16 = 8 CTAs each
    (4112, 200, 1),      # more row groups than SMs: one CTA each
    (200 * 64, 1, 100),  # 200 tiles over at most 128 CTAs: 2 tiles each
])
def test_decode_splits(kv_end, groups, want):
    """A split per 64-key tile, no more CTAs than SMs (132 on the H100)
    over all row groups, at most 128 a group, and no split empty."""
    splits = K.decode_splits(kv_end, groups, 132, 128)
    assert splits == want
    tiles = -(-kv_end // K.BN)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles <= splits * per


def test_bf16_parts_sum_back_to_p_exactly():
    """The tensor-core prefill's split of f32 p: hi + mid + lo == p for
    random p in [0, 1] (and at 0, 1 and the smallest normal), each part a
    bf16; the three-part p·v agrees with the f32 p·v within f32 rounding,
    where p rounded to bf16 (SDPA's p) does not."""
    rng = np.random.default_rng(11)
    p = np.concatenate([rng.random(1 << 16), [0.0, 1.0, 2.0 ** -126]]
                       ).astype(np.float32)
    parts = K.bf16_parts(torch.from_numpy(p))
    assert all(t.dtype == torch.bfloat16 for t in parts)
    total = sum(t.double() for t in parts)
    np.testing.assert_array_equal(total.numpy(), p.astype(np.float64))

    pm = torch.from_numpy(rng.random((64, 64)).astype(np.float32))
    vm = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)
                          ).to(torch.bfloat16).float()
    exact = pm.double() @ vm.double()
    three = sum(t.float() @ vm for t in K.bf16_parts(pm))
    # f32 sums of 64 terms, three times over: a few f32 ulps of |p| @ |v|
    tol = 8 * 64 * 2.0 ** -24 * (pm.double().abs() @ vm.double().abs())
    assert ((three.double() - exact).abs() <= tol).all()
    assert ((pm @ vm).double() - exact).abs().le(tol).all()
    rounded = pm.to(torch.bfloat16).float() @ vm
    assert ((rounded.double() - exact).abs() > tol).any()


# the card's check that the bf16 prefill keeps p in f32: at most this share
# of its bf16 outputs may differ from the plain version's (f32 sums in
# another order flip a rounding now and then), while p rounded to bf16
# before p·v (SDPA's function) flips far more
P_F32_MISMATCH = 0.01


@pytest.mark.parametrize("s,cached", [(17, 0), (64, 200)])
def test_p_in_f32_check_tells_p_rounded_to_bf16_apart(s, cached):
    """The check chip_smoke.py and tests/test_torch_gpu.py apply to the
    tensor-core prefill, here on functions of the CPU: with gemma's heads
    (8 over 1 KV head of 256) and bf16 inputs, a function that keeps p in
    f32 and sums in another order (the split decode algorithm) differs from
    the reference's bf16 output on at most `P_F32_MISMATCH` of the outputs
    and within one bf16 ulp; p rounded to bf16 (the control) fails both."""
    n = cached + s
    args = _qkv(s + cached, 1, 8, 1, s, n, 256)
    q, k, v = _t(args, torch.bfloat16)
    want = torch.from_numpy(np.array(jref.attention_ref(
        *_j(args, jnp.bfloat16), causal=True).astype(jnp.float32)))
    kw = dict(causal=True, kv_valid=n, kv_offset=cached)
    f32_p = K.flash_attention_split_plain(q, k, v, splits=-(-n // K.BN),
                                          **kw).float()
    control = K.flash_attention_plain(q, k, v, p_to_bf16=True, **kw).float()
    ulp = dict(rtol=2.0 ** -7, atol=1e-5)
    assert (f32_p != want).float().mean() <= P_F32_MISMATCH
    assert torch.allclose(f32_p, want, **ulp)
    assert (control != want).float().mean() > P_F32_MISMATCH
    assert not torch.allclose(control, want, **ulp)


def test_kernel_bf16_parts_on_the_cpu_is_bf16_parts():
    p = torch.from_numpy(np.random.default_rng(3).random(101).astype(
        np.float32))
    for a, b in zip(K.kernel_bf16_parts(p), K.bf16_parts(p)):
        assert torch.equal(a, b)
