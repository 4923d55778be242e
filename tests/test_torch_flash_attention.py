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
