"""The port's CUDA kernels on the card (every test here needs a CUDA card).

Each kernel is held against its plain PyTorch version on the same device
tensors; BFS on the kernels against BFS on the plain sort backend; the SSD
kernel's composition and a full-width two-layer mamba2_780m prefill against
the plain SSD path; the flash-attention kernel (f32 at rtol = atol = 3e-5,
bf16 at 2e-2, as the reference's attention tests, and at one bf16 ulp at
gemma_2b's shapes; decode split across CTAs, prefill on tensor cores) and
a full-width two-layer gemma_2b prefill and decode against the plain
attention path.
This file imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_gpu.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from _torch_gpu import cuda_device  # noqa: F401
from repro_torch import atomics
from repro_torch.configs import get_config
from repro_torch.core import bfs as tbfs
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rmw import kernel as K
from repro_torch.kernels.rmw import ref as tref
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models.model import LM

OPS = ["faa", "swp", "min", "max", "cas"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", OPS)
def test_kernels_match_plain_versions(cuda_device, op, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for n, m in ((1 << 16, 1 << 16), (1 << 16, 64), (3000, 700), (1, 5)):
        idx = torch.randint(0, m + 7, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        tab = torch.randint(-8, 9, (m,), generator=g,
                            device=cuda_device).to(dtype)
        val = torch.randint(-8, 9, (n,), generator=g,
                            device=cuda_device).to(dtype)
        exp = 0 if op == "cas" else None
        got = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
        want = K.rmw_table_fetched_plain(tab, idx, val, op, exp)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if op != "cas":
            assert torch.equal(K.rmw_table(tab, idx, val, op),
                               tref.rmw_table_ref(tab, idx, val, op))
        assert torch.equal(K.slot_counts(idx, m), K.slot_counts_plain(idx, m))


@pytest.mark.gpu
def test_wrappers_count_launches_and_leave_inputs_unchanged(cuda_device):
    tab = torch.arange(10, dtype=torch.int32, device=cuda_device)
    idx = torch.tensor([1, 1, 3], dtype=torch.int32, device=cuda_device)
    before = tab.clone()
    K.reset_launches()
    K.rmw_table(tab, idx, idx, "swp")
    K.rmw_table_fetched(tab, idx, idx, "faa")
    K.slot_counts(idx, 10)
    assert K.LAUNCHES == {"rmw_table": 1, "rmw_table_fetched": 1,
                          "slot_counts": 1}
    assert torch.equal(tab, before)


@pytest.mark.gpu
def test_execute_auto_runs_the_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    idx = torch.randint(0, 5000, (1 << 15,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    val = torch.randint(-3, 4, (1 << 15,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    table = atomics.make_table(4096, torch.int32)
    K.reset_launches()
    got = atomics.execute(table, atomics.Faa(idx, val), collect_stats=True)
    want = atomics.execute(table, atomics.Faa(idx, val), backend="sort")
    assert K.LAUNCHES["rmw_table_fetched"] == 1
    assert K.LAUNCHES["slot_counts"] == 1
    assert torch.equal(got.table.data, want.table.data)
    live = idx < 4096
    assert torch.equal(got.fetched[live], want.fetched[live])


@pytest.mark.gpu
def test_bfs_on_the_card_matches_plain_path(cuda_device):
    src, dst = tbfs.kronecker_graph(12, 16, seed=0)
    s, d = np.concatenate([src, dst]), np.concatenate([dst, src])
    root = int(s[0])
    for op in ("cas", "swp", "faa"):
        K.reset_launches()
        got = tbfs.bfs(s, d, 1 << 12, root=root, op=op, device=cuda_device)
        assert sum(K.LAUNCHES.values()) > 0
        want = tbfs.bfs(s, d, 1 << 12, root=root, op=op, backend="sort",
                        device=cuda_device)
        assert torch.equal(got.parent, want.parent)
        assert tbfs.validate_parents(s, d, got.parent, root)


# the reference tests' tolerance for f32 SSD results summed in another
# order (tests/test_kernels_ssd.py:32)
SSD_TOL = dict(rtol=3e-4, atol=3e-4)


def _ssd_chunk_inputs(g, dev, bh, s, n):
    xdt = torch.randn((bh, s, 64), generator=g, device=dev) * (
        torch.rand((bh, s, 1), generator=g, device=dev) * 0.19 + 0.01)
    adt = -(torch.rand((bh, s), generator=g, device=dev) * 0.395 + 0.005)
    B = torch.randn((bh, s, n), generator=g, device=dev)
    C = torch.randn((bh, s, n), generator=g, device=dev)
    return xdt, adt, B, C


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,n,chunk", [(3, 256, 128, 256),
                                          (5, 512, 32, 64),
                                          (2, 768, 64, 128),
                                          (1, 1024, 128, 256)])
def test_ssd_chunk_matches_plain_version(cuda_device, bh, s, n, chunk):
    g = torch.Generator(device=cuda_device).manual_seed(bh * s + n)
    args = _ssd_chunk_inputs(g, cuda_device, bh, s, n)
    SK.reset_launches()
    y, st = SK.ssd_chunk(*args, chunk=chunk)
    assert SK.LAUNCHES == {"ssd_chunk": 1}
    y_p, st_p = SK.ssd_chunk_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert st.shape == (bh, s // chunk, n, 64)
    torch.testing.assert_close(y, y_p, **SSD_TOL)
    torch.testing.assert_close(st, st_p, **SSD_TOL)


@pytest.mark.gpu
def test_ssd_composition_on_the_card_matches_plain_path(cuda_device):
    """`ops.ssd` picks the kernel on CUDA tensors by default; 300 steps pad
    to two chunks of 256."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, h = 2, 300, 4
    x = torch.randn((b, s, h, 64), generator=g, device=cuda_device)
    dt = torch.rand((b, s, h), generator=g, device=cuda_device) * 0.19 + 0.01
    A = -(torch.rand((h,), generator=g, device=cuda_device) * 1.5 + 0.5)
    B = torch.randn((b, s, h, 128), generator=g, device=cuda_device)
    C = torch.randn((b, s, h, 128), generator=g, device=cuda_device)
    SK.reset_launches()
    y, hf = sops.ssd(x, dt, A, B, C, chunk=256, return_final_state=True)
    assert SK.LAUNCHES == {"ssd_chunk": 1}
    y_p, hf_p = sops.ssd_chunked(x, dt, A, B, C, chunk=256,
                                 return_final_state=True)
    torch.testing.assert_close(y, y_p, **SSD_TOL)
    torch.testing.assert_close(hf, hf_p, **SSD_TOL)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_cannot_take(cuda_device):
    z = torch.zeros
    dev = cuda_device
    with pytest.raises(ValueError, match="kernel takes"):
        SK.ssd_chunk(z((2, 64, 16), device=dev), z((2, 64), device=dev),
                     z((2, 64, 32), device=dev), z((2, 64, 32), device=dev),
                     chunk=64)
    with pytest.raises(TypeError):
        SK.ssd_chunk(*(t.double() for t in _ssd_chunk_inputs(
            torch.Generator(device=dev).manual_seed(0), dev, 1, 64, 32)),
            chunk=64)


@pytest.mark.gpu
def test_full_width_prefill_on_the_kernel_matches_plain_path(cuda_device):
    """mamba2_780m at full width, cut to two layers, bf16: prefill logits of
    a 300-token prompt through the kernel and through the plain SSD path
    agree within 0.05.  Two layers leave bf16 rounding flips little room
    to grow; chip_smoke.py measures the 48-layer floor."""
    cfg = get_config("mamba2_780m").replace(n_layers=2)
    model = LM(cfg, device=cuda_device, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(0))
    SK.reset_launches()
    _, logits = model.prefill({"tokens": toks}, 512)
    assert SK.LAUNCHES == {"ssd_chunk": 2}
    model.use_kernel = False
    _, plain = model.prefill({"tokens": toks}, 512)
    assert torch.isfinite(logits).all()
    assert (logits - plain).abs().max() <= 0.05


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FA_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
          torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qkv(dev, b, hq, hkv, sq, skv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (2, 4, 2, 128, 128, 64, True),       # GQA
    (1, 8, 1, 100, 100, 32, True),       # MQA, ragged tiles
    (2, 4, 4, 64, 192, 64, True),        # kv longer than q: offset 128
    (1, 4, 2, 96, 96, 64, False),
    (1, 8, 1, 1, 300, 256, True),        # decode, gemma's heads
    (1, 1, 1, 1, 64, 32, True),          # single-query decode
    (2, 8, 2, 77, 77, 128, True),        # phi3 / command-r head width
    (1, 4, 1, 70, 90, 160, False),       # stablelm head width
    (1, 8, 1, 200, 200, 256, True),      # gemma head width
])
def test_flash_attention_matches_plain_version(cuda_device, b, hq, hkv, sq,
                                               skv, d, causal, dtype):
    q, k, v = _qkv(cuda_device, b, hq, hkv, sq, skv, d, dtype, seed=sq + d)
    FK.reset_launches()
    got = FK.flash_attention(q, k, v, causal=causal)
    assert FK.LAUNCHES == {"flash_attention": 1}
    want = FK.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_valid_prefix_offset_and_strides(cuda_device, dtype):
    """A cached prefill as the model makes it: q (B, S, H, D) and a
    (B, S_max, Hkv, D) cache handed over as transposed views, 40 new rows
    after 60 cached ones in a 160-row cache whose unwritten rows hold NaN."""
    b, hq, hkv, d, cached, s, s_max = 2, 8, 2, 128, 60, 40, 160
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((b, s, hq, d), generator=g, device=cuda_device).to(dtype)
    kc, vc = (torch.randn((b, s_max, hkv, d), generator=g,
                          device=cuda_device).to(dtype) for _ in range(2))
    kc[:, cached + s:] = float("nan")
    vc[:, cached + s:] = float("nan")
    args = (q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2))
    kw = dict(causal=True, kv_valid=cached + s, kv_offset=cached)
    got = FK.flash_attention(*args, **kw)
    want = FK.flash_attention_plain(*args, **kw)
    assert got.transpose(1, 2).is_contiguous()       # laid out as q is
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


# gemma_2b's attention: 8 query heads over one KV head of 256, caches of
# 4,096 + 16 rows.  At these shapes bf16 is held to one bf16 ulp (rtol 2^-7,
# atol 1e-5): the outputs average up to 4,096 keys and are small, where
# 2e-2 would let a dropped tile pass.
GEMMA_BF16 = dict(rtol=2.0 ** -7, atol=1e-5)
G_S_MAX = 4096 + 16


def _gemma_call(dev, s, cached, dtype, seed=0, b=1, hq=8, hkv=1, d=256,
                s_max=G_S_MAX):
    """q (B, s, Hq, D) and a (B, s_max, Hkv, D) cache as the model hands
    them over (transposed views), ``cached`` rows before the ``s`` new ones;
    the rows past them hold NaN."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device=dev)
    kc, vc = (torch.randn((b, s_max, hkv, d), generator=g, device=dev)
              for _ in range(2))
    kc[:, cached + s:] = float("nan")
    vc[:, cached + s:] = float("nan")
    args = tuple(t.to(dtype).transpose(1, 2) for t in (q, kc, vc))
    return args, dict(causal=True, kv_valid=cached + s, kv_offset=cached)


def _gemma_tol(dtype):
    return GEMMA_BF16 if dtype == torch.bfloat16 else FA_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_valid", [1, 63, 64, 65, 1600, 4112])
def test_flash_attention_decode_splits_match_plain_version(cuda_device,
                                                           kv_valid, dtype):
    """A gemma decode step over ``kv_valid`` cached rows (NaN past them):
    the KV walk split across CTAs and combined in split order, in one
    launch, against the plain version; the same bits on a second call."""
    args, kw = _gemma_call(cuda_device, 1, kv_valid - 1, dtype,
                           seed=kv_valid)
    FK.reset_launches()
    got = FK.flash_attention(*args, **kw)
    assert FK.LAUNCHES == {"flash_attention": 1}
    want = FK.flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **_gemma_tol(dtype))
    assert torch.equal(FK.flash_attention(*args, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,cached,d", [
    (2, 8, 2, 1, 300, 128),      # B 2, Hkv 2: four row groups of 4 rows
    (1, 8, 1, 2, 127, 256),      # 16 rows in 2 splits; the second holds
                                 # only key 128, which position 0 cannot see
    (2, 4, 2, 3, 1000, 64),      # 6 rows over 16 tiles
])
def test_flash_attention_decode_groups_match_plain_version(
        cuda_device, b, hq, hkv, s, cached, d, dtype):
    """Decode calls of several row groups, and of more than one position,
    where a split can hold no key that some of its rows may see."""
    args, kw = _gemma_call(cuda_device, s, cached, dtype, seed=cached, b=b,
                           hq=hq, hkv=hkv, d=d, s_max=cached + s + 40)
    FK.reset_launches()
    got = FK.flash_attention(*args, **kw)
    assert FK.LAUNCHES == {"flash_attention": 1}
    want = FK.flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **FA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,cached", [(17, 0), (600, 1000), (4096, 0)])
def test_flash_attention_gemma_prefill_matches_plain_version(cuda_device, s,
                                                             cached, dtype):
    """gemma prefill calls (bf16: q k^T and the three-part p v on tensor
    cores) into a cache whose rows past the prompt hold NaN, one launch
    each, against the plain version."""
    args, kw = _gemma_call(cuda_device, s, cached, dtype, seed=s)
    FK.reset_launches()
    got = FK.flash_attention(*args, **kw)
    assert FK.LAUNCHES == {"flash_attention": 1}
    want = FK.flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **_gemma_tol(dtype))


# at most this share of the bf16 prefill's outputs may differ from the
# plain version's bf16 outputs: p kept in f32, sums in another order
P_F32_MISMATCH = 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("s,cached", [(17, 0), (600, 1000)])
def test_flash_attention_prefill_keeps_p_in_f32(cuda_device, s, cached):
    """The tensor-core prefill's p·v uses all three bf16 parts of p: its
    bf16 outputs differ from the plain version's on at most
    `P_F32_MISMATCH` of them and within one bf16 ulp, while the control,
    the plain version with p rounded to bf16 (SDPA's function), fails both
    through the same comparison."""
    args, kw = _gemma_call(cuda_device, s, cached, torch.bfloat16, seed=s)
    got = FK.flash_attention(*args, **kw)
    want = FK.flash_attention_plain(*args, **kw)
    control = FK.flash_attention_plain(*args, p_to_bf16=True, **kw)
    torch.cuda.synchronize()
    assert (got != want).float().mean() <= P_F32_MISMATCH
    torch.testing.assert_close(got, want, **GEMMA_BF16)
    assert (control != want).float().mean() > P_F32_MISMATCH
    assert not torch.allclose(control, want, **GEMMA_BF16)


@pytest.mark.gpu
def test_flash_split3_matches_bf16_parts(cuda_device):
    """The prefill's device split of f32 p into three bf16 parts is
    `bf16_parts` bit for bit, on p in [0, 1], on p = e^-x down to e^-60
    (a walk's small weights), at 0 and 1, and for an odd count."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = torch.cat([torch.rand(1 << 20, generator=g, device=cuda_device),
                   torch.exp(-60 * torch.rand(1 << 20, generator=g,
                                              device=cuda_device)),
                   torch.tensor([0.0, 1.0, 0.5], device=cuda_device)])
    for x in (p, p[:-1]):
        got = FK.kernel_bf16_parts(x)
        want = FK.bf16_parts(x)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.gpu
def test_flash_attention_ops_pad_narrow_heads(cuda_device):
    """`ops.attention` pads D = 8 and 16 (the reference tests' narrow
    heads, the reduced configs') to the kernel's 32."""
    for d in (8, 16):
        q, k, v = _qkv(cuda_device, 1, 3, 3, 33, 47, d, torch.float32)
        FK.reset_launches()
        got = fops.attention(q, k, v, causal=True)
        assert FK.LAUNCHES == {"flash_attention": 1}
        want = FK.flash_attention_plain(q, k, v, causal=True)
        torch.testing.assert_close(got, want, **FA_TOL[torch.float32])


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 2, 8, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="D % 32"):
        FK.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 8, 8, 288, torch.float32)
    with pytest.raises(ValueError, match="D <= 256"):
        FK.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 8, 8, 64, torch.float16)
    with pytest.raises(TypeError):
        FK.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 8, 8, 64, torch.float32)
    with pytest.raises(TypeError):
        FK.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="contiguous D"):
        FK.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    FK.reset_launches()
    with pytest.raises(ValueError):
        FK.flash_attention(q[..., :60], k[..., :60], v[..., :60])
    assert FK.LAUNCHES == {"flash_attention": 0}


@pytest.mark.gpu
def test_gemma_two_layers_on_the_kernel_match_plain_path(cuda_device):
    """gemma_2b at full width, cut to two layers, bf16: a 300-token prefill
    and four decode steps through the kernel (one launch per layer and
    call) against the plain attention path, logits within 0.05.  Two
    layers leave bf16 rounding flips little room to grow; chip_smoke.py
    measures the 18-layer floor."""
    cfg = get_config("gemma_2b").replace(n_layers=2)
    model = LM(cfg, device=cuda_device, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, 304), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(0))
    out = {}
    for use_kernel in (None, False):
        model.use_kernel = use_kernel
        FK.reset_launches()
        cache, logits = model.prefill({"tokens": toks[:, :300]}, 512)
        steps = [logits]
        for t in range(300, 304):
            cache, logits = model.decode_step(cache,
                                              {"tokens": toks[:, t:t + 1]})
            steps.append(logits)
        out[use_kernel] = torch.stack(steps)
        assert FK.LAUNCHES == {"flash_attention":
                               2 * 5 if use_kernel is None else 0}
    assert torch.isfinite(out[None]).all()
    assert (out[None] - out[False]).abs().max() <= 0.05
