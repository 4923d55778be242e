"""The port's CUDA kernels on the card (every test here needs a CUDA card).

Each kernel is held against its plain PyTorch version on the same device
tensors (fp32 MIN/MAX also with ±0 and NaN); BFS on the kernels against BFS
on the plain sort backend; the SSD kernel in per-head and group form, its
composition and a full-width two-layer mamba2_780m prefill and decode
against the plain SSD path; the flash-attention kernel (f32 at rtol = atol
= 3e-5, bf16 at 2e-2, as the reference's attention tests, and at one bf16
ulp at gemma_2b's shapes; decode split across CTAs, prefill on tensor
cores) and a full-width two-layer gemma_2b prefill and decode against the
plain attention path; the one-thread device loops (`serial_rmw` bit for
bit against the host loop, on ±0, NaN and subnormals too; `chase` in its
four modes against its plain version); training and MLA: a full-width
two-layer gemma_2b train step in f32 against f64, deepseek_v3's MLA layer
at full width in f32 against f64, a backward through the flash and SSD
kernels' wrappers raising, and deterministic backward passes bit-equal;
the flash kernel at qwen2_vl_2b's and whisper_small's shapes (non-causal
encoder, cross-attention prefill and split-KV decode), telemetry's
measured time of a ``cuda``-backend `execute` against the kernel's; and
tuning: tuned int32 runs under a live controller bit-equal to untuned ones
that took other backends, the estimator fed from the ``slot_counts``
kernel, and a swap moving the next `execute`'s auto decision; sharded
training on 4 ranks sharing the card against the local trainer; the
stamps the RMW kernels write (no result bit moved, each inside the CUDA
events around its call); and the contract linter's sweep on the card.
This file imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_gpu.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from _torch_gpu import cuda_device, same_bits, zeros_and_nans  # noqa: F401
from repro_torch import atomics
from repro_torch.configs import get_config
from repro_torch.core import bfs as tbfs
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rmw import kernel as K
from repro_torch.kernels.rmw import ref as tref
from repro_torch.kernels.serial import kernel as XK
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as sops
from repro_torch.launch.steps import loss_and_grads
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
@pytest.mark.parametrize("n,m", [(3000, 700), (1 << 16, 64),
                                 (1 << 20, 1 << 12)])
@pytest.mark.parametrize("op", ["min", "max"])
def test_fp32_minmax_signed_zeros_and_nan_match_plain_versions(cuda_device,
                                                               op, n, m):
    """fp32 MIN/MAX in the reference's order on the card: ±0 and NaN in the
    table and the operands, repeated slots, some ops out of range.  Both
    kernels against their plain versions on the same device tensors, NaN
    by isnan and every other value bit for bit."""
    rng = np.random.default_rng(n + m)
    tab = torch.as_tensor(zeros_and_nans(rng, m), device=cuda_device)
    val = torch.as_tensor(zeros_and_nans(rng, n), device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, m + 7, n).astype(np.int32),
                          device=cuda_device)
    same_bits(K.rmw_table(tab, idx, val, op),
              tref.rmw_table_ref(tab, idx, val, op).cpu().numpy(), "table")
    got = K.rmw_table_fetched(tab, idx, val, op)
    want = K.rmw_table_fetched_plain(tab, idx, val, op)
    same_bits(got[0], want[0].cpu().numpy(), "fetched kernel's table")
    same_bits(got[1], want[1].cpu().numpy(), "fetched")
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(3000, 700), (1 << 16, 64),
                                 (1 << 20, 1 << 12)])
@pytest.mark.parametrize("expected", [0.0, -0.0, 1.0])
def test_fp32_cas_signed_zeros_match_plain_version(cuda_device, expected,
                                                   n, m):
    """fp32 uniform CAS on the fetched kernel over ±0, ±1 and NaN: a value
    equal to `expected` in another zero's bits keeps the chain alive and is
    what the next op fetches.  Against the plain version on the same
    tensors, NaN by isnan, every other value bit for bit."""
    rng = np.random.default_rng(n + m + int(expected))
    pool = np.array([0.0, -0.0, 1.0, -1.0, np.nan], np.float32)
    tab = torch.as_tensor(rng.choice(pool, m), device=cuda_device)
    val = torch.as_tensor(rng.choice(pool, n), device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, m + 7, n).astype(np.int32),
                          device=cuda_device)
    got = K.rmw_table_fetched(tab, idx, val, "cas", expected=expected)
    want = K.rmw_table_fetched_plain(tab, idx, val, "cas", expected)
    same_bits(got[0], want[0].cpu().numpy(), "table")
    same_bits(got[1], want[1].cpu().numpy(), "fetched")
    assert torch.equal(got[2], want[2])


# the table-only kernels' regimes (`kernel.table_regime`), each at shapes
# that take it: (name, n, m, the regime the rule picks).  m = 1, every op
# dropped and Kronecker skew beside them; every other regime the shape
# allows is forced too.
TABLE_SHAPES = [("smem_small", 1 << 16, 700, "smem"),
                ("contended", 1 << 22, 1024, "smem"),
                ("smem_full", 1 << 22, K.SMEM_SLOTS, "smem"),
                ("m1", 1 << 20, 1, "smem"),
                ("cluster_range", 1 << 22, 300_000, "global"),
                ("bfs_n", 1 << 25, 1 << 20, "global"),
                ("all_dropped", 1 << 20, 1 << 20, "global"),
                ("kronecker", 1 << 22, 1 << 18, "global"),
                ("windows", 1 << 24, 1 << 24, "windows"),
                ("windows_ragged", 1 << 22, 2 * K.WINDOW_SLOTS + 5,
                 "windows")]


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [(op, dt) for op in ("faa", "min", "max",
                                                          "swp")
                                      for dt in (torch.int32, torch.float32)]
                         + [("count", torch.int32)],
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("case,n,m,regime", TABLE_SHAPES,
                         ids=[c[0] for c in TABLE_SHAPES])
def test_table_kernels_every_regime_match_plain_versions(cuda_device, case,
                                                         n, m, regime, op,
                                                         dtype):
    """`rmw_table` and `slot_counts` in the regime the rule picks, and
    every other regime the shape allows forced, against the plain
    versions: integer-valued tables bit for bit (fp32 too: every sum is
    exact), normal fp32 FAA within rtol 1e-5, atol 1e-5 sqrt(max
    occupancy) of the plain version summed in float64 (in fp32 on the card
    `index_add_` is itself a sum in atomic order, as far from the exact sum
    as the kernel may be); the input table unchanged."""
    assert K.table_regime("faa", torch.int32, n, m) == regime
    g = torch.Generator(device=cuda_device).manual_seed(n + m)
    if case == "kronecker":
        _, dst = tbfs.kronecker_graph(18, 8, seed=5)
        idx = torch.as_tensor(dst.astype(np.int32), device=cuda_device)
    else:
        idx = torch.randint(0, m + 3, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        if case == "all_dropped":
            idx = torch.where(idx % 2 == 0, m, -1 - idx)
    n = idx.shape[0]
    forced = K.table_regimes(m)
    if op == "count":
        want = K.slot_counts_plain(idx, m)
        assert torch.equal(K.slot_counts(idx, m), want)
        for r in forced:
            got = K.table_combine(torch.zeros_like(want), idx, None, "count",
                                  r)
            assert torch.equal(got, want), r
        return
    tab = torch.randint(-8, 9, (m,), generator=g, device=cuda_device,
                        dtype=torch.int32).to(dtype)
    val = torch.randint(-8, 9, (n,), generator=g, device=cuda_device,
                        dtype=torch.int32).to(dtype)
    before = tab.clone()
    want = tref.rmw_table_ref(tab, idx, val, op)
    assert torch.equal(K.rmw_table(tab, idx, val, op), want)
    assert torch.equal(tab, before)
    for r in forced:
        assert torch.equal(K.table_combine(tab.clone(), idx, val, op, r),
                           want), r
    if op == "faa" and dtype == torch.float32:
        tab = torch.randn((m,), generator=g, device=cuda_device)
        val = torch.randn((n,), generator=g, device=cuda_device)
        want = tref.rmw_table_ref(tab.double(), idx, val.double(),
                                  op).float()
        atol = 1e-5 * float(K.slot_counts_plain(idx, m).max()) ** 0.5
        for r in forced:
            got = K.table_combine(tab.clone(), idx, val, op, r)
            assert torch.allclose(got, want, rtol=1e-5, atol=atol), r


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["smem", "global", "windows"])
@pytest.mark.parametrize("op", ["min", "max", "faa"])
def test_table_kernels_fp32_signed_zeros_and_nan_every_regime(cuda_device,
                                                              op, regime):
    """fp32 MIN/MAX on ±0 and NaN (NaN by isnan, the rest bit for bit),
    and FAA's identity: a −0 slot that no op touches stays −0, in every
    regime (windows over a table of three windows)."""
    m = 3 * K.WINDOW_SLOTS if regime == "windows" else 1000
    rng = np.random.default_rng(len(op) + len(regime))
    tab = torch.as_tensor(zeros_and_nans(rng, m), device=cuda_device)
    n = 1 << 20
    val = torch.as_tensor(zeros_and_nans(rng, n), device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, m + 7, n).astype(np.int32),
                          device=cuda_device)
    if op == "faa":                        # no NaN in the sums
        tab, val = torch.nan_to_num(tab), torch.nan_to_num(val)
    same_bits(K.table_combine(tab.clone(), idx, val, op, regime),
              tref.rmw_table_ref(tab, idx, val, op).cpu().numpy(), regime)


# the fetched kernel's edge shapes: one slot; the BFS shape (scale 20,
# edgefactor 16) with 90% of ops dropped; every op dropped; a slot range
# that needs four radix passes; Kronecker skew
FETCHED_CASES = [("m1", 1 << 22, 1), ("bfs_90pct_dropped", 1 << 25, 1 << 20),
                 ("all_dropped", 1 << 22, 1 << 20),
                 ("m_2pow25_plus1", 1 << 24, (1 << 25) + 1),
                 ("kronecker", 1 << 22, 1 << 18)]


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case,n,m", FETCHED_CASES,
                         ids=[c[0] for c in FETCHED_CASES])
def test_fetched_kernel_edge_shapes_bit_equal_and_repeatable(cuda_device,
                                                             case, n, m, op):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    idx = torch.randint(0, m, (n,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    if case == "bfs_90pct_dropped":
        drop = torch.rand((n,), generator=g, device=cuda_device) < 0.9
        idx = torch.where(drop, m, idx)
    elif case == "all_dropped":
        idx = torch.where(idx % 2 == 0, m, -1 - idx)
    elif case == "kronecker":
        src, dst = tbfs.kronecker_graph(18, 16, seed=1)
        idx = torch.as_tensor(dst.astype(np.int32), device=cuda_device)
    tab = torch.randint(-8, 9, (m,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    val = torch.randint(-8, 9, (n,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    exp = 0 if op == "cas" else None
    got = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
    again = K.rmw_table_fetched(tab, idx, val, op, expected=exp)
    want = K.rmw_table_fetched_plain(tab, idx, val, op, exp)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_fetched_kernel_layout_is_the_libraries(cuda_device):
    """The scratch the library asks for: 16 counters, five histogram rows,
    an 8-byte status word per tile of 4096 ops and digit, four int32 arrays
    of n, each part a multiple of 256 bytes; its digit is the cost model's
    RADIX_BITS."""
    assert K.fetched_layout(0) == (0, K.RADIX_BITS)
    assert K.fetched_layout(1) == (256 + 5120 + 2048 + 4 * 256, 8)
    assert K.fetched_layout(1 << 25) == (
        256 + 5120 + 8192 * 256 * 8 + 4 * (4 << 25), K.RADIX_BITS)


@pytest.mark.gpu
def test_wrappers_count_launches_and_leave_inputs_unchanged(cuda_device):
    tab = torch.arange(10, dtype=torch.int32, device=cuda_device)
    idx = torch.tensor([1, 1, 3], dtype=torch.int32, device=cuda_device)
    before = tab.clone()
    K.reset_launches()
    K.rmw_table(tab, idx, idx, "swp")
    K.table_combine(tab.clone(), idx, idx, "faa", "smem")   # counts nothing
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


# (BH, heads per group, S, N, chunk): mamba2_780m's serving shape in its
# one group, two groups of 24, the per-head form, four sequences, and
# narrower groups that take the kernel's other work splits
SSD_GROUPED = [(48, 48, 4096, 128, 256), (48, 24, 4096, 128, 256),
               (48, 1, 1024, 128, 256), (192, 48, 1024, 128, 256),
               (6, 3, 512, 64, 128), (4, 2, 512, 32, 64),
               (8, 4, 768, 128, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,hpg,s,n,chunk", SSD_GROUPED)
def test_ssd_chunk_group_form_matches_plain_version(cuda_device, bh, hpg, s,
                                                    n, chunk):
    """B and C per group of heads (head i reads group i // hpg), one
    launch, against the plain version on B and C repeated to the heads."""
    g = torch.Generator(device=cuda_device).manual_seed(bh * hpg + s)
    xdt, adt, _, _ = _ssd_chunk_inputs(g, cuda_device, bh, s, n)
    B, C = (torch.randn((bh // hpg, s, n), generator=g, device=cuda_device)
            for _ in range(2))
    SK.reset_launches()
    y, st = SK.ssd_chunk(xdt, adt, B, C, chunk=chunk, heads_per_group=hpg)
    assert SK.LAUNCHES == {"ssd_chunk": 1}
    y_p, st_p = SK.ssd_chunk_plain(xdt, adt, B, C, chunk=chunk,
                                   heads_per_group=hpg)
    torch.testing.assert_close(y, y_p, **SSD_TOL)
    torch.testing.assert_close(st, st_p, **SSD_TOL)


@pytest.mark.gpu
def test_ssd_one_group_launches_one_kernel(cuda_device):
    """`ops.ssd` with B and C on one group of 8 heads hands the group to the
    kernel in one launch (no per-head copy), against the plain path."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, s, h = 2, 300, 8
    x = torch.randn((b, s, h, 64), generator=g, device=cuda_device)
    dt = torch.rand((b, s, h), generator=g, device=cuda_device) * 0.19 + 0.01
    A = -(torch.rand((h,), generator=g, device=cuda_device) * 1.5 + 0.5)
    B = torch.randn((b, s, 1, 128), generator=g, device=cuda_device)
    C = torch.randn((b, s, 1, 128), generator=g, device=cuda_device)
    SK.reset_launches()
    y, hf = sops.ssd(x, dt, A, B, C, chunk=256, return_final_state=True)
    assert SK.LAUNCHES == {"ssd_chunk": 1}
    y_p, hf_p = sops.ssd_chunked(x, dt, A, B, C, chunk=256,
                                 return_final_state=True)
    torch.testing.assert_close(y, y_p, **SSD_TOL)
    torch.testing.assert_close(hf, hf_p, **SSD_TOL)


@pytest.mark.gpu
def test_mamba_two_layers_serve_through_the_group_path(cuda_device):
    """mamba2_780m at full width (48 heads, one group), cut to two layers,
    bf16: a 300-token prefill through the kernel in group form (one launch
    per layer) and four decode steps (no launch), against the plain SSD
    path, logits within 0.05."""
    cfg = get_config("mamba2_780m").replace(n_layers=2)
    model = LM(cfg, device=cuda_device, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, 304), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1))
    out = {}
    for use_kernel in (None, False):
        model.use_kernel = use_kernel
        SK.reset_launches()
        cache, logits = model.prefill({"tokens": toks[:, :300]}, 512)
        steps = [logits]
        for t in range(300, 304):
            cache, logits = model.decode_step(cache,
                                              {"tokens": toks[:, t:t + 1]})
            steps.append(logits)
        out[use_kernel] = torch.stack(steps)
        assert SK.LAUNCHES == {"ssd_chunk": 2 if use_kernel is None else 0}
    assert torch.isfinite(out[None]).all()
    assert (out[None] - out[False]).abs().max() <= 0.05


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
    with pytest.raises(ValueError, match="kernel takes"):
        SK.ssd_chunk(z((2, 512, 64), device=dev), z((2, 512), device=dev),
                     z((2, 512, 32), device=dev), z((2, 512, 32), device=dev),
                     chunk=512)
    with pytest.raises(ValueError, match="heads_per_group"):
        SK.ssd_chunk(z((3, 64, 64), device=dev), z((3, 64), device=dev),
                     z((1, 64, 32), device=dev), z((1, 64, 32), device=dev),
                     chunk=64, heads_per_group=2)
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
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 256), (12, 2, 128),
                                      (48, 8, 128), (12, 12, 64)],
                         ids=["gemma", "qwen2_vl", "dbrx", "whisper"])
@pytest.mark.parametrize("kv_valid", [0, 1, 65, 1600])
def test_flash_attention_decode_lse_and_f32_output(cuda_device, kv_valid,
                                                   hq, hkv, d, dtype):
    """A decode call that also writes each row's log-sum-exp and its
    output in f32 (a rank's partial over its cache segment), NaN past the
    valid rows, against `flash_attention_split_plain` at the kernel's own
    splits: out within 3e-5, lse within 1e-5; the f32 output rounded to
    the input type is the plain call's output bit for bit; kv_valid = 0
    launches and gives out = 0, lse = -inf; one launch each, counted in
    `LSE_LAUNCHES`."""
    args, kw = _gemma_call(cuda_device, 1, kv_valid - 1, dtype,
                           seed=kv_valid, b=2, hq=hq, hkv=hkv, d=d,
                           s_max=kv_valid + 40)
    FK.reset_launches()
    out, lse = FK.flash_attention(*args, **kw, return_lse=True)
    assert FK.LAUNCHES == FK.LSE_LAUNCHES == {"flash_attention": 1}
    rows, max_splits = FK.decode_limits()
    splits = FK.decode_splits(max(kv_valid, 0), 2 * hkv,
                              FK._sm_count(out.device), max_splits)
    want, want_lse = FK.flash_attention_split_plain(
        *args, **kw, splits=splits, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32
    if kv_valid == 0:
        assert not out.any() and bool((lse == float("-inf")).all())
        return
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(FK.flash_attention(*args, **kw), out.to(dtype))


@pytest.mark.gpu
def test_flash_attention_partial_outputs_refused_outside_decode(
        cuda_device):
    """A partial (the log-sum-exp, the output in f32) is the decode
    body's: a prefill-shaped call asking for it raises before any
    launch."""
    args, kw = _gemma_call(cuda_device, 17, 0, torch.bfloat16)
    FK.reset_launches()
    with pytest.raises(ValueError, match="decode body"):
        FK.flash_attention(*args, **kw, return_lse=True)
    assert FK.LAUNCHES == {"flash_attention": 0}


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


# ---------------------------------------------------------------------------
# the one-thread device loops: serial_rmw and chase
# ---------------------------------------------------------------------------

def _serial_inputs(g, dev, n, m, dtype, kind):
    def draw(size):
        if kind == "zeros_nans":
            pool = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, float("nan"),
                                 -float("nan")], device=dev)
            return pool[torch.randint(0, len(pool), (size,), generator=g,
                                      device=dev)]
        if kind == "subnormal":
            sub = torch.tensor([1e-40, -1e-40, 5e-39, -1.1e-38, 1.2e-38,
                                -1.5e-45], device=dev)
            pick = sub[torch.randint(0, len(sub), (size,), generator=g,
                                     device=dev)]
            x = torch.randn((size,), generator=g, device=dev) * 1e-38
            return torch.where(torch.rand((size,), generator=g, device=dev)
                               < 0.5, pick, x)
        return torch.randint(-8, 9, (size,), generator=g,
                             device=dev).to(dtype)
    lo = 0 if kind == "subnormal" else -m - 3
    hi = m if kind == "subnormal" else m + 3
    idx = torch.randint(lo, hi, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    return draw(m), idx, draw(n), draw(n)


#: (op, operands, dtype): every op on small integers in int32 and fp32 and
#: on ±0/NaN in fp32; fp32 FAA also on subnormals, which atom.add.f32
#: flushes to zero and the kernel then restores
SERIAL_CASES = ([(op, "ints", dt) for op in XK.OP_CODES
                 for dt in (torch.int32, torch.float32)]
                + [(op, "zeros_nans", torch.float32) for op in XK.OP_CODES]
                + [("faa", "subnormal", torch.float32)])


@pytest.mark.gpu
@pytest.mark.parametrize("op,kind,dtype", SERIAL_CASES)
def test_serial_rmw_matches_host_loop(cuda_device, op, kind, dtype):
    """serial_rmw against the host loop, every output bit for bit (NaN by
    isnan), at n = 4,096 over 1,024 slots and over one, indices from
    -m - 3 to m + 3; CAS with a per-op and a scalar expected."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for m in (1024, 1):
        tab, idx, val, exp = _serial_inputs(g, cuda_device, 4096, m, dtype,
                                            kind)
        for e in ((exp, 0) if op == "cas" else (None,)):
            got = XK.serial_rmw(tab, idx, val, op, e)
            host = e.cpu() if isinstance(e, torch.Tensor) else e
            want = XK.serial_rmw(tab.cpu(), idx.cpu(), val.cpu(), op, host)
            same_bits(got[0], want[0].numpy(), f"{op} table")
            same_bits(got[1], want[1].numpy(), f"{op} fetched")
            assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.gpu
def test_rmw_serialized_runs_serial_rmw_on_the_card(cuda_device):
    XK.reset_launches()
    tab = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    idx = torch.arange(100, device=cuda_device) % 70      # int64, some drop
    r = atomics.execute(tab, atomics.Faa(idx, torch.ones_like(idx)),
                        backend="serialized")
    assert XK.LAUNCHES["serial_rmw"] == 1
    want = XK.serial_rmw(tab.cpu(), idx.cpu(),
                         torch.ones(100, dtype=torch.int32), "faa")
    assert torch.equal(r.table.data.cpu(), want[0])
    assert torch.equal(r.fetched.cpu(), want[1])
    with pytest.raises(TypeError):
        XK.serial_rmw(tab.double(), idx, idx.double(), "faa")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(XK.CHASE_MODES))
@pytest.mark.parametrize("m,steps", [(1 << 12, 3 << 12), (1 << 16, 1 << 16)])
def test_chase_matches_plain_version(cuda_device, mode, m, steps):
    """The chase against its plain version on a copy of the same cycle:
    the end slot and the table after (faa counts visits in the high bits;
    the other modes leave the cycle as it was)."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    table = XK.single_cycle(m, g, cuda_device)
    host = table._replace(words=table.words.cpu())
    before = host.words.clone()
    XK.reset_launches()
    end = XK.chase(table, steps, mode, start=m // 3)
    want = XK.chase_plain(host, steps, mode, start=m // 3)
    assert XK.LAUNCHES["chase"] == 1
    assert int(end) == int(want)
    assert torch.equal(table.words.cpu(), host.words)
    if mode != "faa":
        assert torch.equal(host.words, before)


@pytest.mark.gpu
def test_sharded_two_ranks_on_the_card(cuda_device):
    """Two gloo ranks sharing the card: oneshot FAA and per-op CAS on a
    sharded table, against the serialized oracle over the two batches in
    rank order; the kernels ran inside the ranks (the fetched kernel for
    the FAA combine and resolve, `serial_rmw` for CAS at the owner)."""
    import os
    from repro_torch.core.rmw import rmw_serialized
    from repro_torch.launch import ranks
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_sharded_worker.py")
    n, m = 1 << 14, 1 << 14
    out = ranks.launch(f"{worker}:run_card_pair", 2,
                       mesh=((2,), ("dev",)), device="cuda", args=(n, m),
                       timeout=600)
    idx, vals, exps, table0 = out[0]["inputs"]
    flat = torch.from_numpy(idx.reshape(-1)).long()
    live = (flat >= 0) & (flat < m)
    pad = torch.cat([torch.from_numpy(table0),
                     torch.zeros(1, dtype=torch.int32)])
    for name, kind, exp in (("faa", "faa", None),
                            ("cas_perop", "cas",
                             torch.from_numpy(exps.reshape(-1)))):
        want = rmw_serialized(pad, torch.where(live, flat, m),
                              torch.from_numpy(vals.reshape(-1)), kind, exp)
        table = np.concatenate([o[name][0] for o in out])
        fetched = np.concatenate([o[name][1] for o in out])
        success = np.concatenate([o[name][2] for o in out])
        np.testing.assert_array_equal(table, want.table[:m].numpy())
        np.testing.assert_array_equal(fetched[live.numpy()],
                                      want.fetched[live].numpy())
        np.testing.assert_array_equal(success,
                                      (want.success & live).numpy())
    for o in out:
        assert o["launches"]["rmw_table_fetched"] > 0
        assert o["launches"]["serial_rmw"] > 0


@pytest.mark.gpu
def test_exchange_migration_two_ranks_on_the_card(cuda_device):
    """Two gloo ranks sharing the card: a table sharded over ``dev`` moves
    by the exchange path onto the same ranks in reverse order (each
    rank's shard crosses), bit for bit; then one FAA batch on the moved
    table through the card's kernels equals the serialized oracle over the
    two batches in the new mesh's rank order."""
    import os
    from repro_torch.core.rmw import rmw_serialized
    from repro_torch.launch import ranks
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_elastic_worker.py")
    m = 1 << 14
    out = ranks.launch(f"{worker}:run_card_exchange", 2,
                       mesh=((2,), ("dev",)), device="cuda", args=(m,),
                       timeout=600)
    tab0, idx, vals = out[0]["inputs"]
    assert all(o["path"] == "exchange" for o in out)
    # the reversed mesh: world rank 1 is flat 0 and holds rows [0, m/2)
    assert [o["moved"][0] for o in out] == [1, 0]
    moved = np.concatenate([o["moved"][1] for o in out[::-1]])
    np.testing.assert_array_equal(moved, tab0)
    flat = torch.from_numpy(idx.reshape(-1)).long()
    live = (flat >= 0) & (flat < m)
    pad = torch.cat([torch.from_numpy(tab0),
                     torch.zeros(1, dtype=torch.int32)])
    want = rmw_serialized(pad, torch.where(live, flat, m),
                          torch.from_numpy(vals.reshape(-1)), "faa")
    after = np.concatenate([o["after"][1] for o in out[::-1]])
    np.testing.assert_array_equal(after, want.table[:m].numpy())
    fetched = np.concatenate([o["fetched"][0] for o in out[::-1]])
    np.testing.assert_array_equal(fetched[live.numpy()],
                                  want.fetched[live].numpy())
    assert all(o["launches"]["rmw_table_fetched"] > 0 for o in out)


# ---------------------------------------------------------------------------
# MoE models: dbrx and jamba on the card's kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape,s,cached", [("prefill", 3523, 0),
                                            ("decode", 1, 1599)])
def test_flash_attention_dbrx_shapes_match_plain_version(cuda_device, shape,
                                                         s, cached):
    """dbrx's attention (48 query heads over 8 KV heads of 128, bf16): the
    prefill of its longest served prompt and a decode call at 1,600 rows,
    within one bf16 ulp of the plain version."""
    args, kw = _gemma_call(cuda_device, s, cached, torch.bfloat16, hq=48,
                           hkv=8, d=128)
    got = FK.flash_attention(*args, **kw)
    want = FK.flash_attention_plain(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.allclose(got.float(), want.float(), **GEMMA_BF16)


@pytest.mark.gpu
def test_dbrx_full_width_layer_matches_plain_path(cuda_device):
    """dbrx at full width cut to one layer (attention and a 16-expert MoE),
    f32: prefill logits of a 512-token prompt through the flash kernel and
    through the plain attention within 1e-3; the MoE runs the same code on
    both paths, so the expert choices agree."""
    cfg = get_config("dbrx_132b").replace(n_layers=1, dtype="float32")
    model = LM(cfg, device=cuda_device, seed=0, attn_impl="ref")
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(0))
    FK.reset_launches()
    _, logits = model.prefill({"tokens": toks}, 520)
    assert FK.LAUNCHES == {"flash_attention": 1}
    model.use_kernel = False
    _, plain = model.prefill({"tokens": toks}, 520)
    assert torch.isfinite(logits).all()
    assert (logits - plain).abs().max() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape,s,cached", [("prefill", 3523, 0),
                                            ("decode", 1, 1599)])
def test_flash_attention_jamba_shapes_match_plain_version(cuda_device, shape,
                                                          s, cached):
    """jamba's attention (64 query heads over 8 KV heads of 128, bf16), as
    dbrx's above."""
    args, kw = _gemma_call(cuda_device, s, cached, torch.bfloat16, hq=64,
                           hkv=8, d=128)
    got = FK.flash_attention(*args, **kw)
    want = FK.flash_attention_plain(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.allclose(got.float(), want.float(), **GEMMA_BF16)


@pytest.mark.gpu
def test_jamba_on_the_kernels_matches_plain_path(cuda_device):
    """jamba at full width cut to its first two layers (SSD + dense MLP,
    SSD + a 16-expert MoE; P 64, N 128, chunk 256, 256 heads), f32, about
    48 GB: prefill and two decode steps through the SSD kernel and through
    the plain paths within 1e-3."""
    cfg = get_config("jamba_1_5_large_398b").replace(n_layers=2,
                                                     dtype="float32")
    model = LM(cfg, device=cuda_device, seed=0, attn_impl="ref")
    toks = torch.randint(0, cfg.vocab_size, (2, 302), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1))
    out = {}
    for use_kernel in (None, False):
        model.use_kernel = use_kernel
        SK.reset_launches()
        cache, logits = model.prefill({"tokens": toks[:, :300]}, 310)
        steps = [logits]
        for t in (300, 301):
            cache, logits = model.decode_step(cache,
                                              {"tokens": toks[:, t:t + 1]})
            steps.append(logits)
        out[use_kernel] = steps
        assert SK.LAUNCHES["ssd_chunk"] == (2 if use_kernel is None else 0)
    del model, cache
    torch.cuda.empty_cache()
    for a, b in zip(out[None], out[False]):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-3


# ---------------------------------------------------------------------------
# training and MLA on the card
# ---------------------------------------------------------------------------

def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    return saved


@pytest.mark.gpu
def test_gemma_full_width_train_step_f32_matches_f64(cuda_device):
    """gemma_2b at full width cut to 2 layers, TF32 off, deterministic
    algorithms on, one batch of 2 x 128 tokens: the f32 loss within rtol
    1e-5 of the f64 one, every gradient leaf within relative L2 1e-4, and
    each element of the master weights after one `make_train_step` step
    within what its gradient's f32 error moves Adam's first step (whose
    slope in the clipped gradient is at most 1 / eps): lr min(2, |g'32 -
    g'64| / eps) plus 2 f32 ulps of the leaf's largest weight
    (`chip_smoke.py`'s `train_check` at the trainer's batch).  A control
    with the label mask dropped fails the gradient check."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.optim.adamw import AdamWConfig, init_state
    saved = _no_tf32()
    try:
        cfg = get_config("gemma_2b").replace(n_layers=2)
        batch = synthetic_batch(DataConfig(128, 2, cfg.vocab_size), 0,
                                device=cuda_device)
        opt = AdamWConfig(warmup_steps=2, total_steps=10)
        res = {}
        for dt in ("float32", "float64"):
            model = LM(cfg.replace(dtype=dt), device=cuda_device, seed=0,
                       use_kernel=False, remat_policy="none")
            if dt == "float64":
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(res["float32"]["init"][n])
            else:
                init = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
            with deterministic_algorithms(True):
                loss, grads = loss_and_grads(model, batch)
            ctrl = loss_and_grads(model, dict(
                batch, labels=batch["labels"].clamp(min=0)))[1] \
                if dt == "float32" else None
            params = dict(model.named_parameters())
            with deterministic_algorithms(True):
                _, st, m = make_train_step(model, opt)(
                    params, init_state(params, opt), batch)
            res[dt] = dict(loss=float(loss), grads=grads, ctrl=ctrl,
                           master=st["master"], lr=float(m["lr"]),
                           scale=min(1.0, 1.0 / float(m["grad_norm"])),
                           init=init if dt == "float32" else None)
            del model, params, st
        a, b = res["float32"], res["float64"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)

        def rel(x, y):
            x, y = x.double(), y.double()
            return float((x - y).norm() / y.norm().clamp(min=1e-30))

        assert max(rel(a["grads"][n], b["grads"][n]) for n in b["grads"]) \
            <= 1e-4
        assert max(rel(a["ctrl"][n], b["grads"][n]) for n in b["grads"]) \
            > 1e-4
        eps32 = torch.finfo(torch.float32).eps
        for n in b["master"]:
            dg = (a["grads"][n].double() * a["scale"]
                  - b["grads"][n] * b["scale"]).abs()
            bound = b["lr"] * torch.clamp(dg / opt.eps, max=2.0) \
                + 2 * eps32 * float(a["init"][n].abs().max())
            assert ((a["master"][n].double() - b["master"][n]).abs()
                    <= bound).all(), n
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_mla_full_width_matches_f64(cuda_device):
    """deepseek_v3's MLA layer at full width (d 7168, 128 heads, kv_lora
    512), TF32 off: a 256-token prefill into the latent cache and two
    decode steps in f32 against f64, within 1e-4 of the output's largest
    magnitude; the decodes against one prefill of all 258 tokens too."""
    from repro_torch.models import attention as tattn
    saved = _no_tf32()
    try:
        cfg = get_config("deepseek_v3_671b")
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        p64 = tattn.attn_init(gen, cfg, torch.float64)
        p32 = tattn.attn_init(gen, cfg, torch.float32)
        with torch.no_grad():
            for (_, a), (_, b) in zip(p32.named_parameters(),
                                      p64.named_parameters()):
                a.copy_(b)
        x = torch.randn((1, 258, cfg.d_model), generator=gen,
                        device=cuda_device, dtype=torch.float64)
        outs = {}
        with torch.no_grad():
            for dt, p in ((torch.float32, p32), (torch.float64, p64)):
                cache = tattn.make_kv_cache(cfg, 1, 258, dt,
                                            device=cuda_device)
                o, cache = tattn.mla_forward(p, x[:, :256].to(dt), cfg,
                                             cache=cache)
                steps = [o]
                for t in (256, 257):
                    o, cache = tattn.mla_forward(p, x[:, t:t + 1].to(dt),
                                                 cfg, cache=cache)
                    steps.append(o)
                outs[dt] = torch.cat(steps, 1)
            full = tattn.mla_forward(p32, x.float(), cfg)[0]
        scale = float(outs[torch.float64].abs().max())
        assert float((outs[torch.float32].double()
                      - outs[torch.float64]).abs().max()) <= 1e-4 * scale
        assert float((outs[torch.float32][:, 256:] - full[:, 256:])
                     .abs().max()) <= 1e-4 * scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_kernel_backward_raises_on_the_card(cuda_device):
    """A gradient through `ops.flash` or `ops.ssd`'s kernel raises: no
    backward kernel exists, and neither wrapper falls back to its plain
    version or detaches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 2, 64, 64), generator=g, device=cuda_device,
                    requires_grad=True)
    k = torch.randn((1, 1, 64, 64), generator=g, device=cuda_device,
                    requires_grad=True)
    out = fops.flash(q, k, k, causal=True, scale=None, kv_valid=64,
                     kv_offset=0)
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="no backward kernel"):
        out.sum().backward()
    x = torch.randn((1, 256, 2, 64), generator=g, device=cuda_device,
                    requires_grad=True)
    dt = torch.full((1, 256, 2), 0.05, device=cuda_device)
    B = torch.randn((1, 256, 1, 64), generator=g, device=cuda_device)
    y = sops.ssd(x, dt, -torch.ones(2, device=cuda_device), B, B.clone(),
                 chunk=256, use_kernel=True)
    assert y.requires_grad
    with pytest.raises(RuntimeError, match="no backward kernel"):
        y.sum().backward()


@pytest.mark.gpu
def test_deterministic_backward_is_bit_equal(cuda_device):
    """Under the trainer's deterministic algorithms, two backward passes of
    one batch give bit-equal gradients on every leaf: the reduced
    gemma_2b (embedding gradient) and deepseek_v3 (MoE's gathers)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.train import deterministic_algorithms
    for arch in ("gemma_2b", "deepseek_v3_671b"):
        cfg = get_reduced(arch).replace(dtype="float32")
        model = LM(cfg, device=cuda_device, seed=0, use_kernel=False)
        batch = synthetic_batch(DataConfig(256, 8, cfg.vocab_size), 0,
                                device=cuda_device)
        with deterministic_algorithms(True):
            _, g1 = loss_and_grads(model, batch)
            _, g2 = loss_and_grads(model, batch)
        for n in g1:
            assert torch.equal(g1[n], g2[n]), (arch, n)


# ---------------------------------------------------------------------------
# qwen2_vl and whisper: the flash kernel at their shapes; telemetry's clock
# ---------------------------------------------------------------------------

def _whisper_call(dev, sq, skv, dtype, b=1, seed=0):
    """whisper_small's attention: 12 heads of 64 over 12 KV heads, q
    (B, sq, 12, 64) against (B, skv, 12, 64) keys as the model hands them
    over (transposed views of contiguous projections), not causal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, 12, 64), generator=g, device=dev)
               .to(dtype).transpose(1, 2) for s in (sq, skv, skv))
    return (q, k, v), dict(causal=False, kv_valid=skv, kv_offset=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what,sq,skv", [("encoder", 1500, 1500),
                                         ("cross_prefill", 37, 1500),
                                         ("cross_decode", 1, 1500)])
def test_flash_attention_whisper_shapes_match_plain_version(
        cuda_device, what, sq, skv, dtype):
    """The encoder's 1,500 x 1,500 at D 64, the cross-attention at
    prefill (Sq 37) and at decode (Sq 1: the split-KV path with
    causal=0), all non-causal, batch 2: within 3e-5 in f32 and one bf16
    ulp in bf16 of the plain version."""
    args, kw = _whisper_call(cuda_device, sq, skv, dtype, b=2,
                             seed=sq + skv)
    FK.reset_launches()
    got = FK.flash_attention(*args, **kw)
    assert FK.LAUNCHES == {"flash_attention": 1}
    want = FK.flash_attention_plain(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **_gemma_tol(dtype))
    # control: the causal call from key 0 differs (row i sees keys <= i),
    # so the mask is not applied silently
    causal = FK.flash_attention(*args, **dict(kw, causal=True))
    assert not torch.allclose(causal.float(), want.float(),
                              **_gemma_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,s,cached", [("prefill", 1024, 0),
                                            ("decode", 1, 1599)])
def test_flash_attention_qwen2_vl_shapes_match_plain_version(
        cuda_device, shape, s, cached, dtype):
    """qwen2_vl_2b's attention (12 query heads over 2 KV heads of 128: 6
    rows a KV head at decode, the split path): a 1,024-token prefill and a
    decode call at 1,600 rows of a 4,112-row cache."""
    args, kw = _gemma_call(cuda_device, s, cached, dtype, hq=12, hkv=2,
                           d=128)
    got = FK.flash_attention(*args, **kw)
    want = FK.flash_attention_plain(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **_gemma_tol(dtype))


@pytest.mark.gpu
def test_execute_measured_time_covers_the_kernel(cuda_device):
    """Under ``capture(sync=True)`` a ``cuda``-backend `execute` records
    ``measured_s`` of at least the device time of the kernels it launched
    (their CUPTI durations in a torch.profiler trace of the same calls:
    the card is synchronised on both sides of the clock, so every kernel
    of a call runs inside its measured interval)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import telemetry
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, m = 1 << 22, 1 << 20
    idx = torch.randint(0, m, (n,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    val = torch.ones((n,), dtype=torch.int32, device=cuda_device)
    tbl = atomics.make_table(m, torch.int32, device=cuda_device)
    atomics.execute(tbl, atomics.Faa(idx, val), backend="cuda")   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            telemetry.capture(sync=True) as buf:
        for _ in range(3):
            atomics.execute(tbl, atomics.Faa(idx, val), backend="cuda")
    kernel_s = sum(e.duration_ns() for e in prof.profiler.kineto_results
                   .events() if e.device_type() ==
                   torch.autograd.DeviceType.CUDA) / 1e9
    evs = [e for e in buf.events if e["event"] == "atomics.execute"]
    assert len(evs) == 3 and all(e["backend"] == "cuda" for e in evs)
    measured = sum(e["measured_s"] for e in evs)
    assert measured >= kernel_s > 0, (measured, kernel_s)
    assert all(e["predicted_s"] > 0 for e in evs)


def _tuned_workload(device, controller):
    """int32 FAA with a fetched sum (16 ops over 64 slots a step, probes
    forced onto ``onehot`` and ``serialized``) plus a contended CAS loop
    (256 ops over 32 slots) twice, under ``controller`` when given."""
    import hashlib

    from repro_torch.benchmarks import tuning as T
    table, acc = T.workload(controller, device)
    idx = torch.as_tensor(np.tile(np.arange(32, dtype=np.int32), 8),
                          device=device)

    def make_ops(slots, observed):
        if slots is None:
            return atomics.Cas(idx, torch.ones_like(idx),
                               expected=torch.zeros_like(idx))
        return observed + 1

    h = hashlib.sha256(table.tobytes())
    tab = atomics.make_table(64, torch.int32, device=device)
    for _ in range(2):
        res = atomics.execute_until(tab, make_ops, max_rounds=16)
        tab = res.table
        for a in (res.fetched, res.success, res.rounds):
            h.update(np.ascontiguousarray(a).tobytes())
        if controller is not None:
            controller.step()
    h.update(tab.data.cpu().numpy().tobytes())
    return h.hexdigest(), acc


@pytest.mark.gpu
def test_tuned_int32_runs_bit_equal_to_untuned_on_the_card(cuda_device,
                                                           tmp_path):
    """A live controller on the card (restored from a state that moves
    the FAA batch's backend, then swapping on its windows): the results
    bit-equal to an untuned run's, another backend on at least one batch,
    the estimator fed from the device with `slot_counts` launched."""
    from repro_torch import telemetry
    from repro_torch.benchmarks import tuning as T
    from repro_torch.tuning import SpecController, TuningConfig
    path = str(tmp_path / "flip.json")
    T.flip_state(path, "cuda", [("faa", 16, 64)])
    _tuned_workload("cuda", None)                 # warm: kernels built
    with telemetry.capture() as base_buf:
        base = _tuned_workload("cuda", None)
    counts = K.LAUNCHES["slot_counts"]
    cfg = TuningConfig(min_events=8, min_samples=1, cooldown_updates=0)
    with telemetry.capture(sync=True) as buf:     # every call measured
        with SpecController(cfg, state_path=path, device="cuda") as ctrl:
            tuned = _tuned_workload("cuda", ctrl)
            est = ctrl.estimator
            stats = ctrl.stats()
    assert tuned == base
    a, b = T._choices(base_buf.events), T._choices(buf.events)
    assert len(a) == len(b) and sum(x != y for x, y in zip(a, b)) >= 1
    assert est.n_updates_device >= 2 and len(est) == 1
    assert K.LAUNCHES["slot_counts"] - counts >= 2
    assert stats["updates"] >= 4           # live windows, not only the restore
    assert stats["applied"] >= 1           # ... and at least one live swap


@pytest.mark.gpu
def test_swap_changes_the_next_auto_decision_on_the_card(cuda_device):
    """FAA 256 over 64 slots picks ``sort`` under the H100 priors; one
    applied window of ``onehot`` drift 2x slow doubles `gather_elem_s`,
    and the next `execute` on the card picks another backend."""
    import dataclasses

    from repro_torch import telemetry
    from repro_torch.core import rmw_engine
    from repro_torch.tuning import SpecController, TuningConfig
    tbl = atomics.make_table(64, torch.int32, device=cuda_device)
    op = atomics.Faa(torch.arange(256, device=cuda_device,
                                  dtype=torch.int32) % 64,
                     torch.ones(256, device=cuda_device, dtype=torch.int32))
    want = atomics.execute(tbl, op, backend="sort")
    cfg = TuningConfig(min_events=8, min_samples=2, cooldown_updates=0)
    with telemetry.capture() as buf:
        with SpecController(cfg, device="cuda") as ctrl:
            first = atomics.execute(tbl, op)
            for _ in range(8):
                telemetry.record("atomics.execute", tier="local",
                                 backend="onehot", op="faa", n=256,
                                 predicted_s=1e-5, measured_s=2e-5)
            assert ctrl.step() == "apply"
            assert ctrl.active == dataclasses.replace(
                ctrl.base, gather_elem_s=2 * ctrl.base.gather_elem_s)
            second = atomics.execute(tbl, op)
    evs = [e for e in buf.events if e["event"] == "atomics.execute"
           and e.get("traced") is False]         # the real calls
    assert len(evs) == 2 and evs[0]["backend"] == "sort"
    assert evs[-1]["backend"] != "sort"
    assert evs[-1]["backend"] == rmw_engine.select_backend(
        "faa", 256, 64, ctrl.active, dtype=torch.int32, device="cuda")
    for got in (first, second):
        assert torch.equal(got.table.data, want.table.data)
        assert torch.equal(got.fetched, want.fetched)


@pytest.mark.gpu
def test_sync_every_measures_one_call_in_k_on_the_card(cuda_device):
    """Beside a sink of ``sync_every`` 4, 8 eager calls on the card record
    8 decision events, one measured in each run of 4; a call that collects
    stats is always measured (its contention event needs the sync
    boundary)."""
    from repro_torch import telemetry
    from repro_torch.telemetry import core
    tbl = atomics.make_table(64, torch.int32, device=cuda_device)
    op = atomics.Faa(torch.arange(16, device=cuda_device,
                                  dtype=torch.int32),
                     torch.ones(16, device=cuda_device, dtype=torch.int32))
    ring = telemetry.RingBuffer()
    ring.sync_every = 4
    telemetry.add_sink(ring, sync=True)
    assert core._sync_every == 4 and core._sync_tick == 0
    try:
        for _ in range(8):
            atomics.execute(tbl, op)
        atomics.execute(tbl, op, collect_stats=True)
    finally:
        telemetry.remove_sink(ring)
    execs = [e for e in ring.events if e["event"] == "atomics.execute"]
    assert len(execs) == 9
    measured = [("measured_s" in e) for e in execs]
    assert sum(measured[:4]) == sum(measured[4:8]) == 1 and measured[8]
    assert [e["event"] for e in ring.events].count("contention.stats") == 1


@pytest.mark.gpu
def test_every_eager_call_is_measured_by_events_on_the_card(cuda_device):
    """Beside a sink installed with sync, 8 eager calls on the card record
    8 decision events, each measured by CUDA events: pending
    (`telemetry.DeviceSeconds`) while the ring is not read, positive
    seconds once it is; a call that collects stats is timed between two
    synchronisations (a float at once) and records its contention
    event."""
    from repro_torch import telemetry
    tbl = atomics.make_table(64, torch.int32, device=cuda_device)
    op = atomics.Faa(torch.arange(16, device=cuda_device,
                                  dtype=torch.int32),
                     torch.ones(16, device=cuda_device, dtype=torch.int32))
    ring = telemetry.RingBuffer()
    telemetry.add_sink(ring, sync=True)
    try:
        for _ in range(8):
            atomics.execute(tbl, op)
        atomics.execute(tbl, op, collect_stats=True)
        pending = [type(e.get("measured_s")) for e in ring._buf
                   if e["event"] == "atomics.execute"]
    finally:
        telemetry.remove_sink(ring)
    assert pending == [telemetry.DeviceSeconds] * 8 + [float]
    execs = [e for e in ring.events if e["event"] == "atomics.execute"]
    assert len(execs) == 9
    assert all(type(e["measured_s"]) is float and e["measured_s"] > 0
               for e in execs)
    assert [e["event"] for e in ring.events].count("contention.stats") == 1


@pytest.mark.gpu
def test_sharded_moe_training_2x2_matches_local_on_the_card(cuda_device,
                                                            tmp_path,
                                                            monkeypatch):
    """Four gloo ranks sharing the card train reduced deepseek_v3 in f32
    on a 2x2 ``("data", "model")`` mesh through the expert-parallel
    layer's training variant, at the no-drop capacity factor, for 3 steps,
    against the local trainer on the card: losses and gradient norms
    within rtol 1e-5, every leaf of the final checkpoint within relative
    L2 1e-4 (`tests/_torch_train_sharded_moe_worker.py`)."""
    import _torch_train_sharded_moe_worker as MW
    from repro_torch.launch import ranks
    from repro_torch.launch import train as ttrain
    torch.cuda.empty_cache()
    sharded = ranks.launch(f"{MW.__file__}:run_card", 4,
                           mesh=((2, 2), ("data", "model")), device="cuda",
                           args=(str(tmp_path),), timeout=600)
    assert all(o == sharded[0] for o in sharded)
    monkeypatch.setattr(ttrain, "get_reduced", MW.no_drop)
    path = str(tmp_path / "local")
    got = ttrain.train(MW.ARCHS[0], ckpt_dir=path, checkpoint_every=3,
                       **{**MW.TRAIN, "device": "cuda"})
    local = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
              for h in got["history"]], got["failures"], path)
    assert MW.runs_off((*sharded[0], MW.ckpt_dir(str(tmp_path), "card")),
                       local, MW.ARCHS[0]) == []


@pytest.mark.gpu
def test_sharded_training_2x2_matches_local_on_the_card(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    """Four gloo ranks sharing the card train reduced gemma_2b in f32 on a
    2x2 ``("data", "model")`` mesh for 3 steps (`train(mesh=...)`), against
    the local trainer on the card: losses and gradient norms within rtol
    1e-5, the final checkpoint's leaves within the worker's bounds
    (`tests/_torch_train_sharded_worker.py`)."""
    import _torch_train_sharded_worker as W
    from repro_torch.launch import ranks
    from repro_torch.launch import train as ttrain
    torch.cuda.empty_cache()     # the earlier tests' cached blocks: the
    #                              ranks allocate on the same card
    sharded = ranks.launch(f"{W.__file__}:run_card", 4,
                           mesh=((2, 2), ("data", "model")), device="cuda",
                           args=(str(tmp_path),), timeout=600)
    assert all(o == sharded[0] for o in sharded)
    monkeypatch.setattr(ttrain, "get_reduced", W.f32)
    path = str(tmp_path / "local")
    got = ttrain.train("gemma_2b", ckpt_dir=path, checkpoint_every=3,
                       **{**W.TRAIN, "device": "cuda"})
    local = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
              for h in got["history"]], got["failures"], path)
    assert W.runs_off((*sharded[0], W.ckpt_dir(str(tmp_path), "card")),
                      local) == []


SWEEP_SHAPES = [("windows", 1 << 22, (1 << 20) * 5), ("global", 1 << 20,
                                                      1 << 18)]


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 8, 32])
@pytest.mark.parametrize("window", [1 << 20, (1 << 20) + 8,
                                    3 * (1 << 18) + 8])
@pytest.mark.parametrize("regime,n,m", SWEEP_SHAPES,
                         ids=[s[0] for s in SWEEP_SHAPES])
def test_table_combine_every_window_and_depth_matches_plain(cuda_device,
                                                            regime, n, m,
                                                            window, depth):
    """`table_combine` at every load depth the `prefetcher` suite runs,
    in the global regime and in windows on and off the 32-slot L2 line
    (the `unaligned` suite's widths, scaled to a table of 5 * 2^20
    slots): int32 FAA and integer-valued fp32 FAA bit for bit against the
    plain version, normal fp32 FAA within rtol 1e-5, atol 1e-5 sqrt(max
    occupancy) of a float64 sum; SWP, MIN and MAX (depth 8 only) bit for
    bit."""
    g = torch.Generator(device=cuda_device).manual_seed(window + depth)
    idx = torch.randint(0, m, (n,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    for dtype in (torch.int32, torch.float32):
        tab = torch.randint(-8, 9, (m,), generator=g, device=cuda_device,
                            dtype=torch.int32).to(dtype)
        val = torch.randint(-8, 9, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32).to(dtype)
        for op in ("faa",) if depth != K.UNROLL else ("faa", "swp", "min",
                                                      "max"):
            got = K.table_combine(tab.clone(), idx, val, op, regime,
                                  window=window, depth=depth)
            assert torch.equal(got, tref.rmw_table_ref(tab, idx, val, op)), \
                (op, dtype)
    tab = torch.randn((m,), generator=g, device=cuda_device)
    val = torch.randn((n,), generator=g, device=cuda_device)
    want = tref.rmw_table_ref(tab.double(), idx, val.double(), "faa").float()
    atol = 1e-5 * float(K.slot_counts_plain(idx, m).max()) ** 0.5
    got = K.table_combine(tab.clone(), idx, val, "faa", regime,
                          window=window, depth=depth)
    assert torch.allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.gpu
def test_event_ring_reads_what_cuda_events_read(cuda_device):
    """A pair of the event ring (`telemetry.events.EventRing`) recorded
    around a pair of ``torch.cuda.Event``s around the same kernels on the
    same stream, behind a busy stretch, reads back the torch pair's time
    and at most 10 µs more (the events between the records: 6.3-7.8 µs
    on an H100), one window of pairs in one read; the pairs of a
    `telemetry.DeviceSeconds` resolve to the ring's own reading."""
    from repro_torch import telemetry
    from repro_torch.telemetry import events as TE
    dev = cuda_device.index or 0
    ring = TE.ring(dev)
    stream = TE.raw_stream(dev)
    x = torch.randn((1 << 22,), device=cuda_device)
    pairs, torch_pairs = [], []
    # every kernel loaded and every event made first (a module load can
    # drain the stream), then the stream kept busy, so each event below is
    # stamped when the card reaches it, not when the host records it
    torch.sin(x)
    torch.cuda.Event(enable_timing=True).record()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for reps in (1, 4, 16):
        k = ring.take()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        assert ring.record(ring.handle, 2 * k, stream) == 0
        a.record()
        for _ in range(reps):
            x = torch.sin(x)
        b.record()
        assert ring.record(ring.handle, 2 * k + 1, stream) == 0
        pairs.append(k)
        torch_pairs.append((a, b))
    got = ring.read(pairs)
    torch.cuda.synchronize()
    want = [a.elapsed_time(b) / 1e3 for a, b in torch_pairs]
    assert all(w - 1e-6 <= s <= w + 10e-6 for s, w in zip(got, want)), \
        (got, want)
    assert got[0] < got[1] < got[2]
    evs = [{"measured_s": telemetry.DeviceSeconds(k, ring=ring)}
           for k in pairs]
    for ev in evs:
        telemetry.core.pend(ev)
    telemetry.resolve()
    assert [ev["measured_s"] for ev in evs] == got


# ---------------------------------------------------------------------------
# stamps the RMW kernels write
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in OPS for dt in (torch.int32, torch.float32)]
    + [("count", torch.int32)])
def test_stamps_change_no_result_bit(cuda_device, op, dtype):
    """Every regime (and FAA's load depths) of the table kernel, the
    fetched kernel and `serial_rmw`, with a stamp pair armed and without:
    bit-equal, NaN by `isnan` (FAA's values are small integers, whose
    fp32 sums are exact in any order); each armed pair reads an exit after
    its entry."""
    from repro_torch.telemetry import events as TE
    ring = TE.stamp_ring(torch.cuda.current_device())
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rng = np.random.default_rng(7)
    for n, m in ((1 << 16, 64), (3000, 700), (1 << 16, K.WINDOW_SLOTS + 8)):
        idx = torch.randint(0, m + 7, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        tab = torch.randint(-8, 9, (m,), generator=g,
                            device=cuda_device).to(dtype)
        if dtype == torch.float32 and op != "faa":
            val = torch.from_numpy(zeros_and_nans(rng, n)).to(cuda_device)
        else:
            val = torch.randint(-8, 9, (n,), generator=g,
                                device=cuda_device).to(dtype)
        runs = []
        if op in ("faa", "swp", "min", "max", "count"):
            for regime in K.table_regimes(m):
                depths = K.DEPTHS if op == "faa" and regime != "smem" \
                    else (K.UNROLL,)
                for d in depths:
                    runs.append(lambda r=regime, d=d: K.table_combine(
                        torch.zeros((m,), dtype=torch.int32,
                                    device=cuda_device) if op == "count"
                        else tab.clone(), idx,
                        None if op == "count" else val, op, r, depth=d))
        if op != "count":
            exp = 0 if op == "cas" else None
            runs.append(lambda: K.rmw_table_fetched(tab, idx, val, op,
                                                    expected=exp))
            if n <= 3000:
                runs.append(lambda: XK.serial_rmw(tab, idx, val, op, exp))
        for fn in runs:
            plain = fn()
            got, k = ring.stamp(fn)
            plain = plain if isinstance(plain, tuple) else (plain,)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(got, plain):
                same_bits(a, b.cpu().numpy(), f"{op} n={n} m={m}") \
                    if a.dtype == torch.float32 else \
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
            assert ring.read([k])[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(4096, 1024), (1 << 22, 1 << 20)])
def test_stamped_seconds_agree_with_event_seconds(cuda_device, n, m):
    """1,024 ``cuda``-backend calls (FAA of ``n`` ops over ``m`` int32
    slots, fetched), enqueued back to back, each timed by a pair of the
    event ring recorded around it and by the stamps its kernels write:
    every stamp lies inside its events, within 2 µs (two clocks read, the
    stamps' at 32 ns and the events' at about 0.5 µs).  At the tuning
    gate's call (4,096 over 1,024) the host enqueues slower than the card
    runs the kernels, so the events also hold the card's waits for the
    host between launches and the stamps read well under them (the reason
    `atomics.execute` times by events); at 2^22 over 2^20 the card sets
    the pace and the median ratio of stamped to event seconds is at least
    0.9 (the events also hold the table's copy, 4 MB, and the scratch's
    memset, beside about 0.5 ms of kernels)."""
    from repro_torch.telemetry import events as TE
    dev = torch.cuda.current_device()
    ring, events = TE.stamp_ring(dev), TE.ring(dev)
    stream = TE.raw_stream(dev)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    tbl = atomics.make_table(m, torch.int32, device=cuda_device)
    op = atomics.Faa(torch.randint(0, m, (n,), generator=g,
                                   device=cuda_device, dtype=torch.int32),
                     torch.ones(n, dtype=torch.int32, device=cuda_device))
    for _ in range(4):
        atomics.execute(tbl, op, backend="cuda")
    st, ev = [], []
    for _ in range(32):
        ks, ke = [], []
        for _ in range(32):
            e = events.take()
            events.record(events.handle, 2 * e, stream)
            _, k = ring.stamp(lambda: atomics.execute(tbl, op,
                                                      backend="cuda"))
            events.record(events.handle, 2 * e + 1, stream)
            ks.append(k)
            ke.append(e)
        st += ring.read(ks)
        ev += events.read(ke)
    st, ev = np.array(st), np.array(ev)
    assert len(st) == 1024 and (st > 0).all()
    assert (st <= ev + 2e-6).all(), float((st - ev).max())
    if n > 4096:
        assert np.median(st / ev) >= 0.9, float(np.median(st / ev))


@pytest.mark.gpu
def test_lint_sweep_on_the_card_is_clean(cuda_device):
    """`python -m repro_torch.analysis.lint` on the card: the nine
    registered entries run there with no unsuppressed error, and with
    the findings the CPU's sweep gives (rule, file, line, suppressed)."""
    from repro_torch.analysis.findings import ERROR
    from repro_torch.analysis.lint import sweep

    def key(res):
        return {n: sorted((f.rule, f.file, f.line, f.suppressed) for f in fs)
                for n, fs in res.items()}

    card = sweep(device="cuda")
    assert len(card) == 9
    assert not [f.format() for fs in card.values() for f in fs
                if f.severity == ERROR and not f.suppressed]
    assert key(card) == key(sweep(device="cpu"))
