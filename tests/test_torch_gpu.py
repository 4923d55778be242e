"""The port's CUDA kernels on the card (every test here needs a CUDA card).

Each kernel is held against its plain PyTorch version on the same device
tensors; BFS on the kernels against BFS on the plain sort backend; the SSD
kernel's composition and a full-width two-layer mamba2_780m prefill against
the plain SSD path.  This file imports no JAX, so it runs where only the
port is installed:

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
