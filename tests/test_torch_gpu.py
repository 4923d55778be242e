"""The port's CUDA kernels on the card (every test here needs a CUDA card).

Each kernel is held against its plain PyTorch version on the same device
tensors; BFS on the kernels against BFS on the plain sort backend.  This
file imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_gpu.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from _torch_gpu import cuda_device  # noqa: F401
from repro_torch import atomics
from repro_torch.core import bfs as tbfs
from repro_torch.kernels.rmw import kernel as K
from repro_torch.kernels.rmw import ref as tref

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
