"""Port parity: `repro_torch.core.bfs` against `repro.core.bfs`.

The same Kronecker graph (one numpy generator) goes through the JAX BFS and
the port's, and the parent arrays must be bit-equal for each combiner; the
vectorised `validate_parents` must agree with the reference's set-based one,
corrupted parent arrays included.
"""

import numpy as np
import pytest
import torch

from _torch_gpu import same
from repro.core import bfs as jbfs
from repro_torch.core import bfs as tbfs


def _undirected(src, dst):
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def test_kronecker_graph_is_the_reference_generator():
    for args in ((6, 4, 2), (9, 8, 1)):
        for a, b in zip(tbfs.kronecker_graph(*args),
                        jbfs.kronecker_graph(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["cas", "swp", "faa"])
@pytest.mark.parametrize("scale", [8, 9])
def test_bfs_parents_match_reference(op, scale):
    s, d = _undirected(*jbfs.kronecker_graph(scale, 8, seed=scale))
    root = int(s[0])
    n = 1 << scale
    want = jbfs.bfs(s, d, n, root=root, op=op)
    for backend in ("auto", "cuda"):
        got = tbfs.bfs(s, d, n, root=root, op=op, backend=backend,
                       device="cpu")
        assert got.parent.dtype == torch.int32
        same(got.parent, want.parent, f"{op}/{backend}")
        assert got.levels == want.levels
        assert got.edges_traversed == want.edges_traversed
        assert tbfs.validate_parents(s, d, got.parent, root)


def test_bfs_all_ops_reach_same_vertex_set():
    s, d = _undirected(*tbfs.kronecker_graph(9, 8, seed=1))
    root = int(s[0])
    reached = [tbfs.bfs(s, d, 512, root=root, op=op, backend="sort",
                        device="cpu").parent >= 0
               for op in ("cas", "swp", "faa")]
    assert torch.equal(reached[0], reached[1])
    assert torch.equal(reached[0], reached[2])


def test_bfs_honours_max_levels_and_rejects_unknown_op():
    s, d = _undirected(*tbfs.kronecker_graph(8, 8, seed=3))
    full = tbfs.bfs(s, d, 256, root=int(s[0]), device="cpu")
    cut = tbfs.bfs(s, d, 256, root=int(s[0]), device="cpu", max_levels=1)
    assert cut.levels == 1 < full.levels
    assert int((cut.parent >= 0).sum()) < int((full.parent >= 0).sum())
    with pytest.raises(ValueError):
        tbfs.bfs(s, d, 256, op="min", device="cpu")


def test_validate_parents_agrees_with_reference():
    s, d = _undirected(*jbfs.kronecker_graph(8, 8, seed=4))
    root = int(s[0])
    good = np.array(jbfs.bfs(s, d, 256, root=root, op="cas").parent)
    rng = np.random.default_rng(0)
    reached = np.nonzero((good >= 0) & (np.arange(256) != root))[0]
    cases = [good]
    bad_root = good.copy()
    bad_root[root] = (root + 1) % 256
    cases.append(bad_root)
    for _ in range(6):                   # a parent that is no neighbour
        p = good.copy()
        v = int(rng.choice(reached))
        p[v] = int(rng.integers(0, 256))
        cases.append(p)
    unreached = good.copy()
    unreached[reached[:5]] = -1          # dropping vertices stays valid
    cases.append(unreached)
    results = []
    for p in cases:
        want = jbfs.validate_parents(s, d, p, root)
        assert tbfs.validate_parents(s, d, p, root) == want
        assert tbfs.validate_parents(s, d, torch.from_numpy(p), root) == want
        results.append(want)
    assert results[0] and not results[1] and True in results[2:]
    assert False in results[2:]
