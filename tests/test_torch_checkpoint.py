"""The port's checkpointing against the reference.

The reference's `tests/test_checkpoint.py` cases on torch trees: round
trip, listing, atomic renames, async saves with keep-last-k, structure
mismatch, the reshard-on-load hook, sha256 integrity, the walk back past
corrupt steps and the gc rule that keeps the newest valid step; and its
local-table cases (`tests/test_reshard.py`).  Then the on-disk format
across packages: a tree of f32, bf16 and int32 arrays plus a local
`AtomicTable`, written by `repro.checkpoint.ckpt.save` and restored by
the port, and the other way round, with equal manifests (leaf order,
dtypes, shapes, sha256, table layouts).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import atomics as ratomics
from repro.checkpoint import ckpt as rckpt
from repro_torch import atomics
from repro_torch.checkpoint import ckpt


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _leaves(t):
    return [t["a"], t["b"]["c"], t["b"]["d"]]


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"note": "x"})
    restored, extra = ckpt.restore(str(tmp_path), 7, t)
    assert extra["note"] == "x"
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_list(tmp_path):
    t = _tree()
    for s in (3, 10, 5):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.list_steps(str(tmp_path)) == [3, 5, 10]
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_atomic_no_torn_checkpoints(tmp_path):
    os.makedirs(tmp_path / "tmp-99")
    ckpt.save(str(tmp_path), 1, _tree())
    assert ckpt.list_steps(str(tmp_path)) == [1]


def test_async_and_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(5):
        saver.save_async(s, _tree(s))
    saver.wait()
    saver.gc()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    restored, _ = ckpt.restore(str(tmp_path), 4, _tree())
    assert torch.equal(restored["a"], _tree(4)["a"])


def test_async_save_copies_before_the_caller_mutates(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=0)
    t = _tree()
    want = t["a"].clone()
    saver.save_async(1, t)
    t["a"].add_(1.0)                  # the live buffer moves on at once
    saver.wait()
    restored, _ = ckpt.restore(str(tmp_path), 1, _tree())
    assert torch.equal(restored["a"], want)


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), 1, {"only": torch.zeros(3)})


def test_reshard_on_load_hook(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 2, t)
    placed = []

    def sharding_fn(key, ref):
        placed.append(key)
        return torch.device("cpu")

    restored, _ = ckpt.restore(str(tmp_path), 2, t, sharding_fn=sharding_fn)
    assert placed == ["leaf_0", "leaf_1", "leaf_2"]
    assert all(x.device.type == "cpu" for x in _leaves(restored))


def _corrupt_payload(tmp_path, step, needle):
    p = tmp_path / f"step-{step:08d}" / "arrays.npz"
    b = bytearray(p.read_bytes())
    at = b.find(needle)
    assert at >= 0, "payload bytes not found — test setup broken"
    b[at] ^= 0xFF
    p.write_bytes(bytes(b))


def test_corrupt_payload_detected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    assert ckpt.validate_step(str(tmp_path), 3)
    _corrupt_payload(tmp_path, 3, np.arange(5, dtype=np.int32).tobytes())
    assert not ckpt.validate_step(str(tmp_path), 3)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path), 3, t)


def test_truncated_npz_detected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    p = tmp_path / "step-00000001" / "arrays.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    with pytest.raises(ckpt.CheckpointCorruptError, match="arrays.npz"):
        ckpt.restore(str(tmp_path), 1, t)


def test_sha256_catches_valid_zip_wrong_bytes(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 2, t)
    path = tmp_path / "step-00000002"
    with np.load(path / "arrays.npz") as npz:
        zeroed = {k: np.zeros_like(npz[k]) for k in npz.files}
    np.savez(path / "arrays.npz", **zeroed)
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.restore(str(tmp_path), 2, t)
    restored, _ = ckpt.restore(str(tmp_path), 2, t, validate=False)
    assert float(restored["a"].abs().sum()) == 0.0


def test_checksum_less_manifest_still_restores(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    mpath = tmp_path / "step-00000005" / "manifest.json"
    m = json.loads(mpath.read_text())
    del m["checksums"]
    mpath.write_text(json.dumps(m))
    assert ckpt.validate_step(str(tmp_path), 5)
    restored, _ = ckpt.restore(str(tmp_path), 5, t)
    assert torch.equal(restored["b"]["c"], torch.arange(5, dtype=torch.int32))


def test_restore_latest_valid_walks_back(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, _tree(s))
    p4 = tmp_path / "step-00000004" / "arrays.npz"
    p4.write_bytes(p4.read_bytes()[:64])
    os.remove(tmp_path / "step-00000003" / "manifest.json")
    got = ckpt.restore_latest_valid(str(tmp_path), t)
    assert got is not None
    step, tree, _extra = got
    assert step == 2
    assert torch.equal(tree["a"], _tree(2)["a"])
    assert (tmp_path / "step-00000004").is_dir()


def test_restore_latest_valid_none_when_nothing_restores(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    (tmp_path / "step-00000001" / "arrays.npz").write_bytes(b"not a zip")
    assert ckpt.restore_latest_valid(str(tmp_path), t) is None
    assert ckpt.restore_latest_valid(str(tmp_path / "missing"), t) is None


def test_list_steps_tolerates_mangled_entries(tmp_path):
    ckpt.save(str(tmp_path), 7, _tree())
    os.makedirs(tmp_path / "step-garbage")
    os.makedirs(tmp_path / "step-00000009")
    assert ckpt.list_steps(str(tmp_path)) == [7]
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_gc_never_drops_newest_valid_step(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, _tree(s))
    for s in (3, 4):
        p = tmp_path / f"step-{s:08d}" / "arrays.npz"
        p.write_bytes(p.read_bytes()[:64])
    ckpt.AsyncCheckpointer(str(tmp_path), keep=2).gc()
    assert ckpt.list_steps(str(tmp_path)) == [2, 3, 4]
    got = ckpt.restore_latest_valid(str(tmp_path), _tree())
    assert got is not None and got[0] == 2


def test_checkpoint_roundtrips_local_table(tmp_path):
    tbl = atomics.AtomicTable(torch.arange(6, dtype=torch.int32))
    ckpt.save(str(tmp_path), 1, {"t": tbl, "x": torch.ones(3)})
    like = {"t": atomics.AtomicTable(torch.zeros(6, dtype=torch.int32)),
            "x": torch.zeros(3)}
    restored, _ = ckpt.restore(str(tmp_path), 1, like)
    assert isinstance(restored["t"], atomics.AtomicTable)
    assert torch.equal(restored["t"].data, torch.arange(6, dtype=torch.int32))


def test_checkpoint_table_restored_as_array_when_like_holds_array(tmp_path):
    tbl = atomics.AtomicTable(torch.arange(6, dtype=torch.int32))
    ckpt.save(str(tmp_path), 1, {"t": tbl, "x": torch.ones(3)})
    like = {"t": torch.zeros(6, dtype=torch.int32), "x": torch.zeros(3)}
    consulted = []
    restored, _ = ckpt.restore(
        str(tmp_path), 1, like,
        sharding_fn=lambda key, ref: consulted.append(key))
    assert not isinstance(restored["t"], atomics.AtomicTable)
    assert torch.equal(restored["t"], torch.arange(6, dtype=torch.int32))
    assert len(consulted) == 2


# ---------------------------------------------------------------------------
# the on-disk format across packages
# ---------------------------------------------------------------------------

def _mixed_numpy():
    """Numpy leaves for both packages; dict keys out of sorted order."""
    rng = np.random.default_rng(4)
    return {"w32": rng.normal(size=(3, 4)).astype(np.float32),
            "nested": {"y": rng.normal(size=(2,)).astype(np.float32),
                       "x": rng.integers(-9, 9, 5).astype(np.int32)},
            "bf": rng.normal(size=(6,)).astype(np.float32),
            "i": rng.integers(-99, 99, 7).astype(np.int32),
            "tbl": rng.integers(-5, 5, 8).astype(np.int32)}


def _ref_tree(a):
    return {"w32": jnp.asarray(a["w32"]),
            "nested": {"y": jnp.asarray(a["nested"]["y"]),
                       "x": jnp.asarray(a["nested"]["x"])},
            "bf": jnp.asarray(a["bf"]).astype(jnp.bfloat16),
            "i": jnp.asarray(a["i"]),
            "tbl": ratomics.AtomicTable(jnp.asarray(a["tbl"]))}


def _port_tree(a):
    t = torch.from_numpy
    return {"w32": t(a["w32"]),
            "nested": {"y": t(a["nested"]["y"]), "x": t(a["nested"]["x"])},
            "bf": t(a["bf"]).to(torch.bfloat16),
            "i": t(a["i"]),
            "tbl": atomics.AtomicTable(t(a["tbl"]))}


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("keys", "shapes", "dtypes", "atomic_tables",
                              "checksums", "treedef")}


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_both_packages_write_the_same_checkpoint(tmp_path):
    a = _mixed_numpy()
    rckpt.save(str(tmp_path / "ref"), 3, _ref_tree(a), extra={"k": 1})
    ckpt.save(str(tmp_path / "port"), 3, _port_tree(a), extra={"k": 1})
    want = _manifest(tmp_path / "ref", 3)
    got = _manifest(tmp_path / "port", 3)
    assert got == want
    assert want["dtypes"] == ["bfloat16", "int32", "int32", "float32",
                              "int32", "float32"]


def test_port_restores_the_reference_checkpoint(tmp_path):
    a = _mixed_numpy()
    rckpt.save(str(tmp_path), 2, _ref_tree(a))
    like = _port_tree({k: (np.zeros_like(v) if not isinstance(v, dict) else
                           {kk: np.zeros_like(vv) for kk, vv in v.items()})
                       for k, v in a.items()})
    got, _ = ckpt.restore(str(tmp_path), 2, like)
    want = _port_tree(a)
    assert isinstance(got["tbl"], atomics.AtomicTable)
    assert got["tbl"].axis is None
    assert torch.equal(got["tbl"].data, want["tbl"].data)
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got["bf"]),
                                  _bf16_bits(want["bf"]))
    for k in ("w32", "i"):
        assert torch.equal(got[k], want[k]), k
    for k in ("x", "y"):
        assert torch.equal(got["nested"][k], want["nested"][k]), k


def test_reference_restores_the_port_checkpoint(tmp_path):
    a = _mixed_numpy()
    ckpt.save(str(tmp_path), 2, _port_tree(a))
    like = _ref_tree({k: (np.zeros_like(v) if not isinstance(v, dict) else
                          {kk: np.zeros_like(vv) for kk, vv in v.items()})
                      for k, v in a.items()})
    got, _ = rckpt.restore(str(tmp_path), 2, like)
    want = _ref_tree(a)
    assert isinstance(got["tbl"], ratomics.AtomicTable)
    np.testing.assert_array_equal(np.asarray(got["tbl"].data), a["tbl"])
    np.testing.assert_array_equal(_bf16_bits(got["bf"]),
                                  _bf16_bits(want["bf"]))
    np.testing.assert_array_equal(np.asarray(got["w32"]), a["w32"])
    np.testing.assert_array_equal(np.asarray(got["nested"]["x"]),
                                  a["nested"]["x"])
