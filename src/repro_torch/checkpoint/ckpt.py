"""Checkpointing: atomic, async, keep-last-k, reshard-on-load.

Port of `repro.checkpoint.ckpt`, in its on-disk format, so either package
restores what the other wrote.  One directory per step:

  manifest.json — tree structure, shapes, dtypes, per-leaf sha256, and the
                  `AtomicTable` leaves' layouts (``atomic_tables``, in
                  `TableLayout.to_dict`'s format)
  arrays.npz    — the flattened leaves (``leaf_<i>``, bf16 stored as its
                  ``uint16`` view)

Leaves are numbered in the reference's order (`repro_torch.tree`: dicts by
sorted key), so ``leaf_<i>`` names the same leaf in both packages.  Writes
go to ``<dir>/tmp-<step>`` and are then renamed: a torn write is never a
valid checkpoint.

In an initialised ``torch.distributed`` world `save` is a collective: a
sharded table is gathered from its shards (one world-level gather,
`atomics.reshard.gather_table`), rank 0 alone writes, and every rank
returns once the step has landed.  `restore` reads on every rank; each
table restores through `atomics.reshard.restore_table`, which keeps this
rank's shard under the *active* mesh (`launch.mesh.use_mesh`): the
writer's extents are provenance, never trusted for placement.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.atomics.layout import dtype_name, norm_axes
from repro_torch.atomics.table import AtomicTable

PyTree = Any

log = logging.getLogger("repro_torch.checkpoint")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed integrity validation: missing or
    unreadable manifest or arrays, truncated npz, or a per-array sha256
    mismatch.  `restore_latest_valid` treats it as "walk back one step"."""


class _HostTable(NamedTuple):
    """A table leaf on the host: the whole table and its layout record."""

    data: np.ndarray
    meta: Dict


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _is_table(x) -> bool:
    return isinstance(x, AtomicTable)


def _is_host_table(x) -> bool:
    return isinstance(x, _HostTable)


def _table_meta(t: AtomicTable, layout) -> Dict:
    """Serialized layout of a live table — full extents when its mesh is
    known, axis names alone otherwise."""
    if layout is not None:
        return layout.to_dict()
    return {"num_slots": int(t.data.shape[0]),
            "dtype": dtype_name(t.data.dtype),
            "axis": list(norm_axes(t.axis)),
            "replica_axes": list(norm_axes(t.replica_axes)),
            "mesh_axes": []}


def _numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its logical dtype's name."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes' numpy bf16
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _to_host(tree: PyTree) -> PyTree:
    """Every leaf copied to the host, tables gathered whole with their
    layouts, so the caller may go on mutating the live buffers.  Every rank
    of the world calls it when the tree holds sharded tables."""
    from repro_torch.atomics import reshard

    def one(x):
        if _is_table(x):
            layout = None
            data = x.data
            if x.is_sharded and x.mesh is not None:
                layout = reshard.live_layout(x)
                data = reshard.gather_table(x.data, layout, x.mesh)
            elif not x.is_sharded:
                layout = x.layout()
            return _HostTable(_numpy(data)[0].copy(), _table_meta(x, layout))
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x, copy=True)
    return tree_util.tree_map(one, tree, is_leaf=_is_table)


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _write(ckpt_dir: str, step: int, host_tree: PyTree,
           extra: Optional[Dict]) -> str:
    """Write one step from a host tree (`_to_host`); returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_util.flatten(host_tree, is_leaf=_is_host_table)
    keys = [f"leaf_{i}" for i in range(len(leaves))]
    arrays, dtypes, tables = [], [], {}
    for key, x in zip(keys, leaves):
        if _is_host_table(x):
            tables[key] = x.meta
            x = x.data
        a, dtype = _numpy(x)
        arrays.append(a)
        dtypes.append(dtype)          # logical dtype (pre-view)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: v for k, v in zip(keys, arrays)})
    manifest = {
        "step": step,
        "treedef": tree_util.treedef_str(host_tree, is_leaf=_is_host_table),
        "keys": keys,
        "shapes": [list(v.shape) for v in arrays],
        "dtypes": dtypes,
        "atomic_tables": tables,
        # per-array integrity over the stored bytes (post bf16 view):
        # restore validates these, restore_latest_valid walks back on a
        # mismatch instead of resuming from silently corrupt state
        "checksums": {k: _sha256(v) for k, v in zip(keys, arrays)},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save; returns the final path.  In an initialised
    world every rank calls it, rank 0 writes, and all return once the step
    has landed."""
    host_tree = _to_host(tree)
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    if _writer():
        path = _write(ckpt_dir, step, host_tree, extra)
    if dist.is_initialized():
        dist.barrier()
    return path


class AsyncCheckpointer:
    """Background-thread saver with keep-last-k garbage collection.  In an
    initialised world every rank calls `save_async` (the tables' gather is
    a collective, made in the caller's thread); rank 0's thread writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        # on the host *before* the thread starts, so training can mutate
        # the live buffers at once
        host_tree = _to_host(tree)
        if not _writer():
            return

        def work():
            try:
                _write(self.ckpt_dir, step, host_tree, extra)
                self.gc()
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def gc(self) -> None:
        """Keep-last-k, with one hard guarantee: the newest step that still
        passes validation is never deleted, even when it has fallen out of
        the keep window because every newer step is corrupt.  (Validation
        walks newest-first and stops at the first valid step.)"""
        if self.keep <= 0:
            return
        steps = list_steps(self.ckpt_dir)
        keep_set = set(steps[-self.keep:])
        for s in reversed(steps):
            if validate_step(self.ckpt_dir, s):
                keep_set.add(s)      # the last validated step survives gc
                break
        for s in steps:
            if s not in keep_set:
                shutil.rmtree(os.path.join(self.ckpt_dir, f"step-{s:08d}"),
                              ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    """Steps with a plausible checkpoint directory.  Tolerant by design: a
    ``step-garbage`` name or a ``step-N`` directory whose manifest is gone
    is *skipped*, never raised."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step-"):
            continue
        try:
            step = int(name.split("-", 1)[1])
        except ValueError:
            log.warning("ignoring non-step entry %r in %s", name, ckpt_dir)
            continue
        if not os.path.isfile(os.path.join(ckpt_dir, name, "manifest.json")):
            log.warning("ignoring manifest-less checkpoint dir %r in %s",
                        name, ckpt_dir)
            continue
        out.append(step)
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step-{step:08d}")


def _load_validated(path: str, *, validate: bool = True
                    ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Read manifest and arrays, raising :class:`CheckpointCorruptError` on
    any integrity failure: unreadable manifest, missing or truncated npz, a
    manifest key absent from the archive, or (when the manifest carries
    ``checksums``) a per-array sha256 mismatch.  ``validate=False`` skips
    only the hash comparison; structural damage always raises."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest ({e})")
    try:
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            data = {k: npz[k] for k in npz.files}
    except Exception as e:  # noqa: BLE001 — BadZipFile/OSError/ValueError:
        # a truncated or torn archive surfaces differently per numpy/zlib
        # version; all of them mean the same thing here
        raise CheckpointCorruptError(f"{path}: unreadable arrays.npz ({e})")
    missing = [k for k in manifest.get("keys", []) if k not in data]
    if missing:
        raise CheckpointCorruptError(
            f"{path}: arrays.npz is missing leaves {missing[:4]}")
    checksums = manifest.get("checksums")
    if validate and checksums:
        for key, want in checksums.items():
            if key in data and _sha256(data[key]) != want:
                raise CheckpointCorruptError(
                    f"{path}: sha256 mismatch on {key!r} — array bytes do "
                    f"not match the manifest (bit rot or torn write)")
    return manifest, data


def validate_step(ckpt_dir: str, step: int) -> bool:
    """True iff the step's checkpoint passes full integrity validation."""
    try:
        _load_validated(_step_path(ckpt_dir, step))
        return True
    except CheckpointCorruptError:
        return False


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


def restore(ckpt_dir: str, step: int, like: PyTree,
            sharding_fn: Optional[Callable[[str, Any], Any]] = None,
            *, validate: bool = True) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``like``.

    ``sharding_fn(key, ref)`` may return a device per leaf, or a function
    that makes the leaf from the stored host tensor (this rank's block,
    `runtime.elastic.placement`): the reshard-on-load hook, leaves placed
    where the *current* run wants them whatever wrote the checkpoint.
    `AtomicTable` leaves in ``like`` bypass
    it (it is never called for them): they restore through
    `reshard.restore_table` under the active mesh, on their ``like``
    handle's device.  Other leaves land on their ``like`` tensor's device
    in its dtype; a ``like`` leaf that is no tensor gets the stored
    array.

    The manifest's sha256 checksums are verified before any leaf is built
    (``validate=False`` skips the hash walk); any structural or checksum
    failure raises :class:`CheckpointCorruptError`, and a structure that
    does not match ``like`` raises ``AssertionError``."""
    from repro_torch.atomics.reshard import restore_table
    manifest, data = _load_validated(_step_path(ckpt_dir, step),
                                     validate=validate)
    leaves_like = tree_util.flatten(like, is_leaf=_is_table)
    if len(leaves_like) != len(manifest["keys"]):
        raise AssertionError(
            f"checkpoint structure mismatch: {len(manifest['keys'])} "
            f"leaves stored, {len(leaves_like)} in like")
    table_meta = manifest.get("atomic_tables", {})
    new_leaves = []
    for i, (key, ref) in enumerate(zip(manifest["keys"], leaves_like)):
        arr = data[key]
        logical = manifest["dtypes"][i]
        if _is_table(ref):
            # table handles bypass sharding_fn (placement comes from the
            # handle's own contract).  A leaf the WRITER stored as a table
            # that `like` holds as a plain array takes the plain path
            # below, which keeps positional sharding_fn iterators aligned.
            new_leaves.append(restore_table(_tensor(arr, logical), like=ref,
                                            meta=table_meta.get(key)))
            continue
        if sharding_fn is not None:
            where = sharding_fn(key, ref)
            if callable(where):
                new_leaves.append(where(_tensor(arr, logical)))
                continue
            if where is not None:
                new_leaves.append(_tensor(arr, logical).to(where))
                continue
        if isinstance(ref, torch.Tensor):
            new_leaves.append(_tensor(arr, logical).to(device=ref.device,
                                                       dtype=ref.dtype))
        elif hasattr(ref, "dtype"):
            new_leaves.append(arr.astype(ref.dtype))
        else:
            new_leaves.append(arr)
    return (tree_util.unflatten(like, new_leaves, is_leaf=_is_table),
            manifest["extra"])


def restore_latest_valid(ckpt_dir: str, like: PyTree,
                         sharding_fn: Optional[Callable[[str, Any], Any]]
                         = None) -> Optional[Tuple[int, PyTree, Dict]]:
    """Restore the newest checkpoint that passes validation, walking
    *backward* past corrupt, truncated or mangled steps.

    Returns ``(step, tree, extra)`` or None when no step restores cleanly.
    Every skipped step is logged with its failure and kept on disk.
    """
    for step in reversed(list_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, like,
                                  sharding_fn=sharding_fn)
            return step, tree, extra
        except Exception as e:  # noqa: BLE001 — a corrupt manifest can
            # surface as CheckpointCorruptError, AssertionError (structure
            # mismatch), KeyError, or an np/json decode error; all mean
            # "this step is unusable, try the previous one"
            log.warning("checkpoint step %d failed validation/restore "
                        "(%s: %s); falling back to the previous step",
                        step, type(e).__name__, e)
    return None
