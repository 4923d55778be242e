"""The port's device mesh: named axes over an initialised process group.

Port of `repro.launch.mesh`, and the torch form of what `jax.make_mesh`
and ``shard_map``'s named axes give the reference.  A :class:`Mesh` lays
the ranks of the ``torch.distributed`` world out row-major over its axes,
as `jax.make_mesh` lays out devices, and answers for any tuple of axis
names:

* `group(axes)` — the process group of the ranks that share this rank's
  coordinates on every other axis (made once, at construction, by every
  rank in the same order, with ``dist.new_group``);
* `size(axes)` — the group's size, what ``lax.psum(1, axes)`` is;
* `index(axes)` — this rank's index in it, major-to-minor over the tuple,
  what ``lax.axis_index(axes)`` is.

Its collectives take buffers laid out by that index (lane ``i`` of an
all-to-all goes to the member of index ``i``), whatever order the process
group gives its members.  A process group whose backend refuses a
collective for CUDA tensors (gloo, on some builds) gets that collective's
buffers copied to the host and back: `probe` finds which, once, and
`host_staged` lists them.

A mesh may cover part of the world: ``ranks`` names its members, laid out
row-major in that order (``jax.make_mesh`` over a subset of the devices).
Every rank of the world still builds it, since ``dist.new_group`` is a
collective of the whole world; a rank outside it holds no shard of its
tables (`is_member` is False) and joins only the world-level collective
(`all_gather_world`) that a migration between two meshes uses.

`use_mesh` installs a mesh as the active one and `active_mesh` returns it;
`atomics.reshard.restore_table`, `models.moe` and the checkpoint read it.
`repro_torch.sharding.use_mesh` installs the logical-axis rules beside it,
in the same state (`active_rules`), so the two never disagree.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
AxisNames = Union[str, Sequence[str]]

def _names(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """``shape`` over ``axis_names``, row-major over ``ranks`` (default:
    the whole initialised world, in rank order)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        if len(self.shape) != len(tuple(shape)):
            raise ValueError(f"mesh {tuple(shape)} needs one distinct name "
                             f"per axis, got {self.axis_names}")
        world = dist.get_world_size()
        self.ranks = tuple(range(world)) if ranks is None \
            else tuple(int(r) for r in ranks)
        if math.prod(self.shape.values()) != len(self.ranks):
            raise ValueError(f"mesh {dict(self.shape)} does not cover "
                             f"{len(self.ranks)} ranks")
        if len(set(self.ranks)) != len(self.ranks) or not all(
                0 <= r < world for r in self.ranks):
            raise ValueError(f"mesh ranks {self.ranks} are not distinct "
                             f"ranks of a world of {world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.is_member = self.rank in self.ranks
        #: this rank's flat index on the mesh (None outside it)
        self.flat = self.ranks.index(self.rank) if self.is_member else None
        self.coords = (dict(zip(self.axis_names, self._unravel(self.flat)))
                       if self.is_member else None)
        self.host_staged: set = set()
        self.exchange_s = 0.0        # wall clock inside collectives
        self.sync_timing = False     # synchronise the card around them
        # every subset of the axes, in mesh order: one group per block of
        # ranks sharing the other coordinates, made by every rank alike
        self._groups: Dict[frozenset, object] = {}
        for k in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                mine = None
                for block in self._blocks(sub):
                    pg = (dist.group.WORLD if len(block) == world
                          else dist.new_group(block))
                    if self.rank in block:
                        mine = pg
                self._groups[frozenset(sub)] = mine

    # --- layout -----------------------------------------------------------
    def _unravel(self, flat: int):
        out = []
        for size in reversed(list(self.shape.values())):
            out.append(flat % size)
            flat //= size
        return tuple(reversed(out))

    def _ravel(self, coords: Dict[str, int]) -> int:
        flat = 0
        for name in self.axis_names:
            flat = flat * self.shape[name] + coords[name]
        return flat

    def _blocks(self, sub: Tuple[str, ...]):
        """World ranks of each group along ``sub``, sorted."""
        rest = [a for a in self.axis_names if a not in sub]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            yield sorted(self.ranks[self._ravel({**dict(zip(rest, fixed)),
                                                 **dict(zip(sub, free))})]
                         for free in itertools.product(
                             *(range(self.shape[a]) for a in sub)))

    def _need_member(self):
        if not self.is_member:
            raise ValueError(f"rank {self.rank} is not on mesh "
                             f"{dict(self.shape)} over ranks {self.ranks}")

    def _check(self, axes: AxisNames) -> Tuple[str, ...]:
        names = _names(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not on mesh "
                                 f"{list(self.axis_names)}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis named twice in {names}")
        return names

    def size(self, axes: AxisNames) -> int:
        """Ranks along ``axes`` (1 for an empty tuple)."""
        return math.prod(self.shape[a] for a in self._check(axes))

    def index(self, axes: AxisNames) -> int:
        """This rank's index along ``axes``, major-to-minor over the
        tuple."""
        names = self._check(axes)
        self._need_member()
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def members(self, axes: AxisNames) -> Tuple[int, ...]:
        """Global ranks of this rank's group along ``axes``, by index."""
        names = self._check(axes)
        self._need_member()
        return tuple(self.ranks[self._ravel({**self.coords,
                                             **dict(zip(names, c))})]
                     for c in itertools.product(
                         *(range(self.shape[a]) for a in names)))

    def group(self, axes: AxisNames):
        """The process group of this rank's ranks along ``axes`` (None
        outside the mesh)."""
        return self._groups[frozenset(self._check(axes))]

    def _perm(self, axes, device):
        """Group rank (position among the sorted members) of each index;
        None where they agree."""
        members = self.members(axes)
        if list(members) == sorted(members):
            return None
        order = sorted(members)
        return torch.tensor([order.index(r) for r in members],
                            device=device)

    # --- collectives --------------------------------------------------------
    def _run(self, name: str, fn, out: Tensor, *ins: Tensor) -> Tensor:
        """Issue one collective, through the host where the backend refuses
        CUDA buffers for it (`host_staged`)."""
        if self.sync_timing and out.is_cuda:
            torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            if out.is_cuda and name in self.host_staged:
                host = out.cpu()
                fn(host, *(t.cpu() for t in ins))
                out.copy_(host)
            else:
                fn(out, *ins)
        if self.sync_timing and out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.exchange_s += time.perf_counter() - t0
        return out

    def all_to_all(self, x: Tensor, axes: AxisNames) -> Tensor:
        """Block ``i`` of ``x`` (leading dim = `size(axes)`) to the member
        of index ``i``; block ``j`` of the result from the member of index
        ``j``.  `lax.all_to_all(split_axis=0, concat_axis=0)`."""
        if not _names(axes):
            return x.clone()
        perm = self._perm(axes, x.device)
        send = x.contiguous()
        if perm is not None:
            send = torch.empty_like(x)
            send[perm] = x                 # blocks by group rank
        recv = torch.empty_like(send)
        self._run("all_to_all", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group(axes)), recv, send)
        return recv if perm is None else recv[perm]

    def reduce_scatter(self, x: Tensor, axes: AxisNames) -> Tensor:
        """Sum over ``axes``, scattered: this rank keeps chunk `index` of
        ``x``'s leading dim.  `lax.psum_scatter(tiled=True)`."""
        n = self.size(axes)
        if not _names(axes):
            return x.clone()
        perm = self._perm(axes, x.device)
        send = x.contiguous()
        if perm is not None:
            chunks = send.reshape(n, -1)
            send = torch.empty_like(chunks)
            send[perm] = chunks
            send = send.reshape(x.shape)
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        self._run("reduce_scatter", lambda o, i: dist.reduce_scatter_tensor(
            o, i, group=self.group(axes)), out, send)
        return out

    def all_gather(self, x: Tensor, axes: AxisNames) -> Tensor:
        """Every member's ``x`` stacked along dim 0 by index.
        `lax.all_gather(tiled=True)`."""
        n = self.size(axes)
        if not _names(axes):
            return x.clone()
        perm = self._perm(axes, x.device)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        self._run("all_gather", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=self.group(axes)), out, x.contiguous())
        if perm is not None:
            out = out.reshape(n, *x.shape)[perm].reshape(out.shape)
        return out

    def all_reduce(self, x: Tensor, axes: AxisNames, op: str = "sum"
                   ) -> Tensor:
        """`lax.psum` (``op="sum"``) or `lax.pmax` (``"max"``)."""
        out = x.clone()
        if not _names(axes):
            return out
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run("all_reduce", lambda o: dist.all_reduce(
            o, op=rop, group=self.group(axes)), out)

    def broadcast(self, x: Tensor, axes: AxisNames, src: int = 0) -> Tensor:
        """The member of index ``src``'s ``x`` on every member."""
        out = x.clone()
        if not _names(axes):
            return out
        root = self.members(axes)[src]
        return self._run("broadcast", lambda o: dist.broadcast(
            o, src=root, group=self.group(axes)), out)

    def all_gather_world(self, x: Tensor) -> Tensor:
        """Every rank of the world's ``x`` stacked along dim 0 by world
        rank, members of this mesh or not (every rank of the world calls
        it): the collective a migration between two meshes uses."""
        world = dist.get_world_size()
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        self._run("all_gather_world", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=dist.group.WORLD), out, x.contiguous())
        return out.reshape(world, *x.shape)

    def probe(self, device) -> Tuple[str, ...]:
        """Try each collective once on tiny ``device`` tensors over the
        whole mesh (and the world-level gather); the ones the backend
        refuses go through the host from then on.  Every rank of the world
        must call it.  Returns `host_staged`."""
        axes = self.axis_names
        n = self.size(axes)
        x = torch.zeros((n,), dtype=torch.int32, device=device)
        calls = {"all_to_all": lambda: self.all_to_all(x, axes),
                 "reduce_scatter": lambda: self.reduce_scatter(x, axes),
                 "all_gather": lambda: self.all_gather(x, axes),
                 "all_reduce": lambda: self.all_reduce(x, axes, "max"),
                 "broadcast": lambda: self.broadcast(x, axes)}
        if not self.is_member:
            calls = {}
        calls["all_gather_world"] = lambda: self.all_gather_world(x)
        for name, call in calls.items():
            try:
                call()
            except RuntimeError:
                self.host_staged.add(name)
                call()
        dist.barrier()
        return tuple(sorted(self.host_staged))

    def __repr__(self):
        where = (f"at {self.coords}" if self.is_member
                 else "outside it")
        return (f"Mesh({dict(self.shape)} over ranks {list(self.ranks)}, "
                f"rank {self.rank} {where}, {self.backend})")


# ---------------------------------------------------------------------------
# Blocks of a leaf by a partition spec (`repro_torch.sharding`)
# ---------------------------------------------------------------------------

def _sharded_dims(spec) -> list:
    """(dim, axis names) of each dim that ``spec`` shards."""
    return [(d, _names(e)) for d, e in enumerate(spec) if e]


def shard_of(full: Tensor, spec, mesh: Mesh) -> Tensor:
    """This rank's block of ``full`` under ``spec`` (one entry per leading
    dim: None, an axis name, or a tuple of them, major to minor), a
    contiguous copy: what ``jax.device_put(full, NamedSharding(mesh,
    spec))`` keeps on this rank's device.  Each sharded dim must divide
    by its axes' size."""
    out = full
    for dim, axes in _sharded_dims(spec):
        n = mesh.size(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(shard: Tensor, spec, mesh: Mesh) -> Tensor:
    """The whole leaf on every rank from each rank's `shard_of` block:
    one all-gather over every axis ``spec`` names, the blocks then laid
    back in place.  A leaf ``spec`` does not shard comes back as it is
    (no copy)."""
    dims = _sharded_dims(spec)
    if not dims:
        return shard
    counts = [mesh.size(axes) for _, axes in dims]
    out = mesh.all_gather(shard.unsqueeze(0),
                          tuple(a for _, axes in dims for a in axes))
    out = out.reshape(*counts, *shard.shape)
    where = {dim: k for k, (dim, _) in enumerate(dims)}
    order, shape = [], []
    for dim in range(shard.ndim):
        if dim in where:
            order.append(where[dim])
        order.append(len(counts) + dim)
        shape.append(shard.shape[dim] * counts[where[dim]]
                     if dim in where else shard.shape[dim])
    return out.permute(order).reshape(shape)


# ---------------------------------------------------------------------------
# The active mesh (reference: repro.sharding.use_mesh / active_mesh)
# ---------------------------------------------------------------------------

_state = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict] = None):
    """Install ``mesh`` as the active mesh for the block, with the
    logical-axis ``rules`` (`repro_torch.sharding`; none by default)."""
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", {}))
    _state.mesh, _state.rules = mesh, dict(rules or {})
    try:
        yield mesh
    finally:
        _state.mesh, _state.rules = prev


def active_mesh() -> Optional[Mesh]:
    """The mesh `use_mesh` installed, or None."""
    return getattr(_state, "mesh", None)


def active_rules() -> Dict:
    """The logical-axis rules installed with the active mesh ({} if
    none)."""
    return getattr(_state, "rules", {})
