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

The differentiable collectives (`cut_duplicated`, `gather_duplicated`,
`gather_summed`, `all_to_all_grad`, `sum_grad`, `all_reduce_grad`) wrap
these calls in `torch.autograd.Function`s whose backward is derived for
the sharded train step, where ranks along an axis the batch is not cut
on duplicate the work; the expert-parallel layer's training variant
(`models.moe._ep_train`) runs on them, and so do the partitioned
products (`models.tensor_parallel`: `sum_grad` on a column product's
input, `all_reduce_grad` on a row product's output).

`make_production_mesh` describes the reference's production meshes (no
process group), and `RecordingMesh` is a mesh at one coordinate of such a
shape with no ``torch.distributed`` behind it: its collectives return
outputs of the right shape and record their wire bytes instead
(`launch.dryrun`'s).

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
    def _run(self, name: str, fn, out: Tensor, *ins: Tensor,
             axes: AxisNames = ()) -> Tensor:
        """Issue one collective over ``axes`` (None: the world), through
        the host where the backend refuses CUDA buffers for it
        (`host_staged`)."""
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
            o, i, group=self.group(axes)), recv, send, axes=axes)
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
            o, i, group=self.group(axes)), out, send, axes=axes)
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
            o, i, group=self.group(axes)), out, x.contiguous(), axes=axes)
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
            o, op=rop, group=self.group(axes)), out, axes=axes)

    def broadcast(self, x: Tensor, axes: AxisNames, src: int = 0) -> Tensor:
        """The member of index ``src``'s ``x`` on every member."""
        out = x.clone()
        if not _names(axes):
            return out
        root = self.members(axes)[src]
        return self._run("broadcast", lambda o: dist.broadcast(
            o, src=root, group=self.group(axes)), out, axes=axes)

    def all_gather_world(self, x: Tensor) -> Tensor:
        """Every rank of the world's ``x`` stacked along dim 0 by world
        rank, members of this mesh or not (every rank of the world calls
        it): the collective a migration between two meshes uses."""
        world = self.world_size()
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        self._run("all_gather_world", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=dist.group.WORLD), out, x.contiguous(), axes=None)
        return out.reshape(world, *x.shape)

    def world_size(self) -> int:
        """Ranks in the world the mesh was built in."""
        return dist.get_world_size()

    def can_exchange(self) -> bool:
        """Whether its collectives can run: the world is initialised."""
        return dist.is_initialized()

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
# The production meshes, and a mesh that records instead of exchanging
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the reference's production meshes
    (`repro.launch.mesh.make_production_mesh`): one pod, (16, 16) over
    ``("data", "model")``, 256 cards; two pods, (2, 16, 16) over
    ``("pod", "data", "model")``, 512.  A description only: it makes no
    process group (`Mesh` over a world of that size, or `RecordingMesh`
    at one of its coordinates, does)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


#: ranks of one node: the cards one NVLink domain joins (an H100 host)
NODE_RANKS = 8
#: the collective kinds of `repro.launch.hlo_stats` by `Mesh` call
HLO_KINDS = {"all_gather": "all-gather", "all_gather_world": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
             "all_to_all": "all-to-all", "broadcast": "collective-permute"}


def wire_bytes(kind: str, n: int, in_bytes: int, out_bytes: int) -> float:
    """Bytes one participant sends for a collective of ``kind`` (an
    `HLO_KINDS` value) over ``n`` ranks, ring schedules, as
    `repro.launch.hlo_stats` counts them: all-gather out (n - 1) / n,
    reduce-scatter in (n - 1) / n, all-reduce 2 in (n - 1) / n, all-to-all
    in (n - 1) / n, a permute (a broadcast) in."""
    frac = (n - 1) / n
    return {"all-gather": out_bytes * frac,
            "reduce-scatter": in_bytes * frac,
            "all-reduce": 2 * in_bytes * frac,
            "all-to-all": in_bytes * frac}.get(kind, float(in_bytes))


class RecordingMesh(Mesh):
    """A `Mesh` of ``shape`` over ``axis_names`` seen from one rank
    (``rank``, row-major: default 0), with no ``torch.distributed``: each
    collective returns an output of the right shape and dtype (its values
    are not exchanged) and is recorded instead of issued, in `calls`:
    (kind, group size, wire bytes, link), the kind and the wire bytes as
    `repro.launch.hlo_stats` names and counts them; `log` holds each
    call's axes and input shape beside.  A group inside one
    node (`NODE_RANKS` consecutive ranks) rides ``"nvlink"``, any other
    ``"ib"``.  The dry run's mesh (`launch.dryrun`), the counterpart
    of the reference's HLO parse: eager torch has no HLO text."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, shape)))
        if len(self.shape) != len(tuple(shape)):
            raise ValueError(f"mesh {tuple(shape)} needs one distinct name "
                             f"per axis, got {self.axis_names}")
        self.ranks = tuple(range(math.prod(self.shape.values())))
        if not 0 <= rank < len(self.ranks):
            raise ValueError(f"rank {rank} is not on mesh {self.shape}")
        self.rank, self.flat, self.is_member = rank, rank, True
        self.backend = "recording"
        self.coords = dict(zip(self.axis_names, self._unravel(rank)))
        self.host_staged: set = set()
        self.exchange_s, self.sync_timing = 0.0, False
        self._groups = {}
        self.calls: list = []
        #: each call's (kind, axes, input shape), in `calls`' order
        self.log: list = []

    def world_size(self) -> int:
        return len(self.ranks)

    def can_exchange(self) -> bool:
        return True

    def _perm(self, axes, device):
        return None               # no values move: the order is moot

    def group(self, axes: AxisNames):
        self._check(axes)
        return None

    def _run(self, name: str, fn, out: Tensor, *ins: Tensor,
             axes: AxisNames = ()) -> Tensor:
        members = self.ranks if axes is None else self.members(axes)
        n = len(members)
        kind = HLO_KINDS[name]
        in_bytes = (ins[0] if ins else out).nbytes
        link = ("nvlink" if len({r // NODE_RANKS for r in members}) == 1
                else "ib")
        self.calls.append((kind, n, wire_bytes(kind, n, in_bytes, out.nbytes),
                           link))
        self.log.append((kind, None if axes is None else _names(axes),
                         tuple((ins[0] if ins else out).shape)))
        return out

    def summary(self) -> Dict[str, object]:
        """The recorded calls as the dry run's record holds them:
        ``collectives`` ({kind: {"count", "wire_bytes"}}, the reference's
        form), ``total_wire_bytes``, ``wire_bytes_by_link`` and
        ``collective_groups`` (count and bytes by kind, group size and
        link)."""
        kinds: Dict[str, Dict[str, float]] = {}
        links: Dict[str, float] = {}
        groups: Dict[tuple, Dict[str, float]] = {}
        for kind, n, wire, link in self.calls:
            for d, key in ((kinds, kind), (groups, (kind, n, link))):
                e = d.setdefault(key, {"count": 0, "wire_bytes": 0.0})
                e["count"] += 1
                e["wire_bytes"] += wire
            links[link] = links.get(link, 0.0) + wire
        return {"collectives": kinds,
                "total_wire_bytes": sum(links.values()),
                "wire_bytes_by_link": links,
                "collective_groups": [
                    {"kind": k, "group": n, "link": ln, **v}
                    for (k, n, ln), v in sorted(groups.items())]}

    def __repr__(self):
        return (f"RecordingMesh({dict(self.shape)}, rank {self.rank} at "
                f"{self.coords})")


# ---------------------------------------------------------------------------
# Differentiable collectives (sharded training's expert-parallel layer)
# ---------------------------------------------------------------------------
#
# In the sharded train step every rank along an axis the batch is not cut
# on ("model") computes the same loss on the same rows: the work is
# *duplicated* along it.  Each backward below is the transpose of its
# forward for that layout, so that after backward a rank holds the
# gradient of its own data cut's loss, equal along the duplicating axes.
# All of them cut and gather along dim 0.  The serving path keeps the
# plain `Mesh` calls.

class _Collective(torch.autograd.Function):
    """``forward(x)`` on the value, ``backward(g)`` on its gradient."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_fn = backward
        return forward(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.backward_fn(grad.contiguous()), None, None


def _own_chunk(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """This rank's chunk of ``x``'s dim 0 by its index along ``axes``."""
    n = mesh.size(axes)
    size = x.shape[0] // n
    return x.narrow(0, mesh.index(axes) * size, size).contiguous()


def cut_duplicated(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """This rank's chunk of an ``x`` that every rank along ``axes`` holds
    alike; backward all-gathers the chunks' gradients, so the upstream
    gradient is whole and equal along ``axes``."""
    return _Collective.apply(x, lambda t: _own_chunk(t, mesh, axes),
                             lambda g: mesh.all_gather(g, axes))


def gather_duplicated(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """`Mesh.all_gather` into a computation every rank along ``axes``
    then duplicates; backward keeps the rank's chunk of the (equal)
    gradient.  A `reduce_scatter` there would count it ``size(axes)``
    times."""
    return _Collective.apply(x, lambda t: mesh.all_gather(t, axes),
                             lambda g: _own_chunk(g, mesh, axes))


def gather_summed(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """`Mesh.all_gather` into computations that differ along ``axes``
    (each rank its own data); backward `reduce_scatter`s, so each rank's
    chunk gets the sum of every rank's gradient for it."""
    return _Collective.apply(x, lambda t: mesh.all_gather(t, axes),
                             lambda g: mesh.reduce_scatter(g, axes))


def all_to_all_grad(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """`Mesh.all_to_all`; its transpose is the same exchange."""
    return _Collective.apply(x, lambda t: mesh.all_to_all(t, axes),
                             lambda g: mesh.all_to_all(g, axes))


def sum_grad(x: Tensor, mesh: Mesh, axes: AxisNames) -> Tensor:
    """The identity, whose backward all-reduces the gradient over
    ``axes``: for a replicated leaf each rank along ``axes`` applies to
    its own part of the data, so each holds a partial gradient."""
    return _Collective.apply(x, torch.clone,
                             lambda g: mesh.all_reduce(g, axes))


def all_reduce_grad(x: Tensor, mesh: Mesh, axes: AxisNames,
                    grad_axes: AxisNames) -> Tensor:
    """`Mesh.all_reduce` over ``axes`` whose backward all-reduces over
    ``grad_axes`` only: the axes of ``axes`` left out are ones whose ranks
    duplicate the downstream, where the gradients are equal and count
    once."""
    return _Collective.apply(x, lambda t: mesh.all_reduce(t, axes),
                             lambda g: mesh.all_reduce(g, grad_axes))


# ---------------------------------------------------------------------------
# Blocks of a leaf by a partition spec (`repro_torch.sharding`)
# ---------------------------------------------------------------------------

def _sharded_dims(spec, only: Optional[AxisNames] = None) -> list:
    """(dim, axis names) of each dim that ``spec`` shards; with ``only``,
    of each dim it shards over those axes alone (a dim sharded over some
    of them and some other axis raises)."""
    dims = [(d, _names(e)) for d, e in enumerate(spec) if e]
    if only is None:
        return dims
    only = set(_names(only))
    for d, axes in dims:
        if only.intersection(axes) and not only.issuperset(axes):
            raise ValueError(f"dim {d} of spec {spec} is sharded over "
                             f"{axes}, not within {sorted(only)}")
    return [(d, axes) for d, axes in dims if only.issuperset(axes)]


def shard_of(full: Tensor, spec, mesh: Mesh,
             axes: Optional[AxisNames] = None) -> Tensor:
    """This rank's block of ``full`` under ``spec`` (one entry per leading
    dim: None, an axis name, or a tuple of them, major to minor), a
    contiguous copy: what ``jax.device_put(full, NamedSharding(mesh,
    spec))`` keeps on this rank's device.  Each sharded dim must divide
    by its axes' size.  With ``axes``, only the dims ``spec`` shards over
    those axes are cut (``full`` is then whole along them only)."""
    out = full
    for dim, names in _sharded_dims(spec, axes):
        n = mesh.size(names)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {names} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(names) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(shard: Tensor, spec, mesh: Mesh,
                axes: Optional[AxisNames] = None) -> Tensor:
    """The whole leaf on every rank from each rank's `shard_of` block:
    one all-gather over every axis ``spec`` names, the blocks then laid
    back in place.  With ``axes``, over the dims ``spec`` shards over
    those axes only, the others kept cut (the sharded train step gathers
    a leaf its module computes on over its ``"fsdp"`` axes and keeps the
    ``"model"`` cut).  A leaf with nothing to gather comes back as it is
    (no copy)."""
    dims = _sharded_dims(spec, axes)
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
