"""Mixture-of-Experts FFN with RMW-semantics dispatch + expert parallelism.

Port of `repro.models.moe`.  Each token's (expert, slot) assignment is a
Fetch-and-Add on the expert's arrival counter, and the overflow policy is a
choice of RMW semantics:

  * ``swp_drop_newest``   — arrival order wins: the slot rank is
                            `atomics.arrival_rank` (a sort-free one-hot FAA
                            fetch), late colliders lose;
  * ``cas_keep_top_gate`` — gate priority wins: one stable sort on
                            (expert, −gate), ties by flat index, then a
                            segmented scan.

Routing takes the top k of the router's probabilities by a stable
descending sort, so equal gates go to the lower expert, as
``jax.lax.top_k`` breaks ties.  The expert products are plain
``torch.einsum``: the reference runs them outside any Pallas kernel.

Expert parallelism (EP): under `repro_torch.launch.mesh.active_mesh()`
with a ``model`` axis larger than 1 that divides ``n_experts``, every rank
of the mesh calls `moe_ffn` together with the same global ``x`` and the
same global parameters.  Each rank cuts its shards of the parameters by
the reference's in_specs (`shard_params`) and runs ``shard_fn``'s body
on them (`_ep_ffn`, reference `moe.py:260-316`): its shard of ``x`` by
the reference's ``x_spec``
(`shard_x`), its experts' weights all-gathered over the fsdp axes
(``pod``, ``data``), the expert counts as a table-only sharded FAA
(``strategy="dense"``) and, for ``swp_drop_newest`` with the sequence
split, each assignment's global arrival rank as a *fetched* sharded FAA
compared with the global capacity, the dispatch and return as
`Mesh.all_to_all` over ``model`` (bf16 on the wire when the model runs in
bf16), and the router's mean probabilities averaged over every axis.  The
output shards are gathered back, so `moe_ffn` returns the global output
on every rank, as the reference's global array.  Without such a mesh the
same routing runs on one device.

Training takes the rank's cut instead.  The sharded train step
(`launch.steps.make_sharded_train_step`) selects it explicitly with
`training_blocks`: each rank then hands `moe_ffn` its own data cut of the
activations and holds only its experts' blocks, and `_ep_train` runs the
same body with a backward through the mesh's collectives
(`launch.mesh.cut_duplicated`, `gather_duplicated`, `gather_summed`,
`all_to_all_grad`, `sum_grad`, `all_reduce_grad`): the blocks come out of
the backward with the whole batch's gradient, the router's and the
activations' gradients are the rank's data cut's, equal along
``"model"``.  On a mesh without expert parallelism each cut runs the
local layer (`_cut_train`), its aux loss from every cut's.

A sharded serving step (`launch.steps.make_sharded_decode_step`) selects
its router through `models.tensor_parallel.cuts`, with the rank's expert
blocks placed in the layer, their rows already whole: `moe_ffn` then
gathers the rank's batch cut over the batch's axes, runs the
expert-parallel layer on the global input (the local layer without
expert parallelism) and keeps the rank's cut of the output
(`_serve_cut`).

Each stage runs in a `torch.profiler.record_function` range named
``moe.<stage>`` (route, rank, atomics, scatter, exchange, experts,
combine, weight_gather), so a profiler's trace splits the layer's time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch import atomics
from repro_torch.core.rmw import segmented_scan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import active_mesh
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """The reference's MoE parameter tree: ``router`` (d, E) f32, ``w1``
    and ``w3`` (E, d, f), ``w2`` (E, f, d), and the optional ``shared``
    MLP.  ``params["w1"]`` reads like the reference's dict."""

    def __getitem__(self, name: str):
        return getattr(self, name)


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> MoE:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = MoE()
    p.router = nn.Parameter(dense_init(gen, d, e, torch.float32))
    p.w1 = nn.Parameter(_normal(gen, (e, d, f), d ** -0.5, dtype))
    p.w3 = nn.Parameter(_normal(gen, (e, d, f), d ** -0.5, dtype))
    p.w2 = nn.Parameter(_normal(gen, (e, f, d), f ** -0.5, dtype))
    if m.n_shared_experts:
        p.shared = mlp_init(gen, d, m.d_ff_expert * m.n_shared_experts,
                            cfg.mlp_act, dtype)
    return p


# ---------------------------------------------------------------------------
# routing with RMW semantics
# ---------------------------------------------------------------------------

def _route(x2d: Tensor, router_w: Tensor, m) -> Tuple[Tensor, Tensor,
                                                      Tuple[Tensor, Tensor]]:
    """(gates (T, k), expert ids (T, k) int32, (mean probability per
    expert (E,), top-1 counts (E,)))."""
    logits = x2d.float() @ router_w.float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top k with ties to the lower index, as lax.top_k
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = srt[:, :m.top_k], order[:, :m.top_k].to(torch.int32)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # top-1 counts; a scatter of ones (not ``bincount``, whose length
    # depends on the ids' values) keeps the shape static under fake tensors
    top1 = ids[:, 0].long()
    counts = torch.zeros((m.n_experts,), dtype=torch.float32,
                         device=ids.device).index_put_(
        (top1,), torch.ones_like(top1, dtype=torch.float32), accumulate=True)
    return gates, ids, (probs.mean(0), counts)


def _priority_rank(expert_ids: Tensor, gates: Tensor, policy: str,
                   num_experts: Optional[int] = None) -> Tensor:
    """Slot rank of each assignment within its expert: the FAA counter.

    swp_drop_newest:    by arrival (flattened token order), sort-free with
                        ``num_experts``.
    cas_keep_top_gate:  by descending gate, ties by flat index: one stable
                        sort on (expert, −gate), then a segmented scan.
    """
    flat_e = expert_ids.reshape(-1).to(torch.int32)
    n = flat_e.shape[0]
    if policy == "swp_drop_newest":
        return atomics.arrival_rank(flat_e, num_experts)
    flat_g = gates.detach().reshape(-1).float()
    # lexicographic (expert, -gate, index): the minor key first, both stable
    by_gate = torch.sort(-flat_g, stable=True).indices
    order = by_gate[torch.sort(flat_e[by_gate], stable=True).indices]
    sorted_e = flat_e[order]
    seg_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                      device=flat_e.device),
                           sorted_e[1:] != sorted_e[:-1]])
    ranks_sorted = segmented_scan(
        torch.ones((n,), dtype=torch.int32, device=flat_e.device),
        seg_start, torch.add) - 1
    rank = torch.empty((n,), dtype=torch.int32, device=flat_e.device)
    # `order` is a sort permutation of arange(n): its indices are distinct
    # by construction (the reference says unique_indices=True; torch has
    # no such flag)
    rank[order] = ranks_sorted  # atomics-lint: disable=A001
    return rank


# ---------------------------------------------------------------------------
# the local (per-shard) dispatch -> compute -> combine pipeline
# ---------------------------------------------------------------------------

def _dispatch_compute(x2d: Tensor, params_local, cfg: ModelConfig,
                      n_shards: int, capacity: int, axis: Optional[str],
                      act: str, replica_axes: Tuple[str, ...] = (),
                      global_capacity: Optional[int] = None, *, mesh=None,
                      exchange=None):
    """x2d: (T, d) local tokens; ``params_local`` hold E / n_shards experts.
    With ``axis`` set, runs the EP all_to_all over that axis of ``mesh``
    (``exchange(x, axis)``, default `Mesh.all_to_all`).

    ``replica_axes`` are data-parallel axes whose ranks hold *distinct*
    tokens (writers into the shared expert counters); ``global_capacity``
    enables the sharded-FAA overflow filter for the arrival-order policy.
    """
    m = cfg.moe
    t, d = x2d.shape
    e_loc = m.n_experts // n_shards
    k = m.top_k
    dev = x2d.device
    if axis is not None and exchange is None:
        exchange = mesh.all_to_all

    with record_function("moe.route"):
        gates, ids, aux = _route(x2d, params_local["router"], m)
    flat_ids = ids.reshape(-1)                              # (T*k,)
    with record_function("moe.rank"):
        rank = _priority_rank(ids, gates, m.overflow_policy, m.n_experts)
        keep = rank < capacity

    if axis is not None:
        with record_function("moe.atomics"):
            # expert counts: a table-only FAA onto the count table sharded
            # over the EP axis (the dense psum_scatter path)
            mean_probs, _ = aux
            cnt_table = atomics.AtomicTable(
                torch.zeros((e_loc,), dtype=torch.float32, device=dev),
                axis=axis, replica_axes=replica_axes, mesh=mesh)
            cnt = atomics.execute(cnt_table, atomics.Faa(
                ids[:, 0], torch.ones((t,), dtype=torch.float32,
                                      device=dev)),
                strategy="dense", need_fetched=False)
            counts = mesh.all_gather(cnt.table.data, axis)
            aux = (mean_probs, counts)
            if global_capacity is not None \
                    and m.overflow_policy == "swp_drop_newest":
                # each assignment's FAA fetch is its arrival rank across
                # every writer, (fsdp-major, model-minor) rank order
                rank_table = atomics.AtomicTable(
                    torch.zeros((e_loc,), dtype=torch.int32, device=dev),
                    axis=axis, replica_axes=replica_axes, mesh=mesh)
                gres = atomics.execute(rank_table, atomics.Faa(
                    flat_ids, torch.ones((t * k,), dtype=torch.int32,
                                         device=dev)), need_fetched=True)
                keep = keep & (gres.fetched < global_capacity)

    with record_function("moe.scatter"):
        # slot in the send buffer: (dest shard, expert-local row, slot)
        dest = flat_ids // e_loc
        e_local = flat_ids % e_loc
        slot = dest * (e_loc * capacity) + e_local * capacity + rank
        buf_rows = n_shards * e_loc * capacity
        slot = torch.where(keep, slot, buf_rows).long()     # scratch row
        xk = torch.repeat_interleave(x2d, k, dim=0)          # (T*k, d)
        # kept slots are pairwise distinct ((dest, row, rank) is injective
        # under rank < capacity); only the scratch row takes collisions,
        # and it is sliced away whatever the write order
        send = x2d.new_zeros((buf_rows + 1, d))
        send[slot] = xk  # atomics-lint: disable=A001
        send = send[:-1]

    # bf16 wire format for the dispatch when the model runs bf16
    wire_dt = torch.bfloat16 if x2d.dtype == torch.bfloat16 else x2d.dtype
    if axis is not None:
        with record_function("moe.exchange"):
            recv = exchange(send.reshape(
                n_shards, e_loc * capacity, d).to(wire_dt), axis)
    else:
        recv = send.reshape(1, e_loc * capacity, d).to(wire_dt)

    with record_function("moe.experts"):
        # expert FFN on (n_src, E_loc, C, d)
        h_in = recv.reshape(n_shards, e_loc, capacity, d)
        w1, w3, w2 = params_local["w1"], params_local["w3"], \
            params_local["w2"]
        if act in ("swiglu", "geglu"):
            g = torch.einsum("secd,edf->secf", h_in, w1)
            u = torch.einsum("secd,edf->secf", h_in, w3)
            hidden = (F.silu(g) if act == "swiglu"
                      else F.gelu(g, approximate="tanh")) * u
        else:
            hidden = F.gelu(torch.einsum("secd,edf->secf", h_in, w1),
                            approximate="tanh")
        out = torch.einsum("secf,efd->secd", hidden, w2).to(wire_dt)

    if axis is not None:
        with record_function("moe.exchange"):
            back = exchange(out.reshape(n_shards, e_loc * capacity, d),
                            axis)
    else:
        back = out.reshape(1, e_loc * capacity, d)

    with record_function("moe.combine"):
        back = torch.cat([back.reshape(buf_rows, d),
                          back.new_zeros((1, d))], dim=0)
        expert_out = back[slot]                              # (T*k, d)
        weights = (gates.reshape(-1) * keep).to(expert_out.dtype)
        combined = (expert_out * weights[:, None]).reshape(t, k, d).sum(1)
    return combined, aux


def _aux_loss(mean_probs: Tensor, counts: Tensor, m) -> Tensor:
    total = torch.clamp(counts.sum(), min=1.0)
    frac = counts / total
    return m.n_experts * torch.sum(frac * mean_probs) * m.router_aux_weight


# ---------------------------------------------------------------------------
# expert parallelism: the shard_map's specs, as cuts of the global tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpPlan:
    """What the reference decides before its ``shard_map``
    (`moe.py:268-288`) for a global batch of (b, s) tokens."""
    ep: int
    dp_axes: Tuple[str, ...]
    dp_size: int
    b_split: bool
    seq_split: bool
    capacity: int
    replica_axes: Tuple[str, ...]
    global_capacity: Optional[int]


def ep_plan(mesh, cfg: ModelConfig, b: int, s: int) -> EpPlan:
    m = cfg.moe
    ep = mesh.shape["model"]
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp_size = _axes_size(mesh, dp_axes)
    # tiny decode batches can't split over data: replicate instead
    b_split = dp_size > 1 and b % dp_size == 0
    # split tokens over the model axis too when seq allows
    seq_split = s % ep == 0 and s >= ep
    b_loc = b // dp_size if b_split else b
    t_loc = b_loc * (s // ep if seq_split else s)
    return EpPlan(
        ep=ep, dp_axes=dp_axes, dp_size=dp_size, b_split=b_split,
        seq_split=seq_split, capacity=_capacity(t_loc, m, ep),
        replica_axes=dp_axes if b_split else (),
        global_capacity=(_capacity(t_loc * ep * (dp_size if b_split else 1),
                                   m, 1) if seq_split else None))


def shard_x(x: Tensor, mesh, plan: EpPlan) -> Tensor:
    """This rank's block of the global ``x`` (b, s, d) under the
    reference's ``x_spec``: P(dp axes | None, "model" | None, None)."""
    if plan.b_split:
        b_loc = x.shape[0] // plan.dp_size
        i = mesh.index(plan.dp_axes)
        x = x[i * b_loc:(i + 1) * b_loc]
    if plan.seq_split:
        s_loc = x.shape[1] // plan.ep
        j = mesh.index("model")
        x = x[:, j * s_loc:(j + 1) * s_loc]
    return x


def shard_params(params, mesh, cfg: ModelConfig) -> Dict[str, Tensor]:
    """This rank's shards of the global expert weights under
    P("model", fsdp, None), and the replicated router: the reference's
    ``shard_map`` in_specs."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    ep, fsdp = mesh.shape["model"], _axes_size(mesh, dp_axes)
    i, j = mesh.index("model"), mesh.index(dp_axes) if dp_axes else 0
    out = {"router": params["router"]}
    for name in ("w1", "w3", "w2"):
        w = params[name]
        e_loc, r_loc = w.shape[0] // ep, w.shape[1] // fsdp
        out[name] = w[i * e_loc:(i + 1) * e_loc,
                      j * r_loc:(j + 1) * r_loc].contiguous()
    return out


def _gather_rows(w: Tensor, mesh, axes: Tuple[str, ...]) -> Tensor:
    """``lax.all_gather(w, axes, axis=1, tiled=True)``."""
    if not axes:
        return w
    n = mesh.size(axes)
    full = mesh.all_gather(w, axes).reshape(n, *w.shape)
    return full.transpose(0, 1).reshape(w.shape[0], n * w.shape[1],
                                        *w.shape[2:])


def _gather_x(out: Tensor, mesh, plan: EpPlan) -> Tensor:
    """The global output from every rank's block (the inverse of
    `shard_x`)."""
    if plan.seq_split:
        out = mesh.all_gather(out.transpose(0, 1).contiguous(), "model") \
            .transpose(0, 1)
    if plan.b_split:
        out = mesh.all_gather(out.contiguous(), plan.dp_axes)
    return out


def _ep_ffn(params, x: Tensor, cfg: ModelConfig, mesh,
            rows_whole: bool = False):
    """The reference's ``shard_map`` on this rank: ``params`` are this
    rank's shards (`shard_params`), ``x`` the global input, cut by
    `shard_x`; the body of ``shard_fn``, then the output gathered back.
    ``rows_whole``: the shards' rows are already gathered over the fsdp
    axes (a serving step placed them once).  Returns (global out, aux
    loss) without the shared experts."""
    m = cfg.moe
    b, s, d = x.shape
    plan = ep_plan(mesh, cfg, b, s)
    xs = shard_x(x, mesh, plan)
    with record_function("moe.weight_gather"):
        rows = () if rows_whole else plan.dp_axes
        p_local = {"router": params["router"],
                   **{name: _gather_rows(params[name], mesh, rows)
                      for name in ("w1", "w3", "w2")}}
    bl, sl, _ = xs.shape
    out2d, (mp, cnt) = _dispatch_compute(
        xs.reshape(bl * sl, d), p_local, cfg, plan.ep, plan.capacity,
        "model", cfg.mlp_act, replica_axes=plan.replica_axes,
        global_capacity=plan.global_capacity, mesh=mesh)
    del p_local
    axes = ("model",) + plan.dp_axes
    mp = mesh.all_reduce(mp, axes) / mesh.size(axes)
    with record_function("moe.exchange"):
        out = _gather_x(out2d.reshape(bl, sl, d), mesh, plan)
    return out, _aux_loss(mp, cnt, m)


# ---------------------------------------------------------------------------
# expert parallelism in sharded training: this rank's cut and blocks
# ---------------------------------------------------------------------------

#: private test hooks: "gather_reduce_scatter" gives the output's gather
#: a `reduce_scatter` backward, "router_partial" leaves the router's
#: gradient partial over "model"; each must break the sharded step
_CONTROLS: frozenset = frozenset()

_training = threading.local()


def expert_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether `moe_ffn` runs expert parallelism on ``mesh``: a ``model``
    axis larger than 1 that divides the experts."""
    ep = mesh.shape.get("model", 1) if mesh is not None else 1
    return cfg.moe is not None and ep > 1 and cfg.moe.n_experts % ep == 0


@contextlib.contextmanager
def training_blocks(blocks, batch_axes: Tuple[str, ...]):
    """Select the training variant for the block: ``blocks`` pairs the
    parameters `moe_ffn` is given (an `MoE` module) with this rank's
    block of each expert weight under P("model", fsdp, None) ({"w1",
    "w3", "w2"}); under an expert-parallel mesh, `moe_ffn` on those
    parameters takes the rank's cut of the batch (cut over
    ``batch_axes``) and runs `_ep_train` on the blocks."""
    with restored(({id(p): b for p, b in blocks}, tuple(batch_axes))):
        yield


def training_state():
    """The selection `training_blocks` put in force (None outside it), for
    a recomputation in backward to install again (`restored`)."""
    return getattr(_training, "state", None)


@contextlib.contextmanager
def restored(state):
    """Put ``state`` (a `training_state`) in force for the block."""
    prev = getattr(_training, "state", None)
    _training.state = state
    try:
        yield
    finally:
        _training.state = prev


def _gather_rows_grad(w: Tensor, mesh, axes: Tuple[str, ...]) -> Tensor:
    """`_gather_rows` whose backward sums every rank's gradient of the
    rows over ``axes`` and keeps the block's (a `reduce_scatter`)."""
    if not axes:
        return w
    n = mesh.size(axes)
    full = mesh_lib.gather_summed(w, mesh, axes).reshape(n, *w.shape)
    return full.transpose(0, 1).reshape(w.shape[0], n * w.shape[1],
                                        *w.shape[2:])


def _ep_train(params, blocks: Dict[str, Tensor], x: Tensor,
              cfg: ModelConfig, mesh, batch_axes: Tuple[str, ...]):
    """One rank's expert-parallel layer in the sharded train step, with a
    backward through the mesh's collectives.

    ``x`` (b, s, d) is the rank's data cut, the same on every rank along
    ``"model"``, which all compute the same loss; ``blocks`` hold the
    rank's experts under P("model", fsdp, None).  It runs the reference's
    ``shard_fn`` on the rank's cut: its sequence chunk of ``x`` (backward:
    the chunks' gradients all-gathered), the blocks' rows gathered over
    the batch's axes (backward: summed over them and cut back to the
    block's, so the blocks come out with the whole batch's gradient), the
    router through an identity whose backward all-reduces over
    ``"model"`` (each rank routes its own chunk), the dispatch and return
    as differentiable all-to-alls, the mean probabilities averaged over
    every axis with a backward summed over the batch's axes only (the
    data cuts' weighted losses add up to the global one), and the output
    gathered over ``"model"`` (backward: the rank's chunk).  Returns (the
    cut's output (b, s, d), aux loss)."""
    m = cfg.moe
    b, s, d = x.shape
    ep = mesh.shape["model"]
    if s % ep:
        raise NotImplementedError(
            f"sharded MoE training cuts the sequence over 'model': "
            f"{s} tokens do not divide over {ep} ranks")
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    t_loc = b * (s // ep)
    xs = mesh_lib.cut_duplicated(x.transpose(0, 1), mesh, "model") \
        .transpose(0, 1)                                   # (b, s/ep, d)
    router = params["router"]
    if "router_partial" not in _CONTROLS:
        router = mesh_lib.sum_grad(router, mesh, "model")
    with record_function("moe.weight_gather"):
        p_local = {"router": router}
        for name in ("w1", "w3", "w2"):
            # a block's rows are cut over the batch's axes, or not at all
            w = blocks[name]
            p_local[name] = _gather_rows_grad(
                w, mesh, () if w.shape[1] == params[name].shape[1]
                else batch_axes)
    out2d, (mp, cnt) = _dispatch_compute(
        xs.reshape(t_loc, d), p_local, cfg, ep, _capacity(t_loc, m, ep),
        "model", cfg.mlp_act, replica_axes=batch_axes,
        global_capacity=_capacity(t_loc * ep * mesh.size(batch_axes), m, 1),
        mesh=mesh,
        exchange=lambda t, axis: mesh_lib.all_to_all_grad(t, mesh, axis))
    del p_local
    axes = ("model",) + dp_axes
    mp = mesh_lib.all_reduce_grad(mp, mesh, axes, batch_axes) \
        / mesh.size(axes)
    gather = (mesh_lib.gather_summed if "gather_reduce_scatter" in _CONTROLS
              else mesh_lib.gather_duplicated)
    with record_function("moe.exchange"):
        out = gather(out2d.reshape(b, s // ep, d).transpose(0, 1)
                     .contiguous(), mesh, "model").transpose(0, 1)
    return out, _aux_loss(mp, cnt, m)


def _cut_train(params, x: Tensor, cfg: ModelConfig, mesh,
               batch_axes: Tuple[str, ...]):
    """The layer in the sharded train step on a mesh without expert
    parallelism: the local dispatch on the rank's cut, each cut with its
    own capacity, and the aux loss from every cut's mean probabilities
    (backward summed over the batch's axes) and top-1 counts, as the
    local layer's on the whole batch."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    out2d, (mp, cnt) = _dispatch_compute(x.reshape(t, d), params, cfg, 1,
                                         _capacity(t, m, 1), None,
                                         cfg.mlp_act)
    mp = mesh_lib.all_reduce_grad(mp, mesh, batch_axes, batch_axes) \
        / mesh.size(batch_axes)
    cnt = mesh.all_reduce(cnt, batch_axes)
    return out2d.reshape(b, s, d), _aux_loss(mp, cnt, m)


def _local(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The layer on one device: (out (b, s, d), aux loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    out2d, aux = _dispatch_compute(x.reshape(t, d), params, cfg, 1,
                                   _capacity(t, m, 1), None, cfg.mlp_act)
    return out2d.reshape(b, s, d), _aux_loss(*aux, m)


def _serve_cut(params, x: Tensor, cfg: ModelConfig, mesh,
               batch_axes: Tuple[str, ...]) -> Tuple[Tensor, Tensor]:
    """The layer in a sharded serving step: ``x`` is this rank's cut of
    the batch over ``batch_axes``, gathered to the global input; the
    expert-parallel layer on the rank's expert blocks (rows whole), or the
    local layer where the mesh runs no expert parallelism; then the
    rank's cut of the global output."""
    xg = mesh.all_gather(x.contiguous(), batch_axes) if batch_axes else x
    if expert_parallel(cfg, mesh):
        out, loss = _ep_ffn(params, xg, cfg, mesh, rows_whole=True)
    else:
        out, loss = _local(params, xg, cfg)
    return (mesh_lib._own_chunk(out, mesh, batch_axes) if batch_axes
            else out), loss


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def moe_ffn(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  Inside
    `training_blocks` under a mesh, ``x`` is the rank's cut and so is the
    output (`_ep_train`, or `_cut_train` without expert parallelism); so
    it is where a sharded serving step selected the router
    (`_serve_cut`)."""
    m = cfg.moe
    mesh = active_mesh()
    state = getattr(_training, "state", None)
    serving = tp.mesh_of(params["router"])
    if state is not None and mesh is not None:
        if expert_parallel(cfg, mesh):
            out, loss = _ep_train(params, state[0][id(params)], x, cfg,
                                  mesh, state[1])
        else:
            out, loss = _cut_train(params, x, cfg, mesh, state[1])
    elif serving is not None:
        out, loss = _serve_cut(params, x, cfg, serving, tp.batch_axes())
    elif not expert_parallel(cfg, mesh):
        out, loss = _local(params, x, cfg)
    else:
        out, loss = _ep_ffn(shard_params(params, mesh, cfg), x, cfg, mesh)
    if m.n_shared_experts:
        out = out + mlp_apply(x, params["shared"], cfg.mlp_act)
    return out, loss


def _capacity(t_local: int, m, ep: int) -> int:
    per_expert = t_local * m.top_k / m.n_experts
    return max(1, int(per_expert * m.capacity_factor + 0.999))


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
