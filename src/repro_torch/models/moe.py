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

Each stage runs in a `torch.profiler.record_function` range named
``moe.<stage>`` (route, rank, atomics, scatter, exchange, experts,
combine, weight_gather), so a profiler's trace splits the layer's time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch import atomics
from repro_torch.core.rmw import segmented_scan
from repro_torch.launch.mesh import active_mesh
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
    counts = torch.bincount(ids[:, 0].long(),
                            minlength=m.n_experts).to(torch.float32)
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
    rank[order] = ranks_sorted
    return rank


# ---------------------------------------------------------------------------
# the local (per-shard) dispatch -> compute -> combine pipeline
# ---------------------------------------------------------------------------

def _dispatch_compute(x2d: Tensor, params_local, cfg: ModelConfig,
                      n_shards: int, capacity: int, axis: Optional[str],
                      act: str, replica_axes: Tuple[str, ...] = (),
                      global_capacity: Optional[int] = None, *, mesh=None):
    """x2d: (T, d) local tokens; ``params_local`` hold E / n_shards experts.
    With ``axis`` set, runs the EP all_to_all over that axis of ``mesh``.

    ``replica_axes`` are data-parallel axes whose ranks hold *distinct*
    tokens (writers into the shared expert counters); ``global_capacity``
    enables the sharded-FAA overflow filter for the arrival-order policy.
    """
    m = cfg.moe
    t, d = x2d.shape
    e_loc = m.n_experts // n_shards
    k = m.top_k
    dev = x2d.device

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
        # under rank < capacity); only the scratch row takes collisions
        send = x2d.new_zeros((buf_rows + 1, d))
        send[slot] = xk
        send = send[:-1]

    # bf16 wire format for the dispatch when the model runs bf16
    wire_dt = torch.bfloat16 if x2d.dtype == torch.bfloat16 else x2d.dtype
    if axis is not None:
        with record_function("moe.exchange"):
            recv = mesh.all_to_all(send.reshape(
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
            back = mesh.all_to_all(out.reshape(n_shards, e_loc * capacity,
                                               d), axis)
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


def _ep_ffn(params, x: Tensor, cfg: ModelConfig, mesh):
    """The reference's ``shard_map`` on this rank: ``params`` are this
    rank's shards (`shard_params`), ``x`` the global input, cut by
    `shard_x`; the body of ``shard_fn``, then the output gathered back.
    Returns (global out, aux loss) without the shared experts."""
    m = cfg.moe
    b, s, d = x.shape
    plan = ep_plan(mesh, cfg, b, s)
    xs = shard_x(x, mesh, plan)
    with record_function("moe.weight_gather"):
        p_local = {"router": params["router"],
                   **{name: _gather_rows(params[name], mesh, plan.dp_axes)
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
# public entry
# ---------------------------------------------------------------------------

def moe_ffn(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    m = cfg.moe
    mesh = active_mesh()
    b, s, d = x.shape
    if mesh is None or "model" not in mesh.shape \
            or m.n_experts % mesh.shape["model"] != 0 \
            or mesh.shape["model"] == 1:
        t = b * s
        cap = _capacity(t, m, 1)
        out2d, aux = _dispatch_compute(x.reshape(t, d), params, cfg, 1, cap,
                                       None, cfg.mlp_act)
        out = out2d.reshape(b, s, d)
        loss = _aux_loss(*aux, m)
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
