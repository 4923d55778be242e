"""Combining-RMW engine: backend registry + model-driven dispatch.

Port of `repro.core.rmw_engine`.  Backends:

``serialized``
    The order-faithful oracle (`core.rmw.rmw_serialized`) — the paper's
    measured hardware, and the only backend for per-op expected CAS.
``sort``
    Stable sort + segmented scan (`core.rmw.rmw_combining`).
``onehot``
    Sort-free: the batch in blocks, the table carried between blocks; within
    a block the fetched values come from the strict-lower-triangular
    same-key mask.  ``need_fetched=False`` is one scatter pass.
``cuda``
    The hand-written Hopper kernels (`kernels.rmw.ops`), in the place the
    reference gives its Pallas kernel.  int32 and fp32 tables.

Every backend produces results equal to ``rmw_serialized`` for every op it
supports (integer dtypes bit for bit; float FAA up to reassociation).

Selection (`select_backend`) is the paper's L(A, S) model as a runtime
decision: each backend prices (op, batch size, table size, device) from a
:class:`~repro_torch.core.perf_model.HardwareSpec` and the cheapest correct
backend wins.  The spec defaults by the table's device: `perf_model.H100` on
CUDA, `perf_model.cpu_default_spec()` on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import perf_model
from repro_torch.core.placement import PlacementState, Tier
from repro_torch.core.rmw import (OPS, RmwResult, _identity, rmw_combining,
                                  rmw_serialized)
from repro_torch.kernels.rmw.kernel import FETCHED_BLOCK

Tensor = torch.Tensor

#: default batch-block edge for the blocked one-hot backend
DEFAULT_ONEHOT_BLOCK = 128


def _is_uniform_expected(expected) -> bool:
    """True when CAS `expected` is one shared value (combinable form)."""
    if expected is None:
        return False
    return torch.as_tensor(expected).dim() == 0


def _device_type(device) -> str:
    return torch.device(device).type


# ---------------------------------------------------------------------------
# The sort-free one-hot backend
# ---------------------------------------------------------------------------

def rmw_onehot(table: Tensor, indices: Tensor, values: Tensor, op: str,
               expected=None, *, block: int = DEFAULT_ONEHOT_BLOCK,
               need_fetched: bool = True) -> RmwResult:
    """Serialized-equivalent RMW batch with **no sort**.

    The batch is cut into blocks of ``block`` ops; an eager loop carries the
    table (plus one scratch row for dropped/padding ops) across blocks.
    Within a block each op's exclusive per-slot prefix comes from the
    strict-lower-triangular same-key mask, and
    ``fetched[i] = combine(table_carry[idx[i]], prefix[i])``.

    ``need_fetched=False`` computes the final table in one scatter pass; the
    returned fetched/success are then zero placeholders.  Indices outside
    [0, table size) go to the scratch row; their fetched/success outputs are
    meaningless.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    values = values.to(table.dtype)
    if not need_fetched:
        return _tables_only(table, indices, values, op, expected)

    n = indices.shape[0]
    m = table.shape[0]
    dev = table.device
    b = int(min(block, max(8, n)))
    pad = (-n) % b
    nb = (n + pad) // b

    idx = indices.to(torch.int32)
    idx = torch.where((idx < 0) | (idx > m), m, idx)      # m == scratch row
    idx = torch.cat([idx, idx.new_full((pad,), m)]).long()
    val = torch.cat([values, values.new_zeros(pad)])
    acc = torch.cat([table, table[:1]])                   # scratch row at m

    pos = torch.arange(b, device=dev)
    tri = pos[:, None] > pos[None, :]                     # strict lower (B,B)
    exp = None if expected is None else torch.as_tensor(
        expected, dtype=table.dtype, device=dev)
    fetched_l, ok_l = [], []
    for k in range(nb):
        ib = idx[k * b:(k + 1) * b]
        vb = val[k * b:(k + 1) * b]
        eq_key = ib[:, None] == ib[None, :]
        same = eq_key & tri                               # j < i, same slot
        base = acc[ib]                                    # carried table value
        ok = torch.ones((b,), dtype=torch.bool, device=dev)
        if op == "faa":
            prefix = torch.where(same, vb[None, :], 0).sum(1, dtype=vb.dtype)
            fetched = base + prefix
            acc.index_add_(0, ib, vb)
        elif op in ("min", "max"):
            masked = torch.where(same, vb[None, :], _identity(op, vb.dtype))
            if op == "min":
                fetched = torch.minimum(base, masked.amin(1))
                acc.scatter_reduce_(0, ib, vb, reduce="amin")
            else:
                fetched = torch.maximum(base, masked.amax(1))
                acc.scatter_reduce_(0, ib, vb, reduce="amax")
        elif op == "swp":
            mpos = torch.where(same, pos[None, :], -1).amax(1)
            fetched = torch.where(mpos >= 0, vb[mpos.clamp(min=0)], base)
            # last collider per slot wins; earlier ones go to the scratch row
            is_last = ~(eq_key & (pos[:, None] < pos[None, :])).any(1)
            acc[torch.where(is_last, ib, m)] = vb
        else:  # cas, uniform expected
            # Serialized CAS chains compose associatively: the slot's value
            # after a collider group is `first value != expected`.
            ne = vb != exp
            fpos = torch.where(same & ne[None, :], pos[None, :], b).amin(1)
            x_excl = torch.where(fpos < b, vb[fpos.clamp(0, b - 1)], exp)
            fetched = torch.where(base == exp, x_excl, base)
            ok = fetched == exp
            write = ne & (fpos == b) & (base == exp)
            acc[torch.where(write, ib, m)] = vb
        fetched_l.append(fetched)
        ok_l.append(ok)
    if nb == 0:
        return RmwResult(acc[:m], values.new_zeros(0),
                         torch.zeros(0, dtype=torch.bool, device=dev))
    return RmwResult(acc[:m], torch.cat(fetched_l)[:n], torch.cat(ok_l)[:n])


def _tables_only(table: Tensor, indices: Tensor, values: Tensor, op: str,
                 expected) -> RmwResult:
    """Final table in one scatter pass (the sort-free 'bincount' core).

    Indices outside [0, m) — negative ones included — land on a scratch row
    past the table and drop, matching the fetched path on identical inputs.
    SWP and CAS resolve duplicates by batch position (last writer, first
    writer of a value other than `expected`), never by scatter order.
    """
    n = indices.shape[0]
    m = table.shape[0]
    dev = table.device
    zeros = (values.new_zeros(n), torch.zeros(n, dtype=torch.bool, device=dev))
    if n == 0:
        return RmwResult(table.clone(), *zeros)
    idx = indices.long()
    slot = torch.where((idx < 0) | (idx >= m), m, idx)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    if op in ("faa", "min", "max"):
        padded = torch.cat([table, table.new_zeros(1)])
        if op == "faa":
            padded.index_add_(0, slot, values)
        else:
            padded.scatter_reduce_(0, slot, values,
                                   reduce="amin" if op == "min" else "amax")
        return RmwResult(padded[:m], *zeros)
    if op == "swp":
        last = torch.full((m + 1,), -1, dtype=torch.int32, device=dev)
        last = last.scatter_reduce_(0, slot, pos, reduce="amax")[:m]
        tab = torch.where(last >= 0, values[last.clamp(min=0).long()], table)
        return RmwResult(tab, *zeros)
    # cas, uniform expected: slot = first value != expected if live
    e = torch.as_tensor(expected, dtype=table.dtype, device=dev)
    first = torch.full((m + 1,), n, dtype=torch.int32, device=dev)
    first = first.scatter_reduce_(0, slot, torch.where(values != e, pos, n),
                                  reduce="amin")[:m]
    tab = torch.where((table == e) & (first < n),
                      values[first.clamp(0, n - 1).long()], table)
    return RmwResult(tab, *zeros)


def slot_occupancy(indices: Tensor, m: int) -> Tensor:
    """(m,) int32 per-slot writer counts for a batch of slot indices: the
    onehot backend's bincount pass (`_tables_only` FAA with unit values);
    out-of-range indices drop."""
    dev = indices.device
    ones = torch.ones(indices.shape, dtype=torch.int32, device=dev)
    return _tables_only(torch.zeros((m,), dtype=torch.int32, device=dev),
                        indices, ones, "faa", None).table


def _arrival_rank_sortfree(keys: Tensor, num_keys: int, *,
                           block: int = DEFAULT_ONEHOT_BLOCK) -> Tensor:
    """Sort-free per-element arrival order among equal keys (0-based): the
    fetched value of FAA(counter[key], 1) in element order.  A dense one-hot
    cumsum for small key spaces, the blocked one-hot backend beyond."""
    n = keys.shape[0]
    k = keys.to(torch.int32)
    if n * num_keys <= (1 << 22):
        onehot = k[:, None] == torch.arange(num_keys, dtype=torch.int32,
                                            device=k.device)[None, :]
        incl = torch.cumsum(onehot.to(torch.int32), 0, dtype=torch.int32)
        return incl.gather(1, k[:, None].long())[:, 0] - 1
    return rmw_onehot(torch.zeros((num_keys,), dtype=torch.int32,
                                  device=k.device), k,
                      torch.ones((n,), dtype=torch.int32, device=k.device),
                      "faa", block=block).fetched


# ---------------------------------------------------------------------------
# Predicted-cost models (the paper's L(A,S) as a decision procedure)
# ---------------------------------------------------------------------------

def _op_for_model(op: str) -> str:
    # perf_model's RMW_OPS has no min/max; they execute like FAA (one
    # combine ALU op on the fetched line).
    return op if op in perf_model.RMW_OPS else "faa"


def _table_tier(nbytes: int) -> Tier:
    """Working tier of the table: on-chip while it fits, HBM/DRAM beyond."""
    return Tier.VMEM if nbytes <= (1 << 21) else Tier.HBM_LOCAL


def _table_state(m: int, itemsize: int = 4) -> PlacementState:
    return PlacementState(tier=_table_tier(m * itemsize))


def cost_serialized(spec: perf_model.HardwareSpec, op: str, n: int, m: int,
                    need_fetched: bool = True,
                    device_type: str = "cpu") -> float:
    """n dependent atomics, each paying the paper's full L(A, S), plus one
    loop step per op."""
    per_op = perf_model.latency(spec, _op_for_model(op), _table_state(m))
    return n * (per_op + (spec.loop_step_s or 1e-6))


def cost_sort(spec: perf_model.HardwareSpec, op: str, n: int, m: int,
              need_fetched: bool = True, device_type: str = "cpu") -> float:
    """sort (log2 n passes) + log-depth segmented scan + gather/scatter."""
    sort_pass = spec.sort_elem_pass_s or 8.0 / max(spec.combine_ops_per_s, 1.0)
    gather = spec.gather_elem_s or sort_pass / 2
    passes = max(1.0, math.log2(max(n, 2)))
    scan = max(1.0, math.log2(max(n, 2))) / max(spec.combine_ops_per_s, 1.0)
    return n * passes * sort_pass + n * scan + 4 * n * gather


def cost_onehot(spec: perf_model.HardwareSpec, op: str, n: int, m: int,
                need_fetched: bool = True, device_type: str = "cpu",
                block: int = DEFAULT_ONEHOT_BLOCK) -> float:
    """Blocked: ceil(n/B) x (B^2 contraction + table carry); scatter-only
    (O(n + m) bincount) when fetched values aren't needed."""
    gather = spec.gather_elem_s or 2e-9
    if not need_fetched:
        return (n + m) * gather
    b = min(block, max(8, n))
    blocks = -(-n // b)
    step = spec.loop_step_s or 1e-6
    mac = 2.0 * b * b / max(spec.peak_flops, 1.0)
    carry = 4.0 * m / max(spec.tier_bandwidth_Bps[_table_tier(4 * m)], 1.0)
    tier_pen = 1.0 if _table_tier(4 * m) is Tier.VMEM else 2.0
    return blocks * (mac + step + carry) + 3.0 * n * gather * tier_pen


def cost_cuda(spec: perf_model.HardwareSpec, op: str, n: int, m: int,
              need_fetched: bool = True, device_type: str = "cpu") -> float:
    """The Hopper kernels: their bytes over HBM bandwidth, plus for the
    fetched kernel one ordered chain step per block of `FETCHED_BLOCK` ops
    (publish a flag, observe it, gather: about two HBM latencies).

    Off CUDA the kernels do not run (the wrappers take their plain versions),
    so the backend is priced out of selection there.
    """
    if device_type != "cuda":
        return math.inf
    if not need_fetched and op != "cas":
        nbytes = 8.0 * n + 8.0 * m + (8.0 * m if op == "swp" else 0.0)
        return nbytes / max(spec.hbm_Bps, 1.0)
    chain = -(-n // FETCHED_BLOCK) * 2.0 * spec.tier_latency_s[Tier.HBM_LOCAL]
    return (13.0 * n + 8.0 * m) / max(spec.hbm_Bps, 1.0) + chain


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RmwBackend:
    """One way of executing an RMW batch, plus its predicted-cost model."""

    name: str
    ops: frozenset                      # ops with serialized results
    run: Callable[..., RmwResult]       # (table, indices, values, op,
                                        #  expected, need_fetched=...)
    cost: Callable[..., float]          # (spec, op, n, m, need_fetched,
                                        #  device_type)
    general_cas: bool = False           # per-op expected arrays supported?
    dtypes: Optional[frozenset] = None  # table dtypes taken (None: any)

    def supports(self, op: str, *, uniform_expected: bool = True,
                 dtype=None) -> bool:
        if op not in self.ops:
            return False
        if op == "cas" and not uniform_expected and not self.general_cas:
            return False
        if self.dtypes is not None and dtype is not None \
                and dtype not in self.dtypes:
            return False
        return True


def _run_cuda(table, indices, values, op, expected=None, need_fetched=True):
    from repro_torch.kernels.rmw import ops as kops  # keeps core import-light
    if not need_fetched and op != "cas":
        n = indices.shape[0]
        return RmwResult(kops.rmw_apply(table, indices, values, op),
                         table.new_zeros(n),
                         torch.zeros(n, dtype=torch.bool, device=table.device))
    return kops.rmw_apply_fetched(table, indices, values, op,
                                  expected=expected)


BACKENDS: Dict[str, RmwBackend] = {}


def register_backend(backend: RmwBackend) -> None:
    BACKENDS[backend.name] = backend


register_backend(RmwBackend(
    name="serialized", ops=frozenset(OPS),
    run=lambda t, i, v, op, e=None, need_fetched=True:
        rmw_serialized(t, i, v, op, e),
    cost=cost_serialized, general_cas=True))
register_backend(RmwBackend(
    name="sort", ops=frozenset(OPS),
    run=lambda t, i, v, op, e=None, need_fetched=True:
        rmw_combining(t, i, v, op, e),
    cost=cost_sort))
register_backend(RmwBackend(
    name="onehot", ops=frozenset(OPS),
    run=lambda t, i, v, op, e=None, need_fetched=True:
        rmw_onehot(t, i, v, op, e, need_fetched=need_fetched),
    cost=cost_onehot))
register_backend(RmwBackend(
    name="cuda", ops=frozenset(OPS), run=_run_cuda, cost=cost_cuda,
    dtypes=frozenset((torch.int32, torch.float32))))


# ---------------------------------------------------------------------------
# Spec selection: the platform spec by device, or a live override
# ---------------------------------------------------------------------------

# Process-wide "live spec" override.  Selectors default their spec through
# `default_spec()`, so this one indirection swaps the cost model everywhere.
# The spec only steers *selection* — every backend matches the serialized
# oracle — so a swap never changes results, only which implementation runs.
_LIVE_SPEC: Optional[perf_model.HardwareSpec] = None


def set_live_spec(spec: perf_model.HardwareSpec) -> None:
    """Install ``spec`` as the process-wide selection cost model."""
    global _LIVE_SPEC
    if not isinstance(spec, perf_model.HardwareSpec):
        raise TypeError(f"live spec must be a HardwareSpec, got {type(spec)}")
    _LIVE_SPEC = spec


def clear_live_spec() -> None:
    """Drop the live override; `default_spec()` reverts to the platform
    spec."""
    global _LIVE_SPEC
    _LIVE_SPEC = None


def live_spec() -> Optional[perf_model.HardwareSpec]:
    """The installed live override, or None."""
    return _LIVE_SPEC


def platform_spec(device="cuda") -> perf_model.HardwareSpec:
    """The priors for a device: `perf_model.H100` on CUDA, the CPU priors
    elsewhere.  (The reference's calibration file is keyed on its JAX
    backend and is never read here.)"""
    if _device_type(device) == "cuda":
        return perf_model.H100
    return perf_model.cpu_default_spec()


def default_spec(device="cuda") -> perf_model.HardwareSpec:
    """The spec selectors use when the caller passes none: the live
    override when installed, else the platform spec of ``device``."""
    if _LIVE_SPEC is not None:
        return _LIVE_SPEC
    return platform_spec(device)


class Selection(NamedTuple):
    """A selector decision plus its predicted-cost record."""

    choice: str                  # winning backend name
    predicted_s: float           # its predicted cost (the model's claim)
    costs: Dict[str, float]      # every candidate's prediction


def select_backend_with_cost(op: str, n: int, m: int,
                             spec: Optional[perf_model.HardwareSpec] = None,
                             *, uniform_expected: bool = True, dtype=None,
                             need_fetched: bool = True,
                             device="cuda") -> Selection:
    """`select_backend` returning the full predicted-cost record."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    spec = spec or default_spec(device)
    dev_type = _device_type(device)
    costs = {b.name: b.cost(spec, op, n, m, need_fetched, dev_type)
             for b in BACKENDS.values()
             if b.supports(op, uniform_expected=uniform_expected,
                           dtype=dtype)}
    choice = min(costs, key=costs.get)
    return Selection(choice, costs[choice], costs)


def select_backend(op: str, n: int, m: int,
                   spec: Optional[perf_model.HardwareSpec] = None, *,
                   uniform_expected: bool = True, dtype=None,
                   need_fetched: bool = True, device="cuda") -> str:
    """Cheapest backend whose semantics cover (op, expected-mode, dtype) on
    ``device``."""
    return select_backend_with_cost(
        op, n, m, spec, uniform_expected=uniform_expected, dtype=dtype,
        need_fetched=need_fetched, device=device).choice


def execute_backend(table: Tensor, indices: Tensor, values: Tensor, op: str,
                    expected=None, *, backend: str = "auto",
                    spec: Optional[perf_model.HardwareSpec] = None,
                    need_fetched: bool = True) -> RmwResult:
    """Run an RMW batch on the named backend ("auto" = cost-model pick for
    the table's device).  The local tier of `repro_torch.atomics.execute`.

    ``need_fetched=False`` declares that the caller consumes only ``.table``
    (for CAS, also not ``.success``): the returned fetched/success fields are
    then unspecified.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    if backend == "auto":
        backend = select_backend(
            op, int(indices.shape[0]), int(table.shape[0]), spec,
            uniform_expected=(op != "cas") or _is_uniform_expected(expected),
            dtype=table.dtype, need_fetched=need_fetched,
            device=table.device)
    try:
        b = BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"have {sorted(BACKENDS)}") from None
    if op == "cas" and not b.general_cas \
            and not _is_uniform_expected(expected):
        raise ValueError(
            f"backend {b.name!r} supports CAS only with a scalar (uniform) "
            f"`expected`; per-op expected arrays need the serialized oracle")
    return b.run(table, indices, values, op, expected,
                 need_fetched=need_fetched)
