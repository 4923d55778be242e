"""Recording layer: function -> (op log, recorded contract call sites).

Port of `repro.analysis.trace`.  A jaxpr has no counterpart in eager
torch, so `trace` runs the function once, eagerly, under a recording
``TorchDispatchMode`` while the `repro_torch.atomics.contracts` observer
records every atomics API interaction the run performs: each `execute`
call site (op kind, tier arguments, the Python frames it was called
from), each `execute_until` entry, each donating step call, and each
marked tensor (table data, an op's operands).  The log keeps every op's
name and overload, its arguments, inputs and outputs, and holds a
reference to every tensor it names, so an ``id`` is never reused within
one record.  Python stacks are taken for the scatter family only (the ops
rule A001 reads), so the log stays cheap.

Arguments may be tensors, `AtomicTable`s, pytrees of them (dicts, lists,
tuples), or :func:`spec` stand-ins, which become zeros on the device
asked for.  Tensor arguments are cloned first, so a check never changes
the caller's tensors.  Which tensors derive from the arguments is tracked
by storage as the run goes (``derived``): a constant made inside the
function does not, and rule A001 may read its values; an argument's never
count.

A run that raises is still a result: a sharded-table execute without a
mesh raises the executor's guidance ``ValueError`` — the observer already
recorded the call site, and the shard-contract rule (A005) turns
(recorded site, aborted run) into a finding instead of a crash.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.atomics import contracts
from repro_torch.atomics.ops import AtomicOp
from repro_torch.atomics.table import AtomicTable

Tensor = torch.Tensor

#: aten ops that write rows of a tensor at positions an index operand
#: names: the ops rule A001 reads, and the only ones whose Python stack
#: the log keeps (with their in-place and out variants)
WRITE_OPS = frozenset((
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "index_copy", "index_copy_", "put", "put_", "masked_scatter",
    "masked_scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_reduce",
    "index_reduce_"))

#: path fragments of frames that are machinery, never a user's: torch
#: itself and this package
_SKIP_FRAMES = ("/torch/", "repro_torch/analysis/")


class Spec(NamedTuple):
    """A stand-in argument: zeros of ``shape`` and ``dtype`` on the device
    `trace` is given (the reference's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32


def spec(shape, dtype=torch.float32) -> Spec:
    """A :class:`Spec` stand-in for `check`'s arguments."""
    return Spec(tuple(int(s) for s in shape), dtype)


Frame = Tuple[str, int, str]           # (file, line, function)


@dataclasses.dataclass
class OpRecord:
    """One op of the run (``marker`` None), or one marked tensor
    (``marker`` the role; ``args`` (tensor,), ``kwargs`` the mark's
    params)."""

    name: str                          # aten op name without "aten::"
    overload: str
    args: tuple
    kwargs: dict
    outputs: tuple
    backward: bool = False             # ran inside autograd's backward
    frames: Optional[List[Frame]] = None
    marker: Optional[str] = None


@dataclasses.dataclass
class CallSite:
    """One recorded atomics API call inside the checked function."""

    site: str              # "execute" | "execute_until" | "donate"
    kind: Optional[str] = None         # op kind for execute sites
    file: Optional[str] = None
    line: Optional[int] = None
    frames: List[Frame] = dataclasses.field(default_factory=list)
    site_id: Optional[int] = None      # joins to the marked operands
    table_sharded: bool = False
    axis_names: Tuple[str, ...] = ()
    axes_bound: Optional[bool] = None
    need_fetched: bool = True
    reverse_ranks: bool = False
    #: the op's marked tensors by role ("indices", "values", "expected"),
    #: filled by the rule engine from the log
    vars: Dict[str, Any] = dataclasses.field(default_factory=dict)
    argnums: Tuple[int, ...] = ()      # donate sites


@dataclasses.dataclass
class TraceResult:
    """Everything `rules.run` consumes."""

    log: List[OpRecord]
    error: Optional[BaseException]
    callsites: List[CallSite]
    table_tensors: List[Tensor]        # arguments that arrived as tables
    observer_errors: List[str]
    derived: Set[Any]                  # storage keys derived from the args


def storage_key(t: Tensor):
    """A key for ``t``'s storage, shared by its views: its device and
    address while the log holds it, or the tensor's own id where it has
    no bytes."""
    try:
        st = t.untyped_storage()
        if st.nbytes():
            return (t.device.type, t.device.index, st.data_ptr())
    except (RuntimeError, NotImplementedError):
        pass
    return ("id", id(t))


def _tensors(tree) -> List[Tensor]:
    """Every tensor in a nest of tuples, lists and dicts (an op's args)."""
    out: List[Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def frames_from(frame, stop) -> List[Frame]:
    """(file, line, function) of ``frame`` and its callers, innermost
    first, up to (not including) ``stop``, torch's and this package's
    frames left out."""
    out: List[Frame] = []
    while frame is not None and frame is not stop:
        code = frame.f_code
        fname = code.co_filename.replace("\\", "/")
        if not any(s in fname for s in _SKIP_FRAMES) \
                and not fname.startswith("<"):
            out.append((code.co_filename, frame.f_lineno, code.co_name))
        frame = frame.f_back
    return out


def user_site(frames: List[Frame], skip: Tuple[str, ...]
              ) -> Tuple[Optional[str], Optional[int]]:
    """(file, line) of the innermost frame outside ``skip``."""
    for f, ln, _ in frames:
        if not any(s in f.replace("\\", "/") for s in skip):
            return f, ln
    return None, None


class _Recorder(TorchDispatchMode):
    """Appends one `OpRecord` per op to ``log``; propagates which storages
    derive from the checked function's arguments."""

    def __init__(self, log: List[OpRecord], derived: Set[Any], stop):
        super().__init__()
        self.log, self.derived, self.stop = log, derived, stop

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        name = schema.name.split("::", 1)[-1]
        ins = _tensors((args, kwargs))
        outs = tuple(_tensors(out))
        if any(storage_key(t) in self.derived for t in ins):
            self.derived.update(storage_key(t) for t in outs)
        frames = None
        if name in WRITE_OPS:
            frames = frames_from(sys._getframe(1), self.stop)
        self.log.append(OpRecord(
            name=name, overload=schema.overload_name, args=tuple(args),
            kwargs=dict(kwargs), outputs=outs,
            backward=torch._C._current_graph_task_id() != -1,
            frames=frames))
        return out


def _axis_names(table: AtomicTable) -> Tuple[str, ...]:
    names: Tuple[str, ...] = ()
    for group in (table.axis, table.replica_axes):
        if group:
            names += (group,) if isinstance(group, str) else tuple(group)
    return names


def _materialize(x, device, tables: List[Tensor]):
    """The argument the run gets: tensors cloned (a Parameter stays one,
    ``requires_grad`` kept), `Spec`s as zeros on ``device``, tables with
    cloned data (their data noted in ``tables``), containers rebuilt."""
    if isinstance(x, Spec):
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    if isinstance(x, torch.nn.Parameter):
        return torch.nn.Parameter(x.detach().clone(),
                                  requires_grad=x.requires_grad)
    if isinstance(x, Tensor):
        c = x.detach().clone()
        return c.requires_grad_(x.requires_grad) if x.is_leaf else c
    if isinstance(x, AtomicTable):
        t = x.with_data(x.data.detach().clone())
        tables.append(t.data)
        return t
    if isinstance(x, dict):
        return type(x)((k, _materialize(v, device, tables))
                       for k, v in x.items())
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_materialize(v, device, tables) for v in x)
    return x


def _leaves(x) -> List[Tensor]:
    if isinstance(x, AtomicTable):
        return [x.data]
    if isinstance(x, Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def trace(fn, *args, device="cpu", **kwargs) -> TraceResult:
    """Run ``fn(*args, **kwargs)`` once, eagerly, under the recording mode
    and contract observation (module docstring)."""
    callsites: List[CallSite] = []
    log: List[OpRecord] = []
    tables: List[Tensor] = []
    args = _materialize(args, device, tables)
    kwargs = _materialize(kwargs, device, tables)
    derived: Set[Any] = {storage_key(t) for t in _leaves((args, kwargs))}
    stop = sys._getframe()

    def observer(site: str, fields: Dict[str, Any]) -> None:
        if site == contracts.MARKER:
            x = fields.pop("tensor")
            role = fields.pop("role")
            log.append(OpRecord(name=contracts.MARKER, overload="",
                                args=(x,), kwargs=fields, outputs=(),
                                marker=role))
            return
        if site == "table":
            return                      # lineage travels via the marker
        frames = frames_from(sys._getframe(1), stop)
        file, line = user_site(frames, skip=(
            "repro_torch/atomics/", "repro_torch/runtime/fault_tolerance"))
        cs = CallSite(site=site, file=file, line=line, frames=frames,
                      site_id=fields.get("site_id"))
        table = fields.get("table")
        if isinstance(table, AtomicTable):
            cs.table_sharded = table.is_sharded
            cs.axis_names = _axis_names(table)
        if site == "execute":
            op = fields.get("op")
            if isinstance(op, AtomicOp):
                cs.kind = op.kind
            cs.need_fetched = bool(fields.get("need_fetched", True))
            cs.reverse_ranks = bool(fields.get("reverse_ranks", False))
            cs.axes_bound = fields.get("axes_bound")
        elif site == "donate":
            cs.argnums = tuple(fields.get("argnums") or ())
        callsites.append(cs)

    error: Optional[BaseException] = None
    with contracts.observe(observer) as errs:
        try:
            with _Recorder(log, derived, stop):
                fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — aborted runs are results
            error = e
        observer_errors = list(errs)
    return TraceResult(log=log, error=error, callsites=callsites,
                       table_tensors=tables, observer_errors=observer_errors,
                       derived=derived)
