"""The rule engine: walk a recorded eager run and apply checkers A001-A005.

Port of `repro.analysis.rules`.  The reference walks a jaxpr; the port
walks the op log `trace.trace` recorded while the function ran once, and
the Python source of the frames the atomics call sites were issued from.

Rules
=====

A001 (error)   race detector — a scatter-family op writing an
               AtomicTable-lineage buffer without coming from a sanctioned
               RMW module (`contracts.SANCTIONED_PATHS`, any frame of the
               op's stack), or a duplicate-capable set-style write
               (``t[idx] = v``, ``scatter`` without reduce, ``index_copy``,
               ``put_``, ``masked_scatter``) / a commutative write
               (``index_put`` accumulating, ``scatter_add``,
               ``scatter_reduce``, ``index_add``, ``index_reduce``) on a
               buffer written twice, with indices that are not provably
               unique.  Lineage follows storage (views share it) and the
               functional output of a write on a table input; a ``copy_``
               into a slice carries lineage and finds nothing.
A002 (warn)    primitive strength — a `Cas` whose update value is
               ``expected + d`` / ``max(expected, x)`` / ``min`` /
               ``expected`` itself is expressible as Faa/Max/Min/a read
               (arxiv 1802.03844; `AtomicOp.CONSENSUS_NUMBER` in the
               reference).
A003 (warn)    unbounded retry — the innermost Python ``while`` around a
               CAS site (its frames' source, innermost first) whose test
               compares no name the body changes by a constant step only.
               ``for`` loops are bounded; loops in `SANCTIONED_PATHS`
               (`atomics.execute_until`) are skipped.
A004 (error)   donation safety — a name passed in a donated position of a
               `declare_donation` step is read again, in the caller's
               source, after the call statement, which does not rebind
               it.  The API-level half lives in `analysis.check_recovery`.
A005 (error)   shard contract — an `execute` on a sharded table whose
               mesh does not bind its axes, or mixed ``reverse_ranks``
               directions over one combine tree whose forward pass never
               fetched.

Ops that run inside autograd's backward are the derivatives of forward
ops the rules already read; they carry lineage but are not checked.
Eager loops repeat ops, so `run` returns one finding per (rule, file,
line, provenance).
"""

from __future__ import annotations

import ast
import functools
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.atomics import contracts
from repro_torch.analysis.findings import Finding, make_finding
from repro_torch.analysis.trace import (CallSite, OpRecord, TraceResult,
                                        storage_key, user_site)

Tensor = torch.Tensor

#: set-style writes: duplicate indices leave an undefined winner
SET_WRITES = frozenset(("index_put", "index_put_", "_index_put_impl_",
                        "scatter", "scatter_", "index_copy", "index_copy_",
                        "put", "put_", "masked_scatter", "masked_scatter_"))
#: duplicate-commutative writes
COMMUTATIVE_WRITES = frozenset(("scatter_add", "scatter_add_",
                                "scatter_reduce", "scatter_reduce_",
                                "index_add", "index_add_", "index_reduce",
                                "index_reduce_"))

#: ops that pass their first tensor's values through unchanged in order
#: and distinctness (views, copies, dtype casts): resolved through when
#: chasing a value to the op that computes it
_TRANSPARENT = frozenset((
    "view", "reshape", "_unsafe_view", "_reshape_alias", "squeeze",
    "unsqueeze", "t", "transpose", "permute", "_to_copy", "clone",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "expand",
    "contiguous", "flatten", "view_as"))
#: ... of which injective (``expand`` repeats values)
_INJECTIVE = _TRANSPARENT - {"expand"}


def _is_accumulating(rec: OpRecord) -> bool:
    """Whether a write in `SET_WRITES` accumulates (``index_put`` and
    ``put_`` with ``accumulate=True``, ``scatter`` with a ``reduce``)."""
    if rec.name.startswith("scatter"):
        return "reduce" in rec.kwargs or rec.overload.endswith("reduce")
    acc = rec.kwargs.get("accumulate")
    if acc is None:
        pos = 3 if rec.name.startswith("index_put") \
            or rec.name == "_index_put_impl_" else 2
        acc = rec.args[pos] if len(rec.args) > pos else False
    return bool(acc)


def _is_inplace(rec: OpRecord) -> bool:
    return rec.name.endswith("_") or rec.overload == "out"


def _operand_and_index(rec: OpRecord) -> Tuple[Any, List[Tensor]]:
    """(the written tensor, its index tensors) of a write op."""
    a = rec.args
    name = rec.name.rstrip("_")
    if name in ("index_put", "_index_put_impl"):
        return a[0], [i for i in a[1] if isinstance(i, Tensor)]
    if name in ("put", "masked_scatter"):
        return a[0], [a[1]]
    # scatter*, index_copy, index_add, index_reduce: (self, dim, index, ..)
    return a[0], [a[2]] if len(a) > 2 and isinstance(a[2], Tensor) else []


def _loc(rec: OpRecord) -> Tuple[Optional[str], Optional[int]]:
    return user_site(rec.frames or [], skip=())


def _sanctioned(frames) -> bool:
    """True when any frame lies in a sanctioned RMW module — the write is
    the engine's own, not a bypass."""
    return any(any(p in f.replace("\\", "/")
                   for p in contracts.SANCTIONED_PATHS)
               for f, _, _ in frames or ())


class _Ctx:
    """Mutable state threaded through the walk."""

    def __init__(self, tr: TraceResult):
        self.tr = tr
        self.findings: List[Finding] = []
        self.table: Set[Any] = {storage_key(t) for t in tr.table_tensors}
        self.producer: Dict[int, OpRecord] = {}
        self._roots: Dict[Any, Any] = {}
        self.root_writes: Dict[Any, int] = {}
        self.site_map = {cs.site_id: cs for cs in tr.callsites
                         if cs.site_id is not None}

    def root(self, key):
        while key in self._roots and self._roots[key] != key:
            key = self._roots[key]
        return key

    def is_table(self, t) -> bool:
        if not isinstance(t, Tensor):
            return False
        k = storage_key(t)
        return k in self.table or self.root(k) in self.table

    def derived(self, t: Tensor) -> bool:
        return storage_key(t) in self.tr.derived

    def emit(self, rule: str, message: str, *, rec: OpRecord = None,
             file=None, line=None, provenance=None) -> None:
        if rec is not None and file is None:
            file, line = _loc(rec)
            provenance = provenance or f"aten.{rec.name}"
        self.findings.append(make_finding(rule, message, file=file,
                                          line=line, provenance=provenance))


# ---------------------------------------------------------------------------
# value chasing (A001 index provenance, A002 pattern match)
# ---------------------------------------------------------------------------

def _data_arg(rec: OpRecord) -> Optional[Tensor]:
    return next((a for a in rec.args if isinstance(a, Tensor)), None)


def _resolve(ctx: _Ctx, t, limit: int = 32):
    """Follow value-preserving ops up the producer chain."""
    for _ in range(limit):
        rec = ctx.producer.get(id(t)) if isinstance(t, Tensor) else None
        if rec is None or rec.name not in _TRANSPARENT:
            return t
        src = _data_arg(rec)
        if src is None:
            return t
        t = src
    return t


def _is_const(ctx: _Ctx, x) -> bool:
    """A Python number, or a 0-dim tensor not derived from the args."""
    if isinstance(x, (int, float, bool)):
        return True
    return isinstance(x, Tensor) and x.dim() == 0 and not ctx.derived(x)


def _unique_base(ctx: _Ctx, t, depth: int = 0):
    """Resolve ``t`` through injective ops to its base: views, copies and
    casts, ``x ± const``, and ``where`` whose data branches share one base
    (negative-index normalization ``where(x < 0, x + n, x)``).  Injective
    steps preserve distinctness, so a unique base means unique ``t``."""
    if depth > 16 or not isinstance(t, Tensor):
        return t
    rec = ctx.producer.get(id(t))
    if rec is None:
        return t
    if rec.name in _INJECTIVE:
        src = _data_arg(rec)
        return t if src is None else _unique_base(ctx, src, depth + 1)
    if rec.name in ("add", "sub", "add_", "sub_"):
        data = [a for a in rec.args[:2] if not _is_const(ctx, a)]
        if len(data) == 1 and isinstance(data[0], Tensor):
            return _unique_base(ctx, data[0], depth + 1)
        return t
    if rec.name == "where":
        branches = [b for b in rec.args[1:3] if isinstance(b, Tensor)]
        bases = [_unique_base(ctx, b, depth + 1) for b in branches]
        if len(bases) == 2 and bases[0] is bases[1]:
            return bases[0]
    return t


def _provably_unique(ctx: _Ctx, idx: Tensor) -> bool:
    """True when a write's index is collision-free by construction: a
    boolean mask, an injective chain over ``arange``, or a constant made
    inside the function that is non-negative and unique.  An index
    derived from the arguments never counts, whatever its values."""
    if idx.dtype == torch.bool:
        return True
    base = _unique_base(ctx, idx)
    rec = ctx.producer.get(id(base))
    if rec is not None and rec.name == "arange":
        return True
    if ctx.derived(base) or ctx.derived(idx):
        return False
    flat = idx.detach().reshape(-1).cpu().numpy()
    return bool((flat >= 0).all() and len(np.unique(flat)) == flat.size)


def _n_updates(idx: List[Tensor]) -> int:
    if not idx:
        return 1
    try:
        return int(torch.broadcast_shapes(*(i.shape for i in idx)).numel())
    except RuntimeError:
        return max(int(i.numel()) for i in idx)


# ---------------------------------------------------------------------------
# A001 — race detector
# ---------------------------------------------------------------------------

def _rule_a001(ctx: _Ctx, rec: OpRecord, operand, is_table: bool) -> None:
    if _sanctioned(rec.frames):
        return
    if is_table:
        ctx.emit("A001",
                 "raw scatter write into AtomicTable data bypasses "
                 "atomics.execute — duplicate-index order is undefined and "
                 "the serialized-equivalence contract is lost; route the "
                 "update through repro_torch.atomics.execute", rec=rec)
        return
    _, idx = _operand_and_index(rec)
    n = _n_updates(idx)
    if n <= 1:
        return                          # a single update cannot self-alias
    if any(i.numel() == n and _provably_unique(ctx, i) for i in idx):
        return
    root = ctx.root(storage_key(operand))
    set_style = rec.name in SET_WRITES and not _is_accumulating(rec)
    if set_style:
        ctx.emit("A001",
                 f"set-style write with potentially-aliasing dynamic "
                 f"indices ({n} updates): the order of duplicate-index "
                 f"writes is undefined — make the indices provably unique "
                 f"(an arange, or suppress with the reason they are), or "
                 f"use atomics.execute (Swp) for last-writer-wins "
                 f"semantics", rec=rec)
        return
    ctx.root_writes[root] = ctx.root_writes.get(root, 0) + 1
    if ctx.root_writes[root] > 1:
        ctx.emit("A001",
                 f"buffer receives multiple {rec.name} writes with "
                 f"potentially-aliasing indices in one run — hand-rolled "
                 f"read-modify-write; use repro_torch.atomics.execute for "
                 f"serialized-equivalent semantics", rec=rec)


def _walk(ctx: _Ctx) -> None:
    for rec in ctx.tr.log:
        if rec.marker is not None:
            x = rec.args[0]
            if rec.marker == "table":
                if isinstance(x, Tensor):
                    ctx.table.add(storage_key(x))
            elif rec.marker.startswith("op_"):
                cs = ctx.site_map.get(rec.kwargs.get("site"))
                if cs is not None and isinstance(x, Tensor):
                    cs.vars[rec.marker[3:]] = x
            continue
        for o in rec.outputs:
            ctx.producer[id(o)] = rec
        if rec.name not in SET_WRITES and rec.name not in COMMUTATIVE_WRITES:
            continue
        operand, _ = _operand_and_index(rec)
        if not isinstance(operand, Tensor):
            continue
        is_table = ctx.is_table(operand)
        if not _is_inplace(rec) and rec.outputs:
            out_key = storage_key(rec.outputs[0])
            ctx._roots[out_key] = ctx.root(storage_key(operand))
            if is_table:
                ctx.table.add(out_key)
        if not rec.backward:
            _rule_a001(ctx, rec, operand, is_table)


# ---------------------------------------------------------------------------
# A003 — unbounded-retry detector, over the source of the CAS site's frames
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _module_ast(path: str) -> Optional[ast.Module]:
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return None


def _enclosing(tree: ast.AST, line: int, kinds) -> List[ast.AST]:
    """Nodes of ``kinds`` whose lines hold ``line``, outermost first."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, kinds) and node.lineno <= line \
                <= getattr(node, "end_lineno", node.lineno):
            out.append(node)
    out.sort(key=lambda n: (n.lineno, -n.end_lineno))
    return out


def _scope(tree: ast.AST, line: int) -> ast.AST:
    """The innermost function (or the module) whose lines hold ``line``."""
    funcs = _enclosing(tree, line, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda))
    return funcs[-1] if funcs else tree


def _const_step(node: ast.AST, name: str) -> bool:
    """``name += c``, ``name -= c`` or ``name = name ± c``, c a literal."""
    if isinstance(node, ast.AugAssign):
        return isinstance(node.op, (ast.Add, ast.Sub)) \
            and isinstance(node.value, ast.Constant)
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.BinOp) \
            and isinstance(node.value.op, (ast.Add, ast.Sub)):
        l, r = node.value.left, node.value.right
        return (isinstance(l, ast.Name) and l.id == name
                and isinstance(r, ast.Constant)) or (
            isinstance(r, ast.Name) and r.id == name
            and isinstance(l, ast.Constant))
    return False


def _stores(node: ast.AST, name: str) -> List[ast.AST]:
    """The statements of ``node`` (nested) that bind ``name``."""
    out = []
    for st in ast.walk(node):
        targets = []
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            targets = [st.target]
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            targets = [i.optional_vars for i in st.items if i.optional_vars]
        elif isinstance(st, ast.NamedExpr):
            targets = [st.target]
        if any(isinstance(n, ast.Name) and n.id == name
               for t in targets for n in ast.walk(t)):
            out.append(st)
    return out


def _bounded_while(loop: ast.While) -> bool:
    """The test compares a name that the body changes only by a constant
    step (a round counter)."""
    names = {n.id for c in ast.walk(loop.test) if isinstance(c, ast.Compare)
             for n in ast.walk(c) if isinstance(n, ast.Name)}
    for name in names:
        stores = _stores(ast.Module(body=loop.body, type_ignores=[]), name)
        if stores and all(_const_step(s, name) for s in stores):
            return True
    return False


def _rule_a003(ctx: _Ctx, cs: CallSite) -> None:
    for path, line, _ in cs.frames:
        tree = _module_ast(path)
        if tree is None:
            continue
        loops = _enclosing(_scope(tree, line), line, (ast.While,))
        if not loops:
            continue
        if _sanctioned([(path, line, "")]):
            return                      # execute_until's own bounded loop
        loop = loops[-1]
        if _bounded_while(loop):
            return
        ctx.emit("A003",
                 "while loop retries a CAS with a data-dependent test and "
                 "no counter-like round bound — under contention this is "
                 "the unbounded CAS storm of arxiv 1305.5800; use "
                 "atomics.execute_until(make_ops, max_rounds=..., "
                 "policy=...) or bound the loop with a round counter",
                 file=path, line=loop.lineno, provenance="while")
        return


# ---------------------------------------------------------------------------
# A004 — donation safety (the source half)
# ---------------------------------------------------------------------------

def _rule_a004(ctx: _Ctx, cs: CallSite) -> None:
    fr = next(((p, ln) for p, ln, _ in cs.frames if not any(
        s in p.replace("\\", "/") for s in (
            "repro_torch/runtime/fault_tolerance", "repro_torch/atomics/",
            "repro_torch/tuning/"))), None)
    if fr is None:
        return
    path, line = fr
    tree = _module_ast(path)
    if tree is None:
        return
    scope = _scope(tree, line)
    stmts = [s for s in _enclosing(scope, line, (ast.stmt,))
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))]
    calls = _enclosing(scope, line, (ast.Call,))
    if not stmts or not calls:
        return
    stmt, call = stmts[-1], calls[-1]
    for i in cs.argnums:
        if i >= len(call.args) or not isinstance(call.args[i], ast.Name):
            continue
        name = call.args[i].id
        if stmt in _stores(stmt, name):
            continue                    # the call statement rebinds it
        later = sorted(
            (n for n in ast.walk(scope) if isinstance(n, ast.Name)
             and n.id == name and n.lineno > stmt.end_lineno),
            key=lambda n: (n.lineno, n.col_offset))
        if later and isinstance(later[0].ctx, ast.Load):
            ctx.emit("A004",
                     f"{name!r} is passed in donated position {i} and read "
                     f"again at line {later[0].lineno} — the step may have "
                     f"updated its buffer in place or freed it; keep a copy "
                     f"or drop the donation", file=path, line=call.lineno,
                     provenance="donate_argnums")


# ---------------------------------------------------------------------------
# A002 / A005 — call-site rules (run even when the run raised)
# ---------------------------------------------------------------------------

def _rule_a002(ctx: _Ctx, cs: CallSite) -> None:
    def _say(alt: str, why: str) -> None:
        ctx.findings.append(make_finding(
            "A002",
            f"Cas batch (consensus number inf) {why} — express it as "
            f"atomics.{alt} (consensus number 2): same cost on every tier "
            f"(the paper's headline result), combinable instead of "
            f"serialized, and no retry loop needed (arxiv 1802.03844)",
            file=cs.file, line=cs.line, provenance="atomics.Cas"))

    vals, exp = cs.vars.get("values"), cs.vars.get("expected")
    if vals is None:
        return
    if exp is not None and not ctx.derived(vals) and not ctx.derived(exp):
        try:
            v = vals.detach().cpu().numpy()
            e = np.broadcast_to(exp.detach().cpu().numpy(), v.shape)
            if np.array_equal(e, v):
                _say("execute(..., need_fetched=True) read or Swp",
                     "writes back exactly its expected value (a no-op when "
                     "it succeeds)")
                return
            diff = v - e
            if diff.size and len(np.unique(diff)) == 1:
                _say("Faa", f"always adds a constant {diff.reshape(-1)[0]} "
                            f"to its expected value")
            return
        except (TypeError, ValueError):
            return
    rv = _resolve(ctx, vals)
    re_ = _resolve(ctx, exp) if exp is not None else None
    if re_ is not None and rv is re_:
        _say("execute(..., need_fetched=True) read or Swp",
             "writes back exactly its expected value (a no-op when it "
             "succeeds)")
        return
    rec = ctx.producer.get(id(rv))
    if rec is None or re_ is None:
        return
    name = {"add": "add", "sub": "sub", "maximum": "max", "max": "max",
            "minimum": "min", "min": "min"}.get(rec.name)
    if name is None or not any(_resolve(ctx, a) is re_ for a in rec.args
                               if isinstance(a, Tensor)):
        return
    if name in ("add", "sub"):
        _say("Faa", "computes value = expected ± delta (the classic "
                    "fetch-and-add retry shape)")
    elif name == "max":
        _say("Max", "computes value = max(expected, x)")
    else:
        _say("Min", "computes value = min(expected, x)")


def _rule_a005(ctx: _Ctx, callsites: List[CallSite]) -> None:
    for cs in callsites:
        if cs.site == "execute" and cs.table_sharded \
                and cs.axes_bound is False:
            ctx.findings.append(make_finding(
                "A005",
                f"execute on a table sharded over mesh axes "
                f"{cs.axis_names!r} with those axes unbound — the table "
                f"has no mesh that can exchange, or its mesh lacks them; "
                f"build it with make_table(..., mesh=Mesh(...)) over "
                f"exactly those axes",
                file=cs.file, line=cs.line, provenance="atomics.execute"))
    by_axes: Dict[Tuple[str, ...], List[CallSite]] = {}
    for cs in callsites:
        if cs.site == "execute" and cs.table_sharded and cs.axes_bound:
            by_axes.setdefault(cs.axis_names, []).append(cs)
    for axes, group in by_axes.items():
        fwd = [c for c in group if not c.reverse_ranks]
        rev = [c for c in group if c.reverse_ranks]
        if rev and fwd and not any(c.need_fetched for c in fwd):
            c = rev[0]
            ctx.findings.append(make_finding(
                "A005",
                f"mixed reverse_ranks directions over axes {axes!r} but no "
                f"forward pass fetches pre-images (need_fetched=False "
                f"everywhere): a reversed second pass is only coherent as "
                f"a revert of fetched values (the SWP+revert scheme) — "
                f"fetch on the forward pass or drop reverse_ranks",
                file=c.file, line=c.line, provenance="atomics.execute"))


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def _dedup(findings: List[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.file, f.line, f.provenance)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def run(tr: TraceResult) -> List[Finding]:
    """Apply every rule to a recorded run; returns findings (unsorted,
    one per (rule, file, line, provenance))."""
    ctx = _Ctx(tr)
    _walk(ctx)
    _rule_a005(ctx, tr.callsites)
    for cs in tr.callsites:
        if cs.site == "execute" and cs.kind == "cas":
            _rule_a002(ctx, cs)
            _rule_a003(ctx, cs)
        elif cs.site == "donate":
            _rule_a004(ctx, cs)
    if tr.error is not None:
        # a run that raised with no diagnosed cause is itself a finding:
        # the analyzer must not report "clean" on it
        if not any(f.rule == "A005" for f in ctx.findings):
            ctx.findings.append(make_finding(
                "A000", f"run aborted: {type(tr.error).__name__}: "
                        f"{tr.error}", provenance="analysis.trace"))
    for msg in tr.observer_errors:
        ctx.findings.append(make_finding(
            "A000", f"contract observer error (analysis bug, not a code "
                    f"finding): {msg.splitlines()[-1]}",
            provenance="contracts.observe"))
    return _dedup(ctx.findings)
