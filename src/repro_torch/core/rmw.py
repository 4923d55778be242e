"""Vectorized RMW (read-modify-write) with the paper's atomic semantics.

Port of `repro.core.rmw`.  A *batch* of RMWs against a table executes as a
data-parallel combine-by-index whose results equal executing the batch
serially in order (the paper's hardware semantics):

* :func:`rmw_serialized` — the order-faithful oracle, one op per step (a
  Python loop: for the tests and tiny batches only).
* :func:`rmw_combining`  — stable sort + segmented scan; exact for
  FAA/SWP/MIN/MAX and for CAS with a uniform expected value.

Index conventions follow the JAX reference exactly, so the two packages agree
bit for bit on the same inputs: a negative index counts from the end of the
table, a gather clamps to the table and a scatter outside it is dropped.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

OPS = ("faa", "swp", "cas", "min", "max")


class RmwResult(NamedTuple):
    table: Tensor    # table after all ops applied
    fetched: Tensor  # per-op value seen *before* that op (serialized order)
    success: Tensor  # per-op bool; always True for non-CAS ops


# ---------------------------------------------------------------------------
# Segmented scan machinery (the classic (flag, value) monoid)
# ---------------------------------------------------------------------------

def segmented_scan(values: Tensor, seg_start: Tensor,
                   combine: Callable[[Tensor, Tensor], Tensor]) -> Tensor:
    """Inclusive segmented scan: scans ``values`` with ``combine`` but restarts
    at every True in ``seg_start``.  A log-step Hillis–Steele pass over the
    (flag, value) monoid: ceil(log2 n) elementwise steps."""
    v = values
    f = seg_start.to(torch.bool)
    n = v.shape[0]
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], combine(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def _exclusive_from_inclusive(incl: Tensor, seg_start: Tensor,
                              identity) -> Tensor:
    """Shift an inclusive segmented scan to exclusive (identity at segment
    starts)."""
    if incl.shape[0] == 0:
        return incl
    shifted = torch.roll(incl, 1, 0)
    first = seg_start.to(torch.bool).clone()
    first[0] = True
    ident = torch.full((), identity, dtype=incl.dtype, device=incl.device)
    return torch.where(first, ident, shifted)


def _sort_by_index(indices: Tensor, *arrays: Tensor):
    sorted_idx, order = torch.sort(indices, stable=True)
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    seg_start = torch.ones(n, dtype=torch.bool, device=indices.device)
    seg_start[1:] = sorted_idx[1:] != sorted_idx[:-1]
    return order, inv, sorted_idx, seg_start, tuple(a[order] for a in arrays)


def _normalize(idx: Tensor, size: int) -> Tensor:
    """Negative indices count from the end, as JAX indexing does."""
    return torch.where(idx < 0, idx + size, idx)


def _gather_clamped(table: Tensor, idx: Tensor) -> Tensor:
    """``table[idx]`` with JAX's gather semantics (normalize, then clamp)."""
    m = table.shape[0]
    return table[_normalize(idx, m).clamp(0, m - 1).long()]


def _scatter_slot(idx: Tensor, size: int) -> Tensor:
    """Scatter target with JAX's drop semantics: rows outside ``[0, size)``
    (after normalization) go to the scratch row ``size``."""
    j = _normalize(idx, size)
    return torch.where((j >= 0) & (j < size), j, size).long()


def _arrival_rank_argsort(keys: Tensor) -> Tensor:
    """Per-element arrival order among equal keys (0-based), via argsort:
    the fetch result of FAA(counter[key], 1) executed in element order."""
    _, inv, _, seg_start, _ = _sort_by_index(keys)
    ones = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    incl = segmented_scan(ones, seg_start, torch.add)
    return (incl - 1)[inv]


# ---------------------------------------------------------------------------
# Serialized oracle (paper hardware: one atomic at a time)
# ---------------------------------------------------------------------------

def rmw_serialized(table: Tensor, indices: Tensor, values: Tensor, op: str,
                   expected=None) -> RmwResult:
    """Apply ops one at a time in order; the semantics oracle.

    A host loop over numpy scalars of the table's dtype (float32 arithmetic
    stays float32, int32 wraps): meant for tests and tiny batches.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    tab = table.detach().cpu().numpy().copy()
    dt = tab.dtype
    m = tab.shape[0]
    idx = indices.detach().cpu().numpy().astype(np.int64)
    val = values.detach().cpu().numpy().astype(dt)
    n = idx.shape[0]
    exp = np.broadcast_to(np.asarray(
        0 if expected is None else (expected.detach().cpu().numpy()
                                    if isinstance(expected, Tensor)
                                    else expected), dt), (n,))
    fetched = np.zeros((n,), dt)
    success = np.ones((n,), bool)
    with np.errstate(over="ignore"):
        for k in range(n):
            i = int(idx[k])
            j = i + m if i < 0 else i
            old = tab[min(max(j, 0), m - 1)]
            v = val[k]
            if op == "faa":
                new = old + v
            elif op == "swp":
                new = v
            elif op == "min":
                new = np.minimum(old, v)
            elif op == "max":
                new = np.maximum(old, v)
            else:  # cas
                ok = bool(old == exp[k])
                success[k] = ok
                new = v if ok else old
            if 0 <= j < m:
                tab[j] = new
            fetched[k] = old
    dev = table.device
    return RmwResult(torch.from_numpy(tab).to(dev),
                     torch.from_numpy(fetched).to(dev),
                     torch.from_numpy(success).to(dev))


# ---------------------------------------------------------------------------
# Combining implementation (the paper's proposed relaxed atomics, vectorized)
# ---------------------------------------------------------------------------

def _combine_fn(op: str):
    return {"faa": torch.add, "min": torch.minimum, "max": torch.maximum}[op]


def _identity(op: str, dtype: torch.dtype):
    if op == "faa":
        return 0
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _padded(table: Tensor) -> Tensor:
    """The table plus two scratch rows: ``m`` (the reference's own scratch
    row for last-wins writes) and ``m + 1`` (dropped writes).  Callers
    return ``[:m]``."""
    return torch.cat([table, table.new_zeros(2)])


def rmw_combining(table: Tensor, indices: Tensor, values: Tensor, op: str,
                  expected=None) -> RmwResult:
    """Vectorized RMW batch, serialized-equivalent results.

    FAA/MIN/MAX: fetched = table ⊕ (exclusive segmented scan of colliders);
    SWP: fetched = previous collider's value (or the table value for the
    first); CAS: uniform expected value only (first-wins within a segment).
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    n = indices.shape[0]
    m = table.shape[0]
    values = values.to(table.dtype)
    if op == "cas":
        if expected is None:
            raise ValueError("cas requires `expected`")
        return _cas_uniform(table, indices, values, expected)

    _, inv, idx_s, seg_start, (val_s,) = _sort_by_index(indices, values)
    base = _gather_clamped(table, idx_s)
    ok = torch.ones((n,), dtype=torch.bool, device=table.device)

    if op == "swp":
        fetched_s = torch.where(seg_start, base, torch.roll(val_s, 1, 0))
        # last-wins: route non-final writes to the scratch row
        is_end = torch.cat([seg_start[1:], seg_start.new_ones(1)])
        w = torch.where(is_end, _scatter_slot(idx_s, m + 1), m)
        padded = _padded(table)
        padded[w] = val_s
        return RmwResult(padded[:m], fetched_s[inv], ok)

    comb = _combine_fn(op)
    incl = segmented_scan(val_s, seg_start, comb)
    exc = _exclusive_from_inclusive(incl, seg_start,
                                    _identity(op, table.dtype))
    fetched_s = comb(base, exc)
    slot = _scatter_slot(indices, m)
    padded = _padded(table)
    if op == "faa":
        padded.index_add_(0, slot, values)
    else:
        padded.scatter_reduce_(0, slot, values,
                               reduce="amin" if op == "min" else "amax")
    return RmwResult(padded[:m], fetched_s[inv], ok)


def _cas_uniform(table: Tensor, indices: Tensor, values: Tensor,
                 expected) -> RmwResult:
    """CAS with one shared expected value: first collider at a matching slot
    wins; later colliders observe the winner's value and fail (paper's BFS
    pattern: cas(parent[v], -1, u)).  1-D tables only."""
    m = table.shape[0]
    e = torch.as_tensor(expected, dtype=table.dtype, device=table.device)
    _, inv, idx_s, seg_start, (val_s,) = _sort_by_index(
        indices, values.to(table.dtype))
    base = _gather_clamped(table, idx_s)
    matches = base == e  # slot held `expected` before the batch
    # Serialized chain semantics: ops succeed while the slot still holds
    # `expected`.  Writing desired == expected keeps the chain alive; the
    # first op writing desired != expected ("break op") ends it.
    eq = (val_s == e).to(torch.int32)
    incl_alive = segmented_scan(eq, seg_start, torch.minimum)
    alive_excl = _exclusive_from_inclusive(incl_alive, seg_start, 1).bool()
    success_s = matches & alive_excl
    break_op = success_s & (eq == 0)
    contrib = torch.where(break_op, val_s, torch.zeros_like(val_s))
    incl_break = segmented_scan(contrib, seg_start, torch.add)
    break_excl = _exclusive_from_inclusive(incl_break, seg_start, 0)
    fetched_s = torch.where(alive_excl | ~matches, base, break_excl)
    # Table write: only the break op changes the slot's value.
    w = torch.where(break_op, _scatter_slot(idx_s, m + 1), m)
    padded = _padded(table)
    padded[w] = val_s
    return RmwResult(padded[:m], fetched_s[inv], success_s[inv])
