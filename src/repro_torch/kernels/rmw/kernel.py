"""Wrappers of the Hopper RMW kernels (`csrc/rmw.cu`) and their plain versions.

Port of `repro.kernels.rmw.kernel`.  Each wrapper takes tensors on one
device.  On a CUDA tensor it launches its kernel (building the library at
first use) or raises; on a CPU tensor it runs the plain PyTorch version of
the same function — that is what the CPU tests exercise.  There is no
fallback from the kernel to the plain version.

`LAUNCHES` counts kernel launches per wrapper, one per call that launched.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.rmw import rmw_combining
from repro_torch.kernels.rmw import ref as _ref

Tensor = torch.Tensor

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"rmw_table": 0, "rmw_table_fetched": 0, "slot_counts": 0}

OP_CODES = {"faa": 0, "swp": 1, "min": 2, "max": 3, "cas": 4}
DTYPE_CODES = {torch.int32: 0, torch.float32: 1}
#: ops per CTA of the fetched kernel (FB in csrc/rmw.cu): one ordered step
FETCHED_BLOCK = 1024
_MAX_N = (1 << 31) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(table_like: Tensor, indices: Tensor, *more: Tensor) -> None:
    """Validate what the kernels take: 1-D contiguous tensors on one CUDA
    device, int32 indices, int32/fp32 tables with values of the same type."""
    dev = table_like.device
    for t in (indices, *more):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in (table_like, indices, *more):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("RMW kernels take 1-D contiguous tensors")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if indices.shape[0] > _MAX_N or table_like.shape[0] > _MAX_N:
        raise ValueError("batch and table must hold fewer than 2**31 entries")


def _launch(name: str, *args) -> None:
    from repro_torch.kernels.rmw import build
    rc = getattr(build.load().lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def _dtype_code(table: Tensor, values: Tensor) -> int:
    if table.dtype not in DTYPE_CODES:
        raise TypeError(f"RMW kernels take int32/float32 tables, "
                        f"got {table.dtype}")
    if values.dtype != table.dtype:
        raise TypeError(f"values ({values.dtype}) must match the table "
                        f"({table.dtype})")
    return DTYPE_CODES[table.dtype]


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# rmw_table: the table-only combine
# ---------------------------------------------------------------------------

def rmw_table(table: Tensor, indices: Tensor, values: Tensor,
              op: str = "faa") -> Tensor:
    """Apply a combining-RMW batch (faa/min/max/swp) to a 1-D table.

    Returns a new table; the input is unchanged.  Out-of-range indices are
    dropped.
    """
    if op not in ("faa", "min", "max", "swp"):
        raise ValueError(f"rmw_table takes faa/min/max/swp, got {op!r}")
    if table.device.type == "cpu":
        return _ref.rmw_table_ref(table, indices, values, op)
    _check(table, indices, values)
    dt = _dtype_code(table, values)
    out = table.clone()
    last = (torch.full(table.shape, -1, dtype=torch.int32, device=table.device)
            if op == "swp" else None)
    with torch.cuda.device(table.device):
        _launch("rmw_table_launch", out.data_ptr(), indices.data_ptr(),
                values.data_ptr(), None if last is None else last.data_ptr(),
                indices.shape[0], table.shape[0], OP_CODES[op], dt,
                _stream(table))
    LAUNCHES["rmw_table"] += 1
    return out


# ---------------------------------------------------------------------------
# rmw_table_fetched: serialized-order fetched values + uniform-expected CAS
# ---------------------------------------------------------------------------

def rmw_table_fetched_plain(table: Tensor, indices: Tensor, values: Tensor,
                            op: str, expected=None
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Vectorised plain version: stable sort + segmented scan
    (`core.rmw.rmw_combining`) with the kernel's drop convention — every
    out-of-range op goes to a scratch slot and reports fetched 0 and
    success False."""
    m = table.shape[0]
    valid = (indices >= 0) & (indices < m)
    idx = torch.where(valid, indices, m)
    padded = torch.cat([table, table.new_zeros(1)])
    res = rmw_combining(padded, idx, values, op, expected)
    fetched = torch.where(valid, res.fetched, torch.zeros_like(res.fetched))
    return res.table[:m], fetched, valid & res.success


def rmw_table_fetched(table: Tensor, indices: Tensor, values: Tensor,
                      op: str = "faa", *, expected=None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Combining RMW returning ``(table, fetched, success)``.

    Semantics match `core.rmw.rmw_serialized` per-op fetch results; CAS
    takes one uniform ``expected`` value.  Out-of-range indices are
    dropped: fetched = 0, success = False for those ops.
    """
    if op not in OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    if table.device.type == "cpu":
        return rmw_table_fetched_plain(table, indices, values, op, expected)
    _check(table, indices, values)
    dt = _dtype_code(table, values)
    n = indices.shape[0]
    out = table.clone()
    fetched = torch.empty((n,), dtype=table.dtype, device=table.device)
    success = torch.empty((n,), dtype=torch.bool, device=table.device)
    counters = torch.zeros((2,), dtype=torch.int32, device=table.device)
    exp = 0.0 if expected is None else float(
        expected.item() if isinstance(expected, Tensor) else expected)
    with torch.cuda.device(table.device):
        _launch("rmw_table_fetched_launch", out.data_ptr(),
                indices.data_ptr(), values.data_ptr(), fetched.data_ptr(),
                success.data_ptr(), counters.data_ptr(), n, table.shape[0],
                OP_CODES[op], dt, exp, _stream(table))
    LAUNCHES["rmw_table_fetched"] += 1
    return out, fetched, success


# ---------------------------------------------------------------------------
# slot_counts: per-slot occupancy
# ---------------------------------------------------------------------------

def slot_counts_plain(indices: Tensor, m: int) -> Tensor:
    valid = (indices >= 0) & (indices < m)
    return torch.bincount(indices[valid].long(), minlength=m).to(torch.int32)


def slot_counts(indices: Tensor, m: int) -> Tensor:
    """(m,) int32 occupancy counts for a slot-index batch; out-of-range
    indices match no slot."""
    if indices.device.type == "cpu":
        return slot_counts_plain(indices, m)
    counts = torch.zeros((m,), dtype=torch.int32, device=indices.device)
    _check(counts, indices)
    with torch.cuda.device(indices.device):
        _launch("slot_counts_launch", indices.data_ptr(), counts.data_ptr(),
                indices.shape[0], m, _stream(indices))
    LAUNCHES["slot_counts"] += 1
    return counts
