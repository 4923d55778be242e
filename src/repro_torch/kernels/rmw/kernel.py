"""Wrappers of the Hopper RMW kernels (`csrc/rmw.cu`) and their plain versions.

Port of `repro.kernels.rmw.kernel`.  Each wrapper takes tensors on one
device.  On a CUDA tensor it launches its kernel (building the library at
first use) or raises; on a CPU tensor it runs the plain PyTorch version of
the same function — that is what the CPU tests exercise.  There is no
fallback from the kernel to the plain version.

`LAUNCHES` counts kernel launches per wrapper, one per call that launched.
A fake tensor (`kernels.build.is_fake`) gets outputs of the right shape
and dtype, no launch and no count.

While a pair of the device's `telemetry.events.StampRing` is armed
(`events.STAMP`, `StampRing.stamp`), each launch passes it to its C
entry, whose first kernel stamps its entry and last kernel its exit
(`kernels/csrc/stamp.cuh`); no result bit depends on it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.core.rmw import rmw_combining
from repro_torch.kernels.build import NvccLibrary, is_fake
from repro_torch.kernels.rmw import ref as _ref
from repro_torch.telemetry.events import STAMP

Tensor = torch.Tensor

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"rmw_table": 0, "rmw_table_fetched": 0, "slot_counts": 0}

OP_CODES = {"faa": 0, "swp": 1, "min": 2, "max": 3, "cas": 4, "count": 5}
DTYPE_CODES = {torch.int32: 0, torch.float32: 1}
#: the bits of the fetched kernel's radix digit (DBITS in csrc/rmw.cu, which
#: `fetched_layout` reports), for the cost model and the CPU tests
RADIX_BITS = 8
_MAX_N = (1 << 31) - 1

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: `csrc/rmw.cu`, built by nvcc at first launch
LIBRARY = NvccLibrary("rmw", Path(__file__).resolve().parent / "csrc"
                      / "rmw.cu", {
    # table, idx, vals, last_pos, n, m, op, dtype, regime, window, depth,
    # stamp pair, stream
    "table_combine_launch": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I,
                             _P, _P),
    # table, out, idx, vals, fetched, success, scratch, scratch_bytes, n, m,
    # op, dtype, expected, stamp pair, stream
    "rmw_table_fetched_launch": (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                 _I, _I, ctypes.c_double, _P, _P),
    # n, scratch_bytes, digit_bits
    "rmw_table_fetched_layout": (_LL, ctypes.POINTER(_LL),
                                 ctypes.POINTER(_I)),
})


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
# rmw_table and slot_counts: the table-only combine (`table_combine_launch`)
# ---------------------------------------------------------------------------

#: the regimes of the table-only kernels (csrc/rmw.cu, REGIME_*)
REGIMES = {"global": 0, "smem": 1, "windows": 2}
#: 4-byte words a CTA's private copy holds (224 KiB of the SM's 227 KB of
#: shared memory), and the slots of an L2 window (16 MiB, a third of the
#: H100's 50 MB L2: the batch streams through it too)
SMEM_SLOTS = 56 * 1024
WINDOW_SLOTS = 1 << 22
#: ops a thread loads before it combines any (UNROLL in csrc/rmw.cu), and
#: the depths FAA also builds at outside the smem regime (the `prefetcher`
#: suite's sweep)
UNROLL = 8
DEPTHS = (1, UNROLL, 32)
#: ... and for fp32 MIN/MAX, whose private copies flush by compare-and-swap
#: (no bulk reduction takes their order), and whose compare-and-swap into a
#: table past the L2 waits on HBM either way: the largest private copy, the
#: ops a slot it needs, and the smallest table that goes in windows
CAS_SMEM_SLOTS = 16 * 1024
CAS_SMEM_OPS_A_SLOT = 512
CAS_WINDOWS_FROM = 3 * WINDOW_SLOTS


def table_regime(op: str, dtype: torch.dtype, n: int, m: int) -> str:
    """Where the table-only kernels combine n ops of ``op`` over m slots of
    ``dtype`` (`tools/rmw_table_ablate.py` measured each threshold from
    both sides on an H100):

    - ``smem``: m fits one CTA's shared memory and the batch holds at least
      32 ops a slot, so the private copies' init and flush stay small beside
      the ops;
    - ``windows``: the table is two L2 windows or more, so one pass would
      send its atomics to HBM (at 1.5 windows one pass was faster);
    - ``global``: otherwise, one L2 atomic per kept op, fewer for MIN, MAX
      and SWP.

    fp32 MIN/MAX (a compare-and-swap per slot, not one atomic) take the
    smem regime only up to `CAS_SMEM_SLOTS` slots and from
    `CAS_SMEM_OPS_A_SLOT` ops a slot, and windows from `CAS_WINDOWS_FROM`
    slots.  Every other op and dtype combines 4-byte words (SWP as batch
    positions, counts as ints) alike.
    """
    if dtype == torch.float32 and op in ("min", "max"):
        if m <= CAS_SMEM_SLOTS and n >= CAS_SMEM_OPS_A_SLOT * m:
            return "smem"
        return "windows" if m >= CAS_WINDOWS_FROM else "global"
    if m <= SMEM_SLOTS and n >= 32 * m:
        return "smem"
    return "windows" if m >= 2 * WINDOW_SLOTS else "global"


def table_regimes(m: int) -> Tuple[str, ...]:
    """Every regime the table-only kernel can run m slots in: ``global``;
    ``smem`` while m fits a CTA's private copy; ``windows`` past one
    window."""
    return (("global",) + (("smem",) if m <= SMEM_SLOTS else ())
            + (("windows",) if m > WINDOW_SLOTS else ()))


def table_combine(out: Tensor, indices: Tensor, values, op: str,
                  regime: str, window: int = WINDOW_SLOTS,
                  depth: int = UNROLL) -> Tensor:
    """Launch the table-only kernel in ``regime`` on CUDA tensors, updating
    ``out`` in place (the callers pass a copy of the table, or zeros for op
    ``count``, whose ``values`` are None) and returning it.  Counts no
    launch: `rmw_table` and `slot_counts` do, in the regime `table_regime`
    picks, at the defaults; the other regimes, windows and depths are for
    the tests, the `unaligned` and `prefetcher` suites and
    `tools/rmw_table_ablate.py`.

    ``window``: the slots of one pass in the ``windows`` regime (any width:
    one off the 32-slot L2 line splits a line at each boundary; every
    atomic stays one aligned word).  ``depth``: the ops a thread loads
    before it combines any, one of `DEPTHS`; other than `UNROLL` only for
    FAA outside the ``smem`` regime."""
    if regime not in REGIMES:
        raise ValueError(f"unknown regime {regime!r}")
    if regime == "smem" and out.shape[0] > SMEM_SLOTS:
        raise ValueError(f"the smem regime takes at most {SMEM_SLOTS} slots")
    if window < 1:
        raise ValueError(f"a window holds at least one slot, got {window}")
    if depth not in DEPTHS or (depth != UNROLL and (
            op != "faa" or regime == "smem")):
        raise ValueError(f"depth {depth} is built for FAA outside the smem "
                         f"regime only, at {DEPTHS}; {op!r} in {regime!r} "
                         f"takes {UNROLL}")
    if op == "count":
        _check(out, indices)
        if out.dtype != torch.int32:
            raise TypeError("counts are int32")
        dt = DTYPE_CODES[torch.int32]
    else:
        _check(out, indices, values)
        dt = _dtype_code(out, values)
    if is_fake(out):
        return out
    last = (torch.full(out.shape, -1, dtype=torch.int32, device=out.device)
            if op == "swp" else None)
    with torch.cuda.device(out.device):
        LIBRARY.launch("table_combine_launch", out.data_ptr(),
                       indices.data_ptr(),
                       None if values is None else values.data_ptr(),
                       None if last is None else last.data_ptr(),
                       indices.shape[0], out.shape[0], OP_CODES[op], dt,
                       REGIMES[regime], window, depth, STAMP.take_armed(),
                       _stream(out))
    return out


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
    out = table_combine(table.clone(), indices, values, op,
                        table_regime(op, table.dtype, indices.shape[0],
                                     table.shape[0]))
    if not is_fake(out):
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


def radix_passes(m: int) -> int:
    """Radix passes the fetched kernel sorts slots 0..m-1 with:
    ceil(bit_length(m - 1) / RADIX_BITS) (3 at m = 2**20 and 2**24, 4 at
    2**25 + 1, none at m = 1)."""
    return -(-max(m - 1, 0).bit_length() // RADIX_BITS)


def fetched_design_bytes(n: int, k: int, m: int, slots: int,
                         op: str) -> int:
    """Bytes the fetched kernel's stages move (csrc/rmw.cu) for n ops of
    which k are kept, touching ``slots`` slots of m, with P =
    `radix_passes(m)`: compaction 9n + 4k, P passes of 16k, the scan 20k
    and 8 per slot, the position pass 16k, the scatter 12k, the table's
    copy 8m, and CAS's success pass 9n."""
    passes = radix_passes(m)
    return (9 * n + (52 + 16 * passes) * k + 8 * slots + 8 * m
            + (9 * n if op == "cas" else 0))


@functools.lru_cache(maxsize=64)
def fetched_layout(n: int) -> Tuple[int, int]:
    """The fetched kernel's scratch bytes for a batch of n ops and the bits
    of its radix digit, as the library reports them
    (`rmw_table_fetched_layout` in csrc/rmw.cu).  Builds the library."""
    nbytes, bits = ctypes.c_longlong(), ctypes.c_int()
    LIBRARY.launch("rmw_table_fetched_layout", n, ctypes.byref(nbytes),
                   ctypes.byref(bits))
    return nbytes.value, bits.value


def rmw_table_fetched(table: Tensor, indices: Tensor, values: Tensor,
                      op: str = "faa", *, expected=None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Combining RMW returning ``(table, fetched, success)``.

    Semantics match `core.rmw.rmw_serialized` per-op fetch results; CAS
    takes one uniform ``expected`` value.  Out-of-range indices are
    dropped: fetched = 0, success = False for those ops.  On the card: a
    stable radix sort of the kept ops by slot and a segmented scan, with a
    scratch buffer from the caching allocator, of the size
    `fetched_layout(n)` reports.
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
    if is_fake(table):
        return out, fetched, success
    nbytes, _ = fetched_layout(n)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=table.device)
    exp = 0.0 if expected is None else float(
        expected.item() if isinstance(expected, Tensor) else expected)
    with torch.cuda.device(table.device):
        LIBRARY.launch("rmw_table_fetched_launch", table.data_ptr(),
                       out.data_ptr(), indices.data_ptr(), values.data_ptr(),
                       fetched.data_ptr(), success.data_ptr(),
                       scratch.data_ptr(), nbytes, n, table.shape[0],
                       OP_CODES[op], dt, exp, STAMP.take_armed(),
                       _stream(table))
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
    indices match no slot.  On the card: the table-only kernel's count
    mode, an int32 FAA of 1 onto a zero table."""
    if indices.device.type == "cpu":
        return slot_counts_plain(indices, m)
    counts = table_combine(torch.zeros((m,), dtype=torch.int32,
                                       device=indices.device), indices, None,
                           "count", table_regime("count", torch.int32,
                                                 indices.shape[0], m))
    if not is_fake(counts):
        LAUNCHES["slot_counts"] += 1
    return counts
