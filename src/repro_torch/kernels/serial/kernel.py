"""Wrappers of the one-thread device loops (`csrc/serial.cu`) and their plain
versions.

- `serial_rmw`: a batch of RMWs applied in batch order by one thread with the
  card's atomics; the device counterpart of the reference's
  `repro.core.rmw.rmw_serialized` (a ``lax.scan``), which
  `core.rmw.rmw_serialized` calls on a CUDA table.
- `chase`: the dependent pointer chase of the latency suite, in a read mode
  and in faa, swp and cas modes whose next address is the atomic's return;
  the device counterpart of `benchmarks/latency.py`'s ``fori_loop`` walks.

On a CUDA tensor each wrapper launches its kernel (building the library at
first use) or raises; on a CPU tensor it runs the plain version: the host
loop `core.rmw.rmw_serialized_host`, and `chase_plain`.  There is no
fallback from the kernel to the plain version.

`LAUNCHES` counts kernel launches per wrapper, one per call that launched.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import rmw as _rmw
from repro_torch.kernels.build import NvccLibrary

Tensor = torch.Tensor

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"serial_rmw": 0, "chase": 0}

OP_CODES = {"faa": 0, "swp": 1, "min": 2, "max": 3, "cas": 4}
DTYPE_CODES = {torch.int32: 0, torch.float32: 1}
CHASE_MODES = {"read": 0, "faa": 1, "swp": 2, "cas": 3}
#: the largest chase table (32-bit words whose low bits hold the pointer)
_MAX_CHASE_SLOTS = 1 << 30
_I32 = torch.iinfo(torch.int32)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: `csrc/serial.cu`, built by nvcc at first launch
LIBRARY = NvccLibrary("serial", Path(__file__).resolve().parent / "csrc"
                      / "serial.cu", {
    # table, idx, vals, expected, fetched, success, n, m, op, dtype, stream
    "serial_rmw_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P),
    # table, m, a, c, start, steps, mode, end, stream
    "chase_launch": (_P, _LL, _LL, _LL, _LL, _LL, _I, _P, _P),
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# serial_rmw
# ---------------------------------------------------------------------------

def _operands(table: Tensor, indices: Tensor, values: Tensor, op: str,
              expected) -> Tuple[Tensor, Tensor, Tensor]:
    """int32 indices, values of the table's type, and (CAS) one expected
    value per op, all contiguous on the table's device.  An index beyond
    int32 is clamped to one that the reference treats alike: past the end,
    or before the start after counting from the end."""
    m = table.shape[0]
    for t in (indices, values):
        if t.device != table.device:
            raise ValueError(f"tensors on {t.device} and {table.device}")
        if t.dim() != 1:
            raise ValueError("serial_rmw takes 1-D tensors")
    if indices.dtype.is_floating_point or indices.dtype == torch.bool:
        raise TypeError(f"indices must be integers, got {indices.dtype}")
    idx = indices.clamp(-m - 1, m).to(torch.int32).contiguous()
    val = values.to(table.dtype).contiguous()
    exp = None
    if op == "cas":
        exp = torch.as_tensor(expected, device=table.device).to(
            table.dtype).expand(indices.shape).contiguous()
    return idx, val, exp


def serial_rmw(table: Tensor, indices: Tensor, values: Tensor, op: str,
               expected=None) -> Tuple[Tensor, Tensor, Tensor]:
    """``(table, fetched, success)`` of the batch applied in order, one op
    at a time: the serialized oracle.  The input table is unchanged.

    On the card one thread runs the batch with the card's atomic
    instructions (int32 and fp32 tables, a scalar or per-op ``expected``
    for CAS); on the CPU, the host loop.
    """
    if op not in OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    if op == "cas" and expected is None:
        raise ValueError("cas requires `expected`")
    if table.device.type == "cpu":
        return tuple(_rmw.rmw_serialized_host(table, indices, values, op,
                                              expected))
    if table.dtype not in DTYPE_CODES:
        raise TypeError(f"serial_rmw takes int32/float32 tables, "
                        f"got {table.dtype}")
    if table.dim() != 1 or not 0 < table.shape[0] < _I32.max:
        raise ValueError("serial_rmw takes a 1-D table of 1 to 2**31 - 2 "
                         "slots")
    idx, val, exp = _operands(table, indices, values, op, expected)
    n = idx.shape[0]
    out = table.contiguous().clone()
    fetched = torch.empty((n,), dtype=table.dtype, device=table.device)
    success = torch.empty((n,), dtype=torch.bool, device=table.device)
    with torch.cuda.device(table.device):
        LIBRARY.launch("serial_rmw_launch", out.data_ptr(), idx.data_ptr(),
                       val.data_ptr(),
                       None if exp is None else exp.data_ptr(),
                       fetched.data_ptr(), success.data_ptr(), n,
                       out.shape[0], OP_CODES[op], DTYPE_CODES[table.dtype],
                       _stream(out))
    LAUNCHES["serial_rmw"] += 1
    return out, fetched, success


# ---------------------------------------------------------------------------
# chase
# ---------------------------------------------------------------------------

class Cycle(NamedTuple):
    """A chase table: ``words``, m 32-bit words (m a power of two) whose
    low log2(m) bits hold slot p's successor f(p) = (a p + c) mod m; with
    a = 1 mod 4 and c odd that is one cycle through every slot (Hull and
    Dobell).  The swp chase writes f(p) back, so it keeps the cycle."""

    words: Tensor
    a: int
    c: int

    @property
    def m(self) -> int:
        return self.words.shape[0]


def single_cycle(m: int, generator: torch.Generator,
                 device="cuda") -> Cycle:
    """A `Cycle` of m slots whose a and c are drawn from ``generator``
    (a in [m / 4, m) where m allows), its words built on ``device``."""
    if m < 2 or m > _MAX_CHASE_SLOTS or m & (m - 1):
        raise ValueError(f"a chase table has a power of two of 2 to 2**30 "
                         f"slots, got {m}")
    r = torch.randint(m // 16, max(m // 4, m // 16 + 1), (2,),
                      generator=generator, device=generator.device)
    a, c = (4 * int(r[0]) + 1) % m, (2 * int(r[1]) + 1) % m
    p = torch.arange(m, dtype=torch.int64, device=device)
    return Cycle(((a * p + c) & (m - 1)).to(torch.int32), a, c)


def _check_chase(table: Cycle, steps: int, mode: str, start: int) -> int:
    if mode not in CHASE_MODES:
        raise ValueError(f"unknown chase mode {mode!r}")
    w = table.words
    if w.dtype != torch.int32 or w.dim() != 1 or not w.is_contiguous():
        raise TypeError("chase takes a contiguous 1-D int32 table")
    m = table.m
    if m < 2 or m > _MAX_CHASE_SLOTS or m & (m - 1):
        raise ValueError(f"chase takes a power of two of 2 to 2**30 slots, "
                         f"got {m}")
    if not 0 <= start < m or steps < 0:
        raise ValueError("start must be a slot and steps >= 0")
    return m


def chase_plain(table: Cycle, steps: int, mode: str = "read",
                start: int = 0) -> Tensor:
    """The chase as a host loop over a `Cycle` on the CPU, whose words it
    updates in place as the kernel does; returns the end slot as a
    one-element int32 tensor."""
    m = _check_chase(table, steps, mode, start)
    words = table.words.numpy().view(np.uint32)
    mask, p = m - 1, start
    if mode in ("read", "cas"):               # CAS's compare never matches
        for _ in range(steps):
            p = int(words[p]) & mask
    elif mode == "faa":
        for _ in range(steps):
            old = int(words[p])
            words[p] = (old + m) & 0xFFFFFFFF
            p = old & mask
    else:
        for _ in range(steps):
            old = int(words[p])
            words[p] = (table.a * p + table.c) & mask
            p = old & mask
    return torch.tensor([p], dtype=torch.int32)


def chase(table: Cycle, steps: int, mode: str = "read",
          start: int = 0) -> Tensor:
    """Walk ``steps`` dependent steps from slot ``start`` through a `Cycle`
    in ``mode`` (read, faa, swp, cas; see csrc/serial.cu): each step's
    address is the previous step's load or, in the RMW modes, the
    previous atomic's return.  Updates the words in place (faa counts
    visits in their high bits; swp clears the high bits of those it
    passes) and returns the end slot as a one-element int32 tensor on the
    table's device.
    """
    if table.words.device.type == "cpu":
        return chase_plain(table, steps, mode, start)
    m = _check_chase(table, steps, mode, start)
    w = table.words
    end = torch.empty((1,), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        LIBRARY.launch("chase_launch", w.data_ptr(), m, table.a, table.c,
                       start, steps, CHASE_MODES[mode], end.data_ptr(),
                       _stream(w))
    LAUNCHES["chase"] += 1
    return end
