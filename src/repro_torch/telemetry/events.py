"""Timing on the card for measured eager calls.

A measured `atomics.execute` on a CUDA table records two CUDA events
around the call on the current stream and reads them back after the fact
(`telemetry.core.DeviceSeconds`, `telemetry.resolve`).  `EventRing` holds
those events: `RING_PAIRS` pairs made once per device by the CUDA runtime
(`csrc/event_ring.cu`, built by `kernels.build.NvccLibrary` at first use),
so a record is one ``cudaEventRecord`` through ``ctypes``, and a window of
pairs is read back in one call (one wait on the newest end event, then
each pair's elapsed time), not by ``torch.cuda.Event``'s record, wait,
queries and elapsed time.

`StampRing` times the port's RMW kernels from inside: while a pair is
armed (`STAMP`, `StampRing.stamp`), each launch of `rmw_table`,
`rmw_table_fetched` or `serial_rmw` passes its address to its C entry,
whose first kernel's blocks stamp their entry and last kernel's their
exit from ``%globaltimer`` (`kernels/csrc/stamp.cuh`).  Arming costs no
host call; a window is read back with one copy into pinned memory and one
wait, and reset with one memset, in one C call.  Stamps cover the kernels
alone: not the table's copy before them, nor the card's waits for the
host between launches, which events hold.  So `atomics.execute` times
its measured calls by events, the ruler the cost model's drift fields are
fitted to; the stamps serve `tools/tuning_probe.py stamps`, `chip_smoke.py`
and the card tests, which compare the two.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.build import NvccLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = NvccLibrary("event_ring", Path(__file__).resolve().parent / "csrc"
                      / "event_ring.cu", {
    # device, pairs, out handle
    "event_ring_create": (_I, _I, ctypes.POINTER(ctypes.c_void_p)),
    # handle, event (2 x pair, + 1 for its end), stream
    "event_ring_record": (_P, _I, _P),
    # handle, pair indices (the newest last), count, ms out
    "event_ring_read": (_P, ctypes.POINTER(_I), _I,
                        ctypes.POINTER(ctypes.c_float)),
    "event_ring_destroy": (_P,),
    # out (3 x u64 on the device), reads, stream
    "globaltimer_probe": (_P, ctypes.c_longlong, _P),
    # words, first pair, pairs, pinned host words, stream
    "stamp_ring_read": (_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P),
})

#: pairs a ring holds: more than the most pairs pending at once
#: (`telemetry.core.PENDING_CAP` + 1: every recorded pair is pended at
#: once, and more than the cap resolves them all), so no pair is recorded
#: again before it has been read
RING_PAIRS = 8192


class EventRing:
    """`RING_PAIRS` pairs of timing events on CUDA device ``device``, taken
    in turn (`take`).  ``record(handle, event, stream)`` is the C entry
    itself (returns a CUDA error code): event ``2 k`` starts pair ``k``,
    ``2 k + 1`` ends it; ``stream`` is a raw ``cudaStream_t`` of the
    device (`raw_stream`)."""

    __slots__ = ("device", "pairs", "handle", "record", "_read", "_next")

    def __init__(self, device: int, pairs: int = RING_PAIRS):
        lib = LIBRARY.load().lib
        handle = ctypes.c_void_p()
        rc = lib.event_ring_create(device, pairs, ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"event_ring_create failed with CUDA error "
                               f"{rc}")
        self.device, self.pairs, self.handle = device, pairs, handle.value
        self.record = lib.event_ring_record
        self._read = lib.event_ring_read
        self._next = 0

    def take(self) -> int:
        """The next pair's index."""
        k = self._next
        self._next = k + 1 if k + 1 < self.pairs else 0
        return k

    def read(self, pairs: Sequence[int]) -> List[float]:
        """Seconds between each pair's two events (``pairs`` in record
        order): one wait on the newest, then each pair's elapsed time."""
        n = len(pairs)
        if not n:
            return []
        ms = (ctypes.c_float * n)()
        rc = self._read(self.handle, (_I * n)(*pairs), n, ms)
        if rc != 0:
            raise RuntimeError(f"event_ring_read failed with CUDA error {rc}")
        return [x / 1e3 for x in ms]


_RINGS: Dict[int, EventRing] = {}


def ring(device: int) -> EventRing:
    """Device ``device``'s ring, made at its first use."""
    r = _RINGS.get(device)
    if r is None:
        r = _RINGS[device] = EventRing(device)
    return r


class StampRing:
    """`RING_PAIRS` stamp pairs on CUDA device ``device``, taken in turn
    (`take`): ``words`` is a (pairs, 2) int64 tensor (unsigned 64-bit
    words to the kernels), zero when reset; pair ``k`` lives at
    `address` (k).  The first word holds the earliest entry as its
    complement, the second the latest exit, in ns of ``%globaltimer``."""

    __slots__ = ("device", "pairs", "words", "base", "_host", "_host_words",
                 "_read", "_next")

    def __init__(self, device: int, pairs: int = RING_PAIRS):
        self.device, self.pairs = device, pairs
        self.words = torch.zeros((pairs, 2), dtype=torch.int64,
                                 device=torch.device("cuda", device))
        self.base = self.words.data_ptr()
        self._host = torch.zeros((pairs, 2), dtype=torch.int64,
                                 pin_memory=True)
        self._host_words = self._host.numpy().view(np.uint64)
        self._read = LIBRARY.load().lib.stamp_ring_read
        self._next = 0

    def take(self) -> int:
        """The next pair's index."""
        k = self._next
        self._next = k + 1 if k + 1 < self.pairs else 0
        return k

    def address(self, k: int) -> int:
        return self.base + 16 * k

    def stamp(self, fn):
        """``fn()`` with the next pair armed (`STAMP`): (its result, the
        pair's index)."""
        k = self.take()
        STAMP.ptr = self.address(k)
        try:
            return fn(), k
        finally:
            STAMP.ptr = None

    def read(self, pairs: Sequence[int]) -> List[float]:
        """Seconds from each pair's entry to its exit (``pairs`` in record
        order): the span of pairs they cover copied to pinned host memory
        on the device's current stream, one wait, and zeroed for reuse.
        A pair no kernel stamped (an empty batch) reads 0."""
        if not len(pairs):
            return []
        lo, hi = min(pairs), max(pairs)
        rc = self._read(self.base, lo, hi - lo + 1,
                        self._host.data_ptr() + 16 * lo,
                        raw_stream(self.device))
        if rc != 0:
            raise RuntimeError(f"stamp_ring_read failed with CUDA error {rc}")
        rows = self._host_words[np.asarray(pairs)]
        first, exit_ns = rows[:, 0], rows[:, 1]
        stamped = (first != 0) & (exit_ns != 0)
        ns = np.where(stamped, exit_ns - ~first, 0).astype(np.int64)
        return (ns / 1e9).tolist()


class _Armed:
    """The armed stamp pair (its device address, or None) and how many C
    entries took it; module-global, as one call is dispatched at a
    time."""

    __slots__ = ("ptr", "used")

    def __init__(self):
        self.ptr: Optional[int] = None
        self.used = 0

    def take_armed(self) -> Optional[int]:
        """The armed pair's address for a launch (None: stamp nothing)."""
        p = self.ptr
        if p is not None:
            self.used += 1
        return p


#: the armed stamp pair the RMW wrappers pass to their C entries
STAMP = _Armed()

_STAMP_RINGS: Dict[int, StampRing] = {}


def stamp_ring(device: int) -> StampRing:
    """Device ``device``'s stamp ring, made at its first use."""
    r = _STAMP_RINGS.get(device)
    if r is None:
        r = _STAMP_RINGS[device] = StampRing(device)
    return r


def globaltimer_resolution(device: int, reads: int = 1 << 20
                           ) -> Dict[str, float]:
    """``%globaltimer`` as the stamps see it: one thread on ``device``
    reads it ``reads`` times back to back; the least nonzero step between
    two reads (ns), the steps seen, and the span (ns)."""
    out = torch.zeros(3, dtype=torch.int64,
                      device=torch.device("cuda", device))
    with torch.cuda.device(device):
        LIBRARY.launch("globaltimer_probe", out.data_ptr(), reads,
                       raw_stream(device))
    least, steps, span = (int(x) for x in out.cpu())
    return {"least_step_ns": least, "steps": steps, "span_ns": span,
            "reads": reads}


def raw_stream(device: int) -> int:
    """The device's current stream as a raw ``cudaStream_t``."""
    return torch._C._cuda_getCurrentRawStream(device)
