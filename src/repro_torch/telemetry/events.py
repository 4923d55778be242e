"""Timing events on the card for measured eager calls.

A measured `atomics.execute` on a CUDA table records two CUDA events
around the call on the current stream and reads them back after the fact
(`telemetry.core.DeviceSeconds`, `telemetry.resolve`).  `EventRing` holds
those events: `RING_PAIRS` pairs made once per device by the CUDA runtime
(`csrc/event_ring.cu`, built by `kernels.build.NvccLibrary` at first use),
so a record is one ``cudaEventRecord`` through ``ctypes``, and a window of
pairs is read back in one call (one wait on the newest end event, then
each pair's elapsed time), not by ``torch.cuda.Event``'s record, wait,
queries and elapsed time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Sequence

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


def raw_stream(device: int) -> int:
    """The device's current stream as a raw ``cudaStream_t``."""
    return torch._C._cuda_getCurrentRawStream(device)
