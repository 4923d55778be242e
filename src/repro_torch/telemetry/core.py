"""Structured event stream: the measurement layer under the cost models.

Port of `repro.telemetry.core` (the port's own copy: the reference module
imports JAX for its profiler annotations).  The paper's methodology is
*check every prediction against the hardware*; the stack's three selector
tiers (`select_backend`, `select_exchange`, `select_migration`) make those
predictions at every dispatch, and this module is where the predictions and
the measurements meet.  Every layer reports into one process-wide event
stream:

* ``record(event, **fields)`` — one structured event (a flat dict), routed
  to every installed sink.  **Near-zero cost when disabled**: the hot-path
  guard is a single module-global boolean (`enabled()`), so instrumented
  code pays one branch per call site when telemetry is off.
* ``span(name, **fields)`` — timing context manager.  It *always* measures
  (``perf_counter`` on enter/exit, exposing ``.wall_s``) and records an
  event only when enabled.
* ``annotation(name)`` — a ``torch.profiler.record_function`` range when
  annotations are on, so a profiler trace of the card names each dispatch.
* sinks — :class:`RingBuffer` (bounded in-memory, tests), ``JsonlWriter``
  (one JSON object per line, offline analysis / the report CLI),
  ``Counters`` (streaming aggregation, no retention).

Eager PyTorch has no trace time: every instrumented call is a host-side
call, so events carry ``traced=False`` (the field is kept so both packages'
events share one schema), and measured wall times come from the call sites
under ``sync``.  A call on the card is measured by two CUDA events
recorded around it on its stream (a pair of the device's
`telemetry.events.EventRing`), with no synchronisation: its event
carries a :class:`DeviceSeconds` in ``measured_s`` until `resolve`
replaces it with the seconds between the two events, after one wait for
the newest (one call reads every pending pair of a ring).  That happens
where the wait costs nothing extra: at a consumer's window boundary (the tuning controller's update cycle), when a
`capture` ends or the stream is disabled, and when a `RingBuffer`'s events
are read; a sink that writes events out as they come (`JsonlWriter`,
`Counters`) resolves each one it is given.  A measured call still costs
an H100's host about 13 µs more than an unmeasured one (recording the
two events, about 9 µs, and reading them back; two synchronisations cost
65-85 µs),
so a sink installed with sync may ask for one call on the card in
``Sink.sync_every`` to be measured (`sync_due`: one call at a seeded
random place in each run of ``k``, so traffic that repeats with a period
is sampled whole); the stream takes the least period among the sinks
installed with sync.  A consumer that leaves the stream on (the tuning
controller) asks for more than 1; a plain sink, and so every capture,
for every call.  A CPU call is measured by the host clock, always.
Building an event costs the card's host a few µs too, so while every
installed sink is ``Sink.measured_only`` an unmeasured call builds none.

Thread safety: sink dispatch holds one module lock; sinks themselves need
no internal locking.  Enabling/disabling swaps the sink tuple atomically.
While every installed sink is ``Sink.lock_free`` (a plain `RingBuffer`:
one atomic deque append) an event is handed over without the lock, to the
deque's own ``append``, so a ring costs an event no Python call of its own.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: env var: a JSONL path (or "ring") enabling telemetry at process start
#: for unmodified callers — the observability sibling of ``REPRO_CHAOS``
TELEMETRY_ENV = "REPRO_TELEMETRY"

_lock = threading.Lock()
_sinks: Tuple["Sink", ...] = ()
_enabled: bool = False          # the one hot-path guard
_sync: bool = False             # measure eager calls' device time
_synced: Tuple["Sink", ...] = ()  # the sinks installed with sync
_sync_every: int = 1            # ... measure one call on the card in this many
_sync_tick: int = 0             # place in the current run of _sync_every
_sync_pick: int = 0             # ... and the place measured in it
_sampler = random.Random(0)
_every_event: bool = False      # some sink reads unmeasured events too
#: (lock free, each installed sink's `Sink.emitter`), read as one tuple
_emission: Tuple[bool, Tuple[Callable[[Dict[str, Any]], Any], ...]] = (
    True, ())
_annotate: bool = False         # torch.profiler ranges at dispatch
_pending: List[Dict[str, Any]] = []  # events whose measured_s is pending


def _wants_every(sinks) -> bool:
    return any(not getattr(s, "measured_only", False) for s in sinks)


def _install(sinks) -> None:
    """Make ``sinks`` the installed set, with what `record_event` reads of
    them (caller holds the lock)."""
    global _sinks, _every_event, _emission
    _sinks = tuple(sinks)
    _every_event = _wants_every(_sinks)
    _emission = (all(s.lock_free for s in _sinks),
                 tuple(s.emitter() for s in _sinks))


def _set_period(synced) -> None:
    """Recompute the sampling period from the sinks installed with sync
    (caller holds the lock)."""
    global _synced, _sync_every, _sync_tick, _sync_pick
    _synced = tuple(synced)
    every = min((max(1, int(getattr(s, "sync_every", 1))) for s in _synced),
                default=1)
    if every != _sync_every:
        _sync_every, _sync_tick = every, 0
        _sync_pick = _sampler.randrange(every)


class DeviceSeconds:
    """A measured time on the card, pending: two CUDA events recorded
    around a call on its stream.  With ``ring`` (the
    `telemetry.events.EventRing` they were recorded in, or a
    `telemetry.events.StampRing` whose pair the call's kernels stamped),
    ``start`` is the index of their pair, and `resolve` reads every
    pending pair of a ring in one call; without, ``start`` and ``end``
    are the event objects (``synchronize``, ``elapsed_time`` in ms).
    `seconds` waits for the end event."""

    __slots__ = ("start", "end", "ring")

    def __init__(self, start, end=None, ring=None):
        self.start, self.end, self.ring = start, end, ring

    def seconds(self) -> float:
        if self.ring is not None:
            return self.ring.read((self.start,))[0]
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


#: pending events past this many are resolved at the next `pend`
PENDING_CAP = 4096


def pend(ev: Dict[str, Any]) -> None:
    """Register an event whose ``measured_s`` is a `DeviceSeconds`, for
    `resolve`."""
    _pending.append(ev)
    if len(_pending) > PENDING_CAP:
        resolve()


def resolve() -> None:
    """Replace the ``measured_s`` of every pending event with its seconds:
    one wait for the newest end event, then each pair's elapsed time (one
    call a ring)."""
    global _pending
    if not _pending:
        return
    batch, _pending = _pending, []
    rings: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in reversed(batch):       # the newest first: one real wait
        meas = ev.get("measured_s")
        if isinstance(meas, DeviceSeconds):
            if meas.ring is None:
                ev["measured_s"] = meas.seconds()
            else:
                rings.setdefault(meas.ring, []).append(ev)
    for ring, evs in rings.items():
        evs.reverse()                # record order, the newest last
        secs = ring.read([ev["measured_s"].start for ev in evs])
        for ev, s in zip(evs, secs):
            ev["measured_s"] = s


def _seconds(x):
    """``x``, or its seconds where it is a pending `DeviceSeconds`."""
    return x.seconds() if isinstance(x, DeviceSeconds) else x


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

class Sink:
    """One consumer of the event stream.  ``emit`` (through `emitter`) is
    called under the module lock with a flat dict (the caller owns the
    dict; copy if you retain it past the call — the built-in sinks retain
    it as-is since instrumentation never mutates an emitted event).

    ``measured_only`` declares a sink that reads only events carrying a
    measured time (the tuning controller's tap): while every installed
    sink says so, an eager `execute` that was not measured skips building
    its decision event.  ``sync_every``: installed with sync, the sink asks
    for one call on the card in this many to be measured.  An event's
    ``measured_s`` may be a pending `DeviceSeconds` until `resolve`.
    ``lock_free`` declares that the sink's `emitter` may be called without
    the module lock, from any thread."""

    measured_only = False
    sync_every = 1
    lock_free = False

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def emitter(self) -> Callable[[Dict[str, Any]], Any]:
        """The callable `record_event` hands each event to (fixed when the
        sink is installed): ``emit``."""
        return self.emit

    def close(self) -> None:
        pass


class RingBuffer(Sink):
    """Bounded in-memory sink — the test/inspection default.  Its events go
    straight to its deque's ``append`` (one atomic call: `lock_free`),
    unless a subclass overrides `emit`."""

    def __init__(self, capacity: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, event: Dict[str, Any]) -> None:
        self._buf.append(event)

    @property
    def lock_free(self) -> bool:
        return type(self).emit is RingBuffer.emit

    def emitter(self) -> Callable[[Dict[str, Any]], Any]:
        return self._buf.append if self.lock_free else self.emit

    @property
    def events(self) -> List[Dict[str, Any]]:
        """The events, their pending times resolved."""
        resolve()
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf.clear()


def _jsonable(x):
    """Best-effort scalar coercion: numpy scalars/arrays -> python, other
    non-JSON types -> repr.  Events must never make a sink raise."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    item = getattr(x, "item", None)
    if item is not None:
        try:
            return _jsonable(item())
        except Exception:  # noqa: BLE001 — non-scalar arrays etc.
            pass
    tolist = getattr(x, "tolist", None)
    if tolist is not None:
        try:
            return _jsonable(tolist())
        except Exception:  # noqa: BLE001
            pass
    return repr(x)


class JsonlWriter(Sink):
    """One JSON object per line — the capture format the report CLI and
    `telemetry.drift` read back (`read_jsonl`)."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[io.TextIOBase] = open(path, "w")

    def emit(self, event: Dict[str, Any]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(
            {k: _jsonable(_seconds(v)) for k, v in event.items()}) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a `JsonlWriter` capture back into a list of event dicts."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class Counters(Sink):
    """Streaming aggregation, no event retention: per event name a count,
    and per numeric field a running (count, sum, min, max)."""

    def __init__(self):
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._num: Dict[Tuple[str, str], List[float]] = {}

    def emit(self, event: Dict[str, Any]) -> None:
        name = str(event.get("event"))
        self.counts[name] += 1
        for k, v in event.items():
            v = _seconds(v)
            if k in ("event", "t") or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            agg = self._num.get((name, k))
            if agg is None:
                self._num[(name, k)] = [1, float(v), float(v), float(v)]
            else:
                agg[0] += 1
                agg[1] += v
                agg[2] = min(agg[2], v)
                agg[3] = max(agg[3], v)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """``{event: {count, fields: {field: {n, sum, mean, min, max}}}}``"""
        out: Dict[str, Dict[str, Any]] = {}
        for name, c in self.counts.items():
            out[name] = {"count": c, "fields": {}}
        for (name, k), (n, s, lo, hi) in self._num.items():
            out[name]["fields"][k] = {"n": n, "sum": s, "mean": s / n,
                                      "min": lo, "max": hi}
        return out


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """The hot-path guard instrumented code checks before doing any work."""
    return _enabled


def sync_enabled() -> bool:
    """True when measured call sites should measure device time, not
    dispatch time (drift captures need this): CUDA events around a call
    on the card, read after the fact (`resolve`)."""
    return _enabled and _sync


def sync_due() -> bool:
    """Whether to measure this call on the card (the caller asks only under
    sync): one call in each run of ``_sync_every`` asking calls, at a place
    drawn from a seeded generator for each run."""
    global _sync_tick, _sync_pick
    if _sync_every <= 1:
        return True
    due = _sync_tick == _sync_pick
    _sync_tick += 1
    if _sync_tick >= _sync_every:
        _sync_tick = 0
        _sync_pick = _sampler.randrange(_sync_every)
    return due


def annotations_enabled() -> bool:
    """True when dispatch sites should open ``torch.profiler`` ranges
    (named regions in a profiler trace)."""
    return _enabled and _annotate


def enable(*sinks: Sink, sync: bool = False, annotate: bool = False) -> None:
    """Install ``sinks`` (replacing any current set) and turn the stream on.

    ``sync=True`` makes instrumented dispatch sites measure the device
    time of eager calls (CUDA events, read after the fact) — the
    measured-vs-predicted events drift captures need.
    ``annotate=True`` additionally opens ``torch.profiler.record_function``
    ranges around engine dispatch / exchange collectives / migrations /
    train steps.
    """
    global _enabled, _sync, _annotate
    with _lock:
        _install(tuple(sinks) or (RingBuffer(),))
        _sync = bool(sync)
        _set_period(_sinks if sync else ())
        _annotate = bool(annotate)
        _enabled = True


def disable() -> None:
    """Turn the stream off (pending times resolved) and close the
    installed sinks."""
    global _enabled, _sync, _annotate
    resolve()
    with _lock:
        for s in _sinks:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        _install(())
        _enabled = False
        _sync = False
        _set_period(())
        _annotate = False


def add_sink(sink: Sink, *, sync: Optional[bool] = None,
             annotate: Optional[bool] = None) -> None:
    """Attach ``sink`` *alongside* any installed sinks and turn the stream
    on (contrast `enable`, which replaces the sink set).  ``sync``/
    ``annotate`` only ever widen the current flags — a live consumer (the
    tuning controller) must not silently strip another consumer's settings.
    With ``sync`` the sink's ``sync_every`` joins the sampling period (the
    least among the sinks installed with sync).  Pair with `remove_sink`."""
    global _enabled, _sync, _annotate
    with _lock:
        _install(_sinks if sink in _sinks else _sinks + (sink,))
        if sync:
            _sync = True
            if sink not in _synced:
                _set_period(_synced + (sink,))
        if annotate is not None:
            _annotate = _annotate or bool(annotate)
        _enabled = True


def remove_sink(sink: Sink, *, close: bool = False) -> bool:
    """Detach one sink installed via `add_sink`/`enable`.  When the last
    sink goes, the stream turns fully off (flags reset).  Returns True if
    the sink was installed."""
    global _enabled, _sync, _annotate
    with _lock:
        had = any(s is sink for s in _sinks)
        _install(s for s in _sinks if s is not sink)
        _set_period(s for s in _synced if s is not sink)
        if not _sinks:
            _enabled = False
            _sync = False
            _annotate = False
    if had and close:
        try:
            sink.close()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass
    return had


def sinks() -> Tuple[Sink, ...]:
    return _sinks


@contextlib.contextmanager
def capture(sink: Optional[Sink] = None, *, sync: bool = False,
            annotate: bool = False):
    """Scoped enable: install ``sink`` (default: a fresh :class:`RingBuffer`)
    *in addition to* any already-installed sinks, yield it, and restore the
    previous state on exit, every pending time resolved.  The standard
    test/benchmark spelling::

        with telemetry.capture(sync=True) as buf:
            atomics.execute(...)
        events = buf.events
    """
    global _enabled, _sync, _annotate
    target = sink if sink is not None else RingBuffer()
    with _lock:
        prev = (_sinks, _enabled, _sync, _annotate, _synced)
        _install(prev[0] + (target,))
        if sync:
            _set_period(_synced + (target,))
        _sync = bool(sync) or _sync
        _annotate = bool(annotate) or _annotate
        _enabled = True
    try:
        yield target
    finally:
        resolve()
        with _lock:
            _install(prev[0])
            _enabled, _sync, _annotate = prev[1:4]
            _set_period(prev[4])
        if sink is None:
            pass                      # caller keeps the buffer; nothing to close
        # an explicitly passed sink stays open — its owner closes it


def record(event: str, **fields) -> None:
    """Record one structured event.  No-op (one boolean check) when the
    stream is disabled; never raises."""
    if not _enabled:
        return
    ev: Dict[str, Any] = {"event": event, "t": time.time()}
    ev.update(fields)
    record_event(ev)


def record_event(ev: Dict[str, Any]) -> None:
    """Hot-path variant of :func:`record`: the caller hands over a prebuilt
    event dict (must contain ``"event"``; ``"t"`` is stamped here if
    absent).  Ownership transfers to the stream — don't mutate after."""
    if not _enabled:
        return
    if "t" not in ev:
        ev["t"] = time.time()
    lock_free, emitters = _emission
    if lock_free:
        for emit in emitters:
            try:
                emit(ev)
            except Exception:  # noqa: BLE001 — a broken sink must not take
                pass           # down the instrumented path
        return
    # acquire/release, not ``with``: this is every instrumented call's cost
    _lock.acquire()
    try:
        for emit in emitters:
            try:
                emit(ev)
            except Exception:  # noqa: BLE001 — as above
                pass
    finally:
        _lock.release()


class Span:
    """Timing scope: measures wall seconds between enter and exit (always —
    ``.wall_s`` is valid whether or not the stream is on) and records one
    ``{event: name, wall_s: ...}`` event when enabled."""

    __slots__ = ("name", "fields", "wall_s", "_t0")

    def __init__(self, name: str, fields: Dict[str, Any]):
        self.name = name
        self.fields = fields
        self.wall_s: Optional[float] = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.wall_s = time.perf_counter() - self._t0
        if _enabled:
            record(self.name, wall_s=self.wall_s,
                   ok=exc_type is None, **self.fields)
        return False


def span(name: str, **fields) -> Span:
    """``with telemetry.span("train.step", step=i) as sp: ...`` — see
    :class:`Span`.  ``sp.wall_s`` is the one clock benchmarks and
    production paths share."""
    return Span(name, fields)


def annotation(name: str):
    """A ``torch.profiler.record_function`` range when annotations are
    enabled, else a no-op context — cheap enough to leave on dispatch
    sites."""
    if not (_enabled and _annotate):
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


# ---------------------------------------------------------------------------
# Ring crash-flush: REPRO_TELEMETRY=ring keeps the last N events in memory,
# so `enable_from_env` registers an atexit flush (atexit runs on unhandled-
# exception exits too), and `runtime.fault_tolerance` calls `flush_ring`
# on the fatal-fault path so the last-N events land next to the
# `recovery.fault` event.
# ---------------------------------------------------------------------------

#: env var naming the directory run artifacts (ring flushes) land in
TELEMETRY_DIR_ENV = "REPRO_TELEMETRY_DIR"

#: default ring-flush filename; lands under `telemetry_dir()`; override the
#: full path with ``REPRO_TELEMETRY=ring:/path/to/flush.jsonl``
RING_FLUSH_DEFAULT = "repro_telemetry_ring.jsonl"

_ring_flush_path: Optional[str] = None   # set by enable_from_env("ring[:p]")
_atexit_registered = False


def telemetry_dir() -> str:
    """The run's telemetry artifact directory: ``REPRO_TELEMETRY_DIR`` when
    set, else ``artifacts/telemetry`` under the working directory.  Not
    created until something is written into it."""
    return os.environ.get(TELEMETRY_DIR_ENV, "").strip() or \
        os.path.join("artifacts", "telemetry")


def _default_flush_target() -> str:
    return _ring_flush_path or os.path.join(telemetry_dir(),
                                            RING_FLUSH_DEFAULT)


def ring_events() -> List[Dict[str, Any]]:
    """Snapshot of every installed RingBuffer sink's events (oldest first,
    concatenated across rings).  Empty when no ring sink is installed —
    callers (`run_with_recovery` attaching the tail to `RunResult`) need no
    mode check."""
    return [ev for s in _sinks if isinstance(s, RingBuffer)
            for ev in s.events]


def flush_ring(path: Optional[str] = None) -> int:
    """Write the current ring snapshot to ``path`` (default: the
    ``ring:<path>`` target from ``REPRO_TELEMETRY``, else
    ``RING_FLUSH_DEFAULT`` under `telemetry_dir`) as JSONL readable by
    `read_jsonl`.  Returns the number of events written; 0 (and no file
    touched) when no ring sink is installed or the ring is empty.  Never
    raises — this runs on crash paths."""
    evs = ring_events()
    if not evs:
        return 0
    target = path or _default_flush_target()
    try:
        parent = os.path.dirname(target)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(target, "w") as f:
            for ev in evs:
                f.write(json.dumps(
                    {k: _jsonable(v) for k, v in ev.items()}) + "\n")
    except Exception:  # noqa: BLE001 — a failing flush must not mask the
        return 0       # fault that triggered it
    return len(evs)


def _flush_ring_atexit() -> None:
    n = flush_ring()
    if n:
        import logging
        logging.getLogger("repro_torch.telemetry").info(
            "flushed %d ring events to %s", n, _default_flush_target())


def enable_from_env() -> bool:
    """The ``REPRO_TELEMETRY`` hook: ``"ring"`` installs a RingBuffer
    (``"ring:/path.jsonl"`` names where the crash/atexit flush lands —
    default `RING_FLUSH_DEFAULT` under `telemetry_dir`), anything else is
    treated as a JSONL
    output path.  Ring mode registers an atexit flush so the last-N events
    survive a crash.  Returns True when the stream was enabled.  Called by
    `launch.train` so unmodified training invocations can be instrumented
    from the environment.  The reference package reads the same variable.
    """
    global _ring_flush_path, _atexit_registered
    target = os.environ.get(TELEMETRY_ENV, "").strip()
    if not target:
        return False
    if target == "ring" or target.startswith("ring:"):
        _, _, flush_to = target.partition(":")
        _ring_flush_path = flush_to.strip() or None
        enable(RingBuffer())
        if not _atexit_registered:
            import atexit
            atexit.register(_flush_ring_atexit)
            _atexit_registered = True
    else:
        enable(JsonlWriter(target))
    return True
