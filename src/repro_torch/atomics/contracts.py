"""Contract observation hooks: how an analyzer sees the atomics API.

Port of `repro.atomics.contracts`, the inert observer only.  The atomics
entry points (`AtomicTable.__init__`, `execute`, `execute_until`) call
:func:`notify` with their call-site contract (table, op, tier arguments);
an installed observer records them.  With no observer installed, a call
costs one module-global read.  Observer exceptions are kept in
:data:`_errors` and never reach the observed code.

(The reference's marker primitive, which tags jaxpr dataflow, comes with
the port of the static analyzer.)
"""

from __future__ import annotations

import contextlib
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the one hot-path guard; installed by :func:`observe`
_observer: Optional[Callable[[str, Dict[str, Any]], None]] = None

#: exceptions raised *by the observer* (never propagated into dispatch)
_errors: List[str] = []


def active() -> bool:
    """True while an observer is installed."""
    return _observer is not None


def notify(site: str, **fields) -> None:
    """Report one contract event to the installed observer (if any).

    ``site`` ∈ {"table", "execute", "execute_until"}; ``fields`` carry the
    live API objects.  Never raises, never mutates its arguments.
    """
    cb = _observer
    if cb is None:
        return
    try:
        cb(site, fields)
    except Exception:  # noqa: BLE001 — observation must not break dispatch
        _errors.append(traceback.format_exc())


@contextlib.contextmanager
def observe(callback: Callable[[str, Dict[str, Any]], None]):
    """Install ``callback`` as the contract observer for the scope; yields
    the list collecting observer-side errors (drained on entry)."""
    global _observer
    prev = _observer
    _observer = callback
    _errors.clear()
    try:
        yield _errors
    finally:
        _observer = prev


def caller_site(skip: Tuple[str, ...] = ("repro_torch/atomics/",
                                         "/torch/")
                ) -> Tuple[Optional[str], Optional[int]]:
    """(file, line) of the innermost stack frame outside the atomics and
    torch machinery — the user call site a finding should point at.
    Best-effort: (None, None) when every frame is machinery."""
    for fr in reversed(traceback.extract_stack()):
        fname = fr.filename.replace("\\", "/")
        if any(s in fname for s in skip):
            continue
        if fname.startswith("<"):          # <string>, <stdin>
            continue
        return fr.filename, fr.lineno
    return None, None
