"""Contract observation hooks: how the static analyzer sees the atomics API.

Port of `repro.atomics.contracts`.  The atomics entry points
(`AtomicTable.__init__`, `execute`, `execute_until`) and
`runtime.fault_tolerance.declare_donation`'s wrapper call :func:`notify`
with their call-site contract (table, op, tier arguments, donated
argnums); an installed observer — `repro_torch.analysis` during a
`check()` run — records them beside the ops that run.  With no observer
installed, a call costs one module-global read.  Observer exceptions are
kept in :data:`_errors` and never reach the observed code.

:func:`mark` is the reference's marker primitive in eager form: a jaxpr's
``Var`` does not keep its identity across jax's passes, so the reference
tags dataflow with an identity equation; an eager tensor does keep it, so
the port's marker records ``(tensor, role, params)`` in the observer's
log and returns the tensor itself.
"""

from __future__ import annotations

import contextlib
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the one hot-path guard; installed by :func:`observe`
_observer: Optional[Callable[[str, Dict[str, Any]], None]] = None

#: exceptions raised *by the observer* (never propagated into dispatch)
_errors: List[str] = []

#: path fragments naming the sanctioned RMW implementation modules: a
#: write whose Python stack passes through one of these came from the
#: engine itself, not from user code bypassing it.  `repro_torch.analysis.
#: rules` is the consumer; the list lives here because it IS the contract
#: ("these modules may touch table memory directly").
SANCTIONED_PATHS: Tuple[str, ...] = (
    "repro_torch/core/rmw",        # rmw.py, rmw_engine.py, rmw_sharded.py
    "repro_torch/atomics/",        # front-end, retry, reshard internals
    "repro_torch/kernels/rmw",     # the Hopper kernels' wrappers
)


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
    global _observer, _site_counter
    prev = _observer
    _observer = callback
    _site_counter = 0
    _errors.clear()
    try:
        yield _errors
    finally:
        _observer = prev


#: the role the observer's log gives a marked tensor (`mark`): the name
#: the reference's identity primitive carries
MARKER = "atomics_lint_marker"

_site_counter = 0


def next_site() -> int:
    """Fresh id tying an `execute` observation to its marked operands."""
    global _site_counter
    _site_counter += 1
    return _site_counter


def mark(x, role: str, **params):
    """Report ``x`` to the installed observer as a `MARKER` site with
    ``role`` (and ``params``), and return ``x`` itself.  Outside
    observation it does nothing: an eager tensor keeps its identity, so
    the observer's log can name it without an op in the dataflow."""
    cb = _observer
    if cb is None or x is None:
        return x
    try:
        cb(MARKER, dict(tensor=x, role=role, **params))
    except Exception:  # noqa: BLE001 — marking must never break dispatch
        _errors.append(traceback.format_exc())
    return x


def caller_site(skip: Tuple[str, ...] = ("repro_torch/atomics/",
                                         "repro_torch/analysis/",
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
