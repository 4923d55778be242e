"""repro_torch.analysis — the atomics race detector and contract linter.

Port of `repro.analysis`.  `check(fn, *args)` runs ``fn`` once, eagerly,
under a recording ``TorchDispatchMode`` and the
`repro_torch.atomics.contracts` observer (`analysis.trace`), then applies
the rule engine (`analysis.rules`) to the op log and the recorded call
sites:

====  ========  =====================================================
id    severity  what it catches
====  ========  =====================================================
A001  error     raw scatter / ``t[idx] = v`` / ``index_add_`` into an
                AtomicTable buffer, or aliasing-capable scatter races
A002  warning   CAS batches expressible as Faa/Min/Max/Swp
                (consensus number 2 instead of ∞)
A003  warning   unbounded ``while`` + CAS retry loops (use
                ``atomics.execute_until``)
A004  error     donated buffers read after the donating call; donating
                step functions handed to recovery without a factory
A005  error     sharded-table execute without a mesh that binds its
                axes / incoherent mixed ``reverse_ranks``
====  ========  =====================================================

Where the reference reads a jaxpr without running it, the port runs the
function once (on the device asked for: ``device="cpu"`` by default,
``"cuda"`` on the card); its arguments are cloned first, so the caller's
tensors never change.  Suppress a deliberate pattern with
``# atomics-lint: disable=A001`` on (or directly above) the flagged line —
suppressed findings stay visible in output, marked.

CLI: ``python -m repro_torch.analysis.lint`` sweeps the registered entry
points (`repro_torch.analysis.entries`).  Pytest: the ``atomics_lint``
fixture (`repro_torch.analysis.pytest_plugin`).
"""

from __future__ import annotations

import inspect
from typing import Callable, Iterable, List, Optional

from repro_torch import telemetry
from repro_torch.analysis.findings import (ERROR, RULES, WARNING, Finding,
                                           apply_suppressions, make_finding)
from repro_torch.analysis import rules as _rules
from repro_torch.analysis import trace as _trace
from repro_torch.analysis.trace import Spec, spec

__all__ = ["check", "check_recovery", "spec", "Spec", "Finding", "RULES",
           "ERROR", "WARNING"]

_SEV_ORDER = {ERROR: 0, WARNING: 1}


def _finalize(findings: List[Finding], entry: Optional[str],
              ignore: Iterable[str]) -> List[Finding]:
    ignore = set(ignore)
    findings = [f for f in findings if f.rule not in ignore]
    apply_suppressions(findings)
    for f in findings:
        f.entry = entry
        telemetry.record("analysis.finding", rule=f.rule,
                         severity=f.severity, file=f.file, line=f.line,
                         entry=entry, suppressed=f.suppressed,
                         message=f.message)
    findings.sort(key=lambda f: (_SEV_ORDER.get(f.severity, 2), f.rule,
                                 f.where))
    return findings


def check(fn: Callable, *args, entry: Optional[str] = None,
          ignore: Iterable[str] = (), device="cpu", **kwargs
          ) -> List[Finding]:
    """Check ``fn(*args, **kwargs)`` against all rules, running it once.

    Arguments may be tensors, `AtomicTable`s, pytrees of them, or
    :func:`spec` stand-ins (zeros on ``device``); tensors are cloned
    first.  Returns findings sorted errors-first; ``ignore`` drops whole
    rule ids; per-line suppression comments mark (not drop) findings.
    """
    tr = _trace.trace(fn, *args, device=device, **kwargs)
    return _finalize(_rules.run(tr), entry, ignore)


def check_recovery(step_fn: Callable, init_state,
                   *, entry: Optional[str] = None,
                   ignore: Iterable[str] = ()) -> List[Finding]:
    """The API-level half of rule A004: a donating step function handed to
    `runtime.fault_tolerance.run_with_recovery` together with a *captured
    state value* (instead of a zero-arg factory) re-feeds donated buffers
    on every restart.  Donation is read from ``donate_argnums``
    (`declare_donation`) only: torch has no jit to introspect.
    """
    findings: List[Finding] = []
    donated = tuple(getattr(step_fn, "donate_argnums", None) or ())
    if donated and not callable(init_state):
        fn = inspect.unwrap(getattr(step_fn, "fn", step_fn))
        file = line = None
        try:
            file = inspect.getsourcefile(fn)
            _, line = inspect.getsourcelines(fn)
        except (TypeError, OSError):
            pass
        findings.append(make_finding(
            "A004",
            f"step function donates argnums {donated} but "
            f"run_with_recovery received a captured state value — after the "
            f"first step the captured buffers are updated in place or "
            f"freed, and every recovery restart replays them; pass a "
            f"zero-arg state factory (init_state=lambda: ...) so restarts "
            f"rebuild fresh buffers", file=file, line=line,
            provenance="check_recovery"))
    return _finalize(findings, entry, ignore)
