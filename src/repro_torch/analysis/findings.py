"""Typed findings: what every analysis rule returns.

Port of `repro.analysis.findings` (pure Python).  A :class:`Finding` is
one diagnosed contract violation with enough provenance to act on: the
rule id (A001..A005 — see :data:`RULES`), a severity (``error`` fails
``python -m repro_torch.analysis.lint``; ``warning`` does not), the source
location the offending op (or API call site) was issued from, and a human
message that says what to do instead.

Suppression is source-comment based, pylint-style: a finding is marked
``suppressed`` when the flagged line — or the line directly above it —
carries ``# atomics-lint: disable=<rule-id>[,<rule-id>...]`` (or
``disable=all``).  Suppressions are *visible* in lint output (counted, not
hidden) so a silenced true positive stays auditable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

ERROR = "error"
WARNING = "warning"

#: rule id -> (default severity, one-line description)
RULES: Dict[str, Tuple[str, str]] = {
    "A000": (ERROR,
             "analysis could not complete — the recorded run raised for an "
             "undiagnosed reason or an entry point crashed; never a clean "
             "pass"),
    "A001": (ERROR,
             "raw scatter write into an AtomicTable-typed buffer (or "
             "duplicate-capable scatter on a multiply-written buffer) — "
             "bypasses atomics.execute; the order of duplicate-index "
             "writes is undefined"),
    "A002": (WARNING,
             "CAS batch expressible as a lower-consensus-number primitive "
             "(Faa/Min/Max/Swp) — arxiv 1802.03844"),
    "A003": (WARNING,
             "while loop wraps a CAS with data-dependent trip count and no "
             "round bound — use atomics.execute_until(max_rounds=...)"),
    "A004": (ERROR,
             "donated buffer read after the donating call — the PR-6 "
             "recovery-restart bug class (pass a zero-arg state factory)"),
    "A005": (ERROR,
             "sharded-table execute without a mesh that binds its axes, "
             "or mixed reverse_ranks directions across a combine tree"),
}

#: the magic comment token (``# atomics-lint: disable=A001``)
SUPPRESS_TOKEN = "atomics-lint:"


@dataclasses.dataclass
class Finding:
    """One diagnosed violation.

    ``file``/``line`` point at user source (the innermost user frame of
    the recorded op, or the recorded API call site); ``provenance`` names
    the aten op / call path for debugging; ``entry`` the registered entry
    point a CLI sweep found it under.
    """

    rule: str
    severity: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    entry: Optional[str] = None
    provenance: Optional[str] = None
    suppressed: bool = False

    @property
    def where(self) -> str:
        if self.file is None:
            return "<unknown>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def format(self) -> str:
        sup = " [suppressed]" if self.suppressed else ""
        prov = f"  ({self.provenance})" if self.provenance else ""
        return (f"{self.where}: {self.severity.upper()} {self.rule}{sup}: "
                f"{self.message}{prov}")


def make_finding(rule: str, message: str, *, file=None, line=None,
                 provenance=None, severity: Optional[str] = None) -> Finding:
    """Construct a Finding with the rule's default severity."""
    default_sev, _ = RULES[rule]
    return Finding(rule=rule, severity=severity or default_sev,
                   message=message, file=file, line=line,
                   provenance=provenance)


@functools.lru_cache(maxsize=256)
def _source_lines(path: str) -> Tuple[str, ...]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return tuple(f.readlines())
    except OSError:
        return ()


def _line_suppresses(text: str, rule: str) -> bool:
    pos = text.find(SUPPRESS_TOKEN)
    if pos < 0:
        return False
    rest = text[pos + len(SUPPRESS_TOKEN):]
    if "disable=" not in rest:
        return False
    spec = rest.split("disable=", 1)[1].split()[0]
    ids = {s.strip() for s in spec.split(",")}
    return "all" in ids or rule in ids


def apply_suppressions(findings) -> None:
    """Mark findings whose flagged line (or the line above) carries a
    matching ``# atomics-lint: disable=`` comment.  In place."""
    for f in findings:
        if f.file is None or not f.line:
            continue
        lines = _source_lines(f.file)
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines) and _line_suppresses(lines[ln - 1],
                                                          f.rule):
                f.suppressed = True
                break
