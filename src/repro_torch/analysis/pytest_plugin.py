"""Pytest integration: the ``torch_atomics_lint`` fixture.

Port of `repro.analysis.pytest_plugin`, under a fixture name of its own so
that a suite can hold both packages' fixtures.  Import it into a test
module or ``conftest.py``::

    from repro_torch.analysis.pytest_plugin import torch_atomics_lint  # noqa

Then in tests::

    def test_my_kernel_clean(torch_atomics_lint):
        torch_atomics_lint(my_fn, example_args)     # raises on errors

    def test_entry_points_clean(torch_atomics_lint):
        torch_atomics_lint.sweep()                  # all registered entries

The fixture object is callable (``check`` + assert) and carries
``.sweep(names=None)`` for entry-point sweeps; both raise ``pytest.fail``
with the formatted findings when any unsuppressed error-severity finding
is present, and return the findings list otherwise.  It runs on the CPU
(``AtomicsLint(device="cuda")`` on the card).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import pytest

from repro_torch import analysis
from repro_torch.analysis.findings import ERROR, Finding


class AtomicsLint:
    """Assertion helper wrapping `analysis.check` / `lint.sweep`."""

    def __init__(self, device="cpu"):
        self.device = device

    @staticmethod
    def _gate(findings: List[Finding]) -> List[Finding]:
        errors = [f for f in findings
                  if f.severity == ERROR and not f.suppressed]
        if errors:
            pytest.fail("atomics lint errors:\n" + "\n".join(
                f.format() for f in errors), pytrace=False)
        return findings

    def __call__(self, fn, *args, **kwargs) -> List[Finding]:
        kwargs.setdefault("device", self.device)
        return self._gate(analysis.check(fn, *args, **kwargs))

    def check_recovery(self, step_fn, init_state, **kw) -> List[Finding]:
        return self._gate(analysis.check_recovery(step_fn, init_state,
                                                  **kw))

    def sweep(self, names: Optional[Sequence[str]] = None
              ) -> List[Finding]:
        from repro_torch.analysis.lint import sweep
        return self._gate([f for fs in sweep(names, self.device).values()
                           for f in fs])


@pytest.fixture
def torch_atomics_lint() -> AtomicsLint:
    return AtomicsLint()
