"""Model validation — the paper's NRMSE gate (Eq. 12, §5).

NRMSE = (1/x̄) * sqrt( (1/n) Σ (x̂_i - x_i)² )

The paper discusses every case where model-vs-data NRMSE exceeds 10%.  We use
the same metric and the same 10% gate in `benchmarks/model_validation.py` and
`tests/test_perf_model.py`.

This is the port's copy of `repro.core.validation` (pure Python);
`repro_torch.benchmarks.model_validation` gates with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


def nrmse(predicted: Sequence[float], observed: Sequence[float]) -> float:
    if len(predicted) != len(observed) or not observed:
        raise ValueError("predicted and observed must be equal-length, non-empty")
    n = len(observed)
    mean = sum(observed) / n
    if mean == 0:
        raise ValueError("observed mean is zero; NRMSE undefined")
    se = sum((p - o) ** 2 for p, o in zip(predicted, observed)) / n
    return math.sqrt(se) / abs(mean)


NRMSE_GATE = 0.10  # the paper's 10% discussion threshold


@dataclass(frozen=True)
class ValidationRow:
    """One (op, placement) validation cell: prediction vs median measurement."""

    label: str
    predicted_s: float
    observed_s: float

    @property
    def rel_err(self) -> float:
        return abs(self.predicted_s - self.observed_s) / max(self.observed_s, 1e-30)


def validate(rows: Sequence[ValidationRow]) -> dict:
    """Aggregate a validation table the way §5 does: NRMSE + flagged cells."""
    preds = [r.predicted_s for r in rows]
    obs = [r.observed_s for r in rows]
    score = nrmse(preds, obs)
    flagged = [r.label for r in rows if r.rel_err > NRMSE_GATE]
    return {"nrmse": score, "passes": score <= NRMSE_GATE, "flagged": flagged,
            "n": len(rows)}
