"""Contention estimator: measured `distinct_slots` per repeated call site.

Port of `repro.tuning.estimator`.  ``distinct_slots`` — the exchange
selector's contention knob (how many distinct table slots a batch touches)
— is a caller-supplied hint.  Lightweight Contention Management (arxiv
1305.5800) argues contention policy must be *measured and adaptive*, and
the measurement is already there: every `execute_until` round knows which
slots it issued (host numpy, one ``np.unique`` away), the round-0 device
pass counts them (`atomics.stats.ContentionStats.distinct_slots`, from the
``slot_counts`` kernel on the card), and the round histogram's
resolved-on-the-first-attempt count is the same quantity seen through
CAS-failure feedback (one winner per contended slot per round).

This module folds those observations into an EWMA per **call site** —
keyed by ``(op kind, tier, size-bucket(m), size-bucket(n))``, the
power-of-two bucketing of the drift tracker, ``m`` the table's global
slots — and serves it back as the ``distinct_slots`` hint for the next
batch of the same shape (`hint` rounds to a power of two, so the decision
caches keyed on it stay bounded).  `execute_until` consults it whenever a
`repro_torch.tuning.SpecController` is running and the caller passed no
hint; the keyword stays an override.

The estimator only shapes *selection* (exchange-strategy caps); like the
live spec it never changes results.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.telemetry import drift

#: call-site key: (op kind, tier, size_bucket(m), size_bucket(n))
SiteKey = Tuple[str, str, str, str]


def site_key(kind: str, tier: str, m: int, n: int) -> SiteKey:
    """The call-site identity two batches share iff the estimator may pool
    their contention observations: same op kind, tier, and power-of-two
    table/batch size buckets."""
    return (str(kind), str(tier), drift.size_bucket(m),
            drift.size_bucket(n))


class ContentionEstimator:
    """EWMA of observed distinct-slot counts per call site.

    ``alpha`` is the EWMA smoothing weight of each new observation; the
    default 0.25 converges in a handful of batches while riding out one
    skewed batch.  Not thread-safe: updates come from the host retry loop,
    reads from the next dispatch on the same thread.
    """

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._ewma: Dict[SiteKey, float] = {}
        self.n_updates = 0
        self.n_updates_host = 0
        self.n_updates_device = 0

    def update(self, key: SiteKey, distinct: int, *,
               source: str = "host") -> None:
        """Fold one observed distinct-slot count into the site's EWMA.
        Counts below 1 carry no signal (nothing was issued) and are
        ignored.  ``source`` tags where the count came from (``"host"``:
        the retry loop's np.unique; ``"device"``: a ContentionStats
        ``distinct_slots`` from the round-0 device pass) — same EWMA and
        site keys either way, the tag only feeds the per-source
        counters."""
        d = float(distinct)
        if not math.isfinite(d) or d < 1.0:
            return
        prev = self._ewma.get(key)
        self._ewma[key] = d if prev is None else \
            prev + self.alpha * (d - prev)
        self.n_updates += 1
        if source == "device":
            self.n_updates_device += 1
        else:
            self.n_updates_host += 1

    def hint(self, key: SiteKey) -> Optional[int]:
        """The site's `distinct_slots` hint: the EWMA rounded to the
        nearest power of two (selection caps only need the order of
        magnitude, and a quantized hint keeps the decision cache key space
        bounded as the EWMA drifts).  None until the site has been
        observed."""
        v = self._ewma.get(key)
        if v is None:
            return None
        return 1 << max(0, int(round(math.log2(max(1.0, v)))))

    def raw(self, key: SiteKey) -> Optional[float]:
        """The unquantized EWMA (observability/tests)."""
        return self._ewma.get(key)

    def sites(self) -> Dict[SiteKey, float]:
        return dict(self._ewma)

    def __len__(self) -> int:
        return len(self._ewma)

    # --- persistence (rides in the controller's state file) ---------------
    def snapshot(self) -> Dict[str, Any]:
        return {"alpha": self.alpha,
                "sites": {"|".join(k): v for k, v in self._ewma.items()}}

    def restore(self, payload: Dict[str, Any]) -> int:
        """Load a `snapshot`; malformed entries are dropped (restores must
        never poison the estimator).  Returns the number of sites kept."""
        kept = 0
        for key_s, v in (payload.get("sites") or {}).items():
            parts = tuple(str(key_s).split("|"))
            if len(parts) != 4 or not isinstance(v, (int, float)) \
                    or isinstance(v, bool) or not math.isfinite(v) \
                    or v < 1.0:
                continue
            self._ewma[parts] = float(v)
            kept += 1
        return kept
