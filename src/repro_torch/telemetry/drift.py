"""Cost-model drift: predicted-vs-measured aggregation over the event stream.

Port of `repro.telemetry.drift`, on the port's `HardwareSpec`.

The selector tiers (`select_backend` / `select_exchange` /
`select_migration`) stamp every decision event with ``predicted_s``; the
host-side call sites stamp ``measured_s``.  This module folds those pairs
into per-``(tier, choice, op, size-bucket)`` drift statistics — the
*geometric* mean of ``measured / predicted`` (ratios are multiplicative:
a model off by 2x slow and 2x fast should average to 1, not 1.25) — and
turns persistent drift into a proposed `HardwareSpec` correction
(:func:`fit_spec_update`), closing the ROADMAP's self-tuning loop: the
constants the paper measured once per architecture (Table 2/3) become
constants the *stack* re-measures continuously in production.

Input is any iterable of event dicts — a live :class:`~repro_torch.
telemetry.core.RingBuffer`'s ``.events``, or a JSONL capture via
:func:`from_jsonl`.

`SPEC_FIELD_OF` is the reference's table.  The card's kernel backend,
``("local", "cuda")``, stays unmapped as ``("local", "pallas")`` is in the
reference: its drift is measured and reported, but no spec constant is
fitted from it (the kernels' constants are fitted by the Table 2/3
calibration, not by the dominant-term rule here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.telemetry.core import read_jsonl

#: events carrying a (predicted_s, measured_s) pair worth folding in
DRIFT_EVENTS = ("atomics.execute", "atomics.retry.round",
                "atomics.reshard.migrate")

#: drift-group key: (tier, choice, op, size_bucket)
Key = Tuple[str, str, str, str]


@dataclasses.dataclass
class DriftStat:
    """Running drift of one (tier, choice, op, size-bucket) group.

    ``ratio`` (the headline number) is the geometric mean of
    ``measured_s / predicted_s`` — 1.0 means the cost model is calibrated,
    2.0 means the hardware is 2x slower than the model thinks.
    """

    n: int = 0
    log_sum: float = 0.0
    min_ratio: float = math.inf
    max_ratio: float = -math.inf
    predicted_sum: float = 0.0
    measured_sum: float = 0.0

    def add(self, predicted: float, measured: float) -> None:
        r = measured / predicted
        self.n += 1
        self.log_sum += math.log(r)
        self.min_ratio = min(self.min_ratio, r)
        self.max_ratio = max(self.max_ratio, r)
        self.predicted_sum += predicted
        self.measured_sum += measured

    @property
    def ratio(self) -> float:
        return math.exp(self.log_sum / self.n) if self.n else float("nan")

    def as_dict(self) -> Dict[str, Any]:
        return {"n": self.n, "ratio": self.ratio,
                "min_ratio": self.min_ratio, "max_ratio": self.max_ratio,
                "mean_predicted_s": self.predicted_sum / max(1, self.n),
                "mean_measured_s": self.measured_sum / max(1, self.n)}


def size_bucket(n: Optional[int]) -> str:
    """Power-of-two bucket label for a batch/table size (``"2^k"``)."""
    if n is None or n < 1:
        return "?"
    return f"2^{max(0, int(n) - 1).bit_length()}"


def _choice(ev: Dict[str, Any]) -> Optional[str]:
    if ev.get("event") == "atomics.reshard.migrate":
        return ev.get("path")
    return ev.get("backend") or ev.get("strategy")


def _size(ev: Dict[str, Any]) -> Optional[int]:
    for k in ("n_exec", "n", "n_slots"):
        v = ev.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return int(v)
    return None


def aggregate(events: Iterable[Dict[str, Any]]) -> Dict[Key, DriftStat]:
    """Fold an event stream into per-group drift statistics.

    Only events with a *positive* predicted and measured time contribute —
    traced decision events (no wall time) and oracle-path events (no
    prediction) are informative elsewhere but carry no drift signal.
    """
    out: Dict[Key, DriftStat] = {}
    for ev in events:
        if ev.get("event") not in DRIFT_EVENTS:
            continue
        pred, meas = ev.get("predicted_s"), ev.get("measured_s")
        if not isinstance(pred, (int, float)) or isinstance(pred, bool) \
                or not isinstance(meas, (int, float)) \
                or isinstance(meas, bool) or pred <= 0 or meas <= 0:
            continue
        key: Key = (str(ev.get("tier", "?")), str(_choice(ev) or "?"),
                    str(ev.get("op", "-")), size_bucket(_size(ev)))
        out.setdefault(key, DriftStat()).add(float(pred), float(meas))
    return out


def from_jsonl(path: str) -> Dict[Key, DriftStat]:
    return aggregate(read_jsonl(path))


def summarize(stats: Dict[Key, DriftStat]) -> List[Dict[str, Any]]:
    """Flat row-per-group view, most-drifted first (|log ratio| descending)."""
    rows = []
    for (tier, choice, op, bucket), st in stats.items():
        rows.append({"tier": tier, "choice": choice, "op": op,
                     "size_bucket": bucket, **st.as_dict()})
    rows.sort(key=lambda r: abs(math.log(r["ratio"])), reverse=True)
    return rows


# ---------------------------------------------------------------------------
# Spec correction: drift -> proposed HardwareSpec constants
# ---------------------------------------------------------------------------

#: which spec constant each (tier, choice) drift pool scales, and in which
#: direction: "direct" constants are latencies (2x-slow hardware -> 2x the
#: constant), "inverse" are bandwidths (2x-slow -> HALF the Bps)
SPEC_FIELD_OF = {
    ("local", "serialized"): ("loop_step_s", "direct"),
    ("local", "sort"): ("sort_elem_pass_s", "direct"),
    ("local", "onehot"): ("gather_elem_s", "direct"),
    ("sharded", "oneshot"): ("collective_launch_s", "direct"),
    ("sharded", "hierarchical"): ("collective_launch_s", "direct"),
    ("sharded", "naive"): ("collective_launch_s", "direct"),
    ("sharded", "dense"): ("collective_launch_s", "direct"),
    ("migration", "exchange"): ("collective_launch_s", "direct"),
    ("migration", "device_put"): ("host_roundtrip_Bps", "inverse"),
}

#: don't propose a correction from fewer samples than this per field
MIN_SAMPLES = 3


def _min_samples_for(name: str, min_samples) -> int:
    """Per-field sample floor: an int applies to every field; a mapping is
    consulted per field name with ``"*"`` as its default (falling back to
    `MIN_SAMPLES`)."""
    if isinstance(min_samples, int):
        return min_samples
    return int(min_samples.get(name, min_samples.get("*", MIN_SAMPLES)))


def fit_spec_update(stats: Dict[Key, DriftStat], spec=None, *,
                    min_samples=MIN_SAMPLES) -> Dict[str, Any]:
    """Turn per-group drift into proposed `HardwareSpec` constants.

    Groups mapping to the same field pool their log-ratios (sample-count
    weighted) into one field-level geometric drift; the proposal scales the
    current constant by it ("inverse" fields — bandwidths — divide instead).
    The dominant-term assumption is deliberate: each backend's cost is
    linear in exactly one spec constant at the sizes the selector's
    crossover points care about, so a multiplicative residual on the total
    is (to first order) a multiplicative residual on that constant — the
    same reasoning the paper uses to read Table 2 constants off median
    latencies.

    ``min_samples`` is either one int floor for every field, or a mapping
    ``{field_name: floor}`` (key ``"*"`` sets the default) — the tuning
    controller uses per-field floors to demand more evidence for
    high-blast-radius constants.  Fields *below* their floor are no longer
    silently dropped: they come back under ``"skipped"`` so reports and the
    controller can surface them.  Returns::

        {"fields": {name: {"current", "proposed", "ratio", "n"}},
         "skipped": {name: {"n", "min_samples"} | {"reason": ...}},
         "spec": <HardwareSpec with proposals applied>}
    """
    if spec is None:
        from repro_torch.core import rmw_engine
        spec = rmw_engine.default_spec()
    pools: Dict[Tuple[str, str], List[float]] = {}   # field -> [log r] pool
    for (tier, choice, _op, _bucket), st in stats.items():
        target = SPEC_FIELD_OF.get((tier, choice))
        if target is None or st.n == 0:
            continue
        pools.setdefault(target, []).extend([st.log_sum / st.n] * st.n)
    fields: Dict[str, Dict[str, float]] = {}
    skipped: Dict[str, Dict[str, Any]] = {}
    updates: Dict[str, float] = {}
    for (name, sense), logs in pools.items():
        floor = _min_samples_for(name, min_samples)
        if len(logs) < floor:
            skipped[name] = {"n": len(logs), "min_samples": floor}
            continue
        ratio = math.exp(sum(logs) / len(logs))
        current = float(getattr(spec, name, 0.0) or 0.0)
        if current <= 0.0:
            skipped[name] = {"n": len(logs), "min_samples": floor,
                             "reason": "field unset on spec"}
            continue
        proposed = current * ratio if sense == "direct" else current / ratio
        fields[name] = {"current": current, "proposed": proposed,
                        "ratio": ratio, "n": len(logs)}
        updates[name] = proposed
    new_spec = dataclasses.replace(spec, **updates) if updates else spec
    return {"fields": fields, "skipped": skipped, "spec": new_spec}
