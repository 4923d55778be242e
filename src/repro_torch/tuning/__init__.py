"""`repro_torch.tuning` — guarded self-tuning of the HardwareSpec cost model.

Port of `repro.tuning`, the feedback loop that closes the telemetry
layer's drift measurement:

* :class:`SpecController` — folds the live telemetry drift window into the
  active `HardwareSpec` on a cadence and swaps it into all three selector
  tiers through `rmw_engine.set_live_spec`, behind clamp / hysteresis /
  rollback / quarantine guardrails and validated persistence
  (`repro_torch.tuning.controller`; on a mesh, one spec on every rank).
* :class:`ContentionEstimator` — EWMA ``distinct_slots`` inference per
  repeated call site, fed by `execute_until`'s collision counts (on the
  card, the ``slot_counts`` kernel's) and round histograms, consulted when
  the caller passes no hint (`repro_torch.tuning.estimator`).
* ``spec_perturb`` — the chaos site (`runtime.chaos`) that poisons the
  live spec or skews drift samples inside the update cycle.

The invariant everything here leans on: the spec and the estimator steer
**selection only** — every backend and strategy equals the serialized
oracle, so a tuned run's int32 results are bit-equal to an untuned run's.
"""

from repro_torch.tuning.controller import (TUNABLE_FIELDS, TUNING_ENV,
                                           SpecController, TuningConfig,
                                           active_controller,
                                           active_estimator, from_env)
from repro_torch.tuning.estimator import (ContentionEstimator, SiteKey,
                                          site_key)

__all__ = [
    "TUNABLE_FIELDS", "TUNING_ENV", "SpecController", "TuningConfig",
    "active_controller", "active_estimator", "from_env",
    "ContentionEstimator", "SiteKey", "site_key",
]
