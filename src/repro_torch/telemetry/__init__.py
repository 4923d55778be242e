"""`repro_torch.telemetry` — structured events, drift tracking, profiler hooks.

Port of `repro.telemetry`: the observability layer every tier of the
atomics stack, the recovery loop and the trainer report into:

* `record` / `span` / `annotation` — the instrumentation primitives
  (near-zero cost disabled; see `repro_torch.telemetry.core`;
  `annotation` is a ``torch.profiler.record_function`` range).
* `enable` / `disable` / `capture` / `enable_from_env` — stream control.
* `RingBuffer` / `JsonlWriter` / `Counters` — the pluggable sinks.
* `repro_torch.telemetry.drift` — predicted-vs-measured aggregation over
  the event stream and the `fit_spec_update` HardwareSpec-correction hook.
* ``python -m repro_torch.telemetry.report capture.jsonl`` — render a
  capture.

Event catalogue, the reference's (the port emits every event whose
producer it has; ``analysis.finding`` comes from the reference's static
analysis, ``tuning.*`` from `repro_torch.tuning.SpecController`):

====================  =====================================================
``atomics.execute``   one per `atomics.execute` op batch: tier,
                      backend/strategy chosen, op, n, m, distinct_slots,
                      predicted_s (+ measured_s eager under ``sync``)
``atomics.retry.round``  one per `execute_until` round: pending/issued/
                      resolved counts, strategy, predicted_s, measured_s
``atomics.retry.done``   end of an `execute_until` call: round-count
                      histogram (the contention signal), unresolved count
``contention.stats``  one per ``collect_stats`` batch at a sync boundary:
                      n_ops, distinct_slots, max_occupancy, log2-bucketed
                      occupancy_hist, topk_slots/topk_counts, per-exchange-
                      level level_ops_in/level_ops_out (sharded tier)
``atomics.reshard.migrate``  one per table migration: path chosen,
                      predicted_s per path, measured_s
``recovery.fault``    one per absorbed/raised failure: site, error type,
                      attempt number, fatal flag
``recovery.backoff``  one per recovery backoff sleep: attempt, backoff_s
``recovery.restore``  one per restore: step resumed from (or scratch)
``chaos.fire``        one per injected fault: site, occurrence, step
``train.step``        per-step span from `launch.train`: wall_s, step
``analysis.finding``  one per static-lint finding (static analysis):
                      rule, severity, file, line, entry, suppressed
``recovery.donation_hazard``  startup warning from `run_with_recovery`:
                      donating step_fn + captured init_state (rule A004)
``tuning.apply``      one per live-spec swap by the tuner: fields
                      changed (from/to/ratio), drift score, window size
``tuning.rollback``   controller reverted to the last-good spec: the
                      post-swap drift score that triggered it
``tuning.quarantine`` pathological proposal rejected (NaN/negative/
                      out-of-envelope): field, value, reason — never silent
``tuning.skip``       update cycle that applied nothing: reason
                      (cooldown/deadband/no_fields) + any skipped fields
``tuning.confirm``    post-swap window showed no regression: swap kept
``tuning.restore``    persisted tuned spec validated+reinstalled (or
                      rejected) at controller start
``tuning.perturb``    spec_perturb chaos fired inside the update cycle:
                      kind (skew/poison) + deterministic parameter
====================  =====================================================
"""

from repro_torch.telemetry.core import (Counters, JsonlWriter, RingBuffer,
                                        Sink, Span, add_sink, annotation,
                                        annotations_enabled, capture,
                                        disable, enable, enable_from_env,
                                        enabled, flush_ring, read_jsonl,
                                        record, record_event, remove_sink,
                                        ring_events, sinks, span,
                                        sync_enabled, telemetry_dir,
                                        TELEMETRY_DIR_ENV, TELEMETRY_ENV)

__all__ = [
    "Counters", "JsonlWriter", "RingBuffer", "Sink", "Span",
    "add_sink", "annotation", "annotations_enabled", "capture", "disable",
    "enable", "enable_from_env", "enabled", "flush_ring", "read_jsonl",
    "record", "record_event", "remove_sink", "ring_events", "sinks",
    "span", "sync_enabled", "telemetry_dir",
    "TELEMETRY_DIR_ENV", "TELEMETRY_ENV",
]
