"""Fault tolerance: retrying step executor, straggler detection, elasticity.

Port of `repro.runtime.fault_tolerance`.  `RunResult.events` (and
`event_counts`) carry the run's recovery trace as in the reference; each
event also goes to the global telemetry stream, whose last-N ring (when a
`telemetry.RingBuffer` sink is installed) comes back in
``RunResult.telemetry_ring`` and is flushed to disk on a fatal fault.

On a real multi-pod deployment, chip/host loss surfaces as a Python exception
from the collective runtime; the recovery sequence is: tear down, re-init the
mesh (possibly smaller — elastic), restore the latest VALID checkpoint
(`checkpoint.ckpt.restore_latest_valid` walks back past corrupt ones),
reshard live `AtomicTable` state onto the new mesh (`reshard_fn`, normally
`runtime.elastic.reshard_tables` — layout re-derivation, not history
replay), and resume from the checkpointed step (the deterministic data
pipeline makes the resume bit-exact).  This module implements that state
machine.

Recovery pacing follows Lightweight Contention Management
(arxiv 1305.5800): failure feedback drives an **explicit policy** —
exponential backoff with deterministic jitter between recovery attempts
(so a fleet of restarting hosts does not re-stampede the same resource),
a wall-clock ``deadline_s`` budget after which recovery gives up, and a
retryable/fatal split (`FatalFault`, ``FaultConfig.fatal_types``) so
misconfiguration is never retried like chip loss.

Faults are injected by the deterministic chaos subsystem
(`runtime.chaos.FaultPlan`) at the named sites of the loop —
``straggler_delay`` / ``step`` / ``ckpt_save`` / ``ckpt_restore`` /
``reshard`` — seeded and replayable; the legacy ``failure_injector``
callback is kept as a thin shim for hand-written step-site crashes.  Set
``REPRO_CHAOS`` (e.g. ``"seed=7,step=0.05,ckpt_save=0.1@2"``) to run any
caller under faults without code changes.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from repro_torch import telemetry
from repro_torch.runtime.chaos import FaultPlan

log = logging.getLogger("repro_torch.runtime")


class FatalFault(Exception):
    """A failure recovery must NOT absorb (misconfiguration, corrupted
    source of truth, operator abort).  Raising it — or any class listed in
    ``FaultConfig.fatal_types`` — propagates immediately, no retry."""


@dataclass
class FaultConfig:
    max_failures: int = 3
    checkpoint_every: int = 50
    straggler_window: int = 20
    straggler_threshold: float = 2.0     # x median step time

    # recovery pacing (arxiv 1305.5800: explicit backoff, not blind retry)
    backoff_base_s: float = 0.01         # first retry delay
    backoff_factor: float = 2.0          # growth per consecutive failure
    backoff_max_s: float = 2.0           # delay ceiling
    backoff_jitter: float = 0.1          # ± fraction, de-stampedes a fleet
    backoff_seed: int = 0                # deterministic jitter stream
    deadline_s: Optional[float] = None   # wall-clock recovery budget
    fatal_types: Tuple[type, ...] = ()   # never retried (FatalFault always)


def backoff_delay(cfg: FaultConfig, failures: int) -> float:
    """Delay before recovery attempt ``failures`` (1-based): capped
    exponential with deterministic jitter — a pure function of
    ``(cfg, failures)``, so a replayed chaos run paces identically."""
    base = min(cfg.backoff_max_s,
               cfg.backoff_base_s * cfg.backoff_factor ** max(0, failures - 1))
    u = random.Random(cfg.backoff_seed * 1_000_003 + failures).uniform(-1.0,
                                                                       1.0)
    return max(0.0, base * (1.0 + cfg.backoff_jitter * u))


class StragglerMonitor:
    """Per-host step-time tracker (paper §5.4 analogue: one slow participant
    serializes the collective, like one contended owner serializes the RMW).

    flag() returns hosts whose recent mean step time exceeds
    threshold x fleet median — the launcher reassigns their data shards and
    excludes them at the next elastic restart.
    """

    def __init__(self, n_hosts: int, cfg: FaultConfig):
        self.cfg = cfg
        self.times: List[List[float]] = [[] for _ in range(n_hosts)]

    def record(self, host: int, seconds: float) -> None:
        w = self.times[host]
        w.append(seconds)
        if len(w) > self.cfg.straggler_window:
            w.pop(0)

    def flag(self) -> List[int]:
        means = [sum(w) / len(w) if w else 0.0 for w in self.times]
        active = sorted(m for m in means if m > 0)
        if not active:
            return []
        median = active[len(active) // 2]
        return [i for i, m in enumerate(means)
                if m > self.cfg.straggler_threshold * median]


class _DonatingStep:
    """A step callable carrying machine-readable donation metadata, which
    `declare_donation` constructs and `run_with_recovery`'s startup check
    reads (the reference's static analyzer, rule A004, too).
    """

    __slots__ = ("fn", "donate_argnums")

    def __init__(self, fn: Callable, donate_argnums: Tuple[int, ...]):
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self) -> str:
        return (f"_DonatingStep({self.fn!r}, "
                f"donate_argnums={self.donate_argnums})")


def declare_donation(fn: Callable, argnums) -> "_DonatingStep":
    """Annotate a step function with the argnums whose buffers it consumes
    (updates in place or frees).

    Purely metadata — the wrapper calls ``fn`` unchanged.  The port's
    `atomics.execute` clones a table before its kernels write it, so a
    step built on it donates nothing; one that writes its input tensors in
    place does, and must be run from a state factory.
    """
    if isinstance(argnums, int):
        argnums = (argnums,)
    return _DonatingStep(fn, tuple(argnums))


@dataclass
class RunResult:
    """Outcome of :func:`run_with_recovery`.

    ``events`` is the run's structured recovery trace — one dict per
    ``recovery.fault`` / ``recovery.backoff`` / ``recovery.restore``
    occurrence, in order, always populated (telemetry enabled or not) so
    tests and callers assert on fields instead of parsing log text.

    ``telemetry_ring`` is the last-N global event stream at run end when a
    `telemetry.RingBuffer` sink is installed (``REPRO_TELEMETRY=ring``) —
    empty otherwise.  The same snapshot is flushed to disk on the fatal
    fault path (`telemetry.flush_ring`).
    """

    steps_done: int
    failures: int
    restored_from: List[int] = field(default_factory=list)
    backoff_total_s: float = 0.0
    events: List[dict] = field(default_factory=list)
    telemetry_ring: List[dict] = field(default_factory=list)

    def event_counts(self) -> dict:
        counts: dict = {}
        for e in self.events:
            counts[e["event"]] = counts.get(e["event"], 0) + 1
        return counts


def run_with_recovery(step_fn: Callable[[int, Any], Any],
                      init_state: Any,
                      n_steps: int,
                      cfg: FaultConfig,
                      save_fn: Callable[[int, Any], None],
                      restore_fn: Callable[[], Optional[tuple]],
                      failure_injector: Optional[Callable[[int], None]] = None,
                      reshard_fn: Optional[Callable[[Any], Any]] = None,
                      chaos: Optional[FaultPlan] = None,
                      sleep_fn: Callable[[float], None] = time.sleep
                      ) -> RunResult:
    """Drive `step_fn(step, state) -> state` with checkpoint/restart recovery.

    `init_state` is the starting state, or a ZERO-ARG FACTORY returning a
    fresh one — pass a factory whenever `step_fn` donates its input
    buffers (`declare_donation`): a post-failure scratch restart must
    rebuild state, because the original buffers were consumed by step 0.
    `restore_fn() -> (step, state) | None` returns the latest *valid*
    checkpoint (wire it to `ckpt.restore_latest_valid` so a corrupt newest
    step costs one checkpoint interval, not the run).
    `reshard_fn(state) -> state`, when given, is applied to every restored
    state before stepping resumes — the elastic-restart hook: the launcher
    wires it to `runtime.elastic.reshard_tables` (itself
    `atomics.reshard.migrate` over the state tree) so live `AtomicTable`s
    land on the post-failure mesh with their owner-major layout re-derived
    instead of their RMW history replayed.

    `chaos` is the fault schedule (`runtime.chaos.FaultPlan`); None reads
    ``REPRO_CHAOS`` from the environment (null plan when unset).
    `failure_injector(step)` is the legacy hand-written step-site hook,
    kept as a thin shim — prefer a seeded plan.

    Every failure is classified: ``FatalFault`` / ``cfg.fatal_types``
    propagate untouched; anything else is retried behind
    :func:`backoff_delay` (logged, accumulated in
    ``RunResult.backoff_total_s``) until ``max_failures`` or the
    ``deadline_s`` wall-clock budget is exhausted.  A failure during
    restore itself is retryable the same way.
    """
    plan = chaos if chaos is not None else FaultPlan.from_env()
    donated = getattr(step_fn, "donate_argnums", None)
    if donated and not callable(init_state):
        # a donating step consumes the captured buffers on step 0, so every
        # scratch restart would replay aliased garbage.  Deliberately NOT
        # in the run-local events trace (RunResult.event_counts is API) —
        # it is a static property of the call, not a recovery occurrence.
        telemetry.record("recovery.donation_hazard",
                         donate_argnums=tuple(donated))
        log.warning(
            "step_fn declares donate_argnums=%s but init_state is a "
            "captured value — pass a zero-arg factory so post-failure "
            "scratch restarts rebuild fresh buffers",
            tuple(donated))
    t_start = time.monotonic()
    failures = 0
    backoff_total = 0.0
    restored: List[int] = []
    events: List[dict] = []

    def _emit(event: str, **fields) -> None:
        # the run-local trace is ALWAYS kept (RunResult.events is API);
        # the global stream only sees it when telemetry is enabled
        events.append({"event": event, **fields})
        telemetry.record(event, **fields)

    def _flush_ring(reason: str) -> None:
        # the fault is about to propagate out of the recovery loop: land
        # the last-N ring events on disk next to the recovery.fault event
        # (a no-op without a ring sink; never raises)
        n = telemetry.flush_ring()
        if n:
            log.error("flushed %d telemetry ring events (%s)", n, reason)

    def _absorb(e: BaseException, what: str) -> None:
        """Count a failure; re-raise fatal/over-budget, else back off."""
        nonlocal failures, backoff_total
        if isinstance(e, FatalFault) or isinstance(e, cfg.fatal_types):
            _emit("recovery.fault", site=what, error=type(e).__name__,
                  message=str(e), attempt=failures + 1, fatal=True)
            log.error("%s failed with fatal %s: %s — not retrying",
                      what, type(e).__name__, e)
            _flush_ring(f"fatal fault at {what}")
            raise e
        failures += 1
        _emit("recovery.fault", site=what, error=type(e).__name__,
              message=str(e), attempt=failures, fatal=False,
              budget=cfg.max_failures)
        log.warning("%s failed (%s: %s); recovery %d/%d", what,
                    type(e).__name__, e, failures, cfg.max_failures)
        if failures > cfg.max_failures:
            _flush_ring(f"failure budget exhausted at {what}")
            raise e
        elapsed = time.monotonic() - t_start
        if cfg.deadline_s is not None and elapsed > cfg.deadline_s:
            _flush_ring(f"recovery deadline exceeded at {what}")
            raise TimeoutError(
                f"recovery deadline {cfg.deadline_s:.3f}s exceeded "
                f"({elapsed:.3f}s elapsed, {failures} failures); "
                f"last error: {type(e).__name__}: {e}") from e
        delay = backoff_delay(cfg, failures)
        backoff_total += delay
        _emit("recovery.backoff", attempt=failures, backoff_s=delay)
        log.info("recovery backoff: sleeping %.4fs before attempt %d",
                 delay, failures + 1)
        sleep_fn(delay)

    def _adopt(s):
        if reshard_fn is None:
            return s
        plan.visit("reshard")
        return reshard_fn(s)

    def _initial():
        return init_state() if callable(init_state) else init_state

    def _restore_and_adopt(scratch_adopts: bool) -> Tuple[int, Any]:
        plan.visit("ckpt_restore")
        ck = restore_fn()
        if ck is None:
            # a POST-FAILURE restart from scratch still crosses the mesh
            # change, so the initial state's live tables need adopting;
            # scratch at startup does not — init_state was built under
            # the current mesh
            _emit("recovery.restore", step=0, scratch=True,
                  resharded=scratch_adopts and reshard_fn is not None)
            return 0, _adopt(_initial()) if scratch_adopts else _initial()
        s, st = ck
        st = _adopt(st)
        restored.append(s)
        _emit("recovery.restore", step=s, scratch=False,
              resharded=reshard_fn is not None)
        return s, st

    def _recover(what: str, scratch_adopts: bool = True) -> Tuple[int, Any]:
        while True:
            try:
                return _restore_and_adopt(scratch_adopts)
            except Exception as e:  # noqa: BLE001 — restore is retryable too
                _absorb(e, what)

    step, state = _recover("initial restore", scratch_adopts=False)
    if restored:
        log.info("resumed from checkpoint at step %d", step)
    while step < n_steps:
        try:
            plan.visit("straggler_delay", step=step)
            if failure_injector is not None:   # legacy step-site shim
                failure_injector(step)
            plan.visit("step", step=step)
            state = step_fn(step, state)
            step += 1
            if step % cfg.checkpoint_every == 0 or step == n_steps:
                plan.visit("ckpt_save", step=step)
                save_fn(step, state)
        except Exception as e:  # noqa: BLE001 — chip loss shows up as generic
            _absorb(e, f"step {step}")
            step, state = _recover("restore")
    return RunResult(steps_done=step, failures=failures,
                     restored_from=restored,
                     backoff_total_s=backoff_total, events=events,
                     telemetry_ring=telemetry.ring_events())
