"""Deterministic, seedable fault injection — the chaos half of recovery.

Port of `repro.runtime.chaos`, a copy of its numpy code: the same seed and
spec fault the same visits in either package, and ``REPRO_CHAOS`` faults
both.  A fired fault is logged and recorded on the telemetry stream as
``chaos.fire`` (site, occurrence, step, kind).

The recovery state machine (`runtime.fault_tolerance`) used to be driven by
ad-hoc hand-written ``failure_injector`` callbacks: each test invented its
own crash schedule, nothing composed, and nothing could answer "does the
whole stack survive a *seeded storm* of chip loss, corrupt checkpoints, and
mid-reshard failures bit-identically?".  This module replaces that with a
:class:`FaultPlan`: one seed deterministically schedules faults at named
**sites** of the recovery loop, with per-site probability/count knobs.

Sites (the first five are visited by ``run_with_recovery`` in loop order;
``spec_perturb`` belongs to the tuning controller's update cycle)::

    straggler_delay   before a step: injected stall (sleeps, never raises)
    step              the step body: raises ChaosError (chip loss analogue)
    ckpt_save         before save_fn: a save that never lands
    ckpt_restore      before restore_fn: a restore attempt that dies
    reshard           before reshard_fn: elastic migration failure
    spec_perturb      tuning update cycle: poison the live HardwareSpec /
                      skew the drift window
                      (`repro_torch.tuning.SpecController`)

Determinism contract: whether visit ``k`` of site ``s`` fires is a pure
function of ``(seed, s, k)`` — every site draws from its own independent
stream, so adding visits at one site never perturbs another site's
schedule, and two runs with the same seed and the same control flow inject
the *same* faults.  (Control flow after a fault differs from the fault-free
run, of course — that is the point; the invariant under test is that the
**final state** is still bit-equal.)

Env hook: ``REPRO_CHAOS="seed=7,step=0.05,ckpt_save=0.1@2,delay=0.02"``
turns any benchmark, example, or training run into a chaos run without
code changes (`FaultPlan.from_env`, consulted by ``run_with_recovery``
when no explicit plan is passed).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np

from repro_torch import telemetry

log = logging.getLogger("repro_torch.runtime")

#: the fault sites of the recovery loop, in `run_with_recovery` visit order
RECOVERY_SITES = ("straggler_delay", "step", "ckpt_save", "ckpt_restore",
                  "reshard")

#: all named fault sites: the recovery loop's plus the tuning controller's
#: spec-poisoning site (visited once per `SpecController` update cycle)
SITES = RECOVERY_SITES + ("spec_perturb",)

#: env var consumed by FaultPlan.from_env (see module docstring for syntax)
CHAOS_ENV = "REPRO_CHAOS"


class ChaosError(RuntimeError):
    """An *injected*, retryable fault.  Recovery must absorb it: the chaos
    suite asserts the final state is bit-equal to a fault-free run."""

    def __init__(self, site: str, occurrence: int, step: Optional[int] = None):
        self.site = site
        self.occurrence = occurrence
        self.step = step
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"injected fault #{occurrence} at site "
                         f"{site!r}{at}")


@dataclass(frozen=True)
class SiteSpec:
    """Per-site knobs: fire with ``prob`` per visit, at most ``count`` times
    total (None = unbounded), skipping the first ``after`` visits.
    ``delay_s`` is the injected stall for the ``straggler_delay`` site."""

    prob: float = 0.0
    count: Optional[int] = None
    after: int = 0
    delay_s: float = 0.0


class FaultPlan:
    """A seed-derived fault schedule over the named recovery-loop sites.

    ``sites`` maps site name -> :class:`SiteSpec` (a bare float is shorthand
    for ``SiteSpec(prob=...)``).  The plan is stateful only in its visit
    counters: the fire decision itself is the pure function
    ``hash(seed, site, visit) < prob`` (counter-mode PRNG per draw), so two
    plans with the same seed replay identically.
    """

    def __init__(self, seed: int = 0,
                 sites: Optional[Dict[str, Union[float, SiteSpec]]] = None,
                 *, sleep_fn: Callable[[float], None] = time.sleep):
        self.seed = int(seed)
        self.sites: Dict[str, SiteSpec] = {}
        for name, spec in (sites or {}).items():
            if name not in SITES:
                raise ValueError(f"unknown fault site {name!r}; "
                                 f"have {SITES}")
            if not isinstance(spec, SiteSpec):
                spec = SiteSpec(prob=float(spec))
            self.sites[name] = spec
        self._sleep = sleep_fn
        self._visits = {s: 0 for s in SITES}
        self._fired = {s: 0 for s in SITES}

    # --- constructors -----------------------------------------------------
    @classmethod
    def null(cls) -> "FaultPlan":
        """A plan that never fires (the no-chaos default)."""
        return cls(0, {})

    @classmethod
    def from_spec(cls, text: str, *,
                  sleep_fn: Callable[[float], None] = time.sleep
                  ) -> "FaultPlan":
        """Parse ``"seed=7,step=0.05,ckpt_save=0.1@2,delay=0.02"``:
        ``seed=<int>``; ``delay=<sec>`` (stall length for the
        ``straggler_delay`` site); ``<site>=<prob>[@<count>]`` per site."""
        seed, delay_s, sites = 0, 0.01, {}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            if "=" not in token:
                raise ValueError(f"bad {CHAOS_ENV} token {token!r} "
                                 f"(want key=value)")
            key, _, val = token.partition("=")
            key, val = key.strip(), val.strip()
            if key == "seed":
                seed = int(val)
            elif key == "delay":
                delay_s = float(val)
            else:
                prob, _, count = val.partition("@")
                sites[key] = SiteSpec(prob=float(prob),
                                      count=int(count) if count else None)
        sites = {name: (SiteSpec(spec.prob, spec.count, spec.after, delay_s)
                        if name == "straggler_delay" else spec)
                 for name, spec in sites.items()}
        return cls(seed, sites, sleep_fn=sleep_fn)

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """The ``REPRO_CHAOS`` hook: a plan parsed from the env var, or the
        null plan when unset/empty."""
        text = os.environ.get(CHAOS_ENV, "").strip()
        return cls.from_spec(text) if text else cls.null()

    # --- the schedule -----------------------------------------------------
    def _draw(self, site: str, visit: int) -> float:
        # counter-mode: one fresh generator per (seed, site, visit) makes
        # the decision history-free — sites never share a stream
        seq = np.random.SeedSequence([self.seed, SITES.index(site), visit])
        return float(np.random.default_rng(seq).random())

    def fire(self, site: str) -> bool:
        """Advance site's visit counter; True iff this visit faults."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; have {SITES}")
        visit = self._visits[site]
        self._visits[site] = visit + 1
        spec = self.sites.get(site)
        if spec is None or spec.prob <= 0.0 or visit < spec.after:
            return False
        if spec.count is not None and self._fired[site] >= spec.count:
            return False
        hit = self._draw(site, visit) < spec.prob
        if hit:
            self._fired[site] += 1
        return hit

    def param(self, site: str) -> float:
        """Deterministic fault *parameter* in [0, 1) for the most recent
        visit of ``site`` — an independent stream from the fire decision
        (tag 1 vs the implicit fire draw), so reading a parameter never
        perturbs the schedule.  The tuning controller maps it onto the
        perturbation shape (skew factor vs poison kind) for the
        ``spec_perturb`` site."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; have {SITES}")
        visit = max(0, self._visits[site] - 1)
        seq = np.random.SeedSequence(
            [self.seed, SITES.index(site), visit, 1])
        return float(np.random.default_rng(seq).random())

    def visit(self, site: str, *, step: Optional[int] = None) -> None:
        """The recovery loop's hook: raise :class:`ChaosError` when the
        site fires — except ``straggler_delay``, which *stalls* instead
        (the straggler analogue: one slow participant, not a dead one)."""
        if not self.fire(site):
            return
        if site == "straggler_delay":
            delay = self.sites[site].delay_s
            telemetry.record("chaos.fire", site=site,
                             occurrence=self._fired[site], step=step,
                             kind="stall", delay_s=delay)
            log.info("chaos: injected %.3fs straggler stall at step %s",
                     delay, step)
            self._sleep(delay)
            return
        telemetry.record("chaos.fire", site=site,
                         occurrence=self._fired[site], step=step,
                         kind="raise")
        log.info("chaos: fault #%d at site %r, step %s", self._fired[site],
                 site, step)
        raise ChaosError(site, self._fired[site], step)

    # --- observability ----------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{"visits": n, "fired": k}`` counters."""
        return {s: {"visits": self._visits[s], "fired": self._fired[s]}
                for s in SITES if self._visits[s] or s in self.sites}

    @property
    def total_fired(self) -> int:
        return sum(self._fired.values())

    def replay(self) -> "FaultPlan":
        """A fresh plan with the same seed/sites and zeroed counters —
        re-running the same program under it injects the same faults."""
        return FaultPlan(self.seed, dict(self.sites), sleep_fn=self._sleep)

    def __repr__(self):
        parts = ", ".join(f"{n}={s.prob:g}" +
                          (f"@{s.count}" if s.count is not None else "")
                          for n, s in self.sites.items())
        return f"FaultPlan(seed={self.seed}, {{{parts}}})"
