"""Guarded self-tuning: the live `HardwareSpec` controller.

Port of `repro.tuning.controller`.  The telemetry layer
(`telemetry.drift.aggregate` + `fit_spec_update`) turns the event stream's
(predicted_s, measured_s) pairs into a corrected-spec *proposal*; this
module closes the loop: a :class:`SpecController` folds the live drift
window into the active spec on a cadence and swaps it into **all three
selector tiers** at once through `rmw_engine.set_live_spec` (the
process-wide indirection `default_spec()` honours — `select_backend`,
`select_exchange` and `select_migration` all default their spec through
it, and `atomics.execute`'s decision cache keys on the spec epoch, so a
swap takes effect at the next call).

An unguarded feedback loop is a new failure mode, so every update passes
hard guardrails:

* **clamp** — no constant moves more than ``max_update_factor`` per
  update; big corrections are walked over several confirmed windows;
* **hysteresis** — no update below ``min_events`` drift samples
  (``min_samples`` per field, per-field floors supported) and none within
  ``cooldown_updates`` windows of the last swap; sub-``deadband`` moves
  are held;
* **rollback** — every swap pushes the previous spec onto a last-good
  stack and arms a post-swap check: if the next window's drift *score*
  (sample-weighted mean ``|log(measured/predicted)|``) worsens by more
  than ``rollback_margin``, the previous spec is reinstalled
  (``tuning.rollback``), else the swap is confirmed (``tuning.confirm``);
* **quarantine** — pathological proposals (NaN / non-positive / outside
  ``envelope_factor`` of the *calibrated* spec) are never installed: the
  field falls back to its calibrated value and a ``tuning.quarantine``
  event names it (``tuning.skip`` carries the reason of a cycle that
  applied nothing, and any fields below their sample floor);
* **validated persistence** — `state_path` persists the tuned spec (and
  the contention estimator) across restarts; restore re-validates every
  field against the calibrated envelope and the device type the state was
  tuned on (``"backend"``: ``"cuda"`` or ``"cpu"``), and quarantines
  anything suspect instead of installing it.  A state tuned on another
  device type, or written by the JAX package (which names its backend
  ``"jax_backend"``), is rejected whole.

The calibrated spec is `rmw_engine.calibrated_spec(device)`: the ``H100``
priors on the card (the default ``device="cuda"``, as every entry point of
the port), the CPU's spec on ``device="cpu"``.

**Ranks.**  A controller's spec is process-wide, and on a mesh every rank
is a process of its own, measuring its own walls.  Two ranks that swapped
different specs (or hinted different ``distinct_slots``) would pick
different exchange strategies and their collectives would hang.  So a
controller given ``mesh=`` makes `step` a collective of every rank of the
mesh: the rank of index 0 decides whether a window is full and fits its
own window, and broadcasts the outcome with the full controller state
(the active spec, the last-good stack, the counters); every other rank
installs exactly that spec at the same call and discards its own window.
``tuning.*`` events are recorded on rank 0 only.  `start` broadcasts rank
0's restored spec and estimator the same way, and only rank 0 writes the
state file.  The estimator needs no exchange: its inputs on a sharded
table (the batch's slots, the mesh-global `ContentionStats`, the gathered
round history) are the same on every rank, and so are its hints.

Chaos coverage (`spec_perturb` site, `runtime.chaos.FaultPlan`): when the
site fires inside an update cycle the deterministic parameter draw either
**skews** the window's measured walls by a log-uniform factor in
[1/8, 8) — poisoning the live spec through its own feedback loop — or
**poisons** the fitted proposal outright (NaN / negated), which the
quarantine guardrail must absorb.  Tuned runs stay **bit-identical** to
untuned ones on int32 tables: the spec steers *selection* only, and every
backend and strategy equals the serialized oracle.  (fp32 FAA on the
card's kernel adds in atomic order, so a swap that moves such a batch to
another backend moves its last bits; it is held to a float64 sum.)
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.core import perf_model, rmw_engine
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.telemetry import drift
from repro_torch.tuning.estimator import ContentionEstimator

#: env var: truthy enables a default controller in `launch.train`
#: (a path value additionally persists/restores the tuned state there)
TUNING_ENV = "REPRO_TUNING"

#: the spec constants the controller may ever touch — exactly the fields
#: the drift fitter maps drift pools onto (everything else in HardwareSpec
#: is structural: tier tables, tile geometry, names)
TUNABLE_FIELDS: Tuple[str, ...] = tuple(sorted(
    {field for field, _sense in drift.SPEC_FIELD_OF.values()}))

#: the state file's format version (the reference's schema)
STATE_VERSION = 1

#: the controller's sink asks for one eager `execute` on the card in this
#: many to be measured (`telemetry.Sink.sync_every`): a measured call costs
#: an H100's host about 13 µs more than an unmeasured one (a pair of the
#: device's `telemetry.events.EventRing` recorded, about 9 µs, and read
#: back in a window, about 4 µs), and the update cycle a window of
#: `TuningConfig.min_events` measured calls about 80-190 µs, against
#: about 100 µs for an eager FAA of 4,096 ops: a live controller
#: measuring every call cost 21-25% against the 5% gate, and 15-25% with
#: the calls timed by the stamps the RMW kernels write (which cost about
#: 2.5 µs a call, but time the kernels alone, not what the cost model's
#: drift fields are fitted to).  Not in the reference, which measures
#: every call; a ``telemetry.capture(sync=True)`` beside the controller
#: measures every call again.  A CPU call is always measured.
SYNC_EVERY = 64

@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """Guardrail knobs of one :class:`SpecController` (the reference's
    defaults, its benchmarked configuration)."""

    #: drift-bearing events per update window (hysteresis floor)
    min_events: int = 32
    #: per-field sample floor handed to `fit_spec_update`
    min_samples: int = 4
    #: per-field overrides of ``min_samples`` (e.g. demand more evidence
    #: for high-blast-radius constants); None = uniform floor
    min_samples_per_field: Optional[Mapping[str, int]] = None
    #: max multiplicative move of any constant per update (clamp)
    max_update_factor: float = 2.0
    #: quarantine envelope around the *calibrated* spec: proposals outside
    #: [cal/envelope, cal*envelope] are pathological by definition
    envelope_factor: float = 64.0
    #: |log(new/current)| below this is held, not applied (no churn)
    deadband: float = 0.05
    #: update windows to sit out after a swap/rollback before fitting again
    #: (the post-swap window still runs the rollback check)
    cooldown_updates: int = 1
    #: rollback when the post-swap drift score worsens by more than this
    #: (additive in mean-|log-ratio| units; 0.2 ~ geometric drift +22%)
    rollback_margin: float = 0.2
    #: last-good stack depth (consecutive bad swaps roll back that far)
    history_depth: int = 8
    #: EWMA weight of the contention estimator
    ewma_alpha: float = 0.25
    #: enable telemetry sync so eager execute walls measure device time —
    #: the controller's drift diet; disable to tune from retry/migration
    #: events only
    sync: bool = True
    #: drift-window retention cap (oldest events drop past this)
    window_cap: int = 4096


class _ControllerSink(telemetry.Sink):
    """The controller's tap on the event stream.  ``emit`` runs under the
    telemetry lock: buffer only, never record (re-entering the stream from
    a sink would deadlock).  It reads measured events only, so while it is
    the only sink an unmeasured `execute` builds no event.  A measured
    call on the card carries CUDA events, its seconds pending until the
    window closes (`SpecController.step` resolves them with one wait)."""

    measured_only = True

    def __init__(self, controller: "SpecController"):
        self._controller = controller

    @property
    def sync_every(self) -> int:
        return SYNC_EVERY

    def emit(self, event: Dict[str, Any]) -> None:
        self._controller._observe(event)


def _timed(meas) -> bool:
    """A measured time the drift fit can take: a positive finite float."""
    return isinstance(meas, (int, float)) and not isinstance(meas, bool) \
        and 0 < meas < math.inf


#: the running controller (at most one per process — it owns the
#: process-wide live spec); `execute_until` reads its estimator
_ACTIVE: Optional["SpecController"] = None


def active_controller() -> Optional["SpecController"]:
    return _ACTIVE


def active_estimator() -> Optional[ContentionEstimator]:
    """The running controller's contention estimator, if any — the hook
    `atomics.execute_until` polls for estimator-backed ``distinct_slots``."""
    return _ACTIVE.estimator if _ACTIVE is not None else None


class SpecController:
    """Lifecycle: ``start()`` (attach to the stream, restore and validate
    any persisted state, install the tuned spec) → ``step()`` once per
    outer step (cheap no-op until a window fills) → ``stop()`` (detach,
    clear the live spec, persist).  The context manager covers all three::

        with SpecController(state_path="tuned.json") as ctrl:
            for i in range(steps):
                state = train_step(i, state)
                ctrl.step()

    or wrap the step function once: ``step = ctrl.wrap_step(step)``.

    ``device`` picks the calibrated spec (`rmw_engine.calibrated_spec`)
    and names the state file's backend; ``base_spec`` overrides the
    calibrated spec.  ``mesh`` (a `launch.mesh.Mesh`) makes `start` and
    `step` collectives of its ranks, so every rank holds one spec (module
    docstring).
    """

    def __init__(self, config: Optional[TuningConfig] = None, *,
                 base_spec: Optional[perf_model.HardwareSpec] = None,
                 chaos: Optional[FaultPlan] = None,
                 state_path: Optional[str] = None,
                 device="cuda", mesh=None):
        self.cfg = config or TuningConfig()
        self.device = torch.device(device)
        self.base = base_spec if base_spec is not None \
            else rmw_engine.calibrated_spec(self.device)
        self.active = self.base
        self.chaos = chaos
        self.state_path = state_path
        self.mesh = mesh
        self.estimator = ContentionEstimator(alpha=self.cfg.ewma_alpha)
        self._sink = _ControllerSink(self)
        self._wlock = threading.Lock()
        self._window: collections.deque = collections.deque(
            maxlen=self.cfg.window_cap)
        self._stack: List[Tuple[perf_model.HardwareSpec, float]] = []
        self._pre_swap_score: Optional[float] = None
        self._cooldown = 0
        self._started = False
        self.last_score: Optional[float] = None
        self.last_outcome: Optional[str] = None
        self.n_updates = 0
        self.n_applied = 0
        self.n_rollbacks = 0
        self.n_quarantined = 0
        self.n_perturbs = 0

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "SpecController":
        global _ACTIVE
        if self._started:
            return self
        if _ACTIVE is not None:
            raise RuntimeError(
                "another SpecController is already running — it owns the "
                "process-wide live spec; stop() it first")
        telemetry.add_sink(self._sink, sync=self.cfg.sync)
        if self.state_path and os.path.exists(self.state_path) \
                and self._is_root():
            self._restore_state()
        if self.mesh is not None:
            self._share_start()
        if self.active != self.base:
            self._install()
        self._started = True
        _ACTIVE = self
        return self

    def stop(self) -> None:
        global _ACTIVE
        if not self._started:
            return
        telemetry.remove_sink(self._sink)
        rmw_engine.clear_live_spec()
        if self.state_path and self._is_root():
            self._save_state()
        self._started = False
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "SpecController":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def wrap_step(self, step_fn: Callable) -> Callable:
        """``step_fn`` with ``self.step()`` appended — the one-line way to
        put a training/serving loop under tuning.  Donation metadata
        (`declare_donation`) is preserved so the recovery loop still sees
        it."""
        def tuned_step(*args, **kwargs):
            out = step_fn(*args, **kwargs)
            self.step()
            return out
        donated = getattr(step_fn, "donate_argnums", None)
        if donated:
            from repro_torch.runtime.fault_tolerance import declare_donation
            return declare_donation(tuned_step, tuple(donated))
        return tuned_step

    # --- stream tap -------------------------------------------------------
    def _observe(self, ev: Dict[str, Any]) -> None:
        # called under the telemetry lock: filter + buffer only.  Unlike
        # the reference, a time that is not finite is dropped too (the
        # ``cuda`` backend forced on a CPU table is priced at inf), so it
        # cannot reach `drift.aggregate`'s log; a pending device time is
        # checked when the window closes (`_take_window`)
        meas = ev.get("measured_s")
        if meas is None or ev.get("event") not in drift.DRIFT_EVENTS:
            return
        pred = ev.get("predicted_s")
        if not isinstance(pred, (int, float)) or isinstance(pred, bool) \
                or not 0 < pred < math.inf or not (
                    type(meas) is telemetry.DeviceSeconds or _timed(meas)):
            return
        with self._wlock:
            self._window.append(ev)

    def _take_window(self) -> Optional[List[Dict[str, Any]]]:
        """The window's events once ``min_events`` of them carry a time:
        their pending device times resolved here, with one wait (the
        window boundary), those not positive and finite dropped; None
        (the window kept) while fewer remain."""
        with self._wlock:
            if len(self._window) < self.cfg.min_events:
                return None
            window = list(self._window)
            self._window.clear()
        telemetry.resolve()
        window = [ev for ev in window if _timed(ev["measured_s"])]
        if len(window) >= self.cfg.min_events:
            return window
        with self._wlock:
            self._window.extendleft(reversed(window))
        return None

    def window_size(self) -> int:
        with self._wlock:
            return len(self._window)

    # --- the update cycle -------------------------------------------------
    def step(self) -> Optional[str]:
        """Run one update cycle if a full drift window has accumulated.
        Returns the cycle outcome (``"apply"`` / ``"confirm"`` /
        ``"rollback"`` / ``"cooldown"`` / ``"quarantine"`` / ``"hold"``)
        or None when the window is still filling (the per-step fast path:
        one lock + one length check; on a mesh, one broadcast more)."""
        if not self._started:
            return None
        if self.mesh is not None:
            return self._step_mesh()
        if len(self._window) < self.cfg.min_events:
            return None              # a deque's len needs no lock
        window = self._take_window()
        if window is None:
            return None
        outcome = self._update(window)
        self.last_outcome = outcome
        return outcome

    def _update(self, window: List[Dict[str, Any]]) -> str:
        self.n_updates += 1
        window = self._maybe_perturb(window)
        stats = drift.aggregate(window)
        n_samples = sum(st.n for st in stats.values())
        score = self._score(stats)
        self.last_score = score

        # post-swap evaluation first — rollback outranks everything,
        # including cooldown (the cooldown window IS the evaluation window)
        if self._pre_swap_score is not None and self._stack:
            pre = self._pre_swap_score
            if score > pre + self.cfg.rollback_margin:
                prev_spec, _prev_score = self._stack.pop()
                self.active = prev_spec
                self._install()
                self._pre_swap_score = None
                self._cooldown = self.cfg.cooldown_updates
                self.n_rollbacks += 1
                telemetry.record("tuning.rollback", score=score,
                                 pre_swap_score=pre, n=n_samples,
                                 depth=len(self._stack))
                return "rollback"
            self._pre_swap_score = None
            telemetry.record("tuning.confirm", score=score,
                             pre_swap_score=pre, n=n_samples)

        if self._cooldown > 0:
            self._cooldown -= 1
            telemetry.record("tuning.skip", reason="cooldown", score=score,
                             n=n_samples)
            return "cooldown"

        fitted = drift.fit_spec_update(stats, self.active,
                                       min_samples=self._sample_floors())
        proposals = {name: f["proposed"]
                     for name, f in fitted["fields"].items()}
        proposals = self._maybe_poison(proposals)
        applied, clamped, quarantined = self._guard(proposals)
        if quarantined:
            self.n_quarantined += len(quarantined)
            telemetry.record("tuning.quarantine", fields=quarantined,
                             score=score, n=n_samples)
        if not applied:
            if not quarantined:
                telemetry.record(
                    "tuning.skip",
                    reason="deadband" if proposals else "no_fields",
                    skipped=fitted["skipped"], score=score, n=n_samples)
            return "quarantine" if quarantined else "hold"

        self._stack.append((self.active, score))
        if len(self._stack) > self.cfg.history_depth:
            self._stack.pop(0)
        changes = {name: {"from": float(getattr(self.active, name)),
                          "to": float(val)}
                   for name, val in applied.items()}
        self.active = dataclasses.replace(self.active, **applied)
        self._install()
        self._pre_swap_score = score
        self._cooldown = self.cfg.cooldown_updates
        self.n_applied += 1
        telemetry.record("tuning.apply", fields=changes, clamped=clamped,
                         skipped=fitted["skipped"], score=score,
                         n=n_samples, depth=len(self._stack))
        return "apply"

    def _guard(self, proposals: Dict[str, Any]):
        """The per-field guardrail ladder: quarantine (pathological →
        calibrated fallback), clamp (bounded move), deadband (hold)."""
        applied: Dict[str, float] = {}
        clamped: Dict[str, Dict[str, float]] = {}
        quarantined: Dict[str, Dict[str, Any]] = {}
        env = self.cfg.envelope_factor
        for name, prop in proposals.items():
            if name not in TUNABLE_FIELDS:
                quarantined[name] = {"value": repr(prop),
                                     "reason": "not a tunable field"}
                continue
            cur = float(getattr(self.active, name, 0.0) or 0.0)
            cal = float(getattr(self.base, name, 0.0) or 0.0)
            if cur <= 0.0 or cal <= 0.0:
                quarantined[name] = {"value": repr(prop),
                                     "reason": "field unset on spec"}
                continue
            bad = not isinstance(prop, (int, float)) \
                or isinstance(prop, bool) or not math.isfinite(prop) \
                or prop <= 0.0
            if bad or not cal / env <= prop <= cal * env:
                quarantined[name] = {
                    "value": repr(prop),
                    "reason": ("non-finite or non-positive" if bad
                               else "outside calibrated envelope"),
                    "envelope": [cal / env, cal * env]}
                if cur != cal:
                    applied[name] = cal    # fall back to the calibrated value
                continue
            val = min(max(float(prop), cur / self.cfg.max_update_factor),
                      cur * self.cfg.max_update_factor)
            if val != prop:
                clamped[name] = {"proposed": float(prop), "applied": val}
            if abs(math.log(val / cur)) < self.cfg.deadband:
                continue
            applied[name] = val
        return applied, clamped, quarantined

    # --- chaos (spec_perturb site) ---------------------------------------
    def _maybe_perturb(self, window):
        if self.chaos is None or not self.chaos.fire("spec_perturb"):
            return window
        self.n_perturbs += 1
        u = self.chaos.param("spec_perturb")
        if u < 0.5:
            # skew: scale the window's measured walls by a log-uniform
            # factor in [1/8, 8) — the live spec gets poisoned through its
            # own feedback loop, and honest windows must walk it back
            factor = 8.0 ** (4.0 * u - 1.0)
            telemetry.record("tuning.perturb", kind="skew", factor=factor)
            self._poison_kind = None
            return [dict(ev, measured_s=ev["measured_s"] * factor)
                    for ev in window]
        # poison: corrupt the fitted proposal outright — quarantine must
        # absorb it
        kind = "nan" if u < 0.75 else "negative"
        telemetry.record("tuning.perturb", kind="poison", poison=kind)
        self._poison_kind = kind
        return window

    _poison_kind: Optional[str] = None

    def _maybe_poison(self, proposals: Dict[str, Any]) -> Dict[str, Any]:
        kind = self._poison_kind
        if kind is None:
            return proposals
        self._poison_kind = None
        bad = float("nan") if kind == "nan" else -1e-6
        if not proposals:
            # nothing fit this window: poison a tunable field anyway so
            # the quarantine path is exercised, not silently skipped
            return {TUNABLE_FIELDS[0]: bad}
        return {name: bad for name in proposals}

    # --- internals --------------------------------------------------------
    @staticmethod
    def _score(stats) -> float:
        """Sample-weighted mean |log(measured/predicted)| over the window —
        0 means the cost model is calibrated; the rollback check compares
        this across the swap."""
        n = sum(st.n for st in stats.values())
        if n == 0:
            return 0.0
        return sum(abs(st.log_sum) for st in stats.values()) / n

    def _sample_floors(self):
        if self.cfg.min_samples_per_field:
            return {"*": self.cfg.min_samples,
                    **dict(self.cfg.min_samples_per_field)}
        return self.cfg.min_samples

    def _install(self) -> None:
        rmw_engine.set_live_spec(self.active)

    def stats(self) -> Dict[str, Any]:
        """Controller observability: counters + the active tuned fields."""
        return {"updates": self.n_updates, "applied": self.n_applied,
                "rollbacks": self.n_rollbacks,
                "quarantined": self.n_quarantined,
                "perturbs": self.n_perturbs,
                "stack_depth": len(self._stack),
                "last_score": self.last_score,
                "last_outcome": self.last_outcome,
                "estimator_sites": len(self.estimator),
                "tuned_fields": {
                    f: {"calibrated": float(getattr(self.base, f)),
                        "active": float(getattr(self.active, f))}
                    for f in TUNABLE_FIELDS
                    if getattr(self.active, f) != getattr(self.base, f)}}

    # --- ranks: one spec on every rank of the mesh -------------------------
    _SHARED = ("active", "_stack", "_pre_swap_score", "_cooldown",
               "last_score", "last_outcome", "n_updates", "n_applied",
               "n_rollbacks", "n_quarantined", "n_perturbs")

    def _is_root(self) -> bool:
        return self.mesh is None or self.mesh.index(
            self.mesh.axis_names) == 0

    def _bcast(self, obj):
        """Rank 0's ``obj`` on every rank of the mesh."""
        import torch.distributed as dist
        box = [obj]
        mesh = self.mesh
        dist.broadcast_object_list(
            box, src=mesh.members(mesh.axis_names)[0],
            group=mesh.group(mesh.axis_names))
        return box[0]

    def _flag(self, ready: bool) -> bool:
        """Rank 0's window-full flag on every rank (one small broadcast)."""
        dev = "cuda" if self.mesh.backend == "nccl" else "cpu"
        x = torch.tensor([1 if ready else 0], dtype=torch.int32, device=dev)
        return bool(self.mesh.broadcast(x, self.mesh.axis_names).item())

    def _share_start(self) -> None:
        got = self._bcast((self.active, self.estimator.snapshot())
                          if self._is_root() else None)
        if not self._is_root():
            self.active = got[0]
            self.estimator = ContentionEstimator(alpha=self.cfg.ewma_alpha)
            self.estimator.restore(got[1])

    def _step_mesh(self) -> Optional[str]:
        root = self._is_root()
        window = None
        if root and len(self._window) >= self.cfg.min_events:
            window = self._take_window()
        if not self._flag(window is not None):
            return None
        if root:
            self.last_outcome = self._update(window)
        state = self._bcast({k: getattr(self, k) for k in self._SHARED}
                            if root else None)
        if not root:
            with self._wlock:
                self._window.clear()
            for k, v in state.items():
                setattr(self, k, v)
            if self.last_outcome in ("apply", "rollback"):
                self._install()      # the swap rank 0 made, at this call
        return self.last_outcome

    # --- persistence ------------------------------------------------------
    def _save_state(self) -> None:
        payload = {"version": STATE_VERSION, "backend": self.device.type,
                   "spec": perf_model.spec_to_dict(self.active),
                   "estimator": self.estimator.snapshot(),
                   "counters": {"applied": self.n_applied,
                                "rollbacks": self.n_rollbacks,
                                "quarantined": self.n_quarantined}}
        tmp = f"{self.state_path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2)
            os.replace(tmp, self.state_path)
        except OSError:
            telemetry.record("tuning.restore", accepted=False,
                             direction="save", reason="unwritable path",
                             path=self.state_path)

    def _restore_state(self) -> None:
        """Load + validate a persisted tuned spec.  Every failure mode —
        unreadable file, backend mismatch (a file of the JAX package has
        no ``"backend"`` and mismatches too), out-of-envelope or
        non-finite constants — quarantines to the calibrated value and
        says so (``tuning.restore`` event); a stale state file never
        installs a pathological spec."""
        try:
            with open(self.state_path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            telemetry.record("tuning.restore", accepted=False,
                             reason="unreadable state file",
                             path=self.state_path)
            return
        if not isinstance(payload, dict):
            payload = {}
        backend = self.device.type
        if payload.get("backend") != backend:
            telemetry.record(
                "tuning.restore", accepted=False,
                reason=f"backend mismatch: tuned on "
                       f"{payload.get('backend')!r}, running {backend!r}",
                path=self.state_path)
            return
        try:
            spec = perf_model.spec_from_dict(
                payload.get("spec") or {}, base=self.base)
        except Exception:  # noqa: BLE001 — corrupt payloads quarantine
            telemetry.record("tuning.restore", accepted=False,
                             reason="malformed spec payload",
                             path=self.state_path)
            return
        env = self.cfg.envelope_factor
        quarantined: Dict[str, str] = {}
        resets: Dict[str, float] = {}
        for name in TUNABLE_FIELDS:
            cal = float(getattr(self.base, name, 0.0) or 0.0)
            val = getattr(spec, name, None)
            ok = isinstance(val, (int, float)) \
                and not isinstance(val, bool) and math.isfinite(val) \
                and val > 0.0 and (cal <= 0.0
                                   or cal / env <= val <= cal * env)
            if not ok:
                quarantined[name] = repr(val)
                resets[name] = cal
        if resets:
            spec = dataclasses.replace(spec, **resets)
        self.active = spec
        self.estimator.restore(payload.get("estimator") or {})
        telemetry.record("tuning.restore", accepted=True,
                         quarantined=quarantined, path=self.state_path,
                         estimator_sites=len(self.estimator))


def from_env(device="cuda", mesh=None) -> Optional[SpecController]:
    """The ``REPRO_TUNING`` hook: unset/falsy → None; ``"1"/"on"/"true"``
    → a default controller on ``device`` (on ``mesh``, when given); any
    other value is a state path the controller persists/restores the
    tuned spec through."""
    val = os.environ.get(TUNING_ENV, "").strip()
    if not val or val.lower() in ("0", "off", "false", "no"):
        return None
    if val.lower() in ("1", "on", "true", "yes"):
        return SpecController(device=device, mesh=mesh)
    return SpecController(state_path=val, device=device, mesh=mesh)
