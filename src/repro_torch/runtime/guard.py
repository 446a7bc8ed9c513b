"""Kill-switch guardrail for the online serving path.

The online EWMA controller is normally the best split policy available
— it tracks drift the offline tuner cannot see.  But it is also a
feedback loop, and feedback loops have failure modes: a mis-set damping
or floor, a poisoned measurement stream, or plain controller bugs can
walk the shares away from the optimum while every individual step looks
plausible.  The guardrail for that class of failure is a **kill
switch** (the circuit-breaker pattern): watch the realized step-time
trajectory against a rolling baseline, and when it regresses past a
threshold for several consecutive steps, stop trusting the controller —
pin the split to the last known-good static configuration (the offline
tuner's stored winner when available) until a cool-down probe shows the
online path is healthy again.

Two pieces, separable for testing:

  * :class:`KillSwitch` — the pure state machine.  Feed it one step
    time per step; it answers "should the controller be driving?".  No
    clocks, no scheduler knowledge: cool-down is counted in steps, so
    trips and re-arms are exactly reproducible under the fault harness.
  * :class:`ServeGuard` — wraps a ``ChunkedScheduler``: while armed it
    steps with online rebalance; while tripped it pins the fallback
    shares (``rebalance=False``) and re-arms after ``cooldown`` healthy
    probe steps.  The fallback resolves, in order: explicit shares →
    the tuning store's best stored split for the workload
    (``TuningStore.best_record``) → the best split the controller
    itself has visited (tracked continuously as a running min over
    observed step times).

Thresholds and the failure model are the reference's
(``docs/resilience.md``).  ``fallback_from_store`` reads the port's
:meth:`~repro_torch.runtime.store.TuningStore.best_record`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..obs import as_observer
from .scheduler import ChunkedScheduler, _project_simplex_floor

__all__ = ["KillSwitch", "ServeGuard", "fallback_from_store"]


@dataclass
class KillSwitch:
    """Step-time circuit breaker (pure state machine, no clocks).

    ``observe(t_step)`` returns a verdict string and moves the state:

      * ``armed`` — healthy observations feed a rolling window; the
        baseline is its median (robust to single outliers).  An
        observation above ``threshold * baseline`` is ``"regressing"``;
        ``patience`` *consecutive* regressing steps trip the switch
        (verdict ``"trip"``); anything else is ``"ok"`` and resets the
        streak.  The first ``min_samples`` observations only build the
        baseline — no verdicts but ``"ok"`` (an empty baseline cannot
        regress).
      * ``tripped`` — observations are cool-down probes (the caller is
        expected to be pinning its fallback, so these measure the
        fallback's health): a probe within ``threshold * baseline``
        counts toward re-arming, one above it resets the count.  After
        ``cooldown`` consecutive healthy probes the switch re-arms
        (verdict ``"rearm"``); until then probes answer ``"cooling"``.
        Healthy probes also feed the baseline, so the post-trip
        baseline reflects the fallback's level, not the pre-trip one.

    Regressing observations never enter the baseline — otherwise a slow
    regression would drag the baseline up with it and never trip.
    """

    threshold: float = 1.5
    patience: int = 5
    window: int = 16
    cooldown: int = 3
    min_samples: int = 4

    def __post_init__(self):
        if self.threshold <= 1.0:
            raise ValueError("threshold must be > 1 (a ratio over baseline)")
        if min(self.patience, self.window, self.cooldown,
               self.min_samples) < 1:
            raise ValueError("patience, window, cooldown and min_samples "
                             "must be >= 1")
        self._times: deque = deque(maxlen=self.window)
        self.tripped = False
        self.streak = 0            # consecutive regressing (armed) or
        #                            healthy-probe (tripped) steps
        self.n_trips = 0

    @property
    def baseline(self) -> float | None:
        """Rolling median of healthy step times (None until warm)."""
        if len(self._times) < self.min_samples:
            return None
        return float(np.median(self._times))

    def reset_baseline(self) -> None:
        """Forget the baseline (e.g. after a membership change: the
        step-time level legitimately moved, comparing against the old
        one would false-trip)."""
        self._times.clear()
        self.streak = 0

    def observe(self, t_step: float) -> str:
        base = self.baseline
        if self.tripped:
            if base is not None and t_step > self.threshold * base:
                self.streak = 0
                return "cooling"
            self.streak += 1
            self._times.append(t_step)
            if self.streak >= self.cooldown:
                self.tripped = False
                self.streak = 0
                return "rearm"
            return "cooling"
        if base is not None and t_step > self.threshold * base:
            self.streak += 1
            if self.streak >= self.patience:
                self.tripped = True
                self.streak = 0
                self.n_trips += 1
                return "trip"
            return "regressing"
        self.streak = 0
        self._times.append(t_step)
        return "ok"

    # -- durability (runtime.checkpoint snapshots) -------------------------
    def state_dict(self) -> dict:
        """JSON-ready recoverable state: baseline window + trip state
        (the config knobs are reconstructed by the caller, not
        persisted — a restart may legitimately retune them)."""
        return {"times": [float(t) for t in self._times],
                "tripped": bool(self.tripped),
                "streak": int(self.streak),
                "n_trips": int(self.n_trips)}

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot; the baseline window
        refills from the saved tail (bounded by ``window``)."""
        self._times.clear()
        self._times.extend(float(t) for t in state.get("times", ()))
        self.tripped = bool(state.get("tripped", False))
        self.streak = int(state.get("streak", 0))
        self.n_trips = int(state.get("n_trips", 0))


def fallback_from_store(store, workload: dict, n_groups: int = 2,
                        space="stream_split") -> np.ndarray | None:
    """Last known-good static shares from a tuning store, or ``None``.

    ``tune_stream_split`` (``launch/serve.py``) records its winners keyed
    by workload signature: a ``fraction`` percent config (the first
    group's share, the reference's space) or a ``host_fraction`` percent
    config (the host group's share, first, in the paper's space).
    ``space`` is the space the winner was tuned over;
    ``TuningStore.best_record`` resolves the lowest-measured-time record
    across strategies.  Only two-group layouts are stored, so
    ``n_groups > 2`` returns ``None`` and the guard falls back to its
    learned snapshot instead.
    """
    if store is None or n_groups != 2:
        return None
    rec = store.best_record(space, workload)
    cfg = getattr(rec, "best_config", None) or {}
    key = next((k for k in ("fraction", "host_fraction") if k in cfg), None)
    if key is None:
        return None
    f = cfg[key] / 100.0
    return np.asarray([f, 1.0 - f])


@dataclass
class ServeGuard:
    """Kill-switch wrapper around a :class:`ChunkedScheduler`.

    ``step(batch)`` is a drop-in for ``scheduler.step``: while the
    switch is armed the controller drives (online rebalance); after a
    trip the guard pins ``fallback`` (projected onto the currently live
    groups) with ``rebalance=False`` and lets the switch's cool-down
    probes decide when the controller may drive again.  Membership
    changes (a demotion mid-step, or an external drop/restore routed
    through the guard) reset the baseline — the step-time level
    legitimately moved.

    The guard continuously snapshots the best shares it has seen
    (running min over healthy step times), so a fallback exists even
    with no tuning store; an explicit ``fallback`` or a stored split
    (:func:`fallback_from_store`) takes precedence.
    """

    scheduler: ChunkedScheduler | None
    switch: KillSwitch = field(default_factory=KillSwitch)
    fallback: np.ndarray | None = None
    observer: object = field(default=None, repr=False)

    def __post_init__(self):
        # scheduler may be None at construction (StreamingPipeline binds
        # its own scheduler and re-runs this validation)
        if self.fallback is not None:
            self.fallback = np.asarray(self.fallback, np.float64)
            if self.scheduler is not None and self.fallback.shape != (
                    self.scheduler.controller.n_groups,):
                raise ValueError("fallback shares must have one entry "
                                 "per group")
        self._best_shares: np.ndarray | None = None
        self._best_t: float = float("inf")
        # inherit the scheduler's observer unless one was given: the
        # guard's journal events must interleave with the scheduler's
        # (demotion -> re-dispatch -> trip) on one sequence
        self._obs = as_observer(self.observer)
        if self._obs is None and self.scheduler is not None:
            self._obs = self.scheduler._obs
        self._armed_logged = False

    # -- membership passthrough (so a FaultInjector can attach the guard)
    def drop_group(self, i: int) -> None:
        self.scheduler.drop_group(i)
        self.switch.reset_baseline()

    def restore_group(self, i: int, share: float | None = None) -> None:
        self.scheduler.restore_group(i, share)
        self.switch.reset_baseline()

    @property
    def tripped(self) -> bool:
        return self.switch.tripped

    @property
    def degraded(self) -> bool:
        """True while the serving path is in degraded mode: the kill
        switch is tripped (controller untrusted, pinned fallback) or
        group membership has shrunk (reduced capacity).  The
        request-level admission layer (the reference's
        ``serve.admission``, not ported yet) consults this to make per-request retry/shed decisions."""
        return self.switch.tripped \
            or not bool(self.scheduler.controller.live.all())

    def state(self) -> dict:
        """Snapshot of the guard's observable state for layers above
        (admission control, CLI status lines): kill-switch state,
        baseline, live membership and the combined degraded flag."""
        ctrl = self.scheduler.controller
        return {
            "tripped": self.switch.tripped,
            "baseline": self.switch.baseline,
            "streak": self.switch.streak,
            "n_trips": self.switch.n_trips,
            "live": [bool(x) for x in ctrl.live],
            "n_live": ctrl.n_live,
            "degraded": self.degraded,
        }

    # -- durability (runtime.checkpoint snapshots) -------------------------
    def state_dict(self) -> dict:
        """JSON-ready recoverable state: the kill switch plus the
        learned known-good snapshot the fallback resolves to."""
        return {
            "switch": self.switch.state_dict(),
            "best_shares": None if self._best_shares is None
            else [float(s) for s in self._best_shares],
            "best_t": None if self._best_t == float("inf")
            else float(self._best_t),
        }

    def load_state(self, state: dict) -> None:
        self.switch.load_state(state.get("switch", {}))
        bs = state.get("best_shares")
        self._best_shares = None if bs is None \
            else np.asarray(bs, np.float64)
        bt = state.get("best_t")
        self._best_t = float("inf") if bt is None else float(bt)

    def _fallback_shares(self) -> np.ndarray:
        ctrl = self.scheduler.controller
        shares = self.fallback if self.fallback is not None \
            else self._best_shares
        if shares is None:                    # nothing known yet: equal
            shares = np.ones(ctrl.n_groups)
        out = np.zeros(ctrl.n_groups)
        live = ctrl.live
        sub = np.asarray(shares, np.float64)[live]
        out[live] = _project_simplex_floor(sub / max(sub.sum(), 1e-12),
                                           ctrl.min_share)
        return out

    def step(self, batch: dict) -> dict:
        ctrl = self.scheduler.controller
        if self._obs is not None and not self._armed_logged:
            self._armed_logged = True
            self._obs.journal.event(
                "killswitch_armed", threshold=self.switch.threshold,
                patience=self.switch.patience, window=self.switch.window,
                cooldown=self.switch.cooldown)
        live_before = ctrl.live.copy()
        if self.switch.tripped:
            ctrl.shares = self._fallback_shares()
            rec = self.scheduler.step(batch, rebalance=False)
        else:
            rec = self.scheduler.step(batch, rebalance=True)
        if not np.array_equal(live_before, ctrl.live):
            # a demotion happened inside the step: the achievable
            # step-time level changed, the old baseline is void (and the
            # failure step's own time is recovery-tainted — skip it)
            self.switch.reset_baseline()
            if self._obs is not None:
                self._obs.metrics.counter(
                    "guard.verdict.membership-change").inc()
                self._obs.journal.event(
                    "guard_membership_change",
                    live=[bool(x) for x in ctrl.live],
                    tripped=self.switch.tripped)
            rec["guard"] = {"verdict": "membership-change",
                            "tripped": self.switch.tripped,
                            "baseline": None}
            return rec
        verdict = self.switch.observe(rec["t_step"])
        if verdict == "ok" and rec["t_step"] < self._best_t \
                and ctrl.live.all():
            # learned known-good snapshot (full membership only — a
            # degraded-mode split would be a bad fallback after repair)
            self._best_t = rec["t_step"]
            self._best_shares = rec["shares"].copy()
        if self._obs is not None:
            self._obs.metrics.counter(f"guard.verdict.{verdict}").inc()
            if verdict == "trip":
                self._obs.journal.event(
                    "killswitch_tripped", t_step=round(rec["t_step"], 9),
                    baseline=self.switch.baseline, n_trips=self.switch.n_trips,
                    fallback=[round(float(s), 6)
                              for s in self._fallback_shares()])
                self._obs.tracer.instant(
                    "killswitch.trip", tid=ctrl.n_groups,
                    args={"t_step": round(rec["t_step"], 9)})
            elif verdict == "rearm":
                self._obs.journal.event(
                    "killswitch_rearmed", baseline=self.switch.baseline)
                self._obs.tracer.instant("killswitch.rearm",
                                         tid=ctrl.n_groups)
        rec["guard"] = {"verdict": verdict, "tripped": self.switch.tripped,
                        "baseline": self.switch.baseline}
        return rec

    def run(self, batches) -> list[dict]:
        return [self.step(b) for b in batches]
