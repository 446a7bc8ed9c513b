"""SLO-aware admission control and load shedding.

The serving path has a finite capacity; an open-loop arrival process
does not care.  The admission layer is the valve between the two: every
submitted request is either **admitted** (it will terminally complete
or be explicitly shed later — never silently lost) or **shed
immediately** with a journaled reason.  The shedding policy, in the
order the checks run:

  1. ``queue_full`` — the batcher's queue already holds
     ``max_queue_rows`` rows.  Backpressure bound: without it an
     over-capacity offered load grows the queue (and every queued
     request's latency) without bound.  Shedding at the door keeps the
     *admitted* latency distribution bounded — the classic
     goodput-over-throughput trade.
  2. ``degraded`` — the serve guard reports degraded mode (kill-switch
     trip or membership shrink).  Capacity is reduced and/or untrusted,
     so requests with ``priority <= degraded_shed_priority`` (the
     best-effort classes) are shed to preserve headroom for the
     latency-sensitive ones.  Higher-priority classes still pass
     through checks 1 and 3.
  3. ``infeasible`` — deadline feasibility.  With the live per-row
     service estimate ``s`` (EWMA over observed scheduler steps), a
     request arriving ``now`` behind ``q`` queued rows completes no
     earlier than ``now + s * (q + rows)``; if that already misses the
     request's deadline, admitting it wastes capacity that feasible
     requests could use.  ``slack`` scales the estimate (>1 =
     conservative admission).

Failed dispatches route through :meth:`AdmissionController.retry_or_shed`
— a bounded-retry policy (``max_retries``), with the same feasibility
check applied at retry time (a request whose deadline became hopeless
while it waited is shed as ``infeasible``, not re-queued).  After a
capacity shrink, :meth:`reevaluate` re-runs feasibility over the queue
so already-admitted requests that can no longer make their deadlines
are shed *now* rather than after burning a dispatch slot.

All decisions are pure functions of (request, clock, queue state,
estimator state), so a fault drill on a ``VirtualClock`` journals the
identical decision sequence every run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .request import Request

__all__ = ["ServiceEstimator", "SloPolicy", "AdmissionController",
           "SHED_REASONS"]

SHED_REASONS = ("queue_full", "degraded", "infeasible", "retries_exhausted",
                "drained")


class ServiceEstimator:
    """EWMA estimate of per-row service time, capacity-shift aware.

    Feed it ``observe(t_step, rows)`` after every scheduler step; it
    tracks ``per_row_s`` (seconds of wall time per batch row) with the
    same exponential smoothing the scheduler's own controller uses.
    ``rescale(ratio)`` handles discrete capacity changes (a group
    demotion roughly multiplies per-row time by old/new capacity) so
    feasibility checks react to a shrink immediately instead of waiting
    for the EWMA to drift there.
    """

    def __init__(self, *, init_per_row_s: float = 1e-3,
                 smoothing: float = 0.4):
        if init_per_row_s <= 0:
            raise ValueError("init_per_row_s must be > 0")
        if not 0 < smoothing <= 1:
            raise ValueError("smoothing must be in (0, 1]")
        self.per_row_s = float(init_per_row_s)
        self.smoothing = float(smoothing)
        self.n_obs = 0

    @property
    def ready(self) -> bool:
        """False until the first real observation: the initial estimate
        is a prior, not a measurement, so admission treats feasibility
        checks as advisory until this flips."""
        return self.n_obs > 0

    def observe(self, t_step: float, rows: int) -> None:
        if rows < 1 or t_step < 0:
            return
        x = t_step / rows
        a = self.smoothing
        self.per_row_s = x if self.n_obs == 0 \
            else (1 - a) * self.per_row_s + a * x
        self.n_obs += 1

    def rescale(self, ratio: float) -> None:
        """Multiply the estimate by ``ratio`` (= old_capacity /
        new_capacity for a shrink: fewer device-seconds per second means
        proportionally more wall time per row)."""
        if ratio > 0:
            self.per_row_s *= float(ratio)

    def eta(self, queued_rows: int, rows: int) -> float:
        """Estimated seconds until a request of ``rows`` rows placed
        behind ``queued_rows`` rows completes."""
        return self.per_row_s * (queued_rows + rows)

    # -- durability (runtime.checkpoint snapshots) -------------------------
    def state_dict(self) -> dict:
        return {"per_row_s": float(self.per_row_s),
                "n_obs": int(self.n_obs)}

    def load_state(self, state: dict) -> None:
        self.per_row_s = float(state["per_row_s"])
        self.n_obs = int(state["n_obs"])


@dataclass(frozen=True)
class SloPolicy:
    """Knobs of the admission policy (defaults documented in
    ``docs/serving.md``).

    ``max_queue_rows``: backpressure bound — queue rows beyond which
    new arrivals are shed ``queue_full``.  ``max_retries``: dispatch
    failures a request may survive before ``retries_exhausted``.
    ``degraded_shed_priority``: in degraded mode, requests with
    priority <= this are shed (default 0 = shed best-effort, keep
    interactive).  ``slack``: feasibility safety factor on the service
    estimate (>1 admits conservatively).
    """

    max_queue_rows: int = 256
    max_retries: int = 1
    degraded_shed_priority: int = 0
    slack: float = 1.0

    def __post_init__(self):
        if self.max_queue_rows < 1:
            raise ValueError("max_queue_rows must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.slack <= 0:
            raise ValueError("slack must be > 0")


class AdmissionController:
    """Stateless-per-decision admission valve (state lives in the
    estimator and the policy)."""

    def __init__(self, policy: SloPolicy | None = None,
                 estimator: ServiceEstimator | None = None):
        self.policy = policy or SloPolicy()
        self.estimator = estimator or ServiceEstimator()

    def _infeasible(self, req: Request, now: float,
                    queued_rows: int) -> bool:
        if not self.estimator.ready:
            return False          # prior only — don't shed on a guess
        eta = self.policy.slack * self.estimator.eta(queued_rows, req.rows)
        return now + eta > req.deadline

    def admit(self, req: Request, now: float, queued_rows: int, *,
              degraded: bool = False) -> str | None:
        """Admission decision for a submitted request: ``None`` =
        admit; otherwise the shed reason (policy order: queue_full,
        degraded, infeasible).  The caller performs the actual state
        transition + journaling."""
        if queued_rows + req.rows > self.policy.max_queue_rows:
            return "queue_full"
        if degraded and req.priority <= self.policy.degraded_shed_priority:
            return "degraded"
        if self._infeasible(req, now, queued_rows):
            return "infeasible"
        return None

    def retry_or_shed(self, req: Request, now: float,
                      queued_rows: int) -> str | None:
        """Post-failure decision: ``None`` = retry (re-queue);
        otherwise the shed reason.  Bounded retries, then the same
        feasibility check as at admission — waiting through a failure
        may have made the deadline hopeless."""
        if req.retries >= self.policy.max_retries:
            return "retries_exhausted"
        if self._infeasible(req, now, queued_rows):
            return "infeasible"
        return None

    def reevaluate(self, queue: Sequence[Request], now: float, *,
                   degraded: bool = False) -> list[tuple[Request, str]]:
        """Re-check already-admitted queued requests after a capacity
        change; returns ``(request, reason)`` pairs to shed (the caller
        removes them from the queue and journals).  Feasibility is
        evaluated against each request's position in the queue, so
        requests that still fit ahead of the cut keep their admission.
        """
        sheds = []
        ahead = 0
        for req in queue:
            if degraded \
                    and req.priority <= self.policy.degraded_shed_priority:
                sheds.append((req, "degraded"))
                continue
            if self._infeasible(req, now, ahead):
                sheds.append((req, "infeasible"))
                continue
            ahead += req.rows
        return sheds
