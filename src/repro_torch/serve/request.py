"""Request lifecycle and deterministic request sources.

The unit of work one level above the scheduler's batch: a ``Request``
asks for ``rows`` batch rows of a given ``(prompt_len, gen)`` shape,
arrives at an instant on the serving clock, and carries a deadline
(``t_arrival + slo_s``) and a priority class.  Its lifecycle is an
explicit state machine —

    submitted ──▶ admitted ──▶ batched ──▶ dispatched ──▶ completed
        │            │                          │
        └──▶ shed ◀──┴──────────(failed ────────┘──▶ admitted | shed)

— every transition is validated (an illegal one raises), timestamped on
the serving clock, and the terminal states are exactly ``completed``
and ``shed``: the zero-lost-requests invariant of the serving engine is
"every admitted request ends in one of the two, with sheds carrying a
journaled reason".

``RequestSource`` is the deterministic arrival process: all arrivals
(Poisson interarrivals at ``rate_rps``, mixed shapes/rows/classes) are
precomputed from one seed in ``__init__``, so every test, bench and
drill that shares a seed sees bit-identical request streams on a
``VirtualClock`` — wall-clock independence exactly like the fault and
observability harnesses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = ["Request", "RequestClass", "RequestSource", "REQUEST_STATES"]

REQUEST_STATES = ("submitted", "admitted", "shed", "batched", "dispatched",
                  "completed", "failed")

# state machine: legal transitions (see module docstring).  ``failed ->
# admitted`` is the retry re-queue; ``failed -> shed`` is the give-up.
_TRANSITIONS = {
    "submitted": {"admitted", "shed"},
    "admitted": {"batched", "shed"},
    "batched": {"dispatched"},
    "dispatched": {"completed", "failed"},
    "failed": {"admitted", "shed"},
    "completed": set(),
    "shed": set(),
}


@dataclass(frozen=True)
class RequestClass:
    """One priority class of the request mix: a name, the class SLO
    (deadline = arrival + ``slo_s``), a priority (higher dispatches
    first; lower is shed first under degraded capacity) and the mix
    weight the source draws with."""

    name: str
    slo_s: float
    priority: int = 0
    weight: float = 1.0

    def __post_init__(self):
        if self.slo_s <= 0:
            raise ValueError("slo_s must be > 0")
        if self.weight < 0:
            raise ValueError("weight must be >= 0")


@dataclass
class Request:
    """One serving request: ``rows`` batch rows of one prompt/gen shape
    with an arrival time, deadline and priority class."""

    rid: int
    rows: int
    prompt_len: int
    gen: int
    t_arrival: float
    slo_s: float
    klass: str = "interactive"
    priority: int = 0
    status: str = "submitted"
    retries: int = 0
    t_admit: float | None = None
    t_dispatch: float | None = None
    t_done: float | None = None
    shed_reason: str | None = field(default=None)
    # True when this request was rebuilt from the write-ahead log after
    # a crash and re-entered admission (at-least-once replay); completion
    # records and journal events carry the marker so recovered lifecycles
    # are distinguishable in latency anatomy (docs/serving.md)
    replayed: bool = False

    def __post_init__(self):
        if self.rows < 1:
            raise ValueError("a request needs at least one row")
        if self.slo_s <= 0:
            raise ValueError("slo_s must be > 0")

    # -- derived ------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        """Batching compatibility key: only same-shape requests coalesce
        into one scheduler batch (one step per shape)."""
        return (self.prompt_len, self.gen)

    @property
    def deadline(self) -> float:
        return self.t_arrival + self.slo_s

    @property
    def terminal(self) -> bool:
        return self.status in ("completed", "shed")

    @property
    def queue_delay_s(self) -> float | None:
        """Arrival -> dispatch wait (None until dispatched)."""
        if self.t_dispatch is None:
            return None
        return self.t_dispatch - self.t_arrival

    @property
    def service_s(self) -> float | None:
        """Dispatch -> completion (None until completed)."""
        if self.t_done is None or self.t_dispatch is None:
            return None
        return self.t_done - self.t_dispatch

    @property
    def latency_s(self) -> float | None:
        """End-to-end arrival -> completion (None until completed)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival

    @property
    def slo_ok(self) -> bool | None:
        if self.t_done is None:
            return None
        return self.t_done <= self.deadline

    # -- transitions --------------------------------------------------------
    def _to(self, state: str) -> None:
        if state not in _TRANSITIONS[self.status]:
            raise ValueError(
                f"request {self.rid}: illegal transition "
                f"{self.status!r} -> {state!r}")
        self.status = state

    def admit(self, now: float) -> "Request":
        self._to("admitted")
        if self.t_admit is None:         # a retry keeps its first admit
            self.t_admit = float(now)
        return self

    def shed(self, now: float, reason: str) -> "Request":
        self._to("shed")
        self.t_done = float(now)
        self.shed_reason = str(reason)
        return self

    def batched(self) -> "Request":
        self._to("batched")
        return self

    def dispatched(self, now: float) -> "Request":
        self._to("dispatched")
        self.t_dispatch = float(now)
        return self

    def completed(self, done_at: float) -> "Request":
        self._to("completed")
        self.t_done = float(done_at)
        return self

    def failed(self) -> "Request":
        """The dispatch carrying this request died before completing it;
        the admission layer decides retry (back to ``admitted``) or
        shed."""
        self._to("failed")
        self.t_dispatch = None           # the next dispatch re-stamps it
        return self

    def retry(self, now: float) -> "Request":
        self.retries += 1
        return self.admit(now)

    def record(self) -> dict:
        """JSON-ready completion record (terminal states only)."""
        return {
            "rid": self.rid, "rows": self.rows, "shape": list(self.shape),
            "klass": self.klass, "priority": self.priority,
            "status": self.status, "retries": self.retries,
            "shed_reason": self.shed_reason,
            "t_arrival": self.t_arrival, "t_done": self.t_done,
            "queue_delay_s": self.queue_delay_s,
            "service_s": self.service_s,
            "latency_s": self.latency_s,
            "slo_ok": self.slo_ok,
            "replayed": self.replayed,
        }

    # -- write-ahead log round trip (runtime.checkpoint) --------------------
    def wal_fields(self) -> dict:
        """The identity fields an ``admit`` WAL record persists — enough
        to rebuild the request for post-crash replay (timing state is
        re-derived on replay, not restored)."""
        return {
            "rid": self.rid, "rows": self.rows,
            "prompt_len": self.prompt_len, "gen": self.gen,
            "t_arrival": self.t_arrival, "slo_s": self.slo_s,
            "klass": self.klass, "priority": self.priority,
            "retries": self.retries,
        }

    @classmethod
    def from_wal(cls, rec: dict) -> "Request":
        """Rebuild a replayable request from an ``admit`` WAL record:
        fresh ``submitted`` status (it re-enters admission), original
        arrival/deadline/retry budget, ``replayed`` marker set."""
        return cls(rid=int(rec["rid"]), rows=int(rec["rows"]),
                   prompt_len=int(rec["prompt_len"]), gen=int(rec["gen"]),
                   t_arrival=float(rec["t_arrival"]),
                   slo_s=float(rec["slo_s"]), klass=str(rec["klass"]),
                   priority=int(rec["priority"]),
                   retries=int(rec.get("retries", 0)), replayed=True)


class RequestSource:
    """Deterministic request arrival process.

    Every arrival is precomputed in ``__init__`` from one seeded
    generator: exponential interarrivals at ``rate_rps`` (a Poisson
    process — the standard open-loop offered-load model), request rows
    drawn from ``rows_choices``, shapes from ``shapes`` and priority
    classes from ``classes`` (weights normalized).  The source is
    consumed by time: ``take_until(now)`` hands over everything that
    has arrived, ``next_time()`` tells the engine how far to advance an
    idle clock.  Two sources with the same parameters and seed produce
    identical streams on any machine.
    """

    def __init__(self, *, n_requests: int, rate_rps: float, seed: int = 0,
                 shapes: Sequence[tuple[int, int]] = ((32, 16),),
                 shape_weights: Sequence[float] | None = None,
                 rows_choices: Sequence[int] = (1, 2, 4),
                 row_weights: Sequence[float] | None = None,
                 classes: Sequence[RequestClass] | None = None,
                 start: float = 0.0):
        if n_requests < 1:
            raise ValueError("need at least one request")
        if rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if classes is None:
            classes = (RequestClass("interactive", slo_s=1.0, priority=1,
                                    weight=0.7),
                      RequestClass("batch", slo_s=4.0, priority=0,
                                   weight=0.3))
        self.classes = tuple(classes)
        rng = np.random.default_rng(seed)

        def norm(w, n):
            w = np.full(n, 1.0 / n) if w is None else np.asarray(w, float)
            return w / w.sum()

        arrivals = start + np.cumsum(rng.exponential(1.0 / rate_rps,
                                                     n_requests))
        shape_idx = rng.choice(len(shapes), n_requests,
                               p=norm(shape_weights, len(shapes)))
        rows = rng.choice(np.asarray(rows_choices, int), n_requests,
                          p=norm(row_weights, len(rows_choices)))
        class_idx = rng.choice(
            len(self.classes), n_requests,
            p=norm([c.weight for c in self.classes], len(self.classes)))
        self.requests = [
            Request(rid=i, rows=int(rows[i]),
                    prompt_len=int(shapes[shape_idx[i]][0]),
                    gen=int(shapes[shape_idx[i]][1]),
                    t_arrival=float(arrivals[i]),
                    slo_s=self.classes[class_idx[i]].slo_s,
                    klass=self.classes[class_idx[i]].name,
                    priority=self.classes[class_idx[i]].priority)
            for i in range(n_requests)
        ]
        self._next = 0

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.requests)

    @property
    def remaining(self) -> int:
        return len(self.requests) - self._next

    def next_time(self) -> float | None:
        """Arrival instant of the next undelivered request (None when
        exhausted) — the engine's idle-clock advance target."""
        if self.exhausted:
            return None
        return self.requests[self._next].t_arrival

    def take_until(self, now: float) -> list[Request]:
        """All requests with ``t_arrival <= now`` not yet handed over,
        in arrival order."""
        out = []
        while not self.exhausted \
                and self.requests[self._next].t_arrival <= now:
            out.append(self.requests[self._next])
            self._next += 1
        return out

    @property
    def total_rows(self) -> int:
        return sum(r.rows for r in self.requests)
