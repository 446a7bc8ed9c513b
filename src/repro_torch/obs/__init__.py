"""repro_torch.obs — structured tracing, metrics, and the decision journal.

One :class:`Observer` bundles the three recording surfaces on a shared
clock and is threaded (default-off) through the runtime, guard, and
tuning constructors:

  * :class:`~repro_torch.obs.trace.Tracer` — Chrome-trace spans of *when*
    things ran (dispatch/drain lanes per group, tuning sessions);
  * :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges, and
    fixed-bucket latency histograms of *how much / how fast*;
  * :class:`~repro_torch.obs.journal.Journal` — the append-only record of
    *why*: every semantic decision (rebalance adopted, group demoted,
    kill switch tripped, store hit, ...) in causal order.

Instrumented call sites hold ``self._obs = as_observer(observer)`` and
guard every recording block with ``if self._obs is not None`` — a
disabled or absent observer costs nothing on the hot path (no calls, no
allocation; ``tests/test_obs.py`` pins this with tracemalloc).

Pass the same ``runtime.simulate.VirtualClock`` that drives a
fault-harness run and all three surfaces stamp deterministic simulated
timestamps: the same ``FaultPlan`` reproduces the same trace and
journal, which is what makes the CI fault drill an exact check.
"""

from __future__ import annotations

from .journal import EVENT_KINDS, Journal, load_journal, validate_events
from .log import LEVELS, StructuredLogger, configure, get_logger
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets)
from .provenance import build_meta, git_sha
from .report import render, summarize, write_summary
from .trace import Tracer, load_trace, validate_trace

__all__ = [
    "EVENT_KINDS", "Journal", "load_journal", "validate_events",
    "LEVELS", "StructuredLogger", "configure", "get_logger",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_buckets",
    "build_meta", "git_sha",
    "render", "summarize", "write_summary",
    "Tracer", "load_trace", "validate_trace",
    "Observer", "as_observer",
]


class Observer:
    """Tracer + metrics + journal on one clock.

    ``enabled=False`` builds the same object but :func:`as_observer`
    resolves it to None, which is how call sites keep their disabled
    path allocation-free; the sub-objects still exist so tests can
    assert they stayed empty.
    """

    def __init__(self, *, enabled: bool = True, clock=None, pid: int = 0):
        self.enabled = bool(enabled)
        self.clock = clock
        self.tracer = Tracer(clock=clock, pid=pid)
        self.metrics = MetricsRegistry(enabled=self.enabled)
        self.journal = Journal(clock=clock)

    def now(self) -> float:
        return self.tracer.now()

    # report.py conveniences, so launch scripts write artifacts in one
    # call each without importing the submodules
    def save_trace(self, path):
        return self.tracer.save(path)

    def save_journal(self, path):
        return self.journal.save(path)

    def write_summary(self, path, *, extra: dict | None = None,
                      date: str | None = None) -> dict:
        return write_summary(self, path, extra=extra, date=date)

    def render(self) -> str:
        return render(summarize(self, events=False))


def as_observer(obs) -> Observer | None:
    """Normalize a constructor's ``observer=`` argument.

    Returns the observer when it is present *and* enabled, else None —
    so instrumented code needs exactly one check (``is not None``) and
    a disabled observer is indistinguishable from no observer.
    """
    if obs is None or not getattr(obs, "enabled", True):
        return None
    return obs
