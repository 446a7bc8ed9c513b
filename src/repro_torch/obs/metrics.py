"""Process-local metrics: counters, gauges, fixed-bucket histograms.

A :class:`MetricsRegistry` hands out named handles; hot paths hold the
handle (one attribute load + add per event), never a dict lookup.  A
**disabled** registry hands out shared no-op singletons instead — the
handle API is identical, the cost is one no-op method call, and nothing
accumulates — so instrumented code needs no ``if enabled`` branches of
its own (the scheduler still guards its whole instrumentation block
behind the observer, which makes the disabled path literally
allocation-free).

Histograms use fixed geometric buckets (default: 1 µs to 100 s, four
per decade — the latency range of everything this repo times, from a
kernel launch to a serving step) and support percentile extraction by
linear interpolation inside the owning bucket: the error of ``p50`` /
``p95`` / ``p99`` is bounded by the bucket width (~78% ratio steps at
four buckets per decade), which is the right resolution for SLO
accounting without keeping samples.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_latency_buckets"]


def default_latency_buckets() -> tuple[float, ...]:
    """Geometric bucket upper bounds: 1e-6 .. 1e2 s, 4 per decade."""
    return tuple(10.0 ** (-6 + i / 4) for i in range(4 * 8 + 1))


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with percentile extraction.

    ``buckets`` are ascending upper bounds; observations above the last
    bound land in an overflow bucket.  ``min``/``max``/``sum``/``count``
    are tracked exactly, so means are exact and percentile estimates
    are clamped to the observed range.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Sequence[float] | None = None):
        self.name = name
        self.bounds = tuple(buckets) if buckets is not None \
            else default_latency_buckets()
        if list(self.bounds) != sorted(self.bounds) or len(self.bounds) < 1:
            raise ValueError("histogram buckets must be ascending")
        self.counts = [0] * (len(self.bounds) + 1)    # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float | None:
        """Estimated ``q``-quantile (``q`` in [0, 1]); None when empty.

        Linear interpolation inside the bucket holding the target rank
        (numpy's ``linear`` method applied to bucket-censored data);
        the estimate is clamped to the exact observed min/max, so
        single-bucket histograms still answer sensibly.
        """
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        target = q * (self.count - 1) + 1        # 1-based fractional rank
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)

    def summary(self) -> dict:
        out = {"count": self.count, "sum": round(self.sum, 9)}
        if self.count:
            out.update(
                min=self.min, max=self.max, mean=self.sum / self.count,
                p50=self.percentile(0.50), p95=self.percentile(0.95),
                p99=self.percentile(0.99))
        return out


class _NoopCounter:
    __slots__ = ()

    def inc(self, n: int | float = 1) -> None:
        pass


class _NoopGauge:
    __slots__ = ()

    def set(self, v: float) -> None:
        pass


class _NoopHistogram:
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> None:
        return None

    def summary(self) -> dict:
        return {"count": 0}


_NOOP_COUNTER = _NoopCounter()
_NOOP_GAUGE = _NoopGauge()
_NOOP_HISTOGRAM = _NoopHistogram()


class MetricsRegistry:
    """Named counters/gauges/histograms; disabled = shared no-op handles."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NOOP_COUNTER
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NOOP_GAUGE
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] | None = None) -> Histogram:
        if not self.enabled:
            return _NOOP_HISTOGRAM
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    def to_dict(self) -> dict:
        """JSON-ready snapshot (histograms as percentile summaries)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }
