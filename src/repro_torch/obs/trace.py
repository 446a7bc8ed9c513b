"""Lightweight span tracer producing Chrome-trace-format JSON.

One :class:`Tracer` records one run as a flat list of Chrome
``chrome://tracing`` / Perfetto events (the "Trace Event Format"):
``ph="X"`` complete spans with microsecond timestamps, ``ph="i"``
instants, and ``ph="M"`` metadata rows naming the lanes.  Load the
saved file directly in ``chrome://tracing`` or https://ui.perfetto.dev.

Three recording surfaces, matching how the runtime is structured:

  * :meth:`Tracer.span` — a context manager for straight-line code
    (tuning sessions, surrogate refits);
  * :meth:`Tracer.begin` / :meth:`Tracer.end` — explicit tokens for the
    threaded drain paths of ``ChunkedScheduler``, where a span opens in
    the dispatch loop and closes in a drain worker;
  * :meth:`Tracer.complete` — one-shot emission with explicit
    timestamps, for call sites that already carry exact instants (the
    scheduler's per-chunk completion times, ``SimReadyAt.ready_at``).

The clock is pluggable exactly like ``ChunkedScheduler``'s: pass the
same ``runtime.simulate.VirtualClock`` that drives a fault-harness run
and the trace timestamps are deterministic simulated instants — the
same ``FaultPlan`` yields the same span timeline, bit for bit (modulo
event append order across drain threads; sort by ``ts`` to compare).

Lanes: ``tid`` is a small stable integer chosen by the caller (the
scheduler uses the group index, never an OS thread id), so traces are
comparable across runs and machines.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Mapping

__all__ = ["Tracer", "load_trace", "validate_trace"]

_US = 1e6     # Chrome trace timestamps are microseconds


class Tracer:
    """Append-only Chrome-trace event recorder (thread-safe)."""

    def __init__(self, *, clock=None, pid: int = 0):
        """``clock`` is anything with ``now() -> float`` seconds (e.g. a
        ``VirtualClock``); the wall clock (``time.perf_counter``) when
        omitted.  ``pid`` groups every event under one process row."""
        self.clock = clock
        self.pid = pid
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._token = 0
        self._open: dict[int, tuple] = {}

    def now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.perf_counter()

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    # -- emission ------------------------------------------------------------
    def complete(self, name: str, ts_s: float, dur_s: float, *,
                 cat: str = "span", tid: int = 0,
                 args: Mapping[str, Any] | None = None) -> None:
        """One finished span with explicit start/duration in seconds."""
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
              "tid": int(tid), "ts": round(ts_s * _US, 3),
              "dur": round(max(dur_s, 0.0) * _US, 3)}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def instant(self, name: str, *, ts_s: float | None = None,
                cat: str = "event", tid: int = 0,
                args: Mapping[str, Any] | None = None) -> None:
        """A zero-duration marker (``ph="i"``, thread scope)."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.pid, "tid": int(tid),
              "ts": round((self.now() if ts_s is None else ts_s) * _US, 3)}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def begin(self, name: str, *, cat: str = "span", tid: int = 0,
              ts_s: float | None = None,
              args: Mapping[str, Any] | None = None) -> int:
        """Open a span; returns a token for :meth:`end`.

        Token-based rather than stack-based so the span can be closed
        from a different thread than the one that opened it (the
        scheduler's drain workers)."""
        ts = self.now() if ts_s is None else ts_s
        with self._lock:
            self._token += 1
            token = self._token
            self._open[token] = (name, cat, int(tid), ts,
                                 dict(args) if args else None)
        return token

    def end(self, token: int, *, ts_s: float | None = None,
            args: Mapping[str, Any] | None = None) -> None:
        """Close a span opened by :meth:`begin` (unknown tokens no-op)."""
        ts = self.now() if ts_s is None else ts_s
        with self._lock:
            opened = self._open.pop(token, None)
        if opened is None:
            return
        name, cat, tid, t0, a0 = opened
        merged = dict(a0 or {})
        if args:
            merged.update(args)
        self.complete(name, t0, ts - t0, cat=cat, tid=tid,
                      args=merged or None)

    @contextmanager
    def span(self, name: str, *, cat: str = "span", tid: int = 0,
             args: Mapping[str, Any] | None = None):
        """``with tracer.span("tune.saml"): ...`` for straight-line code."""
        token = self.begin(name, cat=cat, tid=tid, args=args)
        try:
            yield
        finally:
            self.end(token)

    def thread_name(self, tid: int, name: str) -> None:
        """Label lane ``tid`` (shown as the row name in the viewer)."""
        self._emit({"name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": int(tid), "ts": 0, "args": {"name": name}})

    # -- output --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> dict:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> Path:
        """Write a ``chrome://tracing``-loadable JSON file."""
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return out


def load_trace(path) -> list[dict]:
    """The ``traceEvents`` list of a saved trace file."""
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, list):           # bare-array variant is also legal
        return doc
    return list(doc.get("traceEvents", []))


_PH_REQUIRED = {
    "X": ("name", "cat", "ph", "pid", "tid", "ts", "dur"),
    "i": ("name", "cat", "ph", "pid", "tid", "ts"),
    "M": ("name", "ph", "pid", "tid"),
}


def validate_trace(events: list[dict]) -> list[str]:
    """Structural errors of a trace event list (empty list = valid).

    Checks the subset of the Trace Event Format this tracer emits:
    known phases, the per-phase required keys, numeric non-negative
    timestamps/durations.  ``python -m repro_torch.obs`` runs this against the
    checked-in schema (``docs/obs_schema.json``) in CI.
    """
    errors = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        for k in _PH_REQUIRED[ph]:
            if k not in ev:
                errors.append(f"event {i} ({ev.get('name')!r}): "
                              f"missing key {k!r}")
        for k in ("ts", "dur"):
            if k in ev and (not isinstance(ev[k], (int, float))
                            or ev[k] < 0):
                errors.append(f"event {i} ({ev.get('name')!r}): "
                              f"{k} must be a non-negative number")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"event {i}: args must be an object")
    return errors
