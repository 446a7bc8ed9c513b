"""Append-only structured decision journal (JSONL).

The trace answers *when* things ran; the journal answers *why the run
unfolded the way it did*: every semantic decision the runtime, guard,
and tuning stack makes is one JSON object with a monotone sequence
number and a clock timestamp.  Replaying a fault-harness run on a
``VirtualClock`` yields the same journal every time, so causal
assertions ("the demotion preceded the re-dispatch preceded the guard
trip") are exact tests, not log-scraping heuristics.

Event catalog (``EVENT_KINDS``; ``docs/observability.md`` documents the
fields of each):

  * ``rebalance_adopted`` / ``rebalance_debounced`` — the scheduler's
    plan cache adopted a new row split / suppressed a one-step flicker;
  * ``group_demoted`` / ``group_restored`` — elastic membership changes
    (with the failure reason on demotion);
  * ``chunks_redispatched`` — orphaned rows of a failed group completed
    on the survivors;
  * ``killswitch_armed`` / ``killswitch_tripped`` /
    ``killswitch_rearmed`` / ``guard_membership_change`` — the serve
    guard's state machine;
  * ``tuning_start`` / ``tuning_stop`` — one ``TuningSession.run``, with
    ``n_measured`` vs ``space_size`` (the paper's ~5% accounting);
  * ``store_hit`` / ``store_miss`` — the persistent tuning cache;
  * ``surrogate_refit`` — the online feedback loop folded live
    observations into the BDTR pair;
  * ``request_admitted`` / ``request_shed`` / ``request_retired`` /
    ``request_retried`` — the request-level serving layer
    (``repro.serve``): one event per admission decision, per shed
    (with the policy reason), per completed retirement (with the
    queue-delay/service decomposition) and per post-failure retry;
  * ``request_replayed`` / ``wal_recovered`` / ``snapshot_saved`` /
    ``store_quarantined`` — the crash-durability layer
    (``runtime.checkpoint``): one event per request rebuilt from the
    write-ahead log after a restart (with its requeue/shed
    disposition), one summary per WAL recovery, one per periodic
    soft-state snapshot, and one per corrupt durable file moved aside;
  * ``log`` — a structured-logger line routed into the journal sink.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import IO

__all__ = ["EVENT_KINDS", "Journal", "load_journal", "validate_events"]

EVENT_KINDS = frozenset({
    "rebalance_adopted", "rebalance_debounced",
    "group_demoted", "group_restored", "chunks_redispatched",
    "killswitch_armed", "killswitch_tripped", "killswitch_rearmed",
    "guard_membership_change",
    "tuning_start", "tuning_stop", "store_hit", "store_miss",
    "surrogate_refit",
    "request_admitted", "request_shed", "request_retired",
    "request_retried",
    "request_replayed", "wal_recovered", "snapshot_saved",
    "store_quarantined",
    "log",
})


class Journal:
    """Thread-safe append-only event list with an optional live sink."""

    def __init__(self, *, clock=None, sink: IO[str] | None = None,
                 flush_every: int = 1):
        """``clock`` is anything with ``now() -> float`` seconds (share
        the scheduler's ``VirtualClock`` for deterministic timestamps);
        ``sink`` is an optional open text stream that receives each
        event as one JSON line the moment it is recorded — with the
        default ``flush_every=1`` each line is flushed as written, so a
        crash loses nothing already journaled (larger values batch the
        flushes for hot paths); :meth:`save` writes the full JSONL
        afterwards either way, byte-identical to the streamed lines."""
        if flush_every < 1:
            raise ValueError("flush_every must be >= 1")
        self.clock = clock
        self.sink = sink
        self.flush_every = int(flush_every)
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time
        return time.perf_counter()

    def event(self, kind: str, **fields) -> dict:
        """Record one event; returns the record (already sequenced)."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown journal event kind {kind!r}; add it "
                             "to repro_torch.obs.journal.EVENT_KINDS (and the "
                             "docs/observability.md catalog) first")
        with self._lock:
            rec = {"seq": len(self.events), "ts": round(self.now(), 9),
                   "kind": kind, **fields}
            self.events.append(rec)
            if self.sink is not None:
                self.sink.write(json.dumps(rec, default=str) + "\n")
                if len(self.events) % self.flush_every == 0:
                    self.sink.flush()
        return rec

    def by_kind(self, kind: str) -> list[dict]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]

    def kinds(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            for e in self.events:
                out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.events)

    def save(self, path) -> Path:
        """Write the journal as JSONL (one event object per line)."""
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            lines = [json.dumps(e, default=str) for e in self.events]
        out.write_text("\n".join(lines) + ("\n" if lines else ""))
        return out


def load_journal(path) -> list[dict]:
    """Parse a JSONL journal back into event records."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def validate_events(events: list[dict],
                    known_kinds: frozenset[str] = EVENT_KINDS) -> list[str]:
    """Schema errors of a journal event list (empty list = valid).

    Every event must carry ``seq`` (dense, starting at 0), a numeric
    ``ts``, and a ``kind`` from the catalog.  ``python -m repro_torch.obs``
    runs this against the checked-in ``docs/obs_schema.json`` in CI.
    """
    errors = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for k in ("seq", "ts", "kind"):
            if k not in ev:
                errors.append(f"event {i}: missing key {k!r}")
        if not isinstance(ev.get("ts", 0), (int, float)):
            errors.append(f"event {i}: ts must be a number")
        if ev.get("seq") != i:
            errors.append(f"event {i}: seq {ev.get('seq')!r} is not dense")
        kind = ev.get("kind")
        if kind is not None and kind not in known_kinds:
            errors.append(f"event {i}: unknown kind {kind!r}")
    return errors
