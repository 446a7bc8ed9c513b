"""Crash durability: write-ahead logs, checksummed snapshots, ledgers.

The paper's budget claim — a near-optimal configuration from ~5% of the
space — is an accounting over *measurements performed*; a process fault
(OOM kill, preemption, ``kill -9``) that forfeits them silently breaks
it.  The scheduler and the guard handle device faults; this module
closes the host/process half of the failure model with three small,
separately testable pieces:

``WalWriter`` / ``read_wal`` — the write-ahead request log.
    Append-only JSONL; each record carries a dense ``lsn``, the payload
    and a ``crc`` (truncated SHA-256 over the record minus the crc
    field).  Appends flush per line and ``fsync`` every ``fsync_every``
    records, so a crash loses at most the unsynced suffix — and a *torn*
    final write (the classic partial ``write(2)``) is detected, not
    misread: :func:`read_wal` stops at the first unparsable / checksum-
    mismatched / lsn-discontinuous line and returns the valid prefix
    plus a description of the torn tail.  Reopening a WAL for append
    truncates the torn tail first, so the resumed run's records continue
    a clean prefix.  ``ServeEngine`` logs ``admit``/``retire`` records
    through this: on restart, admitted-but-unretired requests replay
    through admission (at-least-once execution, exactly-once terminal
    accounting — one valid ``retire`` per rid).

``save_snapshot`` / ``load_snapshot`` — checksummed state snapshots.
    Atomic (tmp + ``os.replace``) JSON ``{"checksum", "state"}``; a load
    that fails to parse or whose checksum mismatches **quarantines** the
    file to ``<name>.corrupt-<sha8>`` (:func:`quarantine`) and returns
    ``None`` — corrupted durable state is preserved for forensics and
    never crashes a restart.

``MeasurementLedger`` — resumable tuning.
    A WAL of (config -> metrics) measurements wrapped around any
    evaluator: a config measured before the crash is served from the
    ledger at zero real cost, so a resumed ``TuningSession`` replays the
    deterministic search trajectory through cache hits and only spends
    budget on configs the crashed run never reached.

:class:`SimulatedCrash` is the in-process process-fault (raised by the
fault injector's ``crash`` events in ``raise`` mode); :func:`tear`
truncates a file mid-record to build torn-tail fixtures.

Nothing here touches a tensor: records, snapshots and their checksums
are the JAX package's byte for byte, so a WAL written by either package
reads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Callable, Mapping

__all__ = ["MeasurementLedger", "SimulatedCrash", "WalWriter", "quarantine",
           "load_snapshot", "read_wal", "save_snapshot", "tear"]


class SimulatedCrash(BaseException):
    """An injected process fault (``FaultPlan.crash`` in ``raise`` mode).

    Derives from ``BaseException`` so no recovery-minded ``except
    Exception`` handler on the dispatch path can absorb it — exactly
    like the ``SystemExit``/``KeyboardInterrupt`` it stands in for.
    """


def _record_crc(rec: Mapping[str, Any]) -> str:
    """Truncated SHA-256 of a record minus its ``crc`` field."""
    body = {k: v for k, v in rec.items() if k != "crc"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:8]


def quarantine(path: str | os.PathLike, reason: str = "corrupt") -> Path:
    """Move a corrupt durable file aside to ``<name>.corrupt-<sha8>``.

    The suffix is a hash of the file's raw bytes, so repeated
    quarantines of distinct corruptions never collide and identical
    corruptions are idempotent.  The original path is free afterwards
    (the caller starts fresh).  Returns the quarantine path.
    """
    p = Path(path)
    sha8 = hashlib.sha256(p.read_bytes()).hexdigest()[:8]
    dest = p.with_name(p.name + f".corrupt-{sha8}")
    os.replace(p, dest)
    from ..obs import get_logger
    log = get_logger("repro_torch.checkpoint")
    log.warning(f"quarantined corrupt file {p} -> {dest.name} ({reason})",
                path=str(p), quarantined=dest.name, reason=reason)
    if log.journal is not None:
        log.journal.event("store_quarantined", path=str(p),
                          quarantined=dest.name, reason=reason)
    return dest


def read_wal(path: str | os.PathLike) -> tuple[list[dict], dict | None]:
    """Parse a WAL; returns ``(valid_records, torn)``.

    ``torn`` is ``None`` for a fully valid file, else a description of
    the invalid tail: ``{"line": first bad line index, "valid_bytes":
    byte offset where the valid prefix ends, "reason": ...}``.  Parsing
    stops at the first bad line — records beyond a corruption are
    unordered garbage by the WAL contract (appends are sequential), so
    the valid prefix is exactly the recoverable history.
    """
    p = Path(path)
    records: list[dict] = []
    if not p.exists():
        return records, None
    raw = p.read_bytes()
    offset = 0
    for i, line in enumerate(raw.split(b"\n")):
        if not line.strip():
            offset += len(line) + 1
            continue
        reason = None
        try:
            rec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            rec, reason = None, "unparsable line"
        if rec is not None and not isinstance(rec, dict):
            rec, reason = None, "record is not an object"
        if rec is not None and rec.get("crc") != _record_crc(rec):
            rec, reason = None, "checksum mismatch"
        if rec is not None and rec.get("lsn") != len(records):
            rec, reason = None, (f"lsn {rec.get('lsn')!r} breaks the dense "
                                 f"sequence at {len(records)}")
        if rec is None:
            return records, {"line": i, "valid_bytes": offset,
                             "reason": reason}
        records.append(rec)
        offset += len(line) + 1
    return records, None


class WalWriter:
    """Append-only write-ahead log with fsync batching.

    Opening an existing file recovers its valid prefix (torn tails are
    truncated away) and continues the lsn sequence — the resume path and
    the first run share one code path.  ``fsync_every=1`` makes every
    record durable before ``append`` returns (the real ``kill -9``
    drill's setting); larger values batch the fsyncs and bound the loss
    window to ``fsync_every - 1`` records.
    """

    def __init__(self, path: str | os.PathLike, *, fsync_every: int = 8):
        if fsync_every < 1:
            raise ValueError("fsync_every must be >= 1")
        self.path = Path(path)
        self.fsync_every = int(fsync_every)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.recovered, self.torn = read_wal(self.path)
        if self.torn is not None:
            with open(self.path, "r+b") as f:
                f.truncate(self.torn["valid_bytes"])
        self.lsn = len(self.recovered)
        self._f = open(self.path, "a", encoding="utf-8")
        self._since_sync = 0

    def append(self, kind: str, **fields) -> dict:
        """Durably append one record; returns it (with lsn + crc)."""
        rec = {"lsn": self.lsn, "kind": kind, **fields}
        rec["crc"] = _record_crc(rec)
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()
        self.lsn += 1
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            self.sync()
        return rec

    def append_torn(self, kind: str, **fields) -> None:
        """Simulate a torn write: flush only a prefix of the encoded
        record (no newline, no crc close) — the fault injector's
        ``torn`` event, producing exactly the tail :func:`read_wal`
        detects and the reopen path truncates."""
        rec = {"lsn": self.lsn, "kind": kind, **fields}
        line = json.dumps(rec, default=str)
        self._f.write(line[:max(len(line) // 2, 1)])
        self.sync()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_snapshot(path: str | os.PathLike, state: Mapping[str, Any]) -> Path:
    """Atomically write a checksummed snapshot (tmp + ``os.replace``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    body = {"checksum": _sha_state(state), "state": state}
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(body, indent=1, sort_keys=True, default=str))
    os.replace(tmp, p)
    return p


def _sha_state(state: Mapping[str, Any]) -> str:
    blob = json.dumps(state, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def load_snapshot(path: str | os.PathLike) -> dict | None:
    """Load a snapshot's state; quarantine + ``None`` on corruption.

    Missing file -> ``None`` (a fresh start, not an error).  A parse
    failure or checksum mismatch moves the file aside via
    :func:`quarantine` so the restart proceeds from the WAL alone.
    """
    p = Path(path)
    if not p.exists():
        return None
    try:
        body = json.loads(p.read_text())
        state = body["state"]
        if body.get("checksum") != _sha_state(state):
            raise ValueError("checksum mismatch")
    except (ValueError, KeyError, TypeError) as exc:
        quarantine(p, reason=f"snapshot: {exc}")
        return None
    return state


def tear(path: str | os.PathLike, keep_fraction: float = 0.5) -> None:
    """Truncate a file to a fraction of its last line (test fixture for
    the torn-write failure mode: the tail is mid-record garbage)."""
    p = Path(path)
    raw = p.read_bytes()
    cut = raw.rstrip(b"\n").rfind(b"\n") + 1      # start of the last line
    last_len = len(raw) - cut
    with open(p, "r+b") as f:
        f.truncate(cut + max(int(last_len * keep_fraction), 1))


class MeasurementLedger:
    """WAL-backed (config -> metrics) cache making tuning resumable.

    ``wrap(evaluator)`` returns a drop-in evaluator: a config already in
    the ledger is served from it (``n_replayed`` += 1, zero real cost);
    a miss calls through, durably appends the measurement, and counts
    toward ``n_real``.  Because every registered strategy is
    deterministic given its seed, a crashed-and-resumed
    ``TuningSession`` re-walks the identical config trajectory — the
    prefix hits the ledger, and only the configs beyond the crash point
    spend real measurements.  ``total_real`` (valid WAL records) is the
    cross-restart budget the recovery bench asserts against the
    single-run budget.
    """

    def __init__(self, path: str | os.PathLike, *, fsync_every: int = 1):
        self._wal = WalWriter(path, fsync_every=fsync_every)
        self._cache: dict[str, Any] = {}
        for rec in self._wal.recovered:
            if rec.get("kind") == "measure":
                self._cache[rec["key"]] = rec["value"]
        self.n_real = 0          # real measurements this process
        self.n_replayed = 0      # ledger hits this process

    @property
    def path(self) -> Path:
        return self._wal.path

    @property
    def total_real(self) -> int:
        """Real measurements across every run sharing this ledger file."""
        return len(self._cache)

    @staticmethod
    def _key(cfg: Mapping[str, Any]) -> str:
        return json.dumps({str(k): cfg[k] for k in sorted(cfg, key=str)},
                          sort_keys=True, separators=(",", ":"), default=str)

    def lookup(self, cfg: Mapping[str, Any]) -> Any | None:
        return self._cache.get(self._key(cfg))

    @staticmethod
    def _jsonable(value: Any) -> Any:
        """Round-trip the value through JSON now (numpy scalars ->
        floats), so in-process hits and post-restart replays serve the
        *identical* object shape."""
        return json.loads(json.dumps(value, default=float))

    def record(self, cfg: Mapping[str, Any], value: Any) -> None:
        key = self._key(cfg)
        value = self._jsonable(value)
        self._cache[key] = value
        self._wal.append("measure", key=key, value=value)

    def wrap(self, evaluator: Callable[[Mapping[str, Any]], Any]
             ) -> Callable[[Mapping[str, Any]], Any]:
        """Ledger-through evaluator: hit -> replay, miss -> measure+log."""
        def measured(cfg):
            key = self._key(cfg)
            if key in self._cache:
                self.n_replayed += 1
                return self._cache[key]
            value = self._jsonable(evaluator(cfg))
            self.n_real += 1
            self._cache[key] = value
            self._wal.append("measure", key=key, value=value)
            return value
        return measured

    def close(self) -> None:
        self._wal.close()
