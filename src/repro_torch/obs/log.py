"""Structured logger for the launch scripts and tuning CLI narration.

``launch/serve.py``, ``launch/train.py`` and the ``repro_torch.tune``
selfcheck used to narrate with bare ``print(...)``; this logger keeps
their CLI output **byte-compatible by default** (the default format is
the message verbatim, level INFO, stdout) while adding two things
prints cannot do:

  * level filtering — ``configure(level="warning")`` or
    ``REPRO_LOG_LEVEL=warning`` silences the per-step narration without
    touching call sites;
  * a journal sink — ``configure(journal=observer.journal)`` mirrors
    every emitted line into the run's decision journal as a ``log``
    event (same JSONL stream as the semantic events), so the narration
    and the decisions land in one causally ordered record.

Usage::

    from repro_torch.obs import get_logger
    log = get_logger("repro_torch.serve")
    log.info(f"stream: {n} batches", batches=n)    # fields -> journal only
"""

from __future__ import annotations

import os
import sys
from typing import IO

__all__ = ["LEVELS", "StructuredLogger", "configure", "get_logger"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

# process-wide defaults; configure() updates these AND every logger
# already handed out, so launch scripts may configure at any point
_config: dict = {
    "level": os.environ.get("REPRO_LOG_LEVEL", "info").lower(),
    "journal": None,
    "stream": None,
}


class StructuredLogger:
    """Level-filtered message printer with an optional journal mirror."""

    def __init__(self, name: str, *, level: str | None = None,
                 stream: IO[str] | None = None, journal=None):
        self.name = name
        self.level = LEVELS[(level or _config["level"])]
        self.stream = stream if stream is not None else _config["stream"]
        self.journal = journal if journal is not None else _config["journal"]

    def log(self, level: str, msg: str, **fields) -> None:
        """Print ``msg`` verbatim when ``level`` passes the filter, and
        mirror it (with the structured ``fields``) into the journal.
        The journal sees every emitted line, filtered the same way."""
        n = LEVELS.get(level, LEVELS["info"])
        if n < self.level:
            return
        print(msg, file=self.stream or sys.stdout, flush=True)
        if self.journal is not None:
            self.journal.event("log", level=level, logger=self.name,
                               msg=msg, **fields)

    def debug(self, msg: str, **fields) -> None:
        self.log("debug", msg, **fields)

    def info(self, msg: str, **fields) -> None:
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self.log("error", msg, **fields)


_loggers: dict[str, StructuredLogger] = {}


def get_logger(name: str) -> StructuredLogger:
    """The process-wide logger registered under ``name`` (created on
    first use with the current global configuration)."""
    lg = _loggers.get(name)
    if lg is None:
        lg = _loggers[name] = StructuredLogger(name)
    return lg


def configure(*, level: str | None = None, journal=None,
              stream: IO[str] | None = None) -> None:
    """Reconfigure every registered (and future) logger in place.

    ``level`` filters (``debug``/``info``/``warning``/``error``);
    ``journal`` mirrors emitted lines into a
    :class:`~repro_torch.obs.journal.Journal`; ``stream`` redirects the
    printed output (tests).  Pass ``journal=False`` / ``stream=False``
    to detach an earlier sink."""
    if level is not None:
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; expected one "
                             f"of {sorted(LEVELS)}")
        _config["level"] = level
    if journal is not None:
        _config["journal"] = None if journal is False else journal
    if stream is not None:
        _config["stream"] = None if stream is False else stream
    for lg in _loggers.values():
        if level is not None:
            lg.level = LEVELS[level]
        if journal is not None:
            lg.journal = _config["journal"]
        if stream is not None:
            lg.stream = _config["stream"]
