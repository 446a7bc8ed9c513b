"""Distribution and fault tolerance.  Only the restart supervisor
(``fault.py``) is ported so far; sharding, gradient compression and
sequence-sharded decode follow."""

from .fault import GroupFailure, RestartReport, run_with_restarts

__all__ = ["GroupFailure", "RestartReport", "run_with_restarts"]
