"""Distribution and fault tolerance: the restart supervisor
(``fault.py``) and the rules API chunks are annotated through
(``api.py``); sharding rules tables, gradient compression and
sequence-sharded decode follow."""

from .api import constrain, constrain_leading, current_rules, use_rules
from .fault import GroupFailure, RestartReport, run_with_restarts

__all__ = ["GroupFailure", "RestartReport", "constrain", "constrain_leading",
           "current_rules", "run_with_restarts", "use_rules"]
