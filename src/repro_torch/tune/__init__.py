"""repro_torch.tune — the unified tuning facade.

One session API for every tuning scenario, decoupled into three
pluggable pieces:

  objective  — what to minimise (``Time``, ``Energy``, ``Weighted``,
               ``Pareto``); see ``objective.py``.
  strategy   — how to search (``em``/``eml``/``sam``/``saml``/``random``/
               ``hillclimb`` + ``@register_strategy`` for new ones);
               see ``strategy.py``.
  evaluator  — where scores come from (scalar oracle, metrics oracle,
               batched columns, surrogate pair); see ``objective.py``.

``TuningSession`` binds them and ``run()`` returns a ``TuneResult``.
"""

from .objective import (Energy, Metric, MetricsEvaluator, Objective, Pareto,
                        Time, Weighted, as_metrics_evaluator, pareto_front)
from .result import TuneResult
from .session import TuningSession
from .strategy import (SearchContext, StrategyOutcome, get_strategy,
                       list_strategies, register_strategy)

__all__ = [
    "Objective", "Metric", "Time", "Energy", "Weighted", "Pareto",
    "MetricsEvaluator", "as_metrics_evaluator", "pareto_front",
    "TuneResult", "TuningSession",
    "SearchContext", "StrategyOutcome",
    "register_strategy", "get_strategy", "list_strategies",
]
