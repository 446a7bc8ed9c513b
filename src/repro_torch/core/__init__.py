"""The paper's primary contribution: combinatorial optimization (simulated
annealing) + machine learning (boosted decision-tree regression) to find
near-optimal configurations of a discrete space.

Public surface:
  ConfigSpace/Param      — discrete parameter spaces (space.py)
  simulated_annealing    — the paper's SA (sa.py), + vectorized_sa
  BoostedTreesRegressor  — from-scratch BDTR (bdtr.py)
  MeasurementEvaluator   — experiment-counting oracles (evaluators.py)

Tune through ``repro_torch.tune.TuningSession``.
"""

from .bdtr import (BoostedTreesRegressor, absolute_error, bin_features,
                   fit_tree_hist, percent_error)
from .evaluators import (BatchedLearnedEvaluator, LearnedEvaluator,
                         MeasurementEvaluator, SurrogatePair)
from .sa import SAResult, SASchedule, simulated_annealing, vectorized_sa
from .space import ConfigSpace, Param, paper_space

__all__ = [
    "BoostedTreesRegressor", "absolute_error", "percent_error",
    "bin_features", "fit_tree_hist",
    "BatchedLearnedEvaluator", "LearnedEvaluator", "MeasurementEvaluator",
    "SurrogatePair",
    "SAResult", "SASchedule", "simulated_annealing", "vectorized_sa",
    "ConfigSpace", "Param", "paper_space",
]
