"""The paper's primary contribution: combinatorial optimization (simulated
annealing) + machine learning (boosted decision-tree regression) to find
near-optimal configurations of a discrete space.

Public surface:
  ConfigSpace/Param      — discrete parameter spaces (space.py)
  simulated_annealing    — the paper's SA (sa.py), + vectorized_sa
  BoostedTreesRegressor  — from-scratch BDTR (bdtr.py)
  MeasurementEvaluator   — experiment-counting oracles (evaluators.py)
  HeterogeneousRunner    — two device groups, one tunable split (hetero.py)
  Autotuner              — deprecated shim over ``repro_torch.tune``
  EmilPlatformModel      — calibrated model of the paper's platform
                           (time + energy metric columns)
  fit_emil_surrogates    — the paper's 7200-experiment training pipeline

Tune through ``repro_torch.tune.TuningSession``.
"""

from .autotuner import (Autotuner, TuneReport, emil_training_grids,
                        fit_emil_surrogates)
from .bdtr import (BoostedTreesRegressor, absolute_error, bin_features,
                   fit_tree_hist, percent_error)
from .hetero import (DeviceGroup, HeterogeneousRunner,
                     proportional_rebalance)
from .evaluators import (BatchedLearnedEvaluator, LearnedEvaluator,
                         MeasurementEvaluator, SurrogatePair)
from .platform_model import DATASETS_GB, EmilPlatformModel
from .sa import SAResult, SASchedule, simulated_annealing, vectorized_sa
from .space import ConfigSpace, Param, paper_space

__all__ = [
    "Autotuner", "TuneReport", "emil_training_grids", "fit_emil_surrogates",
    "BoostedTreesRegressor", "absolute_error", "percent_error",
    "bin_features", "fit_tree_hist",
    "DeviceGroup", "HeterogeneousRunner", "proportional_rebalance",
    "BatchedLearnedEvaluator", "LearnedEvaluator", "MeasurementEvaluator",
    "SurrogatePair",
    "DATASETS_GB", "EmilPlatformModel",
    "SAResult", "SASchedule", "simulated_annealing", "vectorized_sa",
    "ConfigSpace", "Param", "paper_space",
]
