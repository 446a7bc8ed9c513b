"""``TuningSession`` — one entry point for every tuning scenario.

A session binds the decoupled pieces of the paper's loop (combinatorial
search + ML evaluation) once —

    session = TuningSession(
        space=paper_space(),
        evaluator=measure,                     # cfg -> metrics record
        objective=Weighted(Time(), Energy(), scales=(1.0, 300.0)),
        surrogate=pair,                        # enables eml / saml
        budget=1000,                           # default iterations/samples
        store="tune_cache.json",               # persistent result cache
        device="cpu",                          # None = the card
    )
    result = session.run("saml", engine="vectorized")

— and ``run(strategy)`` dispatches through the strategy registry
(``repro_torch.tune.strategy``), returning a unified :class:`TuneResult`.

Wiring notes:

  * ``evaluator`` accepts a plain scalar oracle (
    ``cfg -> seconds``), a metrics oracle (``cfg -> {"time": ...,
    "energy": ...}``) or a :class:`~repro_torch.tune.objective.MetricsEvaluator`;
    ``evaluator_batch`` is the optional column-oriented fast path.
  * ``surrogate`` is a ``SurrogatePair`` (scored through the objective's
    surrogate hooks) or any plain ``cfg -> score`` callable (scored
    verbatim — e.g. the sharding tuner's single fitted BDTR).
  * ``store`` caches results keyed by (space, workload, strategy,
    objective); a hit returns with zero new measurements.
  * ``warm_start`` seeds local-search strategies with a configuration
    (or a previous ``TuneResult``'s best config).
  * ``device`` is where the session's tensor work runs (the vectorized
    SA chains) and what keys the store's device topology; ``None``
    means the card.
  * ``observer``, ``ledger`` and ``online`` keep their places in the
    signature, but the layers behind them (the observability bundle,
    the ``MeasurementLedger`` write-ahead log, the
    ``OnlineSurrogateLoop`` feedback loop) are not ported yet: passing
    one raises ``NotImplementedError`` rather than being ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np

from ..core.space import ConfigSpace
from .objective import MetricsEvaluator, Objective, Time, as_metrics_evaluator
from .result import TuneResult
from .strategy import SearchContext, StrategyOutcome, get_strategy

__all__ = ["TuningSession"]


class TuningSession:
    """Builder binding space x evaluator x objective x strategy options."""

    def __init__(
        self,
        space: ConfigSpace,
        *,
        evaluator: Any = None,
        evaluator_batch: Any = None,
        objective: Objective | None = None,
        strategy: str | None = None,
        surrogate: Any = None,
        n_training_experiments: int = 0,
        budget: int | None = None,
        store: Any = None,
        warm_start: Any = None,
        workload: Mapping[str, Any] | None = None,
        online: Any = None,
        truth: Callable[[Mapping[str, Any]], Any] | None = None,
        seed: int | None = None,
        observer: Any = None,
        ledger: Any = None,
        device: Any = None,
    ):
        for name, given, layer in (
                ("observer", observer, "the observability layer (obs)"),
                ("ledger", ledger, "MeasurementLedger (runtime.checkpoint)"),
                ("online", online, "OnlineSurrogateLoop (runtime.feedback)")):
            if given is not None:
                raise NotImplementedError(
                    f"TuningSession({name}=...) needs {layer}, which is "
                    "not ported to repro_torch yet")
        self.space = space
        self.device = device
        self.evaluator = as_metrics_evaluator(evaluator, evaluator_batch)
        self.objective = objective if objective is not None else Time()
        self.strategy = strategy
        self.surrogate = surrogate
        self.n_training_experiments = n_training_experiments
        self.budget = budget
        self.store = self._as_store(store, device)
        self.workload = workload
        self.truth = truth
        self.seed = seed
        if warm_start is not None and hasattr(warm_start, "best_config"):
            warm_start = warm_start.best_config
        if warm_start is not None:
            space.validate(warm_start)
            warm_start = dict(warm_start)
        self.warm_start = warm_start

    @staticmethod
    def _as_store(store, device=None):
        if store is None or hasattr(store, "lookup"):
            return store
        # deferred import: tune must stay importable without runtime
        from ..runtime.store import TuningStore
        return TuningStore(store, device=device)

    # -- oracle composition --------------------------------------------------
    def _measure(self) -> Callable | None:
        """cfg -> objective score of one real measurement."""
        ev = self.evaluator
        if ev is None:
            return None
        objective = self.objective

        def scored(cfg):
            return float(objective(ev.metrics(cfg)))
        return scored

    def _metrics_batch(self) -> Callable | None:
        """Column batch -> metric columns."""
        ev = self.evaluator
        if ev is None or not ev.has_batch:
            return None
        return ev.metrics_batch

    def _measure_batch(self) -> Callable | None:
        metrics_batch = self._metrics_batch()
        if metrics_batch is None:
            return None
        objective = self.objective

        def scored(columns):
            return np.asarray(objective.batch(metrics_batch(columns)),
                              dtype=np.float64)
        return scored

    def _surrogate_oracles(self):
        """(predict, predict_batch, predict_torch_builder) for the context."""
        sur = self.surrogate
        if sur is None:
            return None, None, None
        if callable(sur) and not hasattr(sur, "predict_energy"):
            # a plain cfg -> score predictor (already objective-scored)
            return sur, None, None
        obj = self.objective
        try:
            predict = obj.surrogate_scalar(sur)
        except NotImplementedError:
            # the objective cannot score pair predictions (e.g. Energy):
            # surrogate strategies will raise their canonical "needs a
            # surrogate" error; measurement strategies are unaffected
            return None, None, None
        try:
            predict_batch = obj.surrogate_batch(sur)
        except NotImplementedError:
            predict_batch = None
        try:
            torch_builder = (obj.surrogate_torch_builder(sur)
                             if sur.energy_fn_torch_builder is not None
                             else None)
        except NotImplementedError:
            torch_builder = None
        return predict, predict_batch, torch_builder

    def _truth_metrics(self, cfg) -> tuple[float, dict]:
        """(ground-truth score, metrics record) of one configuration.

        Falls back evaluator -> surrogate when no explicit ``truth`` is
        given.
        """
        if self.truth is not None:
            out = self.truth(cfg)
            if isinstance(out, Mapping):
                m = {str(k): float(v) for k, v in out.items()}
                return float(self.objective(m)), m
            return float(out), {}
        if self.evaluator is not None:
            m = self.evaluator.metrics(cfg)
            return float(self.objective(m)), m
        predict, _, _ = self._surrogate_oracles()
        if predict is not None:
            return float(predict(cfg)), {}
        raise ValueError("session has neither evaluator, truth nor "
                         "surrogate to score the winning config")

    def _context(self) -> SearchContext:
        predict, predict_batch, torch_builder = self._surrogate_oracles()
        metrics_batch = self._metrics_batch()
        return SearchContext(
            space=self.space,
            measure=self._measure(),
            measure_batch=self._measure_batch(),
            predict=predict,
            predict_batch=predict_batch,
            predict_torch_builder=torch_builder,
            metrics_batch=metrics_batch,
            objective=self.objective,
            warm_start=self.warm_start,
            budget=self.budget,
        )

    # -- the run -------------------------------------------------------------
    def _store_key(self, strategy: str) -> str:
        key = strategy.upper()
        if self.objective.key != "time":
            key += "|" + self.objective.key
        return key

    def run(self, strategy: str | None = None, **opts) -> TuneResult:
        """Search and return the unified result.

        ``strategy`` defaults to the one given at construction; ``opts``
        are forwarded to the registered strategy function (``iterations=``,
        ``seed=``, ``engine=``, ``checkpoints=``, ...).
        """
        name = (strategy or self.strategy or "").lower()
        if not name:
            raise ValueError("no strategy: pass run('sam') or "
                             "TuningSession(strategy='sam')")
        info = get_strategy(name)
        if self.store is not None:
            hit = self.store.lookup(self.space, self.workload,
                                    self._store_key(name))
            if hit is not None:
                return hit
        if self.seed is not None:
            opts.setdefault("seed", self.seed)
        if self.device is not None:
            opts.setdefault("device", self.device)
        outcome = info.fn(self._context(), **opts)
        result = self._finalize(name, info, outcome)
        if self.store is not None:
            self.store.record(self.space, self.workload,
                              self._store_key(name), result)
        return result

    def _finalize(self, name: str, info, outcome: StrategyOutcome
                  ) -> TuneResult:
        # For fair comparison the paper evaluates suggested configs with
        # *measured* values (Sec. IV-C) — re-score checkpoints, then the
        # winner, with ground truth (same call order as the reference).
        measured_cp = {
            it: (self._truth_metrics(c)[0], dict(c))
            for it, (_, c) in outcome.checkpoints.items()
        }
        best_measured, best_metrics = self._truth_metrics(outcome.best_config)
        # deduplicated real-execution count, when the oracle keeps it
        # (KernelTimer does); oracle calls otherwise
        raw = getattr(self.evaluator, "raw", None)
        n_measured = getattr(raw, "n_measured", None)
        if n_measured is None:
            n_measured = outcome.n_experiments
        return TuneResult(
            strategy=name.upper(),
            best_config=dict(outcome.best_config),
            best_energy_search=float(outcome.best_score),
            best_energy_measured=best_measured,
            n_experiments=outcome.n_experiments,
            n_predictions=outcome.n_predictions,
            n_training_experiments=(self.n_training_experiments
                                    if info.uses_surrogate else 0),
            space_size=self.space.size(),
            checkpoints=measured_cp,
            objective=self.objective.key,
            best_metrics=best_metrics,
            pareto_front=outcome.pareto_front,
            n_measured=int(n_measured),
        )
