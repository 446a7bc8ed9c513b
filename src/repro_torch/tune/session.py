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
  * ``observer`` (a ``repro_torch.obs.Observer``) journals each run
    (``tuning_start``, ``store_hit``/``store_miss``, ``tuning_stop`` with
    the measurement accounting), counts store hits and misses, and
    traces the strategy's search as a ``tune.<strategy>`` span.
  * ``online`` hooks an ``OnlineSurrogateLoop``: pending live
    observations are folded in (``refit``) before the search, and every
    measurement taken during the search whose metrics carry per-side
    times (``t_host`` / ``t_device``) is observed back into the loop.
  * ``ledger`` hooks a
    :class:`~repro_torch.runtime.checkpoint.MeasurementLedger`: every
    real measurement is appended to its write-ahead log before the
    search proceeds, so a crash mid-tune loses nothing — rerunning the
    same seeded session replays the measured prefix from the ledger
    (zero re-measurement) and only spends budget on the tail.
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
        self.space = space
        self.device = device
        self.ledger = ledger
        if ledger is not None and evaluator is not None:
            # Wrap the raw scalar/metrics oracle before MetricsEvaluator
            # normalization so ledger hits and misses share one shape.
            evaluator = ledger.wrap(evaluator)
        self.evaluator = as_metrics_evaluator(evaluator, evaluator_batch)
        self.objective = objective if objective is not None else Time()
        self.strategy = strategy
        self.online = online
        if surrogate is None and online is not None:
            surrogate = online.surrogate
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
        from ..obs import as_observer
        self._obs = as_observer(observer)

    @staticmethod
    def _as_store(store, device=None):
        if store is None or hasattr(store, "lookup"):
            return store
        # deferred import: tune must stay importable without runtime
        from ..runtime.store import TuningStore
        return TuningStore(store, device=device)

    # -- oracle composition --------------------------------------------------
    def _measure(self) -> Callable | None:
        """cfg -> objective score of one real measurement (+ online feed)."""
        ev = self.evaluator
        if ev is None:
            return None
        objective, online = self.objective, self.online

        def scored(cfg):
            m = ev.metrics(cfg)
            if online is not None:
                th, td = m.get("t_host"), m.get("t_device")
                if th is not None or td is not None:
                    # a zero per-side time is the E = max(...) collapse
                    # (that side did no work), not a measurement
                    online.observe(cfg, th or None, td or None,
                                   auto_refit=False)
            return float(objective(m))
        return scored

    def _observe_batch(self, columns, metrics) -> None:
        """Feed a column batch of measurements into the online loop."""
        th = metrics.get("t_host")
        td = metrics.get("t_device")
        if th is None and td is None:
            return
        names = list(columns)
        n = len(next(iter(metrics.values())))
        for i in range(n):
            cfg = {k: columns[k][i] for k in names}
            h = float(th[i]) if th is not None else 0.0
            d = float(td[i]) if td is not None else 0.0
            # a zero per-side time is the E = max(...) collapse
            self.online.observe(cfg, h or None, d or None, auto_refit=False)

    def _metrics_batch(self) -> Callable | None:
        """Column batch -> metric columns, observing into the online loop."""
        ev = self.evaluator
        if ev is None or not ev.has_batch:
            return None
        if self.online is None:
            return ev.metrics_batch

        def observed(columns):
            m = ev.metrics_batch(columns)
            self._observe_batch(columns, m)
            return m
        return observed

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
        if self._obs is not None:
            self._obs.journal.event("tuning_start", strategy=name,
                                    objective=self.objective.key,
                                    space_size=self.space.size())
        if self.store is not None:
            hit = self.store.lookup(self.space, self.workload,
                                    self._store_key(name))
            if self._obs is not None:
                self._obs.metrics.counter(
                    "tune.store_hits" if hit is not None
                    else "tune.store_misses").inc()
                self._obs.journal.event(
                    "store_hit" if hit is not None else "store_miss",
                    strategy=name, key=self._store_key(name))
            if hit is not None:
                if self._obs is not None:
                    self._obs.journal.event(
                        "tuning_stop", strategy=name, from_cache=True,
                        n_experiments=hit.n_experiments,
                        n_measured=hit.n_measured,
                        space_size=hit.space_size)
                return hit
        if self.online is not None:
            # fold pending live observations into the surrogate first, so
            # the search starts from live data (respects refit_every)
            self.online.refit()
        if self.seed is not None:
            opts.setdefault("seed", self.seed)
        if self.device is not None:
            opts.setdefault("device", self.device)
        if self._obs is not None:
            with self._obs.tracer.span(f"tune.{name}",
                                       args={"objective":
                                             self.objective.key}):
                outcome = info.fn(self._context(), **opts)
        else:
            outcome = info.fn(self._context(), **opts)
        result = self._finalize(name, info, outcome)
        if self.store is not None:
            self.store.record(self.space, self.workload,
                              self._store_key(name), result)
        if self._obs is not None:
            # the paper's effort accounting in one event: how many real
            # measurements bought the winner, out of how large a space
            self._obs.journal.event(
                "tuning_stop", strategy=name, from_cache=False,
                n_experiments=result.n_experiments,
                n_predictions=result.n_predictions,
                n_measured=result.n_measured,
                space_size=result.space_size,
                experiments_fraction=round(result.experiments_fraction, 6),
                best_score=round(result.best_energy_measured, 9))
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
