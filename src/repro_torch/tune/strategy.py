"""Pluggable search-strategy registry.

Every way of searching a ``ConfigSpace`` is one registered function with
the uniform signature ``fn(ctx: SearchContext, **opts) -> StrategyOutcome``.
The paper's four methods (``em``, ``eml``, ``sam``, ``saml``) keep the
reference's oracles, numpy RNG streams and effort accounting, so a scalar
``TuningSession`` run gives the reference's result on a fixed seed (the
vectorized ``saml`` engine draws from a ``torch.Generator`` and agrees by
outcome only).  ``random`` and ``hillclimb`` are implemented purely against
the new interface; a new search method is one decorated function:

    from repro_torch.tune import register_strategy, StrategyOutcome

    @register_strategy("greedy2", description="two random restarts")
    def greedy2(ctx, *, seed=0, **_):
        ...
        return StrategyOutcome(best_cfg, best_score, n_experiments=n)

and is then discoverable via ``list_strategies()`` and runnable through
``TuningSession(...).run("greedy2")``.

``SearchContext`` is the decoupled (objective x evaluator x surrogate)
bundle the session prepares: ``measure``/``measure_batch`` score real
measurements under the session's objective, ``predict``/``predict_batch``
score surrogate predictions, and ``predict_torch_builder`` powers the
vectorized SA engine.  A strategy uses whichever oracles it needs and
reports its effort through the outcome counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from ..core.evaluators import MeasurementEvaluator
from ..core.sa import SASchedule, simulated_annealing, vectorized_sa
from ..core.space import ConfigSpace

__all__ = ["SearchContext", "StrategyOutcome", "StrategyInfo",
           "register_strategy", "get_strategy", "list_strategies"]


@dataclass
class SearchContext:
    """Everything a strategy may consume, pre-composed by the session."""

    space: ConfigSpace
    # objective-scored oracles; None when the session lacks that capability
    measure: Callable[[Mapping[str, Any]], float] | None = None
    measure_batch: Callable[[Mapping[str, np.ndarray]], np.ndarray] | \
        None = None
    predict: Callable[[Mapping[str, Any]], float] | None = None
    predict_batch: Callable[[Mapping[str, np.ndarray]], np.ndarray] | \
        None = None
    # (space, device) -> batched (n, feature_dim) -> (n,) score fn
    predict_torch_builder: Callable[[ConfigSpace], Callable] | None = None
    # component metric columns for a column batch (Pareto front extraction)
    metrics_batch: Callable[[Mapping[str, np.ndarray]],
                            dict[str, np.ndarray]] | None = None
    objective: Any = None
    # initial configuration for local-search strategies
    warm_start: dict | None = None
    # default evaluation budget (iterations / samples) when the caller
    # does not pass one explicitly
    budget: int | None = None

    def require_measure(self, name: str):
        if self.measure is None:
            raise ValueError(f"strategy {name!r} needs a measurement "
                             "evaluator (pass evaluator= to the session)")
        return self.measure

    def require_predict(self, name: str):
        if self.predict is None:
            raise ValueError(f"strategy {name!r} needs a trained surrogate "
                             "(pass surrogate= to the session)")
        return self.predict


@dataclass
class StrategyOutcome:
    """What a strategy returns; the session turns it into a TuneResult."""

    best_config: dict
    best_score: float
    n_experiments: int = 0
    n_predictions: int = 0
    # {iteration: (search score of best-so-far, config)} — the session
    # re-scores checkpoints with ground truth, like the paper (Sec. IV-C)
    checkpoints: dict[int, tuple[float, dict]] = field(default_factory=dict)
    # [[component scores...], config] rows (enumerating Pareto runs)
    pareto_front: list = field(default_factory=list)


@dataclass(frozen=True)
class StrategyInfo:
    name: str
    fn: Callable[..., StrategyOutcome]
    uses_surrogate: bool
    description: str


_REGISTRY: dict[str, StrategyInfo] = {}


def register_strategy(name: str, *, uses_surrogate: bool = False,
                      description: str = ""):
    """Decorator: add ``fn(ctx, **opts) -> StrategyOutcome`` to the registry.

    ``uses_surrogate`` marks strategies whose effort accounting should
    charge the one-time surrogate training experiments (the paper charges
    them to EML/SAML, not to the measurement-only methods).
    """
    key = name.lower()

    def deco(fn):
        doc = (fn.__doc__ or "").strip()
        desc = description or (doc.splitlines()[0] if doc else "")
        _REGISTRY[key] = StrategyInfo(key, fn, uses_surrogate, desc)
        return fn
    return deco


def get_strategy(name: str) -> StrategyInfo:
    info = _REGISTRY.get(name.lower())
    if info is None:
        raise ValueError(f"unknown strategy {name!r}; registered: "
                         f"{', '.join(list_strategies())}")
    return info


def list_strategies() -> list[str]:
    """Sorted names of every registered strategy."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Counting wrappers (prediction-side analogue of MeasurementEvaluator).
# ---------------------------------------------------------------------------

class _PredictCounter:
    """Counts surrogate queries one-per-config, like LearnedEvaluator."""

    def __init__(self, fn):
        self._fn = fn
        self.n_predictions = 0

    def __call__(self, cfg):
        self.n_predictions += 1
        return float(self._fn(cfg))


class _BatchPredictCounter:
    def __init__(self, fn):
        self._fn = fn
        self.n_predictions = 0

    def __call__(self, columns):
        out = np.asarray(self._fn(columns))
        self.n_predictions += len(out)
        return out


def _front_from_metrics(ctx: SearchContext, metrics, grid) -> list:
    """Non-dominated rows of an enumerated space under a Pareto objective."""
    from .objective import pareto_front
    comps = ctx.objective.component_batch(metrics)
    idx = pareto_front(comps)
    return [[[float(v) for v in comps[i]],
             ctx.space.from_indices(grid[i])] for i in idx]


# ---------------------------------------------------------------------------
# The paper's four strategies.
# ---------------------------------------------------------------------------

@register_strategy("em", description="enumeration + measurements "
                   "(optimal, very high effort)")
def _em(ctx: SearchContext, *, engine: str = "auto", **_) -> StrategyOutcome:
    space = ctx.space
    if engine == "auto":
        engine = "batched" if ctx.measure_batch is not None else "scalar"
    if engine == "batched":
        if ctx.measure_batch is None:
            raise ValueError("batched EM needs a batch evaluator "
                             "(measure_batch= / evaluator_batch=)")
        grid = space.index_grid()
        columns = space.enumerate_columns(grid)
        front: list = []
        if (ctx.metrics_batch is not None
                and hasattr(ctx.objective, "component_batch")):
            # Pareto: ONE full-space measurement pass feeds both the
            # scalarised scores and the front — re-running the oracle
            # would double-spend experiments and desync noise draws
            metrics = ctx.metrics_batch(columns)
            scores = np.asarray(ctx.objective.batch(metrics))
            front = _front_from_metrics(ctx, metrics, grid)
        else:
            scores = np.asarray(ctx.measure_batch(columns))
        k = int(np.argmin(scores))        # first minimum, like the loop
        best_cfg = space.from_indices(grid[k])
        # enumeration visits each distinct config exactly once, so the
        # deduplicated experiment count equals the space size
        return StrategyOutcome(
            best_cfg, float(scores[k]), n_experiments=space.size(),
            pareto_front=front)
    if engine != "scalar":
        raise ValueError(f"unknown EM engine {engine!r}")
    ev = MeasurementEvaluator(ctx.require_measure("em"), space)
    best_cfg, best_e = None, float("inf")
    for cfg in space.enumerate():
        e = ev(cfg)
        if e < best_e:
            best_cfg, best_e = cfg, e
    return StrategyOutcome(best_cfg, best_e, n_experiments=ev.n_experiments)


@register_strategy("eml", uses_surrogate=True,
                   description="enumeration + machine learning "
                   "(near-optimal, high effort)")
def _eml(ctx: SearchContext, *, engine: str = "batched",
         **_) -> StrategyOutcome:
    space = ctx.space
    if engine == "batched":
        if ctx.predict_batch is None:
            ctx.require_predict("eml")    # raises the canonical message
            raise ValueError("batched EML needs a batch-capable surrogate")
        ev = _BatchPredictCounter(ctx.predict_batch)
        grid = space.index_grid()
        scores = np.asarray(ev(space.enumerate_columns(grid)))
        k = int(np.argmin(scores))        # first minimum, like the loop
        return StrategyOutcome(space.from_indices(grid[k]), float(scores[k]),
                               n_predictions=ev.n_predictions)
    if engine != "scalar":
        raise ValueError(f"unknown EML engine {engine!r}")
    ev = _PredictCounter(ctx.require_predict("eml"))
    best_cfg, best_e = None, float("inf")
    for cfg in space.enumerate():
        e = ev(cfg)
        if e < best_e:
            best_cfg, best_e = cfg, e
    return StrategyOutcome(best_cfg, best_e, n_predictions=ev.n_predictions)


@register_strategy("sam", description="simulated annealing + measurements "
                   "(near-optimal, medium effort)")
def _sam(ctx: SearchContext, *, iterations: int | None = None, seed: int = 0,
         checkpoints: Sequence[int] = (), **_) -> StrategyOutcome:
    iterations = iterations if iterations is not None else ctx.budget or 1000
    ev = MeasurementEvaluator(ctx.require_measure("sam"), ctx.space)
    res = simulated_annealing(
        ctx.space, ev, seed=seed, initial=ctx.warm_start,
        schedule=SASchedule.for_iterations(iterations),
        max_iterations=iterations, checkpoint_at=checkpoints,
    )
    return StrategyOutcome(res.best_config, res.best_energy,
                           n_experiments=ev.n_experiments,
                           checkpoints=res.checkpoints)


@register_strategy("saml", uses_surrogate=True,
                   description="simulated annealing + machine learning "
                   "— the paper's headline method")
def _saml(ctx: SearchContext, *, iterations: int | None = None, seed: int = 0,
          checkpoints: Sequence[int] = (), engine: str = "scalar",
          n_chains: int = 32, device=None, **_) -> StrategyOutcome:
    iterations = iterations if iterations is not None else ctx.budget or 1000
    if engine == "vectorized":
        if ctx.predict_torch_builder is None:
            raise ValueError(
                "vectorized SAML needs a surrogate with an "
                "energy_fn_torch_builder")
        energy_fn = ctx.predict_torch_builder(ctx.space, device)
        res = vectorized_sa(
            ctx.space, energy_fn, n_chains=n_chains,
            n_iterations=iterations,
            schedule=SASchedule.for_iterations(iterations),
            seed=seed, checkpoint_at=checkpoints, device=device,
        )
        # every chain step is one surrogate query — same accounting unit
        # as the scalar engine (predictions, not experiments)
        return StrategyOutcome(res.best_config, res.best_energy,
                               n_predictions=res.n_evaluations,
                               checkpoints=res.checkpoints)
    if engine != "scalar":
        raise ValueError(f"unknown SAML engine {engine!r}")
    ev = _PredictCounter(ctx.require_predict("saml"))
    res = simulated_annealing(
        ctx.space, ev, seed=seed, initial=ctx.warm_start,
        schedule=SASchedule.for_iterations(iterations),
        max_iterations=iterations, checkpoint_at=checkpoints,
    )
    return StrategyOutcome(res.best_config, res.best_energy,
                           n_predictions=ev.n_predictions,
                           checkpoints=res.checkpoints)


# ---------------------------------------------------------------------------
# New strategies, written purely against the SearchContext interface.
# ---------------------------------------------------------------------------

def _search_oracle(ctx: SearchContext, name: str):
    """(score_fn, counts_as_experiments) — prefer real measurements, fall
    back to the surrogate so these strategies also work surrogate-only."""
    if ctx.measure is not None:
        return MeasurementEvaluator(ctx.measure, ctx.space), True
    if ctx.predict is not None:
        return _PredictCounter(ctx.predict), False
    raise ValueError(f"strategy {name!r} needs an evaluator or a surrogate")


def _counts(ev, measured: bool) -> dict:
    n = ev.n_experiments if measured else ev.n_predictions
    return {"n_experiments": n if measured else 0,
            "n_predictions": 0 if measured else n}


@register_strategy("random", description="uniform random sampling "
                   "(baseline; budgeted)")
def _random(ctx: SearchContext, *, samples: int | None = None,
            iterations: int | None = None, seed: int = 0,
            checkpoints: Sequence[int] = (), **_) -> StrategyOutcome:
    """Sample ``samples`` uniform configs, keep the best.

    A ``warm_start`` (when the session provides one) is evaluated as the
    first sample, so the search result is never worse than the caller's
    known-good configuration — and never ``None`` even if every random
    draw scores ``inf`` (e.g. invalid kernel launch configs).
    """
    n = samples or iterations or ctx.budget or 100
    ev, measured = _search_oracle(ctx, "random")
    rng = np.random.default_rng(seed)
    cps: dict[int, tuple[float, dict]] = {}
    checkpoint_set = set(int(c) for c in checkpoints)
    best, best_e = None, float("inf")
    for it in range(1, n + 1):
        if it == 1 and ctx.warm_start is not None:
            cfg = dict(ctx.warm_start)
        else:
            cfg = ctx.space.random(rng)
        e = ev(cfg)
        if best is None or e < best_e:
            best, best_e = dict(cfg), e
        if it in checkpoint_set:
            cps[it] = (best_e, dict(best))
    return StrategyOutcome(best, best_e, checkpoints=cps,
                           **_counts(ev, measured))


@register_strategy("hillclimb", description="greedy local search with "
                   "random restarts (budgeted)")
def _hillclimb(ctx: SearchContext, *, iterations: int | None = None,
               seed: int = 0, checkpoints: Sequence[int] = (),
               patience: int = 12, **_) -> StrategyOutcome:
    """First-improvement hill climbing over ``space.neighbor`` moves;
    after ``patience`` consecutive non-improving proposals the walk
    restarts from a fresh random configuration (budget permitting)."""
    n = iterations if iterations is not None else ctx.budget or 200
    ev, measured = _search_oracle(ctx, "hillclimb")
    rng = np.random.default_rng(seed)
    cps: dict[int, tuple[float, dict]] = {}
    checkpoint_set = set(int(c) for c in checkpoints)

    cur = dict(ctx.warm_start) if ctx.warm_start else ctx.space.random(rng)
    ctx.space.validate(cur)
    cur_e = ev(cur)
    best, best_e = dict(cur), cur_e
    stuck = 0
    for it in range(1, n + 1):
        restart = stuck >= patience
        cand = ctx.space.random(rng) if restart \
            else ctx.space.neighbor(cur, rng)
        e = ev(cand)
        if restart or e < cur_e:
            # a restart moves the walk to the fresh point even when it
            # scores worse — descending from the new basin is the point;
            # the global best below is unaffected
            cur, cur_e = dict(cand), e
            stuck = 0
        else:
            stuck += 1
        if e < best_e:
            best, best_e = dict(cand), e
        if it in checkpoint_set:
            cps[it] = (best_e, dict(best))
    return StrategyOutcome(best, best_e, checkpoints=cps,
                           **_counts(ev, measured))
