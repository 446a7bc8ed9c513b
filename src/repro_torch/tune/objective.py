"""Declarative, composable tuning objectives.

The paper minimises one scalar — E = max(T_host, T_device) (Eq. 2).  The
follow-up work (Memeti & Pllana, arXiv:2106.01441) extends the identical
search framework to energy-aware multi-objective tuning; this module is
that decoupling: an :class:`Objective` maps a **metrics record** (one
measured/simulated row, e.g. ``{"time": 1.84, "energy": 512.0}``) to the
scalar score the search minimises, and combinators build compound
objectives out of atomic ones.

  * :class:`Time`    — ``metrics["time"]``; the paper's objective.
  * :class:`Energy`  — ``metrics["energy"]`` (joules); the evaluator
    provides the column.
  * :class:`Weighted` — normalised weighted sum of sub-objectives.
  * :class:`Pareto`  — Chebyshev scalarisation (max of normalised
    components) for the search loop, plus non-dominated-front extraction
    for enumerating strategies.

Objectives score *measurements* generically; scoring a **surrogate**
requires the objective to know how predictions compose (the paper's
``SurrogatePair`` predicts per-side times, so only time-like objectives
have a surrogate form).  ``Time`` implements the surrogate hooks; other
objectives raise with a pointer at the measurement-based strategies.

``MetricsEvaluator`` is the evaluator half of the contract: it adapts
whatever the caller has — a scalar oracle, a metrics-dict oracle, a
batched column oracle — into the uniform interface the strategies
consume.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np

__all__ = ["Objective", "Time", "Energy", "Metric", "Weighted", "Pareto",
           "MetricsEvaluator", "as_metrics_evaluator", "pareto_front"]


class Objective:
    """Maps one metrics record to the scalar score being minimised."""

    #: cache-key / display name; folded into ``TuningStore`` keys so
    #: differently-scored searches never collide.
    key: str = "objective"
    #: metric columns this objective reads.
    requires: tuple[str, ...] = ()

    def __call__(self, metrics: Mapping[str, float]) -> float:
        raise NotImplementedError

    def batch(self, metrics: Mapping[str, np.ndarray]) -> np.ndarray:
        """Vectorised score over column-oriented metric arrays.

        The default lifts ``__call__`` over rows; atomic objectives
        override with pure array ops.
        """
        names = list(metrics)
        rows = zip(*(np.asarray(metrics[n]) for n in names))
        return np.asarray([self(dict(zip(names, r))) for r in rows])

    def components(self) -> tuple["Objective", ...]:
        """Atomic sub-objectives (self for atomic objectives)."""
        return (self,)

    # -- surrogate forms ----------------------------------------------------
    def _no_surrogate(self) -> "NotImplementedError":
        return NotImplementedError(
            f"objective {self.key!r} has no surrogate form; use a "
            "measurement-based strategy (em / sam / random / hillclimb) or "
            "an objective that can score predictions (Time)")

    def surrogate_scalar(self, pair) -> Callable[[Mapping[str, Any]], float]:
        """cfg -> predicted score, from a ``SurrogatePair``."""
        raise self._no_surrogate()

    def surrogate_batch(self, pair) -> Callable[[Mapping[str, np.ndarray]],
                                                np.ndarray]:
        """column batch -> predicted scores, from a ``SurrogatePair``."""
        raise self._no_surrogate()

    def surrogate_torch_builder(self, pair):
        """(space, device) -> batched feature-matrix score fn (vectorized SA)."""
        raise self._no_surrogate()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.key!r})"


class Metric(Objective):
    """Minimise one named metric column verbatim."""

    def __init__(self, name: str):
        self.key = name
        self.requires = (name,)
        self._name = name

    def __call__(self, metrics: Mapping[str, float]) -> float:
        return float(metrics[self._name])

    def batch(self, metrics: Mapping[str, np.ndarray]) -> np.ndarray:
        return np.asarray(metrics[self._name], dtype=np.float64)


class Time(Metric):
    """The paper's objective: execution time E = max(T_host, T_device)."""

    def __init__(self):
        super().__init__("time")

    # The SurrogatePair predicts per-side times, so Time is exactly the
    # pair's own energy composition — these delegate to the proven paths.
    def surrogate_scalar(self, pair):
        return pair.predict_energy

    def surrogate_batch(self, pair):
        return pair.predict_energy_batch

    def surrogate_torch_builder(self, pair):
        if pair.energy_fn_torch_builder is None:
            raise ValueError(
                "vectorized search needs a surrogate with an "
                "energy_fn_torch_builder")
        return pair.energy_fn_torch_builder


class Energy(Metric):
    """Energy-to-solution in joules (``metrics['energy']``)."""

    def __init__(self):
        super().__init__("energy")


def _as_pairs(objectives, weights) -> list[tuple[Objective, float]]:
    objectives = tuple(objectives)
    if weights is None:
        weights = (1.0,) * len(objectives)
    if len(weights) != len(objectives):
        raise ValueError("need one weight per objective")
    return [(o, float(w)) for o, w in zip(objectives, weights)]


class Weighted(Objective):
    """Weighted sum of sub-objectives: ``sum(w_i * o_i(m) / scale_i)``.

    ``scales`` normalises components with different units (seconds vs
    joules) onto comparable magnitudes; defaults to 1.0 each.

        Weighted(Time(), Energy(), weights=(1.0, 0.5), scales=(1.0, 300.0))
    """

    def __init__(self, *objectives: Objective,
                 weights: Sequence[float] | None = None,
                 scales: Sequence[float] | None = None):
        if not objectives:
            raise ValueError("Weighted needs at least one objective")
        self._parts = _as_pairs(objectives, weights)
        scales = scales if scales is not None else (1.0,) * len(objectives)
        if len(scales) != len(objectives):
            raise ValueError("need one scale per objective")
        self._scales = [float(s) for s in scales]
        if any(s <= 0 for s in self._scales):
            raise ValueError("scales must be positive")
        self.requires = tuple(dict.fromkeys(
            k for o, _ in self._parts for k in o.requires))
        self.key = "weighted(" + ",".join(
            f"{o.key}*{w:g}" for o, w in self._parts) + ")"

    def components(self) -> tuple[Objective, ...]:
        return tuple(o for o, _ in self._parts)

    def __call__(self, metrics: Mapping[str, float]) -> float:
        return float(sum(w * o(metrics) / s for (o, w), s in
                         zip(self._parts, self._scales)))

    def batch(self, metrics: Mapping[str, np.ndarray]) -> np.ndarray:
        out = 0.0
        for (o, w), s in zip(self._parts, self._scales):
            out = out + (w / s) * o.batch(metrics)
        return np.asarray(out, dtype=np.float64)


class Pareto(Objective):
    """Multi-objective front.  Searches minimise the Chebyshev
    scalarisation ``max_i(w_i * o_i(m) / scale_i)``; enumerating
    strategies (em / eml batched) additionally report the non-dominated
    set of the whole space in ``TuneResult.pareto_front``.
    """

    def __init__(self, *objectives: Objective,
                 weights: Sequence[float] | None = None,
                 scales: Sequence[float] | None = None):
        if len(objectives) < 2:
            raise ValueError("Pareto needs at least two objectives")
        self._parts = _as_pairs(objectives, weights)
        scales = scales if scales is not None else (1.0,) * len(objectives)
        self._scales = [float(s) for s in scales]
        if any(s <= 0 for s in self._scales):
            raise ValueError("scales must be positive")
        self.requires = tuple(dict.fromkeys(
            k for o, _ in self._parts for k in o.requires))
        self.key = "pareto(" + ",".join(o.key for o, _ in self._parts) + ")"

    def components(self) -> tuple[Objective, ...]:
        return tuple(o for o, _ in self._parts)

    def __call__(self, metrics: Mapping[str, float]) -> float:
        return float(max(w * o(metrics) / s for (o, w), s in
                         zip(self._parts, self._scales)))

    def batch(self, metrics: Mapping[str, np.ndarray]) -> np.ndarray:
        cols = [(w / s) * o.batch(metrics) for (o, w), s in
                zip(self._parts, self._scales)]
        return np.max(np.stack(cols), axis=0)

    def component_batch(self, metrics: Mapping[str, np.ndarray]
                        ) -> np.ndarray:
        """Raw (unweighted) component columns, shape (n, n_objectives)."""
        return np.stack([o.batch(metrics) for o, _ in self._parts], axis=1)


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of ``points`` (minimisation).

    A row dominates another when it is <= everywhere and < somewhere.
    O(n^2) pairwise filter — fronts here come from enumerated spaces of
    at most a few tens of thousands of rows.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        dominated = (np.all(pts[i] <= pts, axis=1)
                     & np.any(pts[i] < pts, axis=1))
        dominated[i] = False
        keep &= ~dominated
    return np.flatnonzero(keep)


# ---------------------------------------------------------------------------
# The evaluator half: anything -> metrics records.
# ---------------------------------------------------------------------------

class MetricsEvaluator:
    """Adapts a measurement oracle to the metrics-record interface.

    ``scalar`` maps one config to either a plain float (interpreted as
    ``{"time": value}`` — the seed's oracle shape) or a metrics mapping.
    ``batch`` (optional) maps column-oriented config batches to either a
    score array or a mapping of metric columns.
    """

    def __init__(self, scalar: Callable[[Mapping[str, Any]], Any],
                 batch: Callable[[Mapping[str, np.ndarray]], Any] | None
                 = None):
        self._scalar = scalar
        self._batch = batch

    @property
    def has_batch(self) -> bool:
        return self._batch is not None

    @property
    def raw(self):
        """The underlying scalar oracle (e.g. a ``KernelTimer``), so the
        session can read accounting it keeps — ``n_measured`` is the
        deduplicated real-execution count behind the ~5% budget."""
        return self._scalar

    def metrics(self, cfg: Mapping[str, Any]) -> dict[str, float]:
        out = self._scalar(cfg)
        if isinstance(out, Mapping):
            return {str(k): float(v) for k, v in out.items()}
        return {"time": float(out)}

    def metrics_batch(self, columns: Mapping[str, np.ndarray]
                      ) -> dict[str, np.ndarray]:
        if self._batch is None:
            raise ValueError("evaluator has no batch oracle")
        out = self._batch(columns)
        if isinstance(out, Mapping):
            return {str(k): np.asarray(v, dtype=np.float64)
                    for k, v in out.items()}
        return {"time": np.asarray(out, dtype=np.float64)}


def as_metrics_evaluator(obj: Any,
                         batch: Any = None) -> MetricsEvaluator | None:
    """Coerce ``obj`` into a :class:`MetricsEvaluator` (None passes through)."""
    if obj is None and batch is None:
        return None
    if isinstance(obj, MetricsEvaluator):
        return obj
    if obj is None:
        raise ValueError("evaluator_batch given without a scalar evaluator")
    if not callable(obj):
        raise TypeError(f"evaluator must be callable, got {type(obj).__name__}")
    return MetricsEvaluator(obj, batch)
