"""Evaluation oracles for proposed system configurations.

The paper distinguishes evaluating a configuration by *measurement*
(running the experiment) from evaluating it by *machine learning*
(predicting with the trained BDTR model).  Both are exposed behind the
same callable interface so every search strategy (enumeration / SA) can be
paired with either oracle — giving the paper's four methods EM, EML, SAM,
SAML (Table II).

``MeasurementEvaluator`` counts *experiments* (deduplicated — re-measuring
an identical configuration is free in the paper's accounting since results
are recorded); ``LearnedEvaluator`` counts predictions, which are
effectively free.  The counters feed the effort comparison in
EXPERIMENTS.md (Result 3: SAML needs ~5 % of EM's experiments).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np

from .bdtr import BoostedTreesRegressor
from .space import ConfigSpace

__all__ = ["MeasurementEvaluator", "LearnedEvaluator",
           "BatchedLearnedEvaluator", "SurrogatePair"]


class MeasurementEvaluator:
    """Wraps a measurement function; counts distinct experiments."""

    def __init__(self, fn: Callable[[Mapping[str, Any]], float],
                 space: ConfigSpace, dedup: bool = True):
        self._fn = fn
        self._space = space
        self._dedup = dedup
        self._cache: dict[tuple, float] = {}
        self.n_experiments = 0

    def _key(self, cfg: Mapping[str, Any]) -> tuple:
        return tuple(cfg[n] for n in self._space.names)

    def __call__(self, cfg: Mapping[str, Any]) -> float:
        key = self._key(cfg)
        if self._dedup and key in self._cache:
            return self._cache[key]
        val = float(self._fn(cfg))
        self.n_experiments += 1
        if self._dedup:
            self._cache[key] = val
        return val


@dataclass
class SurrogatePair:
    """Host + device execution-time models (the paper trains per side).

    The combined objective is E(cfg) = max(T_host_hat, T_device_hat)
    (paper Eq. 2 evaluated on predictions).
    """

    host: BoostedTreesRegressor
    device: BoostedTreesRegressor
    host_features: Callable[[Mapping[str, Any]], np.ndarray]
    device_features: Callable[[Mapping[str, Any]], np.ndarray]
    # Optional batched feature builders: map column-oriented config batches
    # ({param_name: (n,) value array}) to model feature matrices (n, d).
    # When absent, the batched paths fall back to stacking the scalar
    # builders (still one model ``predict`` per sweep instead of n).
    host_features_cols: Callable[[Mapping[str, np.ndarray]], np.ndarray] | \
        None = None
    device_features_cols: Callable[[Mapping[str, np.ndarray]], np.ndarray] | \
        None = None
    # Optional builder of a batched PyTorch energy function over a space's
    # *encoded* feature matrix: energy_fn_torch_builder(space, device) -> f((n, F))
    # -> (n,) predicted E = max(T_host, T_device).  Powers the vectorized
    # SA engine (see sa.vectorized_sa and the ``saml`` strategy).
    energy_fn_torch_builder: Callable[..., Callable] | None = None

    def predict_energy(self, cfg: Mapping[str, Any]) -> float:
        f = float(cfg["host_fraction"])
        th = self.host.predict(self.host_features(cfg)[None, :])[0] if f > 0 else 0.0
        td = (self.device.predict(self.device_features(cfg)[None, :])[0]
              if f < 100 else 0.0)
        return float(max(th, td))

    def _feature_matrices(self, columns: Mapping[str, np.ndarray]
                          ) -> tuple[np.ndarray, np.ndarray]:
        if self.host_features_cols is not None and \
                self.device_features_cols is not None:
            return (np.asarray(self.host_features_cols(columns)),
                    np.asarray(self.device_features_cols(columns)))
        # fallback: per-row dicts through the scalar builders (model
        # prediction — the expensive part — stays batched)
        names = list(columns)
        rows = zip(*(np.asarray(columns[n]) for n in names))
        cfgs = [dict(zip(names, r)) for r in rows]
        return (np.stack([self.host_features(c) for c in cfgs]),
                np.stack([self.device_features(c) for c in cfgs]))

    def predict_energy_batch(self, columns: Mapping[str, np.ndarray]
                             ) -> np.ndarray:
        """Vectorized ``predict_energy`` over a column-oriented batch.

        Two ensemble ``predict`` calls total; the host-only/device-only
        collapse (T=0 when the side receives no work) is an array op, so
        results match the scalar path exactly.
        """
        f = np.asarray(columns["host_fraction"], dtype=np.float64)
        Xh, Xd = self._feature_matrices(columns)
        th = np.where(f > 0, self.host.predict(Xh), 0.0)
        td = np.where(f < 100, self.device.predict(Xd), 0.0)
        return np.maximum(th, td)


class LearnedEvaluator:
    """ML oracle: predicts E(cfg); counts predictions (not experiments)."""

    def __init__(self, surrogate: SurrogatePair):
        self._surrogate = surrogate
        self.n_predictions = 0

    def __call__(self, cfg: Mapping[str, Any]) -> float:
        self.n_predictions += 1
        return self._surrogate.predict_energy(cfg)


class BatchedLearnedEvaluator:
    """Batched ML oracle: scores whole config batches per call.

    Same prediction accounting as ``LearnedEvaluator`` (one count per
    config scored) so the paper's effort comparison is unchanged; the
    difference is purely mechanical — a sweep over ``space.size()``
    configs is a handful of numpy ``predict`` calls instead of
    ``space.size()`` Python calls.
    """

    def __init__(self, surrogate: SurrogatePair):
        self._surrogate = surrogate
        self.n_predictions = 0

    def __call__(self, columns: Mapping[str, np.ndarray]) -> np.ndarray:
        n = len(np.asarray(next(iter(columns.values()))))
        self.n_predictions += n
        return self._surrogate.predict_energy_batch(columns)
