"""Online surrogate feedback: warm-refit the BDTR pair from live data.

The offline pipeline (``core.autotuner.fit_emil_surrogates``) trains the
per-side ``BoostedTreesRegressor`` pair once, on a synthetic grid.  In a
live system the measured (config, time) pairs keep arriving — from the
chunked scheduler, from serving sessions, from the autotuner's own
search — and the platform drifts (thermal throttling, contention, a
degraded group).  ``OnlineSurrogateLoop`` closes the loop:

  * ``observe(cfg, t_host, t_device)`` appends one live observation per
    side (features via the pair's own feature builders);
  * every ``refit_every`` observations (or on ``refit(force=True)``)
    both models are **warm-refit**: ``BoostedTreesRegressor.fit_more``
    appends trees that chase the residuals on the live data, reusing the
    ``tree_method="hist"`` binning — the quantile pass runs once, and
    every later batch of rows is a ``searchsorted`` against frozen edges
    (``bdtr.append_rows``).

The refit mutates the pair's models **in place**, so any search holding
the ``SurrogatePair`` picks up the refreshed surrogate on its next
``saml``/``eml`` run (both the scalar and the vectorized engines rebuild
their prediction functions per call; ``fit_more`` drops the packed
tensors ``predict_fn_torch`` walks) — i.e. the search restarts from
live data instead of the offline grid.  Observations can be
persisted/restored through a ``TuningStore`` NPZ side-car
(``save_to``/``load_from``).

The unified facade integration (``repro_torch.tune``): pass the loop as the
``online=`` of a ``TuningSession`` — or call :meth:`session` — and the
session (a) folds pending observations into the surrogate before every
search and (b) feeds each measurement whose metrics carry per-side times
(``t_host``/``t_device``) back into the loop, closing search -> measure
-> refit -> search in one object graph.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..core.bdtr import BinnedFeatures, append_rows, bin_features
from ..core.evaluators import SurrogatePair
from ..obs import as_observer

__all__ = ["OnlineSurrogateLoop"]


class _SideState:
    """Observation buffer + incremental binning for one model side."""

    def __init__(self, model):
        self.model = model
        self.X: list[np.ndarray] = []
        self.y: list[float] = []
        self.n_fitted = 0                      # rows already binned
        self.binned: BinnedFeatures | None = None

    def append(self, x: np.ndarray, t: float) -> None:
        self.X.append(np.asarray(x, dtype=np.float64))
        self.y.append(float(t))

    def matrix(self) -> tuple[np.ndarray, np.ndarray]:
        return np.stack(self.X), np.asarray(self.y, dtype=np.float64)

    def refit(self, n_new_trees: int, max_trees: int) -> None:
        X, y = self.matrix()
        if len(self.model.trees_) + n_new_trees > max_trees:
            # compaction: a long-running loop would otherwise grow the
            # ensemble (and every predict) without bound — retrain from
            # scratch on the live window, which is the ground truth the
            # refits were chasing anyway
            self.model.fit(X, y)
            self.binned = None
            self.n_fitted = len(X)
            return
        if self.model.tree_method == "hist":
            if self.binned is None:
                self.binned = bin_features(X, self.model.max_bins)
            elif len(X) > self.n_fitted:
                self.binned = append_rows(self.binned, X[self.n_fitted:])
            self.model.fit_more(X, y, n_new_trees, binned=self.binned)
        else:
            self.model.fit_more(X, y, n_new_trees)
        self.n_fitted = len(X)


class OnlineSurrogateLoop:
    """Append live (config, time) observations and warm-refit the pair."""

    def __init__(self, surrogate: SurrogatePair, *, refit_every: int = 32,
                 n_new_trees: int = 20, max_observations: int = 8192,
                 max_trees: int = 512, observer=None):
        """``refit_every`` observations trigger a refit on the next
        ``observe`` (or call ``refit(force=True)`` yourself);
        ``n_new_trees`` is the boosting budget per side per refit;
        ``max_observations`` caps the buffers (oldest rows are dropped,
        which also resets the incremental binning so the edges track the
        live window); ``max_trees`` caps each ensemble — a refit that
        would exceed it retrains the model from scratch on the live
        window instead (bounded predict cost over a process lifetime).
        """
        self.surrogate = surrogate
        self.refit_every = refit_every
        self.n_new_trees = n_new_trees
        self.max_observations = max_observations
        self.max_trees = max_trees
        self._host = _SideState(surrogate.host)
        self._device = _SideState(surrogate.device)
        self._since_refit = 0
        self.n_refits = 0
        self._obs = as_observer(observer)

    # -- observations -------------------------------------------------------
    @property
    def n_observations(self) -> int:
        return len(self._host.y) + len(self._device.y)

    def observe(self, cfg: Mapping[str, Any], t_host: float | None,
                t_device: float | None, *, auto_refit: bool = True) -> None:
        """Record one measured configuration.

        Pass ``None`` for a side that did no work (e.g. fraction 0/100 —
        a zero time is the E=max(...) collapse, not a measurement).
        """
        if t_host is not None:
            self._host.append(self.surrogate.host_features(cfg), t_host)
        if t_device is not None:
            self._device.append(self.surrogate.device_features(cfg),
                                t_device)
        self._since_refit += 1
        self._trim()
        if auto_refit and self._since_refit >= self.refit_every:
            self.refit(force=True)

    def _trim(self) -> None:
        for side in (self._host, self._device):
            drop = len(side.y) - self.max_observations
            if drop > 0:
                side.X = side.X[drop:]
                side.y = side.y[drop:]
                side.binned = None          # window moved: re-bin on refit
                side.n_fitted = 0

    # -- refit --------------------------------------------------------------
    def refit(self, force: bool = False) -> bool:
        """Warm-refit both sides from the accumulated observations.

        Returns True when a refit ran.  Without ``force`` the refit only
        runs once ``refit_every`` observations have accumulated since
        the last one.
        """
        if not force and self._since_refit < self.refit_every:
            return False
        token = self._obs.tracer.begin("surrogate.refit") \
            if self._obs is not None else None
        ran = False
        for side in (self._host, self._device):
            if len(side.y) >= 2 * side.model.min_samples_leaf:
                side.refit(self.n_new_trees, self.max_trees)
                ran = True
        if ran:
            self._since_refit = 0
            self.n_refits += 1
        if self._obs is not None:
            self._obs.tracer.end(token, args={"ran": ran})
            if ran:
                self._obs.metrics.counter("surrogate.refits").inc()
                self._obs.journal.event(
                    "surrogate_refit", n_refits=self.n_refits,
                    n_observations=self.n_observations,
                    n_trees=[len(self._host.model.trees_),
                             len(self._device.model.trees_)])
        return ran

    # -- the unified tuning facade ------------------------------------------
    def session(self, space, **session_kw):
        """A ``repro_torch.tune.TuningSession`` wired to this loop.

        The session searches this loop's (live-refit) surrogate pair and
        streams its measurements back in::

            loop = OnlineSurrogateLoop(pair)
            session = loop.session(paper_space(),
                                   evaluator=platform.evaluator(gb))
            session.run("sam", iterations=50)     # measures -> observes
            session.run("saml", engine="vectorized")  # live-data restart
        """
        from ..tune import TuningSession
        return TuningSession(space, online=self, **session_kw)

    # -- persistence (TuningStore NPZ side-car) -----------------------------
    def save_to(self, store, sig: str) -> None:
        """Persist the observation buffers under ``sig`` in ``store``."""
        arrays = {}
        for name, side in (("host", self._host), ("device", self._device)):
            if side.y:
                X, y = side.matrix()
                arrays[f"{name}_X"], arrays[f"{name}_y"] = X, y
        store.save_observations(sig, **arrays)

    def load_from(self, store, sig: str) -> int:
        """Restore observation buffers recorded under ``sig``.

        Returns the number of rows restored (0 on a miss).  Restored
        rows count as un-refit observations — call ``refit(force=True)``
        to fold them in immediately.
        """
        arrays = store.load_observations(sig)
        if not arrays:
            return 0
        n = 0
        for name, side in (("host", self._host), ("device", self._device)):
            if f"{name}_y" in arrays:
                X, y = arrays[f"{name}_X"], arrays[f"{name}_y"]
                for row, t in zip(X, y):
                    side.append(row, t)
                n += len(y)
        self._since_refit += n
        self._trim()
        return n
