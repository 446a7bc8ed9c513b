"""The paper's four optimization strategies: EM, EML, SAM, SAML.

  EM    enumeration + measurements        (optimal, very high effort)
  EML   enumeration + machine learning    (near-optimal, high effort)
  SAM   simulated annealing + measurements (near-optimal, medium effort)
  SAML  simulated annealing + machine learning — the paper's headline method

.. deprecated::
    ``Autotuner`` is a thin compatibility shim over the unified facade
    in :mod:`repro_torch.tune`.  The search engines live in the strategy
    registry (``repro_torch.tune.strategy``) and every ``tune_*`` method
    routes through a ``TuningSession``, emitting a
    ``DeprecationWarning``.  New code should build sessions directly:

        from repro_torch.tune import TuningSession
        TuningSession(space, evaluator=measure, surrogate=pair).run(
            "saml", iterations=1000, engine="vectorized")

The surrogate-training pipeline (``emil_training_grids`` /
``fit_emil_surrogates``, Sec. III-B of the paper) lives here and is not
deprecated.  It is numpy throughout, so the grids and the fitted trees
are the reference package's array for array.

Every strategy takes an ``engine=`` knob selecting the execution path:

  * ``tune_em(engine=...)``    — ``"scalar"`` walks configs through the
    measurement oracle one at a time; ``"batched"`` scores the whole
    space with one ``measure_batch`` call (pass ``measure_batch=`` to
    the constructor, e.g. ``lambda cols:
    platform.energy_batch(cols, gb, rng)``).  ``"auto"`` picks batched
    when available.  A noisy oracle draws noise in a different order per
    engine, so seeded noisy results can differ.
  * ``tune_eml(engine=...)``   — ``"scalar"`` is the per-config loop;
    ``"batched"`` (default) materializes the space once and scores it
    with two ensemble ``predict`` calls.
  * ``tune_saml(engine=...)``  — ``"scalar"`` (default) is the paper's
    single chain; ``"vectorized"`` runs ``n_chains`` chains at once
    (``sa.vectorized_sa``) over the packed BDTR pair with the
    max(T_host, T_device) objective evaluated in PyTorch on ``device``
    (the constructor's; ``None`` = the card).  Its prediction count
    covers every chain, and its random stream is torch's, so it is
    compared with the scalar engine by outcome only.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..tune.result import TuneResult
from .bdtr import BoostedTreesRegressor
from .evaluators import SurrogatePair
from .platform_model import EmilPlatformModel
from .space import ConfigSpace

__all__ = ["Autotuner", "TuneReport", "emil_training_grids",
           "fit_emil_surrogates"]

# The unified result record superseded the seed's report; the name (and
# the persisted-cache schema) stay importable from here.
TuneReport = TuneResult


class Autotuner:
    """Search a ConfigSpace for the configuration minimising measured energy."""

    def __init__(
        self,
        space: ConfigSpace,
        measure: Callable[[Mapping[str, Any]], float],
        *,
        truth: Callable[[Mapping[str, Any]], float] | None = None,
        surrogate: SurrogatePair | None = None,
        n_training_experiments: int = 0,
        measure_batch: Callable[[Mapping[str, np.ndarray]], np.ndarray] |
        None = None,
        warm_start=None,
        record_to=None,
        workload: Mapping[str, Any] | None = None,
        device: Any = None,
    ):
        """``measure`` is the (possibly noisy) measurement oracle; ``truth``
        is the noise-free oracle used only for *reporting* (defaults to
        ``measure``).  ``surrogate`` enables EML/SAML.  ``measure_batch``
        (columns -> energies, e.g. ``lambda cols:
        platform.energy_batch(cols, gb, rng)``) enables the batched EM
        engine.

        ``warm_start`` / ``record_to`` attach a persistent tuning cache
        (``repro_torch.runtime.store.TuningStore``, or a path to one; pass the
        same store to both for read-write caching).  ``workload``
        describes the tuned workload beyond the space itself — shapes,
        device topology, anything that changes measured times — and is
        folded into the cache key.  ``tune()`` consults ``warm_start``
        before searching (a hit performs zero new measurements) and
        records fresh results to ``record_to``; the per-strategy
        ``tune_*`` methods always search.  ``device`` is where the
        vectorized SAML chains run and what keys the stores' device
        topology (``None`` = the card).
        """
        self.space = space
        self.measure = measure
        self.truth = truth or measure
        self.surrogate = surrogate
        self.n_training_experiments = n_training_experiments
        self.measure_batch = measure_batch
        self.workload = workload
        self.device = device
        self.warm_start = self._as_store(warm_start, device)
        self.record_to = self._as_store(record_to, device)

    @staticmethod
    def _as_store(store, device=None):
        if store is None or hasattr(store, "lookup"):
            return store
        # deferred import: core must stay importable without runtime
        from ..runtime.store import TuningStore
        return TuningStore(store, device=device)

    # -- the deprecated shim over repro_torch.tune --------------------------
    def _session(self):
        from ..tune import TuningSession
        return TuningSession(
            self.space, evaluator=self.measure,
            evaluator_batch=self.measure_batch, surrogate=self.surrogate,
            truth=self.truth,
            n_training_experiments=self.n_training_experiments,
            device=self.device)

    def _run(self, name: str, strategy: str, **opts) -> TuneReport:
        warnings.warn(
            f"Autotuner.{name} is deprecated; use "
            f"repro_torch.tune.TuningSession(...).run({strategy!r}) "
            "instead",
            DeprecationWarning, stacklevel=3)
        if strategy in ("eml", "saml") and self.surrogate is None:
            raise ValueError("strategy needs a trained surrogate "
                             "(pass surrogate= to Autotuner)")
        return self._session().run(strategy, **opts)

    # -- strategies (legacy surface; identical seeded results) --------------
    def tune_em(self, *, engine: str = "auto") -> TuneReport:
        return self._run("tune_em", "em", engine=engine)

    def tune_eml(self, *, engine: str = "batched") -> TuneReport:
        return self._run("tune_eml", "eml", engine=engine)

    def tune_sam(self, *, iterations: int = 1000, seed: int = 0,
                 checkpoints: Sequence[int] = ()) -> TuneReport:
        return self._run("tune_sam", "sam", iterations=iterations, seed=seed,
                         checkpoints=checkpoints)

    def tune_saml(self, *, iterations: int = 1000, seed: int = 0,
                  checkpoints: Sequence[int] = (), engine: str = "scalar",
                  n_chains: int = 32) -> TuneReport:
        return self._run("tune_saml", "saml", iterations=iterations,
                         seed=seed, checkpoints=checkpoints, engine=engine,
                         n_chains=n_chains)

    def tune(self, strategy: str, **kw) -> TuneReport:
        strategy = strategy.upper()
        fn = {
            "EM": self.tune_em, "EML": self.tune_eml,
            "SAM": self.tune_sam, "SAML": self.tune_saml,
        }.get(strategy)
        if fn is None:
            raise ValueError(f"unknown strategy {strategy!r}")
        if self.warm_start is not None:
            hit = self.warm_start.lookup(self.space, self.workload, strategy)
            if hit is not None:
                return hit
        report = fn(**kw)
        if self.record_to is not None:
            self.record_to.record(self.space, self.workload, strategy, report)
        return report


# ---------------------------------------------------------------------------
# Surrogate training for the Emil platform (paper Sec. III-B / IV-B).
# ---------------------------------------------------------------------------

def _one_hot_cols(vals: np.ndarray, domain: Sequence[str]) -> np.ndarray:
    return (np.asarray(vals)[:, None] ==
            np.asarray(domain)[None, :]).astype(np.float64)


def emil_training_grids(
    platform: EmilPlatformModel,
    *,
    datasets_gb: Sequence[float],
    host_threads: Sequence[int] = (2, 6, 12, 24, 36, 48),
    device_threads: Sequence[int] = (2, 4, 8, 16, 30, 60, 120, 180, 240),
    host_affinities: Sequence[str] = ("none", "scatter", "compact"),
    device_affinities: Sequence[str] = ("balanced", "scatter", "compact"),
    fractions: Sequence[float] | None = None,
    rng: np.random.Generator | None = None,
    seed: int = 0,
):
    """Vectorized generation of the paper's host/device training grids.

    Returns ``((host_X, host_y), (device_X, device_y))`` with feature rows
    [input_gb, threads, affinity one-hot..., fraction_pct] and noisy
    execution times (lognormal, ``platform.noise_sigma``).  Row order
    matches the paper's nested experiment loops (fraction fastest), and
    the noise draws consume ``rng`` exactly like per-row scalar draws
    would — so the grids are bit-reproducible for a given seed.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    if fractions is None:
        fractions = [2.5 * i for i in range(1, 41)]  # 2.5 .. 100 step 2.5

    def side(threads, affinities, time_batch):
        gb, t, a, f = (g.ravel() for g in np.meshgrid(
            np.asarray(datasets_gb, dtype=np.float64),
            np.asarray(threads, dtype=np.float64),
            np.arange(len(affinities)),
            np.asarray(fractions, dtype=np.float64),
            indexing="ij"))
        aff = np.asarray(affinities)[a]
        tt = time_batch(gb * f / 100.0, t, aff)
        tt = tt * np.exp(rng.normal(0, platform.noise_sigma, tt.shape))
        X = np.column_stack([gb, t, _one_hot_cols(aff, affinities), f])
        return X, tt

    return (side(host_threads, host_affinities, platform.host_time_batch),
            side(device_threads, device_affinities,
                 platform.device_time_batch))


def fit_emil_surrogates(
    platform: EmilPlatformModel,
    dataset_gb: float,
    *,
    datasets_gb: Sequence[float] | None = None,
    host_threads: Sequence[int] = (2, 6, 12, 24, 36, 48),
    device_threads: Sequence[int] = (2, 4, 8, 16, 30, 60, 120, 180, 240),
    host_affinities: Sequence[str] = ("none", "scatter", "compact"),
    device_affinities: Sequence[str] = ("balanced", "scatter", "compact"),
    fractions: Sequence[float] | None = None,
    seed: int = 0,
    n_estimators: int = 150,
    max_depth: int = 5,
    tree_method: str = "hist",
    return_eval: bool = False,
):
    """Generate the paper's training grid and fit per-side BDTR models.

    The paper runs 2880 host experiments (4 datasets x 6 thread counts x 3
    affinities x 40 fractions) and 4320 device experiments (9 thread
    counts), then trains on half and evaluates on the other half.  Feature
    vectors are [input_gb, threads, affinity one-hot..., fraction_pct].

    The grid is generated vectorized (meshgrid + the platform's batch
    evaluators) and the BDTR pair is histogram-fit by default; because the
    grid features take few distinct values, the histogram splitter
    partitions the training rows exactly like the exact one, though
    off-grid queries can route differently where thresholds land inside
    value gaps (``tree_method="exact"`` restores the reference splitter).

    The returned ``SurrogatePair`` also carries the batched feature
    builders (column batches -> model features) and a jit-compatible
    energy-function builder, enabling ``Autotuner.tune_eml`` /
    ``tune_saml(engine="vectorized")`` fast paths.

    Returns (surrogate, n_experiments[, eval_tables]).
    """
    rng = np.random.default_rng(seed)
    if fractions is None:
        fractions = [2.5 * i for i in range(1, 41)]  # 2.5 .. 100 step 2.5
    if datasets_gb is None:
        datasets_gb = (dataset_gb,)

    def one_hot(val: str, domain: Sequence[str]) -> list[float]:
        return [1.0 if val == d else 0.0 for d in domain]

    (host_X, host_y), (dev_X, dev_y) = emil_training_grids(
        platform, datasets_gb=datasets_gb, host_threads=host_threads,
        device_threads=device_threads, host_affinities=host_affinities,
        device_affinities=device_affinities, fractions=fractions, rng=rng)
    n_experiments = len(host_y) + len(dev_y)

    # half train / half eval (paper's "standard validation methodology")
    def split(X, y):
        idx = rng.permutation(len(y))
        half = len(y) // 2
        return (X[idx[:half]], y[idx[:half]]), (X[idx[half:]], y[idx[half:]])

    (hXtr, hytr), (hXev, hyev) = split(host_X, host_y)
    (dXtr, dytr), (dXev, dyev) = split(dev_X, dev_y)

    host_model = BoostedTreesRegressor(
        n_estimators=n_estimators, max_depth=max_depth, seed=seed,
        tree_method=tree_method).fit(hXtr, hytr)
    dev_model = BoostedTreesRegressor(
        n_estimators=n_estimators, max_depth=max_depth, seed=seed + 1,
        tree_method=tree_method).fit(dXtr, dytr)

    def host_features(cfg: Mapping[str, Any]) -> np.ndarray:
        return np.asarray([
            dataset_gb, float(cfg["host_threads"]),
            *one_hot(str(cfg["host_affinity"]), host_affinities),
            float(cfg["host_fraction"]),
        ])

    def device_features(cfg: Mapping[str, Any]) -> np.ndarray:
        return np.asarray([
            dataset_gb, float(cfg["device_threads"]),
            *one_hot(str(cfg["device_affinity"]), device_affinities),
            100.0 - float(cfg["host_fraction"]),
        ])

    def host_features_cols(cols: Mapping[str, np.ndarray]) -> np.ndarray:
        t = np.asarray(cols["host_threads"], dtype=np.float64)
        return np.column_stack([
            np.full(t.shape, dataset_gb), t,
            _one_hot_cols(cols["host_affinity"], host_affinities),
            np.asarray(cols["host_fraction"], dtype=np.float64),
        ])

    def device_features_cols(cols: Mapping[str, np.ndarray]) -> np.ndarray:
        t = np.asarray(cols["device_threads"], dtype=np.float64)
        return np.column_stack([
            np.full(t.shape, dataset_gb), t,
            _one_hot_cols(cols["device_affinity"], device_affinities),
            100.0 - np.asarray(cols["host_fraction"], dtype=np.float64),
        ])

    def energy_fn_torch_builder(space: ConfigSpace, device=None):
        """E(cfg) = max(T_h_hat, T_d_hat) over a space's encoded feature
        matrix, on ``device`` (``None`` = the card).  The space must use
        the paper's parameter names.  The trees walk in float32, as
        ``BoostedTreesRegressor.predict_fn_torch`` does."""
        names = space.feature_names
        i_ht = names.index("host_threads")
        i_dt = names.index("device_threads")
        i_f = names.index("host_fraction")
        h_idx = [names.index(f"host_affinity={a}") for a in host_affinities]
        d_idx = [names.index(f"device_affinity={a}") for a in
                 device_affinities]
        fn_h = host_model.predict_fn_torch(device)
        fn_d = dev_model.predict_fn_torch(device)

        def energy(X):
            X = torch.as_tensor(X)
            f = X[:, i_f]
            gb = torch.full_like(f, dataset_gb)
            Xh = torch.stack([gb, X[:, i_ht], *(X[:, j] for j in h_idx), f],
                             dim=1)
            Xd = torch.stack([gb, X[:, i_dt], *(X[:, j] for j in d_idx),
                              100.0 - f], dim=1)
            th = fn_h(Xh)
            td = fn_d(Xd)
            f = f.to(th.device)
            th = torch.where(f > 0, th, torch.zeros_like(th))
            td = torch.where(f < 100, td, torch.zeros_like(td))
            return torch.maximum(th, td)

        return energy

    surrogate = SurrogatePair(host=host_model, device=dev_model,
                              host_features=host_features,
                              device_features=device_features,
                              host_features_cols=host_features_cols,
                              device_features_cols=device_features_cols,
                              energy_fn_torch_builder=energy_fn_torch_builder)
    if return_eval:
        eval_tables = {
            "host": (hXev, hyev, host_model.predict(hXev)),
            "device": (dXev, dyev, dev_model.predict(dXev)),
        }
        return surrogate, n_experiments, eval_tables
    return surrogate, n_experiments
