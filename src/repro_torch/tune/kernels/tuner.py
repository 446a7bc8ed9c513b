"""``tune_kernel`` — the paper's loop applied to kernel launch parameters.

For surrogate strategies (``saml`` — the default — and ``eml``) the flow
mirrors the paper end to end:

  1. measure a small seeded training sample of *valid* configs (the
     hardcoded default plus random valid draws; the sample is sized to
     keep total measurements within ``budget_fraction`` — 5% — of the
     space, matching the headline result);
  2. fit a BDTR surrogate on (encoded config -> seconds);
  3. hand the surrogate to a :class:`~repro_torch.tune.session.TuningSession`
     and search with the requested registry strategy (predictions are
     free; invalid configs predict ``inf`` so the search cannot leave
     the launchable region);
  4. the session re-measures the winner with ground truth (free when the
     winner was in the training sample — measurements deduplicate);
  5. the result is the fastest point the timer measured: the session's
     pick, or a point of the training sample (the warm start among them)
     when one was faster.  A surrogate fit on a few points can rank a point
     it never measured above one it did; the store then keeps the measured
     best, not the prediction.  The reference returns the pick whatever
     it measured (a deliberate difference).

Measurement-only strategies (``sam``/``random``/``hillclimb``/``em``)
skip 1–2 and drive the timer directly.  Results persist through the
session's :class:`~repro_torch.runtime.store.TuningStore` keyed by (kernel,
shape signature, dtype, device topology): repeating a tune of the same
workload — or resolving it through a kernel's ``tuned=`` path — performs
zero new measurements.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Mapping

import numpy as np

from ...core.bdtr import BoostedTreesRegressor
from ..session import TuningSession
from ..strategy import get_strategy
from .evaluate import KernelTimer
from .registry import get_kernel, kernel_workload

__all__ = ["KernelTuneOutcome", "tune_kernel"]


@dataclass
class KernelTuneOutcome:
    """A tuned kernel: the session result plus measurement accounting."""

    kernel: str
    shape: dict
    dtype: str
    result: Any                   # TuneResult (from_cache=True on a hit)
    default_config: dict
    space_size: int
    n_measured: int               # actual kernel executions this tune
    timer: KernelTimer            # reusable oracle (measurements dedup)
    # which measured point the result is: "pick" (the search's winner),
    # "warm_start", "training" (another point of the surrogate's sample),
    # "search" (another point a measurement strategy timed), or "cache"
    best_source: str = "pick"

    @property
    def best_config(self) -> dict:
        return self.result.best_config

    @property
    def measured_fraction(self) -> float:
        return self.n_measured / self.space_size if self.space_size else 0.0

    def default_time(self) -> float:
        """Seconds at the hardcoded defaults (measures once, then cached)."""
        return self.timer(self.default_config)

    def best_time(self) -> float:
        return float(self.result.best_energy_measured)


def _axis_corner(space, spec, meta, base, pick):
    """Greedily move each ordinal parameter to the ``pick``-most valid
    candidate (holding the rest) — the standard design-of-experiments
    anchors that give the surrogate the slope of every axis."""
    cfg = dict(base)
    for p in space.params:
        if not p.ordinal:
            continue
        for v in sorted(p.values, reverse=(pick == "max")):
            cand = dict(cfg, **{p.name: v})
            if spec.validate(cand, meta) is None:
                cfg = cand
                break
    return cfg


def _training_sample(space, spec, meta, default_cfg, n_train, seed):
    """Seeded design: default + per-axis extreme corners + random valid
    draws, deduplicated (an experiment is never measured twice)."""
    rng = np.random.default_rng(seed)
    anchors = [default_cfg,
               _axis_corner(space, spec, meta, default_cfg, "max"),
               _axis_corner(space, spec, meta, default_cfg, "min")]
    cfgs, seen = [], set()
    for cand in anchors:
        key = tuple(sorted(cand.items()))
        if key not in seen and spec.validate(cand, meta) is None:
            seen.add(key)
            cfgs.append(cand)
    attempts = 0
    while len(cfgs) < n_train and attempts < 200 * n_train:
        attempts += 1
        cand = space.random(rng)
        key = tuple(sorted(cand.items()))
        if key in seen or spec.validate(cand, meta) is not None:
            continue
        seen.add(key)
        cfgs.append(cand)
    return cfgs[:n_train]


def _measured_best(result, timer: KernelTimer, warm: Mapping[str, Any],
                   training: list) -> tuple[Any, str]:
    """The result moved to the fastest point ``timer`` measured, and which
    point that is; the pick itself when nothing measured beat it."""
    best_key, best_s = None, float(result.best_energy_measured)
    for key, seconds in timer._cache.items():
        if np.isfinite(seconds) and seconds < best_s:
            best_key, best_s = key, float(seconds)
    if best_key is None:
        return result, "pick"
    cfg = dict(best_key)
    if cfg == dict(warm):
        source = "warm_start"
    elif any(cfg == dict(c) for c in training):
        source = "training"
    else:
        source = "search"
    return replace(result, best_config=cfg, best_energy_measured=best_s,
                   best_metrics={**result.best_metrics, "time": best_s}
                   ), source


def tune_kernel(name: str, shape: Mapping[str, Any] | None = None, *,
                dtype: Any = None, strategy: str = "saml",
                store: Any = None, iterations: int = 300, seed: int = 0,
                n_train: int | None = None, budget_fraction: float = 0.05,
                repeats: int = 3, device: Any = None,
                smoke: bool = False, observer: Any = None,
                **opts) -> KernelTuneOutcome:
    """Tune one kernel's launch parameters for one (shape, dtype).

    ``shape`` overrides entries of the spec's default (or, with
    ``smoke=True``, CI-sized) shape.  ``store`` (a ``TuningStore`` or a
    path) makes the result persistent — a repeated tune is a cache hit
    with zero measurements.  Any registered session strategy works;
    surrogate strategies train on at most ``budget_fraction`` of the
    space.  Extra ``opts`` go to the strategy (``engine=``, ...).
    ``device=None`` measures on the card; ``device="cpu"`` times the
    kernels' plain PyTorch versions on the host.
    """
    spec = get_kernel(name)
    if dtype is None:
        dtype = spec.dtype          # match the ops layer's resolution key
    meta = dict(spec.smoke_shape if smoke else spec.default_shape,
                **(shape or {}))
    space = spec.space(meta)
    timer = KernelTimer(spec, meta, dtype, device=device,
                        repeats=repeats, seed=seed, observer=observer)
    workload = kernel_workload(name, meta, dtype)
    default_cfg = spec.default_config(space, meta)
    tstore = TuningSession._as_store(store, timer.device)
    info = get_strategy(strategy)

    surrogate = None
    n_train_used = 0
    cfgs: list = []
    warm = dict(default_cfg)
    cached = (tstore.lookup(space, workload, strategy.upper())
              if tstore is not None else None)
    if cached is None and info.uses_surrogate:
        if n_train is None:
            n_train = max(4, int(budget_fraction * space.size()) - 1)
        cfgs = _training_sample(space, spec, meta, default_cfg, n_train, seed)
        times = np.asarray([timer(c) for c in cfgs])
        ok = np.isfinite(times)
        if ok.sum() < 2:
            raise ValueError(f"kernel {name!r}: too few valid training "
                             f"measurements ({int(ok.sum())}) to fit a "
                             "surrogate; use a measurement strategy")
        X = space.encode_many([c for c, k in zip(cfgs, ok) if k])
        model = BoostedTreesRegressor(
            n_estimators=60, learning_rate=0.1, max_depth=3,
            min_samples_leaf=1, tree_method="hist").fit(X, times[ok])
        n_train_used = timer.n_measured

        def surrogate(cfg):
            # validity is free — keep the search inside the launchable
            # region without spending measurements on invalid configs
            if spec.validate(cfg, meta) is not None:
                return float("inf")
            return float(model.predict(space.encode(cfg)[None, :])[0])

        best_i = int(np.argmin(np.where(ok, times, np.inf)))
        warm = dict(cfgs[best_i])

    session = TuningSession(
        space, evaluator=timer, surrogate=surrogate,
        n_training_experiments=n_train_used, warm_start=warm,
        workload=workload, store=tstore, seed=seed, device=timer.device)
    result = session.run(strategy, iterations=iterations, **opts)
    source = "cache"
    if not result.from_cache:
        result, source = _measured_best(result, timer, warm, cfgs)
        if source != "pick" and tstore is not None:
            tstore.record(space, workload, session._store_key(strategy),
                          result)
    return KernelTuneOutcome(
        kernel=name, shape=dict(meta), dtype=workload["dtype"],
        result=result, default_config=default_cfg,
        space_size=space.size(), n_measured=timer.n_measured, timer=timer,
        best_source=source)
