"""Registry-completeness selfcheck: smoke-tune every registered strategy.

    PYTHONPATH=src python -m repro_torch.tune

Runs each strategy in ``list_strategies()`` end-to-end on a tiny
two-parameter space with a deterministic analytic evaluator (plus a
fitted surrogate pair for the ML strategies) and fails loudly if any
registered strategy cannot complete a search, so a strategy added to
the registry without a working implementation is caught at once.  It
runs on the host alone (numpy oracles and surrogates; the scalar SAML
engine), so it needs no card.
"""

from __future__ import annotations

import sys

import numpy as np

from ..obs import get_logger

log = get_logger("repro_torch.obs")


def selfcheck(verbose: bool = True) -> list[str]:
    """Smoke-tune every registered strategy; returns the checked names."""
    from ..core import (BoostedTreesRegressor, ConfigSpace, Param,
                        SurrogatePair)
    from . import Time, TuningSession, get_strategy, list_strategies

    space = ConfigSpace([
        Param("threads", (1, 2, 4, 8)),
        Param("host_fraction", tuple(range(0, 101, 10))),
    ])

    def truth(cfg):
        f = cfg["host_fraction"] / 100.0
        return f * 8.0 / cfg["threads"] + (1.0 - f) * 1.2

    def feats(cfg):
        return np.asarray([float(cfg["threads"]),
                           float(cfg["host_fraction"])])

    grid = space.index_grid()
    cols = space.enumerate_columns(grid)
    X = np.column_stack([np.asarray(cols["threads"], float),
                         np.asarray(cols["host_fraction"], float)])
    f = X[:, 1] / 100.0
    yh = f * 8.0 / X[:, 0]
    yd = (1.0 - f) * 1.2
    pair = SurrogatePair(
        host=BoostedTreesRegressor(n_estimators=20, max_depth=3,
                                   tree_method="hist").fit(X, yh),
        device=BoostedTreesRegressor(n_estimators=20, max_depth=3,
                                     tree_method="hist").fit(X, yd),
        host_features=feats, device_features=feats)

    session = TuningSession(
        space, evaluator=truth, objective=Time(), surrogate=pair,
        budget=60, seed=0)
    checked = []
    for name in list_strategies():
        opts = {}
        if get_strategy(name).uses_surrogate and name == "saml":
            opts["engine"] = "scalar"
        result = session.run(name, **opts)
        assert result.strategy == name.upper(), result
        assert set(result.best_config) == set(space.names), result
        assert np.isfinite(result.best_energy_measured), result
        assert (result.n_experiments + result.n_predictions) > 0, result
        assert result.space_size == space.size(), result
        assert 0 <= result.n_measured <= max(result.n_experiments, 1), result
        if verbose:
            # the paper's effort accounting: measured configs as a
            # fraction of the enumeration count (~5% in Sec. IV-C)
            log.info(
                f"[selfcheck] {name:<10s} best={result.best_config} "
                f"score={result.best_energy_measured:.4f} "
                f"(exp={result.n_experiments} pred={result.n_predictions} "
                f"measured={result.n_measured}/{result.space_size} "
                f"= {100 * result.experiments_fraction:.1f}%)")
        checked.append(name)
    return checked


def main() -> int:
    names = selfcheck()
    if len(names) < 6:
        print(f"[selfcheck] FAIL: only {len(names)} strategies registered "
              f"({names}); expected >= 6", file=sys.stderr)
        return 1
    log.info(f"[selfcheck] OK: {len(names)} strategies "
             f"({', '.join(names)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
