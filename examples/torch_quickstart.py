"""Quickstart: the paper's autotuner through the PyTorch port (the twin
of ``examples/quickstart.py``; it prints the same lines).

1. Build the paper's configuration space (threads x affinity x split).
2. Train the BDTR surrogate from 7200 simulated measurements.
3. SAML: simulated annealing on the surrogate -> near-optimal config.
4. Compare against enumeration and the host-only / device-only baselines.

Everything here runs on the host, as in the reference: the platform is
the calibrated simulator, and no kernel is launched.

    PYTHONPATH=src python examples/torch_quickstart.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import (DATASETS_GB, EmilPlatformModel,
                              fit_emil_surrogates, paper_space)
from repro_torch.tune import TuningSession, list_strategies


def main(argv=None) -> dict:
    platform = EmilPlatformModel()
    gb = DATASETS_GB["human"]
    print(f"workload: human DNA ({gb} GB) on 2x Xeon E5 + Xeon Phi 7120P "
          "(calibrated simulator)")

    surrogate, n_train = fit_emil_surrogates(
        platform, gb, datasets_gb=list(DATASETS_GB.values()), seed=0)
    print(f"surrogate trained from {n_train} measurements "
          "(3600 train / 3600 eval, as in the paper)")

    space = paper_space(workload_step=5)
    rng = np.random.default_rng(0)
    session = TuningSession(
        space,
        evaluator=lambda c: platform.energy(c, gb, rng),
        truth=lambda c: platform.energy(c, gb, None),
        surrogate=surrogate,
        n_training_experiments=n_train)
    print(f"registered strategies: {', '.join(list_strategies())}")

    saml = session.run("saml", iterations=1000, seed=1, checkpoints=(1000,))
    em = session.run("em")

    e_saml = saml.checkpoints[1000][0]
    e_em = em.best_energy_measured
    t_host = platform.host_only_time(gb)
    t_dev = platform.device_only_time(gb)
    print(f"\nEM optimum        : {e_em:.3f}s after {em.n_experiments} "
          "experiments")
    print(f"SAML @1000 iters  : {e_saml:.3f}s after 0 experiments "
          f"({saml.n_predictions} predictions)")
    print(f"suggested config  : {saml.best_config}")
    print(f"host-only (48 thr): {t_host:.3f}s -> speedup {t_host/e_saml:.2f}x"
          f"   (paper: 1.74x)")
    print(f"device-only (240) : {t_dev:.3f}s -> speedup {t_dev/e_saml:.2f}x"
          f"   (paper: 2.18x)")
    print(f"pct diff vs EM    : {100*(e_saml-e_em)/e_em:.2f}% "
          "(paper: ~10% at 1000 iterations)")
    return {"saml": saml, "em": em}


if __name__ == "__main__":
    main()
