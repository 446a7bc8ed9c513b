"""The paper's Results 1-5 through the port, held against the reference.

Mirrors ``tests/test_core_autotuner.py`` (the same banded asserts on the
port's ``fit_emil_surrogates`` / ``Autotuner``) and adds what ties the
port to the reference:

  * the surrogate fit is numpy in both packages: the port's grids, trees
    and evaluation tables equal the reference's array for array;
  * ``energy_fn_torch_builder(space, "cpu")`` lies within 1e-6 relative of
    the reference's ``energy_fn_jax_builder`` over the whole encoded space
    (both walk the trees in float32);
  * vectorized SAML on the CPU lands within 5 % of EM (the two engines
    draw different random streams, so they are compared by outcome);
  * ``python -m repro_torch.tune`` passes its self-check.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import SRC

import repro.core as ref_core
from repro_torch.core import (Autotuner, DATASETS_GB, EmilPlatformModel,
                              emil_training_grids, fit_emil_surrogates,
                              paper_space, percent_error)
from repro_torch.tune import TuningSession

GB = DATASETS_GB["human"]

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def platform():
    return EmilPlatformModel()


@pytest.fixture(scope="module")
def surrogate(platform):
    sur, n, ev = fit_emil_surrogates(
        platform, GB, datasets_gb=list(DATASETS_GB.values()),
        n_estimators=80, return_eval=True, seed=0)
    return sur, n, ev


@pytest.fixture(scope="module")
def ref_surrogate():
    return ref_core.fit_emil_surrogates(
        ref_core.EmilPlatformModel(), GB,
        datasets_gb=list(DATASETS_GB.values()), n_estimators=80,
        return_eval=True, seed=0)


def test_result1_prediction_matches_measurement(surrogate):
    _, n_train, ev = surrogate
    assert n_train == 7200                      # paper's experiment count
    for side, bound in (("host", 8.0), ("device", 8.0)):
        _, y, yp = ev[side]
        assert percent_error(y, yp).mean() < bound


def test_result2_absolute_errors_low(surrogate):
    _, _, ev = surrogate
    _, y_host, yp_host = ev["host"]
    _, y_dev, yp_dev = ev["device"]
    # paper: avg abs err 0.027 s (host), 0.074 s (device); allow 4x slack
    assert np.abs(y_host - yp_host).mean() < 0.11
    assert np.abs(y_dev - yp_dev).mean() < 0.30


def test_fit_equals_the_reference_array_for_array(surrogate, ref_surrogate):
    sur, n, ev = surrogate
    rsur, rn, rev = ref_surrogate
    assert n == rn
    for port, ref in ((sur.host, rsur.host), (sur.device, rsur.device)):
        assert port.base_ == ref.base_
        assert len(port.trees_) == len(ref.trees_) == 80
        for a, b in zip(port.trees_, ref.trees_):
            for name in ("feature", "threshold", "left", "right", "value"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
    for side in ("host", "device"):
        for got, want in zip(ev[side], rev[side]):
            np.testing.assert_array_equal(got, want)
    grids = emil_training_grids(EmilPlatformModel(), datasets_gb=(GB, 2.43),
                                seed=3)
    ref_grids = ref_core.emil_training_grids(ref_core.EmilPlatformModel(),
                                             datasets_gb=(GB, 2.43), seed=3)
    for (X, y), (rX, ry) in zip(grids, ref_grids):
        np.testing.assert_array_equal(X, rX)
        np.testing.assert_array_equal(y, ry)
    # the pair's numpy paths, scalar and batched, give the same numbers
    space = paper_space(workload_step=25)
    cols = space.enumerate_columns()
    np.testing.assert_array_equal(sur.predict_energy_batch(cols),
                                  rsur.predict_energy_batch(cols))
    for cfg in list(space.enumerate())[::53]:
        assert sur.predict_energy(cfg) == rsur.predict_energy(cfg)


def test_energy_fn_torch_builder_matches_the_jax_builder(surrogate,
                                                        ref_surrogate):
    sur, _, _ = surrogate
    rsur, _, _ = ref_surrogate
    space = paper_space(workload_step=10)
    X = space.encode_all()
    got = sur.energy_fn_torch_builder(space, "cpu")(
        torch.as_tensor(X, dtype=torch.float32)).double().numpy()
    want = np.asarray(rsur.energy_fn_jax_builder(
        ref_core.paper_space(workload_step=10))(X), dtype=np.float64)
    assert got.shape == want.shape == (space.size(),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # and both lie within float32's reach of the float64 numpy path
    np.testing.assert_allclose(
        got, sur.predict_energy_batch(space.enumerate_columns()),
        rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def tuner(platform, surrogate):
    sur, n_train, _ = surrogate
    space = paper_space(workload_step=10)       # keep EM tractable in tests
    rng = np.random.default_rng(0)
    return Autotuner(
        space,
        measure=lambda c: platform.energy(c, GB, rng),
        truth=lambda c: platform.energy(c, GB, None),
        surrogate=sur, n_training_experiments=n_train, device="cpu")


@pytest.fixture(scope="module")
def em_report(tuner):
    return tuner.tune_em()


def test_em_finds_hetero_optimum(em_report):
    cfg = em_report.best_config
    # paper Fig. 2b: large inputs favour a 50-75 % host share with max threads
    assert 40 <= cfg["host_fraction"] <= 80
    assert cfg["host_threads"] >= 24
    assert cfg["device_threads"] >= 120


def test_result3_saml_close_to_em_at_5pct_budget(tuner, em_report):
    saml = tuner.tune_saml(iterations=1000, seed=1,
                           checkpoints=(250, 500, 750, 1000))
    # effort: SAML performs ZERO search measurements
    assert saml.n_experiments == 0
    assert saml.n_predictions >= 1000
    diff = 100 * (saml.best_energy_measured - em_report.best_energy_measured) \
        / em_report.best_energy_measured
    assert diff < 12.0                            # paper: ~10 % at 1000 iters


def test_result4_checkpoint_differences_decrease(tuner, em_report):
    saml = tuner.tune_saml(iterations=1000, seed=2,
                           checkpoints=(250, 500, 750, 1000))
    best = em_report.best_energy_measured
    diffs = [100 * (saml.checkpoints[i][0] - best) / best
             for i in (250, 500, 750, 1000)]
    assert diffs[-1] <= diffs[0] + 1e-9
    assert diffs[-1] < 15.0


def test_result5_speedups(platform, tuner):
    saml = tuner.tune_saml(iterations=1000, seed=3, checkpoints=(1000,))
    e = saml.checkpoints[1000][0]
    sp_host = platform.host_only_time(GB) / e
    sp_dev = platform.device_only_time(GB) / e
    # paper: 1.74x vs host-only, 2.18x vs device-only @1000 iters
    assert 1.45 <= sp_host <= 2.2
    assert 1.8 <= sp_dev <= 2.7


def test_sam_uses_measurements_not_predictions(tuner):
    sam = tuner.tune_sam(iterations=120, seed=0)
    assert sam.n_experiments > 0
    assert sam.n_predictions == 0


def test_eml_enumerates_predictions(platform, surrogate):
    sur, n_train, _ = surrogate
    space = paper_space(workload_step=25)
    tuner = Autotuner(space, measure=lambda c: platform.energy(c, GB, None),
                      surrogate=sur, n_training_experiments=n_train)
    eml = tuner.tune_eml()
    assert eml.n_predictions == space.size()
    assert eml.n_experiments == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorized_saml_on_the_cpu_within_5pct_of_em(platform, surrogate,
                                                      seed):
    """The paper's headline engine through the session on the CPU: every
    chain's step is one surrogate query, the winner measured on the
    noise-free platform lies within 5 % of EM's."""
    sur, n_train, _ = surrogate
    space = paper_space(workload_step=10)
    session = TuningSession(space, evaluator=platform.evaluator(GB),
                            surrogate=sur, n_training_experiments=n_train,
                            device="cpu")
    em = session.run("em")
    saml = session.run("saml", engine="vectorized", iterations=1000,
                       n_chains=32, seed=seed)
    assert saml.n_experiments == 0
    assert saml.n_predictions == 32 * 1001
    assert saml.best_energy_measured <= 1.05 * em.best_energy_measured


def test_vectorized_saml_defaults_to_the_card(surrogate):
    """No device named: the energy function is built on the card, which
    this machine lacks, so the run raises instead of falling back."""
    sur, _, _ = surrogate
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    session = TuningSession(paper_space(workload_step=25), surrogate=sur)
    with pytest.raises(RuntimeError):
        session.run("saml", engine="vectorized", iterations=10)


def test_tune_selfcheck_passes():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.tune"],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout + proc.stderr
    assert "[selfcheck] OK: 6 strategies" in out
    assert "jax" not in out
