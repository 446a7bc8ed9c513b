"""The Emil platform model of the port, held against the reference's.

``repro_torch.core.platform_model`` is the reference's analytic model
re-homed (numpy only), so every calibration band of
``tests/test_platform_model.py`` is checked here on the port, and the
port's times, energies and metric records must equal the reference's
with ``==`` — scalar and batched, noise-free and seeded.
"""

import numpy as np
import pytest

from repro.core import EmilPlatformModel as RefModel
from repro_torch.core import DATASETS_GB, EmilPlatformModel, paper_space

GB = DATASETS_GB["human"]


@pytest.fixture(scope="module")
def plat():
    return EmilPlatformModel()


def test_more_threads_never_slower(plat):
    times_h = [plat.host_time(GB, t, "scatter") for t in (2, 6, 12, 24, 48)]
    assert all(a >= b for a, b in zip(times_h, times_h[1:]))
    times_d = [plat.device_time(GB, t, "balanced")
               for t in (2, 8, 30, 120, 240)]
    assert all(a >= b for a, b in zip(times_d, times_d[1:]))


def test_execution_time_spans_match_paper(plat):
    """Paper: host runs span ~0.74-5.5 s, device ~0.9-42 s."""
    host = [plat.host_time(GB * f, t, a)
            for f in (0.025, 0.5, 1.0) for t in (2, 12, 48)
            for a in ("none", "scatter", "compact")]
    dev = [plat.device_time(GB * f, t, a)
           for f in (0.025, 0.5, 1.0) for t in (2, 30, 240)
           for a in ("balanced", "scatter", "compact")]
    assert min(host) < 1.2 and 3.0 < max(host) < 9.0
    assert min(dev) < 1.5 and 25.0 < max(dev) < 60.0


def test_optimal_split_band(plat):
    """Paper Fig. 2b: with 48 host threads the best split is ~60/40-70/30."""
    fractions = range(0, 101, 5)
    es = {f: plat.energy({"host_threads": 48, "device_threads": 240,
                          "host_affinity": "scatter",
                          "device_affinity": "balanced",
                          "host_fraction": f}, GB) for f in fractions}
    best = min(es, key=es.get)
    assert 45 <= best <= 75
    # and the hetero optimum beats both endpoints (host-only / device-only)
    assert es[best] < es[100] and es[best] < es[0]


def test_small_input_prefers_host_only(plat):
    """Paper Fig. 2a: 190 MB input -> offload overhead dominates."""
    es = {f: plat.energy({"host_threads": 48, "device_threads": 240,
                          "host_affinity": "scatter",
                          "device_affinity": "balanced",
                          "host_fraction": f}, 0.19)
          for f in range(0, 101, 10)}
    assert min(es, key=es.get) == 100


def test_few_host_threads_shift_work_to_device(plat):
    """Paper Fig. 2c: with 4 host threads ~70 % goes to the device."""
    es = {f: plat.energy({"host_threads": 4, "device_threads": 240,
                          "host_affinity": "scatter",
                          "device_affinity": "balanced",
                          "host_fraction": f}, GB)
          for f in range(0, 101, 5)}
    assert min(es, key=es.get) <= 40


def test_noise_is_seeded_and_small(plat):
    cfg = {"host_threads": 48, "device_threads": 240,
           "host_affinity": "none", "device_affinity": "balanced",
           "host_fraction": 60}
    a = plat.energy(cfg, GB, np.random.default_rng(7))
    b = plat.energy(cfg, GB, np.random.default_rng(7))
    c = plat.energy(cfg, GB, None)
    assert a == b
    assert abs(a - c) / c < 0.1
    assert a == RefModel().energy(cfg, GB, np.random.default_rng(7))


@pytest.mark.parametrize("gb", [GB, DATASETS_GB["cat"], 0.19])
def test_energies_equal_the_reference(plat, gb):
    """Scalar and batched times, energies and metric records over a grid
    of the paper's space, noise-free and seeded, with ``==``."""
    ref = RefModel()
    space = paper_space(workload_step=25)
    cols = space.enumerate_columns()
    np.testing.assert_array_equal(plat.energy_batch(cols, gb, None),
                                  ref.energy_batch(cols, gb, None))
    np.testing.assert_array_equal(
        plat.energy_batch(cols, gb, np.random.default_rng(3)),
        ref.energy_batch(cols, gb, np.random.default_rng(3)))
    got = plat.metrics_batch(cols, gb, np.random.default_rng(4))
    want = ref.metrics_batch(cols, gb, np.random.default_rng(4))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rng_p, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    for cfg in list(space.enumerate())[::97]:
        assert plat.energy(cfg, gb, None) == ref.energy(cfg, gb, None)
        assert plat.metrics(cfg, gb, rng_p) == ref.metrics(cfg, gb, rng_r)
    assert plat.host_only_time(gb) == ref.host_only_time(gb)
    assert plat.device_only_time(gb) == ref.device_only_time(gb)
    # the evaluator bundle: both oracle paths, the port's MetricsEvaluator
    ev = plat.evaluator(gb)
    cfg = next(iter(space.enumerate()))
    assert ev.metrics(cfg) == ref.metrics(cfg, gb, None)
    np.testing.assert_array_equal(ev.metrics_batch(cols)["time"],
                                  ref.energy_batch(cols, gb, None))
