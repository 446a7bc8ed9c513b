"""repro_torch.core.hetero held against repro.core.hetero: the rebalance
controller (equal outputs) and the two-group runner, in-process on a
``VirtualClock`` (the reference runs its runner test on forced host
devices in a subprocess; the simulated devices here give the same
timings on both sides, so the trajectories are compared exactly)."""

import numpy as np
import pytest
import torch

from repro.core import hetero as ref_hetero
from repro.runtime import simulate as ref_sim
from repro_torch.core import hetero
from repro_torch.core.hetero import proportional_rebalance
from repro_torch.runtime import simulate as port_sim

SIDES = {"ref": (ref_hetero, ref_sim), "port": (hetero, port_sim)}


def both(f, ta, tb, **kw):
    """The port's answer, after checking it is the reference's."""
    out = proportional_rebalance(f, ta, tb, **kw)
    assert out == ref_hetero.proportional_rebalance(f, ta, tb, **kw)
    return out


# -- proportional_rebalance (pure controller math) ------------------------------

def test_rebalance_fixed_point_when_rates_equal():
    assert both(0.5, 1.0, 1.0) == pytest.approx(0.5)
    assert both(0.8, 1.0, 1.0) == pytest.approx(0.8)


def test_rebalance_moves_toward_faster_group():
    f1 = both(0.5, 1.0, 2.0)
    assert f1 > 0.5
    target = (0.5 / 1.0) / (0.5 / 1.0 + 0.5 / 2.0)
    assert f1 == pytest.approx(0.5 + 0.5 * (target - 0.5))
    assert both(0.5, 2.0, 1.0) < 0.5


def test_rebalance_converges_to_rate_ratio():
    f = g = 0.5
    for _ in range(30):
        f = proportional_rebalance(f, f / 1.0, (1 - f) / 0.25)
        g = ref_hetero.proportional_rebalance(g, g / 1.0, (1 - g) / 0.25)
    assert f == g == pytest.approx(0.8, abs=1e-3)


def test_rebalance_no_damping_jumps_to_target():
    assert both(0.5, 1.0, 3.0, damping=1.0) == pytest.approx(0.75)


def test_rebalance_survives_degenerate_inputs():
    for f in (0.0, 1.0, 0.5):
        for ta, tb in ((0.0, 1.0), (1.0, 0.0), (0.0, 0.0)):
            assert 0.0 < both(f, ta, tb) < 1.0


def test_rebalance_nonpositive_times_keep_fraction():
    assert both(0.7, 0.0, 1.0) == pytest.approx(0.7)
    assert both(0.7, 1.0, -3.0) == pytest.approx(0.7)
    assert both(0.7, -1.0, -1.0) == pytest.approx(0.7)


def test_rebalance_output_clamped_away_from_0_and_1():
    assert both(0.5, 1e-12, 10.0, damping=1.0) <= 1.0 - 1e-3
    assert both(0.5, 10.0, 1e-12, damping=1.0) >= 1e-3
    assert both(0.5, 1e-12, 10.0, damping=1.0,
                min_fraction=0.05) == pytest.approx(0.95)


def test_rebalance_recovers_from_near_starvation():
    f = 1.0 - 1e-3
    for _ in range(40):
        f = both(f, f / 1.0, (1 - f) / 1.0)
    assert f == pytest.approx(0.5, abs=1e-2)


# -- HeterogeneousRunner --------------------------------------------------------

def sim_runner(side: str, per_row: float):
    """A fast group of 4 and a 3x slower group of 4 on a virtual clock: a
    dispatch returns at once and is ready ``per_row * rows`` later."""
    hmod, smod = SIDES[side]
    clock = smod.VirtualClock()
    ga = hmod.DeviceGroup("fast", [smod.FakeDevice()] * 4)
    gb = hmod.DeviceGroup("slow", [smod.FakeDevice()] * 4, work_multiplier=3)

    def builder(group):
        per = per_row * group.work_multiplier / len(group.devices)

        def fn(batch):
            return smod.SimReadyAt(None, clock.now() + per
                                   * batch["x"].shape[0], clock)
        return fn

    return hmod.HeterogeneousRunner(builder, ga, gb, fraction=0.5,
                                    clock=clock)


def test_runner_split_and_tune_fraction_sa():
    x = np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)
    runner = sim_runner("port", 0.002)
    a, b = runner._split({"x": torch.as_tensor(x)})
    assert a["x"].shape[0] % 4 == 0
    assert a["x"].shape[0] + b["x"].shape[0] == 64
    torch.testing.assert_close(torch.cat([a["x"], b["x"]]),
                               torch.as_tensor(x), rtol=0, atol=0)
    runner.step({"x": torch.as_tensor(x)})
    assert runner.step({"x": torch.as_tensor(x)})["rows_a"] + \
        runner.history[-1]["rows_b"] == 64

    # the paper's offline loop: SAM over the fraction space with measured
    # step times as the energy, the same seeded search on both sides
    out = {}
    for side in SIDES:
        sim = sim_runner(side, 0.01)
        batch = {"x": x if side == "ref" else torch.as_tensor(x)}
        e_half = sim.step(batch, rebalance=False)["t_step"]
        if side == "ref":
            with pytest.warns(DeprecationWarning):
                best = sim.tune_fraction_sa(batch, iterations=40, seed=0)
        else:       # the port keeps tune_fraction, not its deprecated alias
            best = sim.tune_fraction(batch, strategy="sam", iterations=40,
                                     seed=0)
        e_best = sim.step(batch, rebalance=False)["t_step"]
        out[side] = (best, e_half, e_best,
                     [(r["fraction"], r["t_step"], r["rows_a"])
                      for r in sim.history])
    assert out["port"] == out["ref"]
    best, e_half, e_best, _ = out["port"]
    assert 0.6 <= best <= 0.9, best
    assert e_best < 0.8 * e_half + 0.02, (e_best, e_half, best)
