"""repro_torch SA engines and the strategy registry held against ``repro``.

The scalar chain and every scalar strategy draw from the same numpy
stream in both packages, so results are equal for equal seeds.  The
vectorized chains draw from ``torch.Generator`` instead of
``jax.random`` and are compared by outcome on a deterministic quadratic
energy: the port's best energy is no worse than the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sa as ref_sa
from repro.core import space as ref_space
from repro.tune import TuningSession as RefSession
from repro.tune import list_strategies as ref_list_strategies
from repro_torch.core import sa as port_sa
from repro_torch.core import space as port_space
from repro_torch.core.evaluators import SurrogatePair
from repro_torch.tune import (Time, TuningSession, get_strategy,
                              list_strategies, register_strategy)
from repro_torch.tune.strategy import StrategyOutcome

TARGET = {"a": 6, "b": 40, "kind": "z", "c": 3}


def make_space(mod):
    return mod.ConfigSpace([
        mod.Param("a", tuple(range(1, 13))),
        mod.Param("b", tuple(range(0, 101, 10))),
        mod.Param("kind", ("x", "y", "z"), ordinal=False),
        mod.Param("c", (1, 2, 3, 4, 5)),
    ])


def energy(cfg):
    """Deterministic quadratic bowl with its minimum (1.0) at TARGET."""
    return (1.0 + (cfg["a"] - 6) ** 2 + ((cfg["b"] - 40) / 10.0) ** 2
            + (0.0 if cfg["kind"] == "z" else 2.0) + (cfg["c"] - 3) ** 2)


def feature_energy(space):
    """The same bowl over ``space.encode`` features, per framework."""
    names = space.feature_names
    ia, ib, ic = names.index("a"), names.index("b"), names.index("c")
    iz = names.index("kind=z")

    def over(X, where):
        return (1.0 + (X[:, ia] - 6) ** 2 + ((X[:, ib] - 40) / 10.0) ** 2
                + where(X[:, iz] > 0.5) + (X[:, ic] - 3) ** 2)

    return (lambda X: over(X, lambda z: jnp.where(z, 0.0, 2.0)),
            lambda X: over(X, lambda z: torch.where(z, 0.0, 2.0)))


def test_schedule_matches_reference():
    for mod_ref, mod_port in [(ref_sa.SASchedule, port_sa.SASchedule)]:
        assert mod_port().n_iterations() == mod_ref().n_iterations()
        for n in (1, 50, 300):
            a, b = mod_ref.for_iterations(n), mod_port.for_iterations(n)
            assert a.cooling_rate == b.cooling_rate
            assert a.n_iterations() == b.n_iterations()


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_scalar_sa_same_seed_same_result(seed):
    kw = dict(seed=seed, max_iterations=250, checkpoint_at=(10, 100),
              record_history=True)
    ref = ref_sa.simulated_annealing(
        make_space(ref_space), energy,
        schedule=ref_sa.SASchedule.for_iterations(250), **kw)
    port = port_sa.simulated_annealing(
        make_space(port_space), energy,
        schedule=port_sa.SASchedule.for_iterations(250), **kw)
    assert port.best_config == ref.best_config
    assert port.best_energy == ref.best_energy
    assert port.n_evaluations == ref.n_evaluations
    assert port.history == ref.history
    assert port.checkpoints == ref.checkpoints


def test_scalar_sa_warm_start_and_validation():
    space = make_space(port_space)
    res = port_sa.simulated_annealing(space, energy, initial=TARGET,
                                      max_iterations=20)
    assert res.best_config == TARGET and res.best_energy == 1.0
    with pytest.raises(ValueError):
        port_sa.simulated_annealing(space, energy,
                                    initial=dict(TARGET, a=99))


@pytest.mark.parametrize("seed", [0, 3])
def test_vectorized_sa_no_worse_than_reference(seed):
    space_ref, space_port = make_space(ref_space), make_space(port_space)
    e_jax, e_torch = feature_energy(space_port)
    kw = dict(n_chains=16, n_iterations=300, seed=seed,
              checkpoint_at=(1, 50, 300, 999))
    ref = ref_sa.vectorized_sa(
        space_ref, e_jax, schedule=ref_sa.SASchedule.for_iterations(300), **kw)
    port = port_sa.vectorized_sa(
        space_port, e_torch, device="cpu",
        schedule=port_sa.SASchedule.for_iterations(300), **kw)
    assert port.best_energy <= ref.best_energy + 1e-6
    assert port.best_energy == pytest.approx(energy(port.best_config))
    assert port.best_energy == pytest.approx(1.0)     # the global minimum
    assert port.n_evaluations == ref.n_evaluations == 16 * 301
    assert sorted(port.checkpoints) == sorted(ref.checkpoints) == [1, 50, 300]
    cps = [port.checkpoints[k][0] for k in (1, 50, 300)]
    assert cps[0] >= cps[1] >= cps[2] == pytest.approx(port.best_energy)
    for e, cfg in port.checkpoints.values():
        assert e == pytest.approx(energy(cfg))
    assert len(port.history) == len(ref.history)


def test_vectorized_sa_is_seeded_and_defaults_to_the_card():
    space = make_space(port_space)
    _, e_torch = feature_energy(space)
    runs = [port_sa.vectorized_sa(space, e_torch, n_chains=4,
                                  n_iterations=40, seed=5, device="cpu")
            for _ in range(2)]
    assert runs[0].best_config == runs[1].best_config
    assert runs[0].history == runs[1].history
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_sa.vectorized_sa(space, e_torch, n_chains=2, n_iterations=2)


# -- the strategy registry ------------------------------------------------------

def test_same_strategies_registered():
    assert list_strategies() == ref_list_strategies()
    assert get_strategy("SAML").uses_surrogate
    assert not get_strategy("sam").uses_surrogate
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("nope")


def surrogate(cfg):
    return energy(cfg) + 0.25 * (cfg["c"] - 3)       # a biased predictor


SCALAR_RUNS = [
    ("em", {}),
    ("eml", {"engine": "scalar"}),
    ("sam", {"iterations": 120, "seed": 4, "checkpoints": (10, 60)}),
    ("saml", {"iterations": 120, "seed": 4, "checkpoints": (10, 60)}),
    ("random", {"samples": 80, "seed": 4, "checkpoints": (5,)}),
    ("hillclimb", {"iterations": 120, "seed": 4, "patience": 5}),
]


@pytest.mark.parametrize("name,opts", SCALAR_RUNS, ids=[r[0] for r in SCALAR_RUNS])
def test_strategy_results_equal_reference(name, opts):
    ref = RefSession(make_space(ref_space), evaluator=energy,
                     surrogate=surrogate, n_training_experiments=17
                     ).run(name, **opts)
    port = TuningSession(make_space(port_space), evaluator=energy,
                         surrogate=surrogate, n_training_experiments=17,
                         device="cpu").run(name, **opts)
    for field in ("strategy", "best_config", "best_energy_search",
                  "best_energy_measured", "n_experiments", "n_predictions",
                  "n_training_experiments", "space_size", "checkpoints",
                  "objective", "best_metrics", "n_measured"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.experiments_fraction == ref.experiments_fraction


def test_em_batched_and_pareto_front():
    from repro_torch.tune import Energy, Pareto

    space = make_space(port_space)

    def metrics_batch(cols):
        t = (1.0 + (cols["a"] - 6.0) ** 2 + (cols["c"] - 3.0) ** 2)
        return {"time": t, "energy": 100.0 / cols["a"] + cols["b"]}

    def metrics(cfg):
        out = metrics_batch({k: np.asarray([v]) for k, v in cfg.items()
                             if k != "kind"})
        return {k: float(v[0]) for k, v in out.items()}

    res = TuningSession(space, evaluator=metrics, evaluator_batch=metrics_batch,
                        objective=Pareto(Time(), Energy(), scales=(1.0, 50.0)),
                        device="cpu").run("em")
    assert res.n_experiments == space.size()
    assert res.pareto_front and res.objective == "pareto(time,energy)"
    scores = np.asarray([row[0] for row in res.pareto_front])
    for i, p in enumerate(scores):       # nothing on the front is dominated
        assert not np.any(np.all(scores <= p, axis=1)
                          & np.any(scores < p, axis=1))


def test_saml_vectorized_through_the_session():
    space = make_space(port_space)

    def builder(sp, device):
        assert torch.device(device).type == "cpu"
        return feature_energy(sp)[1]

    pair = SurrogatePair(host=None, device=None, host_features=None,
                         device_features=None, energy_fn_torch_builder=builder)
    pair.predict_energy = energy                       # scalar surrogate form
    res = TuningSession(space, evaluator=energy, surrogate=pair,
                        device="cpu").run("saml", engine="vectorized",
                                          iterations=200, n_chains=8, seed=1)
    assert res.best_config == TARGET
    assert res.n_experiments == 0 and res.n_predictions == 8 * 201
    assert res.best_energy_measured == 1.0

    bare = SurrogatePair(host=None, device=None, host_features=None,
                         device_features=None)
    bare.predict_energy = energy
    with pytest.raises(ValueError, match="energy_fn_torch_builder"):
        TuningSession(space, surrogate=bare, device="cpu").run(
            "saml", engine="vectorized", iterations=5)
    with pytest.raises(ValueError, match="unknown SAML engine"):
        TuningSession(space, surrogate=surrogate, device="cpu").run(
            "saml", engine="bogus")


def test_strategies_need_their_oracles_and_new_ones_register():
    space = make_space(port_space)
    with pytest.raises(ValueError, match="needs a measurement"):
        TuningSession(space, surrogate=surrogate, device="cpu").run("sam")
    with pytest.raises(ValueError, match="needs a trained surrogate"):
        TuningSession(space, evaluator=energy, device="cpu").run("saml")
    with pytest.raises(ValueError, match="no strategy"):
        TuningSession(space, evaluator=energy, device="cpu").run()

    @register_strategy("first_config", description="takes the first config")
    def first_config(ctx, **_):
        cfg = next(ctx.space.enumerate())
        return StrategyOutcome(cfg, ctx.measure(cfg), n_experiments=1)

    try:
        res = TuningSession(space, evaluator=energy, strategy="first_config",
                            device="cpu").run()
        assert res.strategy == "FIRST_CONFIG" and res.n_experiments == 1
        assert "first_config" in list_strategies()
    finally:
        from repro_torch.tune import strategy as strategy_mod
        strategy_mod._REGISTRY.pop("first_config")


# -- evaluators -----------------------------------------------------------------------

def test_evaluators_match_reference():
    """Measurement counting and the SurrogatePair's E = max(T_host, T_dev)
    composition, scalar and batched, against the reference's."""
    from repro.core import bdtr as ref_bdtr, evaluators as ref_ev
    from repro_torch.core import bdtr as port_bdtr, evaluators as port_ev

    rng = np.random.default_rng(0)
    X = np.column_stack([rng.integers(1, 13, 200), rng.integers(0, 101, 200)]
                        ).astype(np.float64)
    y_h = X[:, 1] / X[:, 0] + 1.0
    y_d = (100.0 - X[:, 1]) / 4.0 + 0.5

    def features(cfg):
        return np.asarray([float(cfg["a"]), float(cfg["host_fraction"])])

    def features_cols(cols):
        return np.column_stack([np.asarray(cols["a"], np.float64),
                                np.asarray(cols["host_fraction"], np.float64)])

    pairs = []
    for bd, ev in ((ref_bdtr, ref_ev), (port_bdtr, port_ev)):
        fit = lambda y: bd.BoostedTreesRegressor(n_estimators=15).fit(X, y)
        pairs.append((ev, ev.SurrogatePair(
            host=fit(y_h), device=fit(y_d), host_features=features,
            device_features=features, host_features_cols=features_cols,
            device_features_cols=features_cols)))
    cfgs = [{"a": int(a), "host_fraction": int(f)}
            for a, f in [(1, 0), (6, 50), (12, 100), (3, 30)]]
    cols = {"a": np.asarray([c["a"] for c in cfgs]),
            "host_fraction": np.asarray([c["host_fraction"] for c in cfgs])}
    (ref_mod, ref_pair), (port_mod, port_pair) = pairs
    for cfg in cfgs:
        assert port_pair.predict_energy(cfg) == ref_pair.predict_energy(cfg)
    np.testing.assert_array_equal(port_pair.predict_energy_batch(cols),
                                  ref_pair.predict_energy_batch(cols))
    learned, batched = (port_mod.LearnedEvaluator(port_pair),
                        port_mod.BatchedLearnedEvaluator(port_pair))
    assert learned(cfgs[1]) == ref_mod.LearnedEvaluator(ref_pair)(cfgs[1])
    np.testing.assert_array_equal(batched(cols),
                                  port_pair.predict_energy_batch(cols))
    assert (learned.n_predictions, batched.n_predictions) == (1, 4)

    space = make_space(port_space)
    meas = port_mod.MeasurementEvaluator(energy, space)
    assert meas(TARGET) == meas(dict(TARGET)) == 1.0
    assert meas.n_experiments == 1
    # Time scores a pair through its own composition
    assert Time().surrogate_scalar(port_pair) == port_pair.predict_energy
    with pytest.raises(ValueError, match="energy_fn_torch_builder"):
        Time().surrogate_torch_builder(port_pair)
