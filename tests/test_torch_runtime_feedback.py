"""``repro_torch.runtime.feedback`` and the incremental BDTR machinery it
rides on, held against ``repro.runtime.feedback``: binning reuse
(``bin_rows``/``append_rows``), warm refits (``fit_more``), the online
loop's drift correction, compaction, persistence, and SAML restarting
from live data.

The loop is numpy throughout, so each scenario runs through both
packages on the same data and the refit trees must be equal array for
array; the packed predictor is ``predict_fn_torch`` on the CPU where the
reference has ``predict_fn_jax``.
"""

import numpy as np
import pytest

import repro.core as ref_core
import repro.runtime as ref_runtime
from repro_torch.core import (Autotuner, BoostedTreesRegressor, ConfigSpace,
                              Param, SurrogatePair)
from repro_torch.core.bdtr import append_rows, bin_features, bin_rows
from repro_torch.runtime import OnlineSurrogateLoop, TuningStore


def toy_data(n=200, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, 3))
    y = 3.0 * X[:, 0] + np.sin(4 * X[:, 1]) + 0.5 * X[:, 2] + shift
    return X, y


def assert_same_trees(port, ref):
    """The port's ensemble equals the reference's, array for array."""
    assert port.base_ == ref.base_
    assert len(port.trees_) == len(ref.trees_)
    for a, b in zip(port.trees_, ref.trees_):
        for name in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# -- binning reuse ---------------------------------------------------------------

def test_bin_rows_matches_original_codes():
    from repro.core.bdtr import bin_features as ref_bin, bin_rows as ref_rows

    X, _ = toy_data(300)
    binned = bin_features(X, max_bins=32)
    np.testing.assert_array_equal(bin_rows(binned, X), binned.codes)
    np.testing.assert_array_equal(binned.codes, ref_bin(X, 32).codes)
    np.testing.assert_array_equal(bin_rows(binned, X),
                                  ref_rows(ref_bin(X, 32), X))


def test_bin_rows_clamps_out_of_range():
    X = np.linspace(0, 1, 50)[:, None]
    binned = bin_features(X, max_bins=16)
    codes = bin_rows(binned, np.array([[-5.0], [0.5], [99.0]]))
    assert codes[0, 0] == 0
    assert codes[2, 0] == binned.n_bins[0] - 1


def test_append_rows_extends_codes_only():
    X, _ = toy_data(100)
    binned = bin_features(X, max_bins=16)
    X2, _ = toy_data(40, seed=1)
    ext = append_rows(binned, X2)
    assert len(ext.codes) == 140
    np.testing.assert_array_equal(ext.codes[:100], binned.codes)
    assert ext.split_value is binned.split_value    # bins are frozen


# -- fit_more --------------------------------------------------------------------

@pytest.mark.parametrize("method", ["exact", "hist"])
def test_fit_more_reduces_error_on_new_data(method):
    X, y = toy_data(300)
    Xn, yn = toy_data(200, seed=7, shift=2.0)       # drifted platform
    models = []
    for cls in (BoostedTreesRegressor, ref_core.BoostedTreesRegressor):
        model = cls(n_estimators=40, max_depth=3, tree_method=method).fit(X, y)
        err_before = np.abs(model.predict(Xn) - yn).mean()
        model.fit_more(Xn, yn, 40)
        err_after = np.abs(model.predict(Xn) - yn).mean()
        assert len(model.trees_) == 80
        assert err_after < 0.5 * err_before
        models.append(model)
    assert_same_trees(*models)


def test_fit_more_requires_fit_and_invalidates_pack():
    X, y = toy_data(100)
    with pytest.raises(ValueError):
        BoostedTreesRegressor().fit_more(X, y, 5)
    model = BoostedTreesRegressor(n_estimators=10, tree_method="hist")
    model.fit(X, y)
    torch_pred = model.predict_fn_torch("cpu")      # forces pack
    before = torch_pred(X[:5]).numpy()
    model.fit_more(X, y + 1.0, 20)
    after = model.predict_fn_torch("cpu")(X[:5]).numpy()
    # the packed torch predictor reflects the new trees...
    assert not np.allclose(before, after)
    # ...and agrees with the numpy path
    np.testing.assert_allclose(after, model.predict(X[:5]), rtol=1e-5,
                               atol=1e-5)
    # the one-row path sees the new trees too (its walk cache is dropped)
    assert model.predict(X[:1])[0] == model.predict(X[:2])[0]


def test_fit_more_with_incremental_binning_matches_fresh_binning():
    X, y = toy_data(300)
    Xn, yn = toy_data(100, seed=3, shift=1.0)
    allX, ally = np.vstack([X, Xn]), np.concatenate([y, yn])

    def fitted():
        return BoostedTreesRegressor(n_estimators=20, max_depth=3, seed=0,
                                     tree_method="hist").fit(X, y)

    a = fitted().fit_more(allX, ally, 10,
                          binned=append_rows(bin_features(X, 64), Xn))
    b = fitted().fit_more(allX, ally, 10)
    # same data, frozen-edge vs fresh binning: predictions stay close on
    # the training hull (bins differ only where new rows moved quantiles)
    q = toy_data(50, seed=9)[0]
    np.testing.assert_allclose(a.predict(q), b.predict(q), atol=0.2)


# -- the online loop -------------------------------------------------------------

def tiny_surrogate(core=None, host_bias=0.0, dev_bias=0.0, n_estimators=30):
    """A SurrogatePair over {threads, host_fraction} with analytic truth:
    t_host = f/100 * 8/threads + bias,  t_dev = (1-f/100) * 1.0 + bias.
    ``core`` picks the package (default: the port's)."""
    regressor = (core.BoostedTreesRegressor if core is not None
                 else BoostedTreesRegressor)
    pair_cls = core.SurrogatePair if core is not None else SurrogatePair
    threads = np.array([1, 2, 4, 8])
    fracs = np.arange(0, 101, 5)
    T, F = np.meshgrid(threads, fracs, indexing="ij")
    Xh = np.column_stack([T.ravel(), F.ravel()]).astype(float)
    yh = F.ravel() / 100.0 * 8.0 / T.ravel() + host_bias
    Xd = np.column_stack([T.ravel(), F.ravel()]).astype(float)
    yd = (1.0 - F.ravel() / 100.0) * 1.0 + dev_bias
    host = regressor(n_estimators=n_estimators, max_depth=3,
                     tree_method="hist").fit(Xh, yh)
    dev = regressor(n_estimators=n_estimators, max_depth=3,
                    tree_method="hist").fit(Xd, yd)

    def feats(cfg):
        return np.asarray([float(cfg["threads"]),
                           float(cfg["host_fraction"])])

    return pair_cls(host=host, device=dev, host_features=feats,
                    device_features=feats)


def test_observe_refit_corrects_drift():
    cfg = {"threads": 4, "host_fraction": 50}
    pairs = []
    for core, runtime in ((None, None), (ref_core, ref_runtime)):
        pair = tiny_surrogate(core)
        loop_cls = (runtime.OnlineSurrogateLoop if runtime is not None
                    else OnlineSurrogateLoop)
        loop = loop_cls(pair, refit_every=16, n_new_trees=40)
        base = pair.host.predict(pair.host_features(cfg)[None, :])[0]
        # live platform runs 0.5s slower on the host side
        rng = np.random.default_rng(2)
        for _ in range(16):
            c = {"threads": int(rng.choice([1, 2, 4, 8])),
                 "host_fraction": int(rng.choice(np.arange(0, 101, 5)))}
            t_true = c["host_fraction"] / 100.0 * 8.0 / c["threads"] + 0.5
            loop.observe(c, t_true, None)
        assert loop.n_refits == 1                   # auto-refit fired
        updated = pair.host.predict(pair.host_features(cfg)[None, :])[0]
        assert updated == pytest.approx(base + 0.5, abs=0.2)
        pairs.append(pair)
    assert_same_trees(pairs[0].host, pairs[1].host)
    assert_same_trees(pairs[0].device, pairs[1].device)


def test_saml_restarts_from_live_data():
    """After live observations show the device 3x slower than the offline
    grid claimed, SAML's optimum moves host-ward — in both packages, to the
    same configurations."""
    outcome = []
    for core, runtime in ((None, None), (ref_core, ref_runtime)):
        pair = tiny_surrogate(core)
        space_cls = core.ConfigSpace if core is not None else ConfigSpace
        param = core.Param if core is not None else Param
        space = space_cls([
            param("threads", (1, 2, 4, 8)),
            param("host_fraction", tuple(range(0, 101, 5))),
        ])
        tuner = core.Autotuner if core is not None else Autotuner

        def tune():
            with pytest.warns(DeprecationWarning):
                return tuner(space, lambda c: 0.0, surrogate=pair).tune_saml(
                    iterations=400, seed=0)

        before = tune().best_config["host_fraction"]
        loop_cls = (runtime.OnlineSurrogateLoop if runtime is not None
                    else OnlineSurrogateLoop)
        loop = loop_cls(pair, refit_every=200, n_new_trees=60)
        rng = np.random.default_rng(3)
        for _ in range(120):
            c = {"threads": int(rng.choice([1, 2, 4, 8])),
                 "host_fraction": int(rng.choice(np.arange(0, 101, 5)))}
            t_dev = (1.0 - c["host_fraction"] / 100.0) * 3.0  # 3x slower now
            loop.observe(c, None, t_dev, auto_refit=False)
        assert loop.refit(force=True)
        after = tune().best_config["host_fraction"]
        assert after > before, (before, after)
        outcome.append((before, after))
    assert outcome[0] == outcome[1]


def test_max_trees_compaction_bounds_ensemble():
    pairs = []
    for core, runtime in ((None, None), (ref_core, ref_runtime)):
        pair = tiny_surrogate(core, n_estimators=30)
        loop_cls = (runtime.OnlineSurrogateLoop if runtime is not None
                    else OnlineSurrogateLoop)
        loop = loop_cls(pair, refit_every=8, n_new_trees=10, max_trees=45)
        rng = np.random.default_rng(5)
        for _ in range(40):                     # 5 auto-refits
            c = {"threads": int(rng.choice([1, 2, 4, 8])),
                 "host_fraction": int(rng.choice(np.arange(0, 101, 5)))}
            loop.observe(c, 1.0, 1.0)
        assert loop.n_refits == 5
        # growth is bounded: 30 +10 (=40) then compaction retrains to 30,
        # never exceeding max_trees
        assert len(pair.host.trees_) <= 45
        assert len(pair.device.trees_) <= 45
        pairs.append(pair)
    assert_same_trees(pairs[0].host, pairs[1].host)


def test_observation_persistence_via_store(tmp_path):
    pair = tiny_surrogate()
    store = TuningStore(tmp_path / "t.json", devices="pinned")
    loop = OnlineSurrogateLoop(pair, refit_every=1000)
    for f in (10, 50, 90):
        loop.observe({"threads": 2, "host_fraction": f}, 0.5, 0.7,
                     auto_refit=False)
    loop.save_to(store, "sig0")

    fresh = OnlineSurrogateLoop(tiny_surrogate(), refit_every=1000)
    assert fresh.load_from(store, "sig0") == 6      # 3 host + 3 device rows
    assert fresh.n_observations == 6
    assert fresh.load_from(store, "missing") == 0
    # the side-car reads in the reference's loop too (one file format)
    ref_store = ref_runtime.TuningStore(tmp_path / "t.json", devices="pinned")
    ref_loop = ref_runtime.OnlineSurrogateLoop(tiny_surrogate(ref_core),
                                               refit_every=1000)
    assert ref_loop.load_from(ref_store, "sig0") == 6
