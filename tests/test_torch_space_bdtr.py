"""repro_torch.core space + BDTR held against the JAX package.

The same inputs (made from a seed with numpy) go through ``repro`` and
``repro_torch``.  Tolerances: ``ConfigSpace`` results are equal (they are
integers or float64 copies of the values); BDTR ``fit``/``predict`` are
the same numpy arithmetic, held to 1e-6; the packed float32 tree walk
(``predict_fn_torch`` vs ``predict_fn_jax``) to 1e-5 relative to the
prediction scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bdtr as ref_bdtr
from repro.core import space as ref_space
from repro.runtime.store import space_fingerprint as ref_fingerprint
from repro_torch.convert import bdtr_from_arrays
from repro_torch.core import bdtr as port_bdtr
from repro_torch.core import space as port_space
from repro_torch.runtime.store import space_fingerprint as port_fingerprint

SPACES = {
    "paper10": lambda m: m.paper_space(workload_step=10),
    "dna": lambda m: m.ConfigSpace([
        m.Param("map_chunk", (256, 512, 1024, 2048)),
        m.Param("count_chunk", (256, 512, 1024, 2048)),
        m.Param("block_threads", (64, 128, 256, 512, 1024))]),
    "mixed": lambda m: m.ConfigSpace([
        m.Param("a", (1, 2, 3)),
        m.Param("kind", ("x", "y", "z", "w"), ordinal=False),
        m.Param("b", (0.5, 1.5))]),
}


def both(name):
    return SPACES[name](ref_space), SPACES[name](port_space)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_structure_equal(name):
    ref, port = both(name)
    assert port.size() == ref.size()
    assert port.names == ref.names
    assert port.feature_dim == ref.feature_dim
    assert port.feature_names == ref.feature_names
    np.testing.assert_array_equal(port.cardinalities, ref.cardinalities)
    np.testing.assert_array_equal(port.index_grid(), ref.index_grid())
    assert port_fingerprint(port) == ref_fingerprint(ref)
    assert port_fingerprint(port) == ref_fingerprint(port)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_encodings_equal(name):
    ref, port = both(name)
    rng = np.random.default_rng(3)
    cfgs = [ref.random(rng) for _ in range(20)]
    for cfg in cfgs:
        np.testing.assert_array_equal(port.encode(cfg), ref.encode(cfg))
        np.testing.assert_array_equal(port.to_indices(cfg),
                                      ref.to_indices(cfg))
    np.testing.assert_array_equal(port.encode_many(cfgs),
                                  ref.encode_many(cfgs))
    assert port.encode_many([]).shape == ref.encode_many([]).shape
    np.testing.assert_array_equal(port.encode_all(), ref.encode_all())
    t_ref, o_ref = ref.index_feature_table()
    t_port, o_port = port.index_feature_table()
    np.testing.assert_array_equal(t_port, t_ref)
    np.testing.assert_array_equal(o_port, o_ref)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_random_and_neighbor_share_the_numpy_stream(name):
    ref, port = both(name)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    cur_ref, cur_port = ref.random(r1), port.random(r2)
    assert cur_port == cur_ref
    for _ in range(30):
        cur_ref, cur_port = ref.neighbor(cur_ref, r1), port.neighbor(cur_port, r2)
        assert cur_port == cur_ref
    assert list(port.enumerate())[:50] == list(ref.enumerate())[:50]


def test_space_rejects_what_the_reference_rejects():
    for mod in (ref_space, port_space):
        with pytest.raises(ValueError):
            mod.Param("p", ())
        with pytest.raises(ValueError):
            mod.Param("p", (1, 1))
        with pytest.raises(ValueError):
            mod.ConfigSpace([])
        space = mod.ConfigSpace([mod.Param("p", (1, 2))])
        with pytest.raises(KeyError):
            space.validate({})
        with pytest.raises(ValueError):
            space.validate({"p": 3})


# -- BDTR ---------------------------------------------------------------------

def regression_data(seed=0, n=160, d=4, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        X = rng.integers(0, 8, (n, d)).astype(np.float64)
    else:
        X = rng.standard_normal((n, d))
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * X[:, 3] ** 2
         + 0.01 * rng.standard_normal(n))
    return X, y


FIT_CASES = [
    dict(tree_method="exact"),
    dict(tree_method="hist"),
    dict(tree_method="hist", max_bins=8),
    dict(tree_method="exact", subsample=0.7, seed=5),
    dict(tree_method="hist", subsample=0.7, seed=5),
    dict(tree_method="hist", min_samples_leaf=1, max_depth=3),
]


@pytest.mark.parametrize("kw", FIT_CASES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("grid", [False, True], ids=["normal", "grid"])
def test_bdtr_fit_predict_matches_reference(kw, grid):
    X, y = regression_data(1, grid=grid)
    Xq, _ = regression_data(2, n=64, grid=grid)
    ref = ref_bdtr.BoostedTreesRegressor(n_estimators=25, **kw).fit(X, y)
    port = port_bdtr.BoostedTreesRegressor(n_estimators=25, **kw).fit(X, y)
    assert len(port.trees_) == len(ref.trees_)
    assert abs(port.base_ - ref.base_) <= 1e-12
    np.testing.assert_allclose(port.predict(X), ref.predict(X), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.predict(Xq), ref.predict(Xq), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["exact", "hist"])
def test_bdtr_fit_more_matches_reference(method):
    X, y = regression_data(3)
    X2, y2 = regression_data(4, n=60)
    out = []
    for mod in (ref_bdtr, port_bdtr):
        m = mod.BoostedTreesRegressor(n_estimators=10, tree_method=method)
        m.fit(X, y).fit_more(np.concatenate([X, X2]),
                             np.concatenate([y, y2]), 6)
        assert len(m.trees_) == 16
        out.append(m.predict(X2))
    np.testing.assert_allclose(out[1], out[0], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        port_bdtr.BoostedTreesRegressor().fit_more(X, y, 1)


def test_binning_helpers_match_reference():
    X, _ = regression_data(5, n=300)
    X_new, _ = regression_data(6, n=40)
    b_ref, b_port = ref_bdtr.bin_features(X, 16), port_bdtr.bin_features(X, 16)
    np.testing.assert_array_equal(b_port.codes, b_ref.codes)
    np.testing.assert_array_equal(b_port.n_bins, b_ref.n_bins)
    for a, b in zip(b_port.split_value, b_ref.split_value):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_bdtr.bin_rows(b_port, X_new),
                                  ref_bdtr.bin_rows(b_ref, X_new))
    np.testing.assert_array_equal(port_bdtr.append_rows(b_port, X_new).codes,
                                  ref_bdtr.append_rows(b_ref, X_new).codes)
    with pytest.raises(ValueError):
        port_bdtr.bin_rows(b_port, X_new[:, :2])


@pytest.mark.parametrize("fit", ["fit_tree", "fit_tree_hist"])
def test_single_tree_matches_reference(fit):
    X, y = regression_data(7)
    if fit == "fit_tree":
        t_ref = ref_bdtr.fit_tree(X, y, max_depth=3)
        t_port = port_bdtr.fit_tree(X, y, max_depth=3)
    else:
        t_ref = ref_bdtr.fit_tree_hist(ref_bdtr.bin_features(X, 32), y)
        t_port = port_bdtr.fit_tree_hist(port_bdtr.bin_features(X, 32), y)
    for field in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(t_port, field),
                                      getattr(t_ref, field))
    assert t_port.depth == t_ref.depth


def tree_arrays(model):
    return [{f: getattr(t, f) for f in
             ("feature", "threshold", "left", "right", "value", "depth")}
            for t in model.trees_]


@pytest.mark.parametrize("method", ["exact", "hist"])
def test_bdtr_from_arrays_round_trip(method):
    """A surrogate fitted by the reference, handed over as numpy arrays,
    predicts the same numbers in the port (exactly: same arithmetic)."""
    X, y = regression_data(8)
    Xq, _ = regression_data(9, n=50)
    ref = ref_bdtr.BoostedTreesRegressor(n_estimators=20,
                                         tree_method=method).fit(X, y)
    port = bdtr_from_arrays(tree_arrays(ref), ref.base_, ref.learning_rate,
                            tree_method=method)
    np.testing.assert_array_equal(port.predict(Xq), ref.predict(Xq))
    # and it can go on boosting where the reference stopped
    port.fit_more(X, y, 3)
    ref.fit_more(X, y, 3)
    np.testing.assert_allclose(port.predict(Xq), ref.predict(Xq),
                               atol=1e-6, rtol=0)


def test_bdtr_from_arrays_needs_a_depth():
    X, y = regression_data(8)
    ref = ref_bdtr.BoostedTreesRegressor(n_estimators=2).fit(X, y)
    arrays = [{k: v for k, v in t.items() if k != "depth"}
              for t in tree_arrays(ref)]
    with pytest.raises(ValueError, match="depth"):
        bdtr_from_arrays(arrays, ref.base_, ref.learning_rate)
    port = bdtr_from_arrays(arrays, ref.base_, ref.learning_rate, max_depth=4)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


@pytest.mark.parametrize("method,depth", [("exact", 4), ("hist", 3),
                                          ("hist", 6)])
def test_predict_fn_torch_matches_predict_fn_jax(method, depth):
    X, y = regression_data(10, grid=True)
    Xq, _ = regression_data(11, n=96, grid=True)
    kw = dict(n_estimators=30, tree_method=method, max_depth=depth)
    ref = ref_bdtr.BoostedTreesRegressor(**kw).fit(X, y)
    port = port_bdtr.BoostedTreesRegressor(**kw).fit(X, y)
    want = np.asarray(ref.predict_fn_jax()(jnp.asarray(Xq)))
    got = port.predict_fn_torch("cpu")(torch.from_numpy(Xq))
    assert got.dtype == torch.float32 and got.shape == (96,)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale, rtol=0)
    # the float32 walk also agrees with the float64 numpy predictor
    np.testing.assert_allclose(got.numpy(), port.predict(Xq),
                               atol=1e-4 * scale, rtol=0)


def test_pack_returns_cpu_tensors_and_caches():
    X, y = regression_data(12)
    port = port_bdtr.BoostedTreesRegressor(n_estimators=5).fit(X, y)
    packed = port.pack()
    assert packed is port.pack()
    feat, thr, left, right, value, base, lr, depth = packed
    assert feat.shape == thr.shape == left.shape == right.shape == value.shape
    assert feat.shape[0] == 5 and feat.dtype == torch.int64
    assert thr.dtype == value.dtype == torch.float32
    assert depth == 4 and lr == pytest.approx(0.1)
    port.fit(X, y)
    assert port.pack() is not packed


def test_predict_fn_torch_defaults_to_the_card():
    X, y = regression_data(13)
    port = port_bdtr.BoostedTreesRegressor(n_estimators=2).fit(X, y)
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.predict_fn_torch()


def test_accuracy_metrics_match_reference():
    a, b = np.array([1.0, 2.0, 4.0]), np.array([1.5, 1.0, 4.0])
    np.testing.assert_array_equal(port_bdtr.absolute_error(a, b),
                                  ref_bdtr.absolute_error(a, b))
    np.testing.assert_array_equal(port_bdtr.percent_error(a, b),
                                  ref_bdtr.percent_error(a, b))
