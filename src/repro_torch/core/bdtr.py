"""Boosted Decision Tree Regression (BDTR), from scratch.

The paper evaluates candidate system configurations with a supervised
regression model and reports that Boosted Decision Tree Regression was the
most accurate of the models they tried.  This module implements
least-squares gradient boosting (Friedman's LSBoost) over depth-limited
regression trees:

    F_0(x)   = mean(y)
    r_m      = y - F_{m-1}(X)
    tree_m   = fit_regression_tree(X, r_m)
    F_m(x)   = F_{m-1}(x) + lr * tree_m(x)

Trees are grown greedily with exact SSE-minimising splits over (optionally
quantile-binned) thresholds.  Fitting runs in numpy on the host; prediction
is available both in numpy and as a batched PyTorch function over packed
node tensors (on the device the caller names), so the vectorized SA chains
can query the surrogate for all chains at once.

Two tree-growing engines share the same tree semantics:

  * ``tree_method="exact"`` — per-node argsort over every feature
    (the original reference splitter),
  * ``tree_method="hist"``  — LightGBM-style histogram fitting: features
    are quantile-binned ONCE per ``fit``, per-node split search is two
    ``bincount`` calls + prefix sums, and each child inherits its
    histogram from the parent by sibling subtraction.  On data whose
    features have at most ``max_bins`` distinct values (e.g. the paper's
    measurement grids) the candidate splits partition the training rows
    exactly like the exact splitter's, so predictions agree at every
    trained value; threshold *placement* uses global bin edges, so the
    two engines may route queries differently inside value gaps the
    node's rows do not straddle (off-grid inputs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

__all__ = ["BoostedTreesRegressor", "fit_tree", "fit_tree_hist",
           "BinnedFeatures", "bin_features", "bin_rows", "append_rows",
           "Tree"]


@dataclass
class Tree:
    """A regression tree packed into arrays (complete-traversal friendly).

    ``feature[i] < 0`` marks node ``i`` as a leaf with prediction
    ``value[i]``; internal nodes route ``x[feature] <= threshold`` to
    ``left`` else ``right``.
    """

    feature: np.ndarray      # (n_nodes,) int32, -1 for leaves
    threshold: np.ndarray    # (n_nodes,) float64
    left: np.ndarray         # (n_nodes,) int32
    right: np.ndarray        # (n_nodes,) int32
    value: np.ndarray        # (n_nodes,) float64
    depth: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        node = np.zeros(n, dtype=np.int32)
        for _ in range(self.depth + 1):
            feat = self.feature[node]
            is_leaf = feat < 0
            go_left = X[np.arange(n), np.maximum(feat, 0)] <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(is_leaf, node, nxt).astype(np.int32)
        return self.value[node]


def _best_split(x: np.ndarray, y: np.ndarray, min_leaf: int,
                max_bins: int) -> tuple[float, float] | None:
    """Best SSE-reducing threshold for one feature, or None.

    Returns ``(gain, threshold)``; gain is the SSE reduction.
    """
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    n = len(xs)
    # prefix sums for O(1) SSE of any prefix/suffix
    csum = np.cumsum(ys)
    total = csum[-1]
    # split after position i (1-based count i+1 on the left); only at value
    # boundaries, and respecting min_samples_leaf
    boundary = np.nonzero(xs[:-1] < xs[1:])[0]  # split between i and i+1
    if len(boundary) == 0:
        return None
    boundary = boundary[(boundary + 1 >= min_leaf) & (n - boundary - 1 >= min_leaf)]
    if len(boundary) == 0:
        return None
    if len(boundary) > max_bins:
        sel = np.linspace(0, len(boundary) - 1, max_bins).astype(int)
        boundary = boundary[sel]
    nl = boundary + 1.0
    nr = n - nl
    sl = csum[boundary]
    sr = total - sl
    # SSE reduction = sl^2/nl + sr^2/nr - total^2/n
    gain = sl * sl / nl + sr * sr / nr - total * total / n
    k = int(np.argmax(gain))
    thr = 0.5 * (xs[boundary[k]] + xs[boundary[k] + 1])
    return float(gain[k]), float(thr)


def fit_tree(X: np.ndarray, y: np.ndarray, *, max_depth: int = 4,
             min_samples_leaf: int = 4, max_bins: int = 64,
             min_gain: float = 1e-12) -> Tree:
    """Greedy SSE-minimising regression tree."""
    n, d = X.shape
    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        value.append(0.0)
        return len(feature) - 1

    def grow(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        value[node] = float(y[idx].mean())
        if depth >= max_depth or len(idx) < 2 * min_samples_leaf:
            return node
        best: tuple[float, int, float] | None = None
        for f in range(d):
            res = _best_split(X[idx, f], y[idx], min_samples_leaf, max_bins)
            if res is not None and (best is None or res[0] > best[0]):
                best = (res[0], f, res[1])
        if best is None or best[0] <= min_gain:
            return node
        _, f, thr = best
        mask = X[idx, f] <= thr
        feature[node] = f
        threshold[node] = thr
        left[node] = grow(idx[mask], depth + 1)
        right[node] = grow(idx[~mask], depth + 1)
        return node

    grow(np.arange(n), 0)
    return Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float64),
        depth=max_depth,
    )


# ---------------------------------------------------------------------------
# Histogram-based fitting (LightGBM-style).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BinnedFeatures:
    """Per-fit binning of a feature matrix (computed once, reused by every
    boosting iteration — the bins depend on X only, not on the residuals).

    ``codes[i, f]`` is the bin index of sample ``i`` on feature ``f``;
    ``split_value[f][b]`` is the real-valued threshold realising the split
    "bin <= b goes left" (midpoint between bin b's upper edge and the
    smallest data value above it, so ``x <= thr`` partitions exactly like
    the bin codes on training data).
    """

    codes: np.ndarray            # (n, d) int32
    n_bins: np.ndarray           # (d,) int64
    split_value: tuple           # d arrays of shape (n_bins[f] - 1,)
    uppers: tuple                # d arrays of per-bin upper edges (n_bins[f],)


def bin_features(X: np.ndarray, max_bins: int) -> BinnedFeatures:
    """Quantile-bin every feature into at most ``max_bins`` bins.

    Features with <= ``max_bins`` distinct values get one bin per value
    (the histogram splitter is then exact).
    """
    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    codes = np.empty((n, d), dtype=np.int32)
    n_bins = np.empty(d, dtype=np.int64)
    split_value = []
    all_uppers = []
    for f in range(d):
        x = X[:, f]
        u = np.unique(x)
        if len(u) > max_bins:
            qs = np.quantile(x, np.linspace(0.0, 1.0, max_bins + 1)[1:])
            uppers = np.unique(qs)
            uppers[-1] = u[-1]          # quantile interpolation can undershoot
        else:
            uppers = u
        c = np.searchsorted(uppers, x, side="left")
        codes[:, f] = np.minimum(c, len(uppers) - 1)
        n_bins[f] = len(uppers)
        all_uppers.append(uppers)
        # smallest data value strictly above each interior bin boundary
        nxt_i = np.minimum(np.searchsorted(u, uppers[:-1], side="right"),
                           len(u) - 1)
        split_value.append(0.5 * (uppers[:-1] + u[nxt_i]))
    return BinnedFeatures(codes=codes, n_bins=n_bins,
                          split_value=tuple(split_value),
                          uppers=tuple(all_uppers))


def bin_rows(binned: BinnedFeatures, X_new: np.ndarray) -> np.ndarray:
    """Code new rows with an existing binning's edges (no re-binning).

    Values above the top edge clamp into the last bin (tree ensembles
    cannot extrapolate anyway); values below the bottom edge land in bin
    0.  This is what keeps incremental refits cheap: the per-fit
    quantile pass runs once, and every later batch of observations is a
    ``searchsorted`` against the frozen edges.
    """
    X_new = np.asarray(X_new, dtype=np.float64)
    if X_new.ndim != 2 or X_new.shape[1] != binned.codes.shape[1]:
        raise ValueError("X_new must be (n, d) with d matching the binning")
    codes = np.empty(X_new.shape, dtype=np.int32)
    for f in range(X_new.shape[1]):
        c = np.searchsorted(binned.uppers[f], X_new[:, f], side="left")
        codes[:, f] = np.minimum(c, binned.n_bins[f] - 1)
    return codes


def append_rows(binned: BinnedFeatures, X_new: np.ndarray) -> BinnedFeatures:
    """Extend a binning with new rows, reusing the existing bin edges."""
    return BinnedFeatures(
        codes=np.concatenate([binned.codes, bin_rows(binned, X_new)]),
        n_bins=binned.n_bins, split_value=binned.split_value,
        uppers=binned.uppers)


def fit_tree_hist(binned: BinnedFeatures, y: np.ndarray, *,
                  row_idx: np.ndarray | None = None, max_depth: int = 4,
                  min_samples_leaf: int = 4, min_gain: float = 1e-12,
                  return_pred: bool = False):
    """Greedy SSE-minimising regression tree over pre-binned features.

    Split search per node is O(n_node * d) via ``bincount`` + prefix sums
    (vs. the exact splitter's per-node, per-feature argsort); one child's
    histogram is derived from the parent's by sibling subtraction.

    With ``return_pred=True`` returns ``(tree, pred)`` where ``pred`` holds
    the tree's prediction for every training row covered by ``row_idx``
    (leaf assignments fall out of the partition built while growing, so
    the boosting loop can skip a full ``Tree.predict`` pass).
    """
    codes, n_bins, split_value = binned.codes, binned.n_bins, binned.split_value
    n_all, d = codes.shape
    B = int(n_bins.max())
    y = np.asarray(y, dtype=np.float64)
    if row_idx is None:
        row_idx = np.arange(n_all)
    offsets = np.arange(d, dtype=np.int64) * B
    # interior split positions exist only below each feature's bin count
    _cols = np.arange(max(B - 1, 1))[None, :]
    interior = _cols < (n_bins[:, None] - 1)       # (d, B-1) static mask

    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        value.append(0.0)
        return len(feature) - 1

    def hist_of(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        flat = (codes[idx].astype(np.int64) + offsets).ravel()
        cnt = np.bincount(flat, minlength=d * B).reshape(d, B)
        sm = np.bincount(flat, weights=np.repeat(y[idx], d),
                         minlength=d * B).reshape(d, B)
        return cnt, sm

    def best_split(cnt, sm, m):
        """-> (gain, f, b, left_count, left_sum) or None."""
        if B < 2:
            return None
        # the last column is never a split point — drop it before cumsum
        nl = np.cumsum(cnt[:, :-1], axis=1)
        sl = np.cumsum(sm[:, :-1], axis=1)
        total = float(sm[0].sum())    # every feature's bins sum to sum(y)
        nr = m - nl
        sr = total - sl
        # SSE reduction, same formula as the exact splitter (0-count bins
        # divide to inf/nan; masked out just below — errstate is hoisted
        # to the caller).  The constant -total^2/m term does not affect
        # the argmax; it is applied to the winner only.
        gain = sl * sl / nl + sr * sr / nr
        # children must be non-empty even when min_samples_leaf == 0, or
        # an empty bin's NaN/inf gain would win the argmax
        min_child = max(min_samples_leaf, 1)
        ok = interior & (nl >= min_child) & (nr >= min_child)
        gain = np.where(ok, gain, -np.inf)
        k = int(np.argmax(gain))
        f, b = divmod(k, B - 1)
        g = float(gain[f, b]) - total * total / m
        if not np.isfinite(g) or g <= min_gain:
            return None
        return g, f, b, int(nl[f, b]), float(sl[f, b])

    pred = np.empty(n_all) if return_pred else None

    def grow(idx: np.ndarray, depth: int, mean: float, hist=None) -> int:
        node = new_node()
        value[node] = mean
        if depth >= max_depth or len(idx) < 2 * min_samples_leaf:
            if pred is not None:
                pred[idx] = mean
            return node
        cnt, sm = hist if hist is not None else hist_of(idx)
        res = best_split(cnt, sm, len(idx))
        if res is None:
            if pred is not None:
                pred[idx] = mean
            return node
        _, f, b, nl, sl = res
        mask = codes[idx, f] <= b
        li, ri = idx[mask], idx[~mask]
        feature[node] = f
        threshold[node] = float(split_value[f][b])
        # Child means fall out of the split sums — no per-node y gather.
        l_mean = sl / nl
        r_mean = (mean * len(idx) - sl) / (len(idx) - nl)
        # Build child histograms only for children that can still split;
        # when both need one, build the smaller child's and derive the
        # other by sibling subtraction.
        def splittable(child):
            return depth + 1 < max_depth and len(child) >= 2 * min_samples_leaf
        lh = rh = None
        if splittable(li) and splittable(ri):
            if len(li) <= len(ri):
                lh = hist_of(li)
                rh = (cnt - lh[0], sm - lh[1])
            else:
                rh = hist_of(ri)
                lh = (cnt - rh[0], sm - rh[1])
        left[node] = grow(li, depth + 1, l_mean, lh)
        right[node] = grow(ri, depth + 1, r_mean, rh)
        return node

    row_idx = np.asarray(row_idx)
    with np.errstate(divide="ignore", invalid="ignore"):
        grow(row_idx, 0, float(y[row_idx].mean()))
    tree = Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float64),
        depth=max_depth,
    )
    return (tree, pred) if return_pred else tree


@dataclass
class BoostedTreesRegressor:
    """LSBoost ensemble with packed-tensor PyTorch prediction."""

    n_estimators: int = 200
    learning_rate: float = 0.1
    max_depth: int = 4
    min_samples_leaf: int = 4
    max_bins: int = 64
    subsample: float = 1.0
    seed: int = 0
    tree_method: str = "exact"       # "exact" | "hist"
    # fitted state
    base_: float = 0.0
    trees_: list = field(default_factory=list)
    _packed: tuple | None = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BoostedTreesRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or len(X) != len(y):
            raise ValueError("X must be (n, d) and aligned with y")
        if self.tree_method not in ("exact", "hist"):
            raise ValueError(f"unknown tree_method {self.tree_method!r}")
        rng = np.random.default_rng(self.seed)
        self.base_ = float(y.mean())
        pred = np.full_like(y, self.base_)
        self.trees_ = []
        n = len(y)
        # bins depend on X only: compute once, reuse across all estimators
        binned = (bin_features(X, self.max_bins)
                  if self.tree_method == "hist" else None)
        for _ in range(self.n_estimators):
            resid = y - pred
            if self.subsample < 1.0:
                idx = rng.choice(n, size=max(2 * self.min_samples_leaf,
                                             int(self.subsample * n)),
                                 replace=False)
            else:
                idx = np.arange(n)
            if binned is not None and self.subsample >= 1.0:
                # full-data fit: the grower hands back every row's leaf
                # value, so no predict pass is needed
                tree, tpred = fit_tree_hist(
                    binned, resid, row_idx=idx, max_depth=self.max_depth,
                    min_samples_leaf=self.min_samples_leaf, return_pred=True)
            elif binned is not None:
                tree = fit_tree_hist(binned, resid, row_idx=idx,
                                     max_depth=self.max_depth,
                                     min_samples_leaf=self.min_samples_leaf)
                tpred = None
            else:
                tree = fit_tree(X[idx], resid[idx], max_depth=self.max_depth,
                                min_samples_leaf=self.min_samples_leaf,
                                max_bins=self.max_bins)
                tpred = None
            self.trees_.append(tree)
            pred = pred + self.learning_rate * (
                tpred if tpred is not None else tree.predict(X))
        self._packed = None
        return self

    def fit_more(self, X: np.ndarray, y: np.ndarray, n_more: int, *,
                 binned: BinnedFeatures | None = None,
                 ) -> "BoostedTreesRegressor":
        """Continue boosting: append ``n_more`` trees fit on ``(X, y)``.

        The existing ensemble (``base_`` + ``trees_``) is kept and the new
        trees chase the residuals ``y - predict(X)`` — warm refit from
        live observations instead of a full retrain.  ``X`` need not be
        the original training matrix; with ``tree_method="hist"`` pass a
        precomputed ``binned`` (e.g. grown incrementally via
        ``append_rows``) to skip the quantile pass entirely.  New trees
        always fit the full row set (``subsample`` applies to ``fit``
        only).
        """
        if not self.trees_:
            raise ValueError("fit_more needs a fitted ensemble; call fit first")
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or len(X) != len(y):
            raise ValueError("X must be (n, d) and aligned with y")
        if self.tree_method == "hist" and binned is None:
            binned = bin_features(X, self.max_bins)
        if binned is not None and len(binned.codes) != len(y):
            raise ValueError("binned row count does not match y")
        pred = self.predict(X)
        idx = np.arange(len(y))
        for _ in range(n_more):
            resid = y - pred
            if binned is not None:
                tree, tpred = fit_tree_hist(
                    binned, resid, row_idx=idx, max_depth=self.max_depth,
                    min_samples_leaf=self.min_samples_leaf, return_pred=True)
            else:
                tree = fit_tree(X, resid, max_depth=self.max_depth,
                                min_samples_leaf=self.min_samples_leaf,
                                max_bins=self.max_bins)
                tpred = tree.predict(X)
            self.trees_.append(tree)
            pred = pred + self.learning_rate * tpred
        self._packed = None
        return self

    # -- numpy prediction ----------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.full(X.shape[0], self.base_)
        for t in self.trees_:
            out += self.learning_rate * t.predict(X)
        return out

    # -- packed PyTorch prediction ---------------------------------------------
    def pack(self) -> tuple:
        """Stack all trees into padded (M, n_nodes) CPU tensors.

        Returns ``(feature, threshold, left, right, value, base,
        learning_rate, depth)``: int64 node/feature indices, float32
        thresholds and values, and three Python scalars.
        """
        if self._packed is not None:
            return self._packed
        m = len(self.trees_)
        max_nodes = max(len(t.feature) for t in self.trees_)

        def pad(a, fill, dtype):
            out = np.full((m, max_nodes), fill, dtype=dtype)
            for i, t in enumerate(self.trees_):
                arr = getattr(t, a)
                out[i, : len(arr)] = arr
            return torch.from_numpy(out)

        packed = (
            pad("feature", -1, np.int64),
            pad("threshold", 0.0, np.float32),
            pad("left", 0, np.int64),
            pad("right", 0, np.int64),
            pad("value", 0.0, np.float32),
            float(np.float32(self.base_)),
            float(np.float32(self.learning_rate)),
            int(max(t.depth for t in self.trees_)),
        )
        self._packed = packed
        return packed

    def predict_fn_torch(self, device=None
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Returns ``f(X: (n, d)) -> (n,)`` walking every tree for the
        whole batch at once, in float32 on ``device`` (``None`` = the
        card)."""
        from .. import resolve_device

        dev = resolve_device(device)
        feat, thr, left, right, value, base, lr, depth = self.pack()
        m, n_nodes = feat.shape
        # trees flattened end to end; ``offs`` turns a per-tree node
        # index into an index of the flat arrays
        feat, thr, left, right, value = (
            a.reshape(-1).to(dev) for a in (feat, thr, left, right, value))
        offs = (torch.arange(m, device=dev) * n_nodes)[None, :]

        def predict(X: torch.Tensor) -> torch.Tensor:
            X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
            node = torch.zeros((X.shape[0], m), dtype=torch.int64, device=dev)
            for _ in range(depth + 1):
                flat = node + offs
                f = feat[flat]
                x = torch.gather(X, 1, f.clamp(min=0))
                nxt = torch.where(x <= thr[flat], left[flat], right[flat])
                node = torch.where(f < 0, node, nxt)
            return base + lr * value[node + offs].sum(dim=1)

        return predict


# -- paper's accuracy metrics (Eqs. 5-6) --------------------------------------

def absolute_error(t_measured: np.ndarray, t_predicted: np.ndarray) -> np.ndarray:
    return np.abs(np.asarray(t_measured) - np.asarray(t_predicted))


def percent_error(t_measured: np.ndarray, t_predicted: np.ndarray) -> np.ndarray:
    t_measured = np.asarray(t_measured)
    return 100.0 * absolute_error(t_measured, t_predicted) / t_measured
