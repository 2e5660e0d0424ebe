"""Random-forest surrogate with XLA-compiled inference.

Capability parity with the reference's RF surrogate
(ref: bayes_optim/surrogate/random_forest.py:63-155): sklearn forest with
one-hot encoding of categorical levels, empirical MSE = variance of
per-tree predictions, and `SurrogateAggregation` (weighted-sum blending of
surrogates for multi-objective scalarization, :19-53).

Accelerator design: the reference calls sklearn's Python predict per point
inside the acquisition loop. Here the fitted forest is flattened into
padded node arrays (feature, threshold, children, value) and traversal runs
as a jittable gather program — (n_points, n_trees) traversals advance in
lock-step for `max_depth` iterations — so RF-backed acquisition argmax uses
the same fused population programs as the GP path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class RFConfig(NamedTuple):
    """Static info for jitted RF inference."""

    max_depth: int
    trend: str = "none"  # field for interface symmetry with GPConfig


class RFState(NamedTuple):
    """Flattened forest: arrays shaped (n_trees, max_nodes[, n_outputs])."""

    feature: jnp.ndarray    # int32; -1 => leaf
    threshold: jnp.ndarray  # f32
    left: jnp.ndarray       # int32
    right: jnp.ndarray      # int32
    value: jnp.ndarray      # f32 leaf predictions (n_trees, max_nodes, m)


def flatten_forest(estimators, dtype=jnp.float32):
    """sklearn tree ensemble -> padded arrays + max depth.

    Keeps ALL outputs of each leaf (tree_.value[:, :, 0] is (n_nodes, m)),
    so multi-output forests — the reference fits multi-objective y in one
    forest (ref: random_forest.py:110-139, exercised by its test_mobo) —
    predict every objective from one traversal."""
    n_trees = len(estimators)
    max_nodes = max(e.tree_.node_count for e in estimators)
    m = estimators[0].tree_.value.shape[1]
    feature = np.full((n_trees, max_nodes), -1, np.int32)
    threshold = np.zeros((n_trees, max_nodes), np.float32)
    left = np.zeros((n_trees, max_nodes), np.int32)
    right = np.zeros((n_trees, max_nodes), np.int32)
    value = np.zeros((n_trees, max_nodes, m), np.float32)
    max_depth = 1
    for t, est in enumerate(estimators):
        tr = est.tree_
        n = tr.node_count
        feature[t, :n] = tr.feature
        threshold[t, :n] = tr.threshold
        left[t, :n] = tr.children_left
        right[t, :n] = tr.children_right
        value[t, :n] = tr.value[:, :, 0]
        max_depth = max(max_depth, int(tr.max_depth))
    state = RFState(
        feature=jnp.asarray(feature),
        threshold=jnp.asarray(threshold),
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        value=jnp.asarray(value, dtype),
    )
    return state, max_depth


def rf_predict_trees(state: RFState, X: jnp.ndarray, config: RFConfig) -> jnp.ndarray:
    """Per-tree predictions (n_points, n_trees) via lock-step traversal."""
    n_trees = state.feature.shape[0]

    def traverse(x):  # x: (d,)
        idx0 = jnp.zeros(n_trees, jnp.int32)

        def body(_, idx):
            feat = jnp.take_along_axis(state.feature, idx[:, None], axis=1)[:, 0]
            thr = jnp.take_along_axis(state.threshold, idx[:, None], axis=1)[:, 0]
            lft = jnp.take_along_axis(state.left, idx[:, None], axis=1)[:, 0]
            rgt = jnp.take_along_axis(state.right, idx[:, None], axis=1)[:, 0]
            is_leaf = feat < 0
            xv = x[jnp.maximum(feat, 0)]
            nxt = jnp.where(xv <= thr, lft, rgt)
            return jnp.where(is_leaf, idx, nxt)

        idx = jax.lax.fori_loop(0, config.max_depth, body, idx0)
        return jnp.take_along_axis(state.value, idx[:, None, None], axis=1)[:, 0, :]

    return jax.vmap(traverse)(X)


def rf_predict(state: RFState, X: jnp.ndarray, config: RFConfig):
    """(mu[N, m], var[N, m]): ensemble mean and across-tree variance per
    output (ref parity: random_forest.py:140-155)."""
    per_tree = rf_predict_trees(state, X, config)  # (N, n_trees, m)
    mu = jnp.mean(per_tree, axis=1)
    var = jnp.var(per_tree, axis=1)
    return mu, var


class RandomForest:
    """Reference-compatible surrogate surface: fit/predict(eval_MSE)/
    is_fitted, with `levels` for categorical one-hot
    (ref parity: random_forest.py:63-155)."""

    def __init__(
        self,
        n_estimators: int = 100,
        max_features: float = 5.0 / 6.0,
        min_samples_leaf: int = 2,
        levels: Optional[dict] = None,
        random_state: Optional[int] = None,
        feature_space: str = "raw",
        **kwargs,
    ):
        # 'raw': reference behavior — object rows, internal one-hot from
        # `levels`. 'embedding': rows are already the numeric space
        # embedding (used when plugged into the fused BO argmax path).
        self.feature_space = feature_space
        self.n_estimators = n_estimators
        self.max_features = max_features
        self.min_samples_leaf = min_samples_leaf
        self.levels = dict(levels) if levels else None
        self.random_state = random_state
        self._kwargs = kwargs
        self.is_fitted = False
        self._cat_idx = sorted(self.levels.keys()) if self.levels else []
        self._onehot = None

    # -------------------------------------------------------------- codecs
    def _encode(self, X) -> np.ndarray:
        if self.feature_space == "embedding":
            X = np.asarray(X, dtype=float)
            return X.reshape(1, -1) if X.ndim == 1 else X
        X = np.asarray(X, dtype=object)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if not self._cat_idx:
            return np.asarray(X, dtype=float)
        num_idx = [j for j in range(X.shape[1]) if j not in self._cat_idx]
        num = np.asarray(X[:, num_idx], dtype=float) if num_idx else np.zeros((len(X), 0))
        blocks = [num]
        for j in self._cat_idx:
            levels = list(self.levels[j])
            oh = np.zeros((len(X), len(levels)))
            for i, v in enumerate(X[:, j]):
                oh[i, levels.index(v)] = 1.0
            blocks.append(oh)
        return np.hstack(blocks)

    # ----------------------------------------------------------------- fit
    def fit(self, X, y) -> "RandomForest":
        from sklearn.ensemble import RandomForestRegressor

        Xe = self._encode(X)
        # keep multi-output y 2-D: sklearn fits all outputs in one forest
        # (ref parity: random_forest.py:110-139, MOBO-with-RF)
        y = np.asarray(y, dtype=float)
        self._m = 1 if y.ndim == 1 else y.shape[1]
        if y.ndim == 2 and y.shape[1] == 1:
            y = y.ravel()
        self._rf = RandomForestRegressor(
            n_estimators=self.n_estimators,
            max_features=min(self.max_features, 1.0),
            min_samples_leaf=self.min_samples_leaf,
            random_state=self.random_state,
            **self._kwargs,
        )
        self._rf.fit(Xe, y)
        self._state, depth = flatten_forest(self._rf.estimators_)
        self._config = RFConfig(max_depth=depth)
        self.is_fitted = True
        return self

    # ------------------------------------------------------------- predict
    def predict(self, X, eval_MSE: bool = False):
        """(N,) / (N,) for single-output fits, (N, m) for multi-output
        (matching GaussianProcess.predict's squeeze convention)."""
        Xe = jnp.asarray(self._encode(X), jnp.float32)
        mu, var = rf_predict(self._state, Xe, self._config)
        mu = np.asarray(mu, dtype=float)
        if self._m == 1:
            mu = mu.ravel()
        if eval_MSE:
            var = np.asarray(var, dtype=float)
            if self._m == 1:
                var = var.ravel()
            return mu, var
        return mu

    # device-side handles mirroring GaussianProcess's interface
    @property
    def posterior(self) -> RFState:
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        return self._state

    @property
    def config(self) -> RFConfig:
        return self._config

    def predict_jax(self, Xq: jnp.ndarray, eval_mse: bool = True):
        mu, var = rf_predict(self._state, Xq, self._config)
        return (mu, var) if eval_mse else (mu, None)


class SurrogateAggregation:
    """Weighted-sum aggregation of fitted surrogates
    (ref parity: random_forest.py:19-53)."""

    def __init__(self, surrogates, aggregation: str = "WS", weights=None):
        self.surrogates = list(surrogates)
        self.aggregation = aggregation
        self.weights = np.asarray(
            weights if weights is not None else np.ones(len(self.surrogates)) / len(self.surrogates),
            dtype=float,
        )
        if aggregation != "WS":
            raise NotImplementedError("only weighted-sum ('WS') aggregation is supported")

    @property
    def is_fitted(self) -> bool:
        return all(getattr(s, "is_fitted", False) for s in self.surrogates)

    def fit(self, X, y):
        raise NotImplementedError("aggregate of already-fitted surrogates")

    def predict(self, X, eval_MSE: bool = False):
        mus, mses = [], []
        for s in self.surrogates:
            out = s.predict(X, eval_MSE=eval_MSE)
            if eval_MSE:
                mus.append(np.asarray(out[0]).ravel())
                mses.append(np.asarray(out[1]).ravel())
            else:
                mus.append(np.asarray(out).ravel())
        mu = np.average(np.stack(mus), axis=0, weights=self.weights)
        if eval_MSE:
            mse = np.stack(mses)
            mse = np.sum((self.weights[:, None] ** 2) * mse, axis=0)
            return mu, mse
        return mu
