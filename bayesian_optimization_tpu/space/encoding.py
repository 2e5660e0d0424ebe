"""Masked continuous embedding of mixed search spaces.

This is the array-first replacement for the reference's per-type Python
dispatch: a `SearchSpace` is compiled once into static arrays so that every
downstream operation — DoE sampling, surrogate fitting, acquisition
evaluation, and the population-based argmax — is a fixed-shape XLA program.

Two array representations of a batch of points:

- **unit** `U: f32[N, dim]` — one column per variable, all in [0, 1].
  Reals live on their *transformed* scale (linear/log/log10/logit/bilog,
  ref: bayes_optim/search_space/variable.py:40-53) normalized to [0,1];
  ordered/categorical variables store `level / n_levels` (quantized on
  decode). This is the representation the evolutionary/gradient argmax
  engines operate on.

- **embed** `E: f32[N, d_embed]` — the surrogate-facing features: reals and
  ordered discretes as their unit value, categoricals expanded to one-hot
  blocks (so squared distance = Hamming-like), matching the behavioral role
  of the reference's one-hot for RF (ref: surrogate/random_forest.py:95-109)
  and giving GP kernels a meaningful metric on nominal variables.

All `unit_to_*` maps are jax-jittable; raw<->unit codecs are host-side
(object arrays cannot cross into XLA).
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .variables import Bool, Discrete, Integer, Ordinal, Real, Subset
from .space import SearchSpace


class SpaceEncoding:
    """Static, hashable description of a search space for the XLA path."""

    def __init__(self, space: SearchSpace, dtype=None):
        self.space = space
        self.dtype = dtype or jnp.float32
        self.dim = space.dim

        is_real, n_levels, is_onehot = [], [], []
        lo_t, hi_t = [], []
        for var in space.data:
            if isinstance(var, Real):
                is_real.append(True)
                n_levels.append(0)
                is_onehot.append(False)
                lo, hi = var.bounds_transformed
                lo_t.append(lo)
                hi_t.append(hi)
            else:
                is_real.append(False)
                n_levels.append(var.n_levels)
                # ordered discretes embed as a scalar; unordered as one-hot
                ordered = isinstance(var, (Integer, Ordinal, Bool))
                is_onehot.append(not ordered)
                lo_t.append(0.0)
                hi_t.append(1.0)

        self.is_real = np.asarray(is_real)
        self.n_levels = np.asarray(n_levels, dtype=np.int32)
        self.is_onehot = np.asarray(is_onehot)
        self.lo_t = np.asarray(lo_t, dtype=np.float64)
        self.hi_t = np.asarray(hi_t, dtype=np.float64)

        # embedding layout: scalar vars take 1 slot, one-hot vars take n_levels
        widths = [int(n) if oh else 1 for n, oh in zip(self.n_levels, self.is_onehot)]
        self.emb_width = np.asarray(widths, dtype=np.int32)
        self.emb_offset = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
        self.d_embed = int(np.sum(widths))

        # device-side constants
        self._n_levels_j = jnp.asarray(np.maximum(self.n_levels, 1), dtype=self.dtype)
        self._is_discrete_j = jnp.asarray(~self.is_real)
        # scatter matrix W: f32[dim, d_embed] for scalar slots; one-hot handled
        # separately via segment indices
        scalar_cols = []
        onehot_specs = []  # (var_idx, offset, n)
        for j in range(self.dim):
            if self.is_onehot[j]:
                onehot_specs.append((j, int(self.emb_offset[j]), int(self.n_levels[j])))
            else:
                scalar_cols.append((j, int(self.emb_offset[j])))
        self._scalar_cols = scalar_cols
        self._onehot_specs = onehot_specs

    def embed_widths(self):
        """Per-embedding-dim RAW widths: hi_t - lo_t for real scalar slots,
        1.0 for level/one-hot slots (used to map the reference's
        raw-coordinate theta conventions onto the unit embedding)."""
        import numpy as _np

        w = _np.ones(self.d_embed)
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                w[off] = float(self.hi_t[j] - self.lo_t[j])
        return w

    # ----------------------------------------------------------- jax codecs
    def quantize_unit(self, U: jnp.ndarray) -> jnp.ndarray:
        """Snap discrete columns of a unit-cube batch to their level grid.

        A discrete variable with n levels is represented by the midpoint
        `(k + 0.5) / n` of its level cell, so decode(quantize(u)) == decode(u).
        """
        U = jnp.clip(U, 0.0, 1.0)
        n = self._n_levels_j
        lev = jnp.minimum(jnp.floor(U * n), n - 1.0)
        snapped = (lev + 0.5) / n
        return jnp.where(self._is_discrete_j, snapped, U)

    def unit_levels(self, U: jnp.ndarray) -> jnp.ndarray:
        """Integer level indices (discrete columns; zeros for reals)."""
        n = self._n_levels_j
        lev = jnp.minimum(jnp.floor(jnp.clip(U, 0.0, 1.0) * n), n - 1.0)
        return jnp.where(self._is_discrete_j, lev, 0.0).astype(jnp.int32)

    def unit_to_embed(self, U: jnp.ndarray) -> jnp.ndarray:
        """Unit batch [N, dim] -> surrogate features [N, d_embed] (jittable).

        Reals pass through; ordered discretes become normalized level index
        (level / (n-1), or 0.5 when n == 1); categoricals become one-hot.
        Differentiable in the real columns (discrete columns go through
        floor, so their gradient is 0 — intended: gradient engines only move
        real coordinates, ES engines move everything).
        """
        U = jnp.asarray(U, self.dtype)
        batch_shape = U.shape[:-1]
        E = jnp.zeros(batch_shape + (self.d_embed,), self.dtype)
        levels = self.unit_levels(U)
        n = self._n_levels_j
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                col = U[..., j]
            else:
                denom = jnp.maximum(n[j] - 1.0, 1.0)
                col = levels[..., j].astype(self.dtype) / denom
            E = E.at[..., off].set(col)
        for j, off, width in self._onehot_specs:
            oh = jax.nn.one_hot(levels[..., j], width, dtype=self.dtype)
            E = jax.lax.dynamic_update_slice_in_dim(E, oh, off, axis=-1)
        return E

    def unit_to_embed_np(self, U: np.ndarray) -> np.ndarray:
        """Host (numpy) mirror of `unit_to_embed` for ask/tell paths.

        Calling the traced version eagerly dispatches one op at a time to the
        device, a launch and a transfer per op for an (n, dim) batch on every
        `tell`. The embedding is plain
        arithmetic, so the host path computes it in numpy; test_encoding
        asserts it matches the jittable version bit-for-bit."""
        U = np.atleast_2d(np.asarray(U, dtype=np.float64))
        n = np.maximum(self.n_levels, 1).astype(np.float64)
        lev = np.minimum(np.floor(np.clip(U, 0.0, 1.0) * n), n - 1.0)
        E = np.zeros(U.shape[:-1] + (self.d_embed,), dtype=np.float64)
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                E[..., off] = U[..., j]
            else:
                E[..., off] = lev[..., j] / max(n[j] - 1.0, 1.0)
        for j, off, width in self._onehot_specs:
            idx = lev[..., j].astype(np.int64)
            E[..., off:off + width] = np.eye(width)[idx]
        return E

    def unit_to_raw(self, U: jnp.ndarray) -> jnp.ndarray:
        """Unit batch [N, dim] -> RAW numeric values f32[N, dim] (jittable).

        The in-program mirror of `decode_unit` for numeric variables: reals
        go through the inverse scale transform (no precision rounding —
        penalty-guided constraint evaluation does not need it), integers are
        `lo + level*step`, bools are 0/1, and numeric ordinal/discrete levels
        gather from a value table. Columns whose raw values are NOT numeric
        (strings, subsets) decode to NaN — `ConstraintProgram` validates the
        traced path against the host decoder and falls back to a host
        callback when a constraint touches such a column."""
        U = jnp.asarray(U, self.dtype)
        levels = self.unit_levels(U)
        cols = []
        for j, var in enumerate(self.space.data):
            if isinstance(var, Real):
                lo, hi = float(self.lo_t[j]), float(self.hi_t[j])
                t = lo + (hi - lo) * jnp.clip(U[..., j], 0.0, 1.0)
                scale = var._scale
                if scale == "linear":
                    x = t
                elif scale == "log":
                    x = jnp.exp(t)
                elif scale == "log10":
                    x = jnp.power(10.0, t)
                elif scale == "logit":
                    x = jax.nn.sigmoid(t)
                elif scale == "bilog":
                    x = jnp.sign(t) * jnp.expm1(jnp.abs(t))
                else:  # pragma: no cover - SCALE_TRANSFORMS is closed
                    x = t
                cols.append(x)
            elif isinstance(var, Integer):
                lev = levels[..., j].astype(self.dtype)
                cols.append(float(var.bounds[0]) + lev * float(var.step))
            elif isinstance(var, Bool):
                cols.append(levels[..., j].astype(self.dtype))
            else:
                vals = []
                numeric = True
                for k in range(int(self.n_levels[j])):
                    v = var.value_of(k)
                    if isinstance(v, (bool, int, float, np.integer, np.floating)):
                        vals.append(float(v))
                    else:
                        numeric = False
                        break
                if numeric:
                    table = jnp.asarray(vals, self.dtype)
                    cols.append(table[levels[..., j]])
                else:
                    cols.append(jnp.full(U.shape[:-1], jnp.nan, self.dtype))
        return jnp.stack(cols, axis=-1)

    def sample_unit(self, key: jax.Array, n: int, method: str = "uniform") -> jnp.ndarray:
        """Jittable sampler on the unit cube: 'uniform' or 'lhs'."""
        if method == "uniform":
            return jax.random.uniform(key, (n, self.dim), self.dtype)
        if method in ("lhs", "LHS"):
            k1, k2 = jax.random.split(key)
            u = jax.random.uniform(k1, (n, self.dim), self.dtype)
            perms = jax.vmap(lambda k: jax.random.permutation(k, n))(jax.random.split(k2, self.dim)).T
            return (perms.astype(self.dtype) + u) / n
        raise ValueError(f"unknown method {method!r}")

    # ---------------------------------------------------------- host codecs
    def encode_unit(self, X_raw) -> np.ndarray:
        """Raw object array [N, dim] -> unit batch f64[N, dim] (host-side)."""
        X_raw = np.asarray(X_raw, dtype=object)
        if X_raw.ndim == 1:
            X_raw = X_raw.reshape(1, -1)
        N = X_raw.shape[0]
        U = np.zeros((N, self.dim))
        for j, var in enumerate(self.space.data):
            col = X_raw[:, j]
            if isinstance(var, Real):
                x = var._trans(np.asarray(col, dtype=float))
                lo, hi = self.lo_t[j], self.hi_t[j]
                U[:, j] = np.clip((x - lo) / max(hi - lo, 1e-300), 0.0, 1.0)
            else:
                n = self.n_levels[j]
                lev = np.array([var.level_of(v) for v in col])
                U[:, j] = (lev + 0.5) / n
        return U

    def decode_unit(self, U) -> np.ndarray:
        """Unit batch [N, dim] -> raw object array (host-side), applying the
        inverse scale transform, precision rounding and level lookup."""
        U = np.asarray(U, dtype=float)
        if U.ndim == 1:
            U = U.reshape(1, -1)
        N = U.shape[0]
        X = np.empty((N, self.dim), dtype=object)
        for j, var in enumerate(self.space.data):
            u = np.clip(U[:, j], 0.0, 1.0)
            if isinstance(var, Real):
                lo, hi = self.lo_t[j], self.hi_t[j]
                x = var.to_linear_scale(lo + (hi - lo) * u)
                X[:, j] = np.asarray(var.round(x), dtype=float)
            else:
                n = self.n_levels[j]
                lev = np.minimum((u * n).astype(int), n - 1)
                X[:, j] = np.array([var.value_of(k) for k in lev], dtype=object)
        return X

    def embed_raw(self, X_raw) -> np.ndarray:
        """Raw object array -> surrogate features (host-side)."""
        return self.unit_to_embed_np(self.encode_unit(X_raw))

    # ---------------------------------------------------------------- misc
    # identity hash/eq: a SpaceEncoding instance is immutable after build, so
    # it can be used as a static argument of jitted programs
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    @property
    def n_free_real(self) -> int:
        return int(np.sum(self.is_real))

    def __repr__(self) -> str:
        return (
            f"SpaceEncoding(dim={self.dim}, d_embed={self.d_embed}, "
            f"reals={int(self.is_real.sum())}, discretes={int((~self.is_real).sum())})"
        )
