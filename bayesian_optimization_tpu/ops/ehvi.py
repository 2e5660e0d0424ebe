"""Exact Expected Hypervolume Improvement (EHVI) in pure JAX.

Capability parity with the reference's torch implementation
(ref: bayes_optim/multi_objective/analytic.py:99-274, [Yang2019] psi/nu cell
terms + the 2^m cross-product gather), re-written as a jittable einsum over
hypercells so a whole candidate batch evaluates in one XLA program — the
reference evaluates one candidate at a time through a numpy->torch bridge
(analytic.py:223-233).

Convention: MAXIMIZATION; `mu` is the posterior mean of the m objectives at
each candidate, `sigma` the posterior standard deviation, and the cells come
from ops/box_decomposition.NondominatedPartitioning.
"""
from __future__ import annotations

from itertools import product
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.stats import norm

_UPPER_CLAMP = 1e8  # inf upper bounds clamped for differentiability (ref :240-242)
_SIGMA_FLOOR = 1e-9

# MC sample count the fused qEHVI argmax uses (optim/argmax.py). The MC
# estimator below is exact per sample (inclusion-exclusion over cells), so
# the only error is variance; measured on a 3-point m=2 front (round 5,
# tests/test_mo.py::test_qehvi_mc_accuracy): median |rel err| vs a 2^18
# golden at q=2 is 11% @ S=16, 6.8% @ 64, 2.7% @ 256, 1.0% @ 1024; q=8 is
# EASIER (errors average over candidates): 2.6% @ 64, 0.8% @ 256. S=256
# keeps the q=2 error under ~3% at 4x the samples (cells x subsets x S
# stays one fused einsum).
QEHVI_N_SAMPLES = int(__import__("os").environ.get("BOTPU_QEHVI_SAMPLES", "256"))


def _psi(lower, upper, mu, sigma):
    """Eq. 19 of [Yang2019] (ref parity: analytic.py:176-200)."""
    u = (upper - mu) / sigma
    return sigma * norm.pdf(u) + (mu - lower) * (1.0 - norm.cdf(u))


def _nu(lower, upper, mu, sigma):
    """Eq. 25 of [Yang2019] (ref parity: analytic.py:202-221)."""
    return (upper - lower) * (1.0 - norm.cdf((upper - mu) / sigma))


def ehvi(
    mu: jnp.ndarray,
    sigma: jnp.ndarray,
    cell_lower: jnp.ndarray,
    cell_upper: jnp.ndarray,
) -> jnp.ndarray:
    """EHVI for a batch of candidates.

    mu, sigma: (B, m) posterior moments; cell_lower/upper: (K, m).
    Returns (B,) EHVI values.
    """
    m = mu.shape[-1]
    sigma = jnp.maximum(sigma, _SIGMA_FLOOR)
    upper = jnp.minimum(cell_upper, _UPPER_CLAMP)
    lower = cell_lower

    mu_b = mu[:, None, :]       # (B, 1, m)
    sig_b = sigma[:, None, :]
    psi_lu = _psi(lower[None], upper[None], mu_b, sig_b)   # (B, K, m)
    psi_ll = _psi(lower[None], lower[None], mu_b, sig_b)
    nu = _nu(lower[None], upper[None], mu_b, sig_b)
    psi_diff = psi_ll - psi_lu

    # cross product over {psi_diff, nu}^m (ref parity: analytic.py:255-274)
    idx = jnp.asarray(list(product(*[[0, 1]] * m)), jnp.int32)  # (2^m, m)
    stacked = jnp.stack([psi_diff, nu], axis=-2)                # (B, K, 2, m)
    cols = jnp.arange(m)
    terms = stacked[..., idx, cols]                             # (B, K, 2^m, m)
    return jnp.sum(jnp.prod(terms, axis=-1), axis=(-1, -2))


def qehvi(
    mu: jnp.ndarray,
    sigma: jnp.ndarray,
    cell_lower: jnp.ndarray,
    cell_upper: jnp.ndarray,
    key: jax.Array,
    n_samples: int = 128,
) -> jnp.ndarray:
    """Monte-Carlo joint Expected Hypervolume Improvement of q candidates
    [Daulton2020qehvi]: inclusion-exclusion over candidate subsets inside
    each hypercell, averaged over posterior samples.

    mu, sigma: (q, m) per-candidate posterior moments (marginal sampling —
    cross-candidate posterior covariance is not modeled). Returns a scalar.
    """
    q, m = mu.shape
    sigma = jnp.maximum(sigma, _SIGMA_FLOOR)
    upper = jnp.minimum(cell_upper, _UPPER_CLAMP)  # (K, m)
    lower = cell_lower
    eps = jax.random.normal(key, (n_samples, q, m), mu.dtype)
    Y = mu[None] + sigma[None] * eps  # (S, q, m)

    # subset masks: (2^q - 1, q) — built in numpy (static, trace-safe)
    masks_np = np.asarray(
        [[(t >> i) & 1 for i in range(q)] for t in range(1, 2**q)], dtype=np.float32
    )
    signs = jnp.asarray((-1.0) ** (masks_np.sum(axis=1) + 1), mu.dtype)
    masks = jnp.asarray(masks_np, mu.dtype)

    # per-subset joint minimum of the samples (min over selected candidates)
    big = jnp.asarray(_UPPER_CLAMP, mu.dtype)
    Y_exp = Y[:, None, :, :]                        # (S, 1, q, m)
    sel = jnp.where(masks[None, :, :, None] > 0, Y_exp, big)   # (S, T, q, m)
    y_min = jnp.min(sel, axis=2)                    # (S, T, m)

    # overlap of [cell_lower, min(cell_upper, y_min)] per cell
    top = jnp.minimum(upper[None, None], y_min[:, :, None, :])  # (S, T, K, m)
    edge = jnp.maximum(top - lower[None, None], 0.0)
    vol = jnp.prod(edge, axis=-1)                   # (S, T, K)
    hvi = jnp.sum(vol * signs[None, :, None], axis=(1, 2))      # (S,)
    return jnp.mean(hvi)


class EHVI:
    """Object wrapper mirroring the reference's criterion surface
    (ref: analytic.py:99-175): EHVI(model, ref_point, partitioning)(X)."""

    def __init__(self, model, ref_point, partitioning):
        self.model = model
        self.ref_point = np.asarray(ref_point, dtype=float).ravel()
        if len(self.ref_point) != partitioning.num_outcomes:
            raise ValueError(
                "the reference point length must match the number of outcomes"
            )
        P = partitioning.pareto_Y
        if len(P) > 0 and not np.any(np.all(P > self.ref_point, axis=1)):
            raise ValueError("at least one pareto point must be better than the reference point")
        self.partitioning = partitioning
        bounds = partitioning.get_hypercell_bounds()
        self.cell_lower = jnp.asarray(bounds[0], jnp.float32)
        self.cell_upper = jnp.asarray(bounds[1], jnp.float32)

    def __call__(self, X, return_dx: bool = False):
        X = np.atleast_2d(np.asarray(X, dtype=object))
        mu, mse = self.model.predict(np.asarray(X, dtype=float), eval_MSE=True)
        mu = jnp.asarray(np.atleast_2d(mu), jnp.float32)
        sigma = jnp.sqrt(jnp.maximum(jnp.asarray(np.atleast_2d(mse), jnp.float32), 0.0))
        vals = np.asarray(ehvi(mu, sigma, self.cell_lower, self.cell_upper), dtype=float)
        out = vals if vals.size > 1 else float(vals.ravel()[0])
        if not return_dx:
            return out
        raise NotImplementedError("use the fused jax path for gradients")
