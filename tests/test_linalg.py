"""Golden tests for the compact blocked Cholesky (ops/linalg.py) against
numpy/jax reference implementations — values, inverses, solves, gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_optimization_tpu.ops.linalg import (
    chol_and_inv, tri_solve_lower, tri_solve_upper_t, whiten, _factor,
)


def _spd(n, seed=0, cond="easy"):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 16)).astype(np.float32)
    if cond == "easy":
        return (X @ X.T / 16 + np.eye(n) * n).astype(np.float32) / n
    # kernel-like: moderately ill-conditioned
    Z = rng.uniform(0, 1, (n, 4))
    D = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    return (np.exp(-5.0 * D) + 1e-4 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [16, 64, 128, 256, 512, 1024])
def test_chol_and_inv_matches_numpy(n):
    R = _spd(n)
    L_ref = np.linalg.cholesky(np.asarray(R, np.float64))
    L, Li, piv = jax.jit(chol_and_inv)(jnp.asarray(R))
    rel = np.abs(np.asarray(L, np.float64) - L_ref).max() / np.abs(L_ref).max()
    assert rel < 1e-5, rel
    resid = np.abs(np.asarray(Li, np.float64) @ L_ref - np.eye(n)).max()
    assert resid < 1e-4, resid
    assert float(piv) > 0.0


@pytest.mark.parametrize("n", [128, 256])
def test_chol_and_inv_kernel_like(n):
    R = _spd(n, seed=3, cond="kernel")
    L_ref = np.linalg.cholesky(np.asarray(R, np.float64))
    L, Li, piv = jax.jit(chol_and_inv)(jnp.asarray(R))
    rel = np.abs(np.asarray(L, np.float64) - L_ref).max() / np.abs(L_ref).max()
    assert rel < 1e-3, rel
    assert float(piv) > 0.0


@pytest.mark.parametrize("n", [64, 256])
def test_tri_solves(n):
    R = _spd(n, seed=1)
    B = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    L, Dinv, _piv = jax.jit(_factor)(jnp.asarray(R))
    L64 = np.asarray(L, np.float64)
    X1 = np.asarray(tri_solve_lower(L, Dinv, jnp.asarray(B)), np.float64)
    assert np.abs(L64 @ X1 - B).max() < 1e-4
    X2 = np.asarray(tri_solve_upper_t(L, Dinv, jnp.asarray(B)), np.float64)
    assert np.abs(L64.T @ X2 - B).max() < 1e-4


def test_whiten_value_and_grad():
    n = 256
    R = jnp.asarray(_spd(n, seed=4))
    B = jnp.asarray(np.random.default_rng(5).standard_normal((n, 2)).astype(np.float32))

    def f_new(R):
        d, W, _ = whiten(R, B)
        return jnp.sum(jnp.log(d)) + jnp.sum(W**2)

    def f_ref(R):
        L = jnp.linalg.cholesky(R)
        W = jax.scipy.linalg.solve_triangular(L, B, lower=True)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(W**2)

    v1, v2 = f_new(R), f_ref(R)
    assert abs(float(v1) - float(v2)) < 1e-2 * max(1.0, abs(float(v2)))
    g1, g2 = jax.grad(f_new)(R), jax.grad(f_ref)(R)
    rel = float(jnp.abs(g1 - g2).max() / jnp.abs(g2).max())
    assert rel < 1e-3, rel


def test_vmap_batch():
    # batched factorization under vmap (multi-restart MLE shape)
    Rs = jnp.stack([jnp.asarray(_spd(128, seed=s)) for s in range(4)])
    Ls, Lis, _ = jax.vmap(chol_and_inv)(Rs)
    for i in range(4):
        ref = np.linalg.cholesky(np.asarray(Rs[i], np.float64))
        assert np.abs(np.asarray(Ls[i], np.float64) - ref).max() < 1e-4


def test_min_pivot_flags_indefinite():
    # an indefinite matrix must be flagged by min_pivot <= 0 even though the
    # clamp keeps the factorization finite (advisor finding r2)
    n = 128
    R = _spd(n, seed=7)
    R = np.asarray(R, np.float64)
    R[0, 0] = -1.0  # make it indefinite
    L, Li, piv = jax.jit(chol_and_inv)(jnp.asarray(R, jnp.float32))
    assert float(piv) <= 0.0
    d, W, piv2 = whiten(jnp.asarray(R, jnp.float32), jnp.ones((n, 1), jnp.float32))
    assert float(piv2) <= 0.0


@pytest.mark.parametrize("n", [128, 256, 512])
def test_whiten_matches_float64_at_nugget_1e6(n):
    """whiten's value and gradient on a Matern-5/2 GP correlation matrix at
    nugget 1e-6 against float64 numpy, at the tolerances above."""
    from benchmark import reference as ref

    X = np.random.default_rng(n).uniform(0.0, 1.0, (n, 5))
    R = ref.kernel("matern52", 10.0, X) + 1e-6 * np.eye(n)
    B = np.random.default_rng(1).standard_normal((n, 2))

    def f(R, B):
        d, W, _ = whiten(R, B)
        return jnp.sum(jnp.log(d)) + jnp.sum(W**2)

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(R, jnp.float32), jnp.asarray(B, jnp.float32))
    ve, ge = ref.relative_errors(v, g, *ref.whiten_value_grad(R, B))
    assert ve < 1e-2, ve
    assert ge < 1e-3, ge
