"""Plain float64 numpy references for the GP numerics.

Independent of the package's JAX code: the same semantics written the
straightforward way (LAPACK Cholesky, triangular solves, QR), used to check
what the package computes in float32 on the card.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.linalg as sla


def kernel(name: str, theta, X, Y=None) -> np.ndarray:
    """Correlation k(X, Y) with r^2 = sum_d theta_d (x_d - y_d)^2, for the
    package's "matern" (nu = 3/2), "matern52" and "squared_exponential"."""
    X = np.asarray(X, np.float64)
    Yv = X if Y is None else np.asarray(Y, np.float64)
    theta = np.broadcast_to(np.asarray(theta, np.float64), (X.shape[1],))
    r2 = sum(t * (X[:, None, j] - Yv[None, :, j]) ** 2 for j, t in enumerate(theta))
    r = np.sqrt(r2)
    if name in ("matern", "matern32"):
        s = math.sqrt(3.0) * r
        K = (1.0 + s) * np.exp(-s)
    elif name == "matern52":
        s = math.sqrt(5.0) * r
        K = (1.0 + s + s * s / 3.0) * np.exp(-s)
    elif name in ("squared_exponential", "rbf"):
        K = np.exp(-r2)
    else:
        raise ValueError(f"no reference for kernel {name!r}")
    if Y is None:
        np.fill_diagonal(K, 1.0)
    return K


def noisy_correlation(kernel_name, theta, sigma2, noise_var, X, jitter=1e-6):
    """R of the 'noisy' estimation mode: (sigma2 R0 + (noise + jitter) I) /
    (sigma2 + noise + jitter), with R0 carrying 1 + jitter on its diagonal."""
    n = len(X)
    R0 = kernel(kernel_name, theta, X) + jitter * np.eye(n)
    return (sigma2 * R0 + (noise_var + jitter) * np.eye(n)) / (sigma2 + noise_var + jitter)


def _gls(R, y):
    """Cholesky of R and the GLS fit of a constant trend to y."""
    L = np.linalg.cholesky(R)
    y = np.asarray(y, np.float64).reshape(-1)
    Yt = sla.solve_triangular(L, y, lower=True)
    Ft = sla.solve_triangular(L, np.ones(len(y)), lower=True)
    beta = float(Ft @ Yt / (Ft @ Ft))
    return L, beta, Yt - Ft * beta


def concentrated_nll(X, y, theta, sigma2, noise_var, kernel_name="matern", jitter=1e-6) -> float:
    """Negative concentrated log-likelihood of the 'noisy' mode with an
    estimated constant trend (ref: bayes_optim gpr.py:920-985)."""
    R = noisy_correlation(kernel_name, theta, sigma2, noise_var, X, jitter)
    L, _beta, rho = _gls(R, y)
    total = sigma2 + noise_var
    n = len(rho)
    return 0.5 * (
        n * (math.log(total) + math.log(2.0 * math.pi))
        + 2.0 * np.sum(np.log(np.diag(L)))
        + float(rho @ rho) / total
    )


def posterior_mean(X, y, Xq, theta, sigma2, noise_var, kernel_name="matern", jitter=1e-6):
    """BLUP mean beta + k(Xq, X) gamma, gamma = sigma2/total * R^-1 (y - beta)."""
    R = noisy_correlation(kernel_name, theta, sigma2, noise_var, X, jitter)
    L, beta, rho = _gls(R, y)
    gamma = sla.solve_triangular(L.T, rho, lower=False) * (sigma2 / (sigma2 + noise_var))
    return beta + kernel(kernel_name, theta, Xq, X) @ gamma


def whiten_value_grad(R, B):
    """f(R) = log det L + ||L^-1 B||^2 for R = L L^T, and its gradient with
    respect to symmetric R: R^-1 / 2 - (R^-1 B)(R^-1 B)^T."""
    R = np.asarray(R, np.float64)
    B = np.asarray(B, np.float64)
    c = sla.cho_factor(R, lower=True)
    L = np.tril(c[0])
    W = sla.solve_triangular(L, B, lower=True)
    value = float(np.sum(np.log(np.diag(L))) + np.sum(W * W))
    Rinv = sla.cho_solve(c, np.eye(len(R)))
    RinvB = sla.cho_solve(c, B)
    return value, 0.5 * Rinv - RinvB @ RinvB.T


def relative_errors(value, grad, ref_value, ref_grad):
    """(|value - ref| / max(1, |ref|), max|grad - ref| / max|ref|)."""
    grad = np.asarray(grad, np.float64)
    ve = abs(float(value) - ref_value) / max(1.0, abs(ref_value))
    ge = float(np.abs(grad - ref_grad).max() / np.abs(ref_grad).max())
    return ve, ge
