"""Masked, batched GP log-likelihoods and posterior state.

Numerical parity with the reference's likelihood machinery
(ref: bayes_optim/surrogate/gaussian_process/gpr.py:772-1040):

- `concentrated` likelihood — trend coefficients beta (GLS) and, in
  noiseless/noise_estim modes, the process variance sigma2 concentrated out
  (gpr.py:920-1040). Three estimation modes: 'noiseless' (par = theta),
  'noisy' (par = theta ++ sigma2, fixed noise_var; the reference's default
  since nugget=1e-6 makes it "noisy", gpr.py:256-263), and 'noise_estim'
  (par = theta ++ alpha with R = alpha R0 + (1-alpha) I, gpr.py:949-961).
- `restricted` (REML) likelihood (gpr.py:813-918).

All parameters arrive in log10 space, exactly like the reference's MLE
driver (gpr.py:1089-1110).

Accelerator design: one jittable `neg_log_likelihood(log10_par, data)`
whose gradient is autodiff (the reference hand-codes kernel/likelihood
gradients); it vmaps over a *batch* of hyperparameter vectors so
multi-restart MLE and HMC evaluate many candidates per Cholesky batch.
Variable n is
handled by bucketed padding with a mask: padded rows/cols of R are identity,
padded y/F rows are zero, so Cholesky/QR/triangular solves stay fixed-shape
with zero contribution from padding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..ops.linalg import chol_inv_whiten, whiten
from .kernels import kernel_fn

_LOG2PI = math.log(2.0 * math.pi)

# smallest acceptable raw Cholesky pivot: below this the 1e-12 clamp in
# ops/linalg produced a wrong-but-finite factorization and the likelihood
# value is garbage — penalize instead of trusting it (advisor finding r2)
PIV_TOL = 1e-10


class GPConfig(NamedTuple):
    """Static (hashable) GP configuration — safe to close over in jit."""

    kernel: str = "matern"
    mode: str = "noisy"  # 'noiseless' | 'noisy' | 'noise_estim'
    likelihood: str = "concentrated"  # 'concentrated' | 'restricted'
    estimate_trend: bool = True
    n_basis: int = 1
    trend: str = "constant"  # 'constant' | 'linear' | 'quadratic' | 'custom'
    jitter: float = 1e-6
    n_ensemble: int = 0  # >0: PosteriorState carries a leading sample axis
                         # (HMC/VI posterior over hyperparameters)
    theta_prior_strength: float = 0.0  # >0: MAP with a weak Gaussian prior
        # on log10(theta), centered mid-bounds with sd = half the log-range.
        # Cures the "white-noise" MLE pathology (theta -> upper bound makes
        # the kernel ~ I, likelihood maximal with few points in high-D, and
        # the acquisition surface collapses to variance-chasing); 0 = pure
        # MLE (reference behavior)


def trend_basis(config: "GPConfig", X: jnp.ndarray) -> jnp.ndarray:
    """Rebuild the trend basis F(X) inside a jitted program from the static
    config (mirrors models/trend.py for the three built-in trends)."""
    if config.trend == "constant":
        return jnp.ones((X.shape[0], 1), X.dtype)
    if config.trend == "linear":
        return jnp.concatenate([jnp.ones((X.shape[0], 1), X.dtype), X], axis=1)
    if config.trend == "quadratic":
        import numpy as _np

        iu, ju = _np.triu_indices(X.shape[1])
        return jnp.concatenate(
            [jnp.ones((X.shape[0], 1), X.dtype), X, X[:, iu] * X[:, ju]], axis=1
        )
    raise ValueError(f"cannot rebuild custom trend {config.trend!r} inside jit")


def n_hyper_params(dim: int, config: GPConfig) -> int:
    """Length of the log10-parameter vector: theta (dim) plus sigma2 or alpha."""
    return dim + (0 if config.mode == "noiseless" else 1)


def split_params(log10_par: jnp.ndarray, config: GPConfig):
    """log10 parameter vector -> (theta, extra) in linear space."""
    if config.mode == "noiseless":
        return 10.0 ** log10_par, None
    return 10.0 ** log10_par[:-1], 10.0 ** log10_par[-1]


def _masked_correlation(theta, X, mask, kern, jitter, dtype):
    """R0 with padded rows/cols zeroed off-diagonal and unit diagonal."""
    R0 = kern(theta, X)
    m2 = jnp.outer(mask, mask)
    eye = jnp.eye(X.shape[0], dtype=dtype)
    return R0 * m2 * (1.0 - eye) + (1.0 + jitter) * eye


class AuxState(NamedTuple):
    L: jnp.ndarray        # cholesky of R (masked)
    L_inv: jnp.ndarray    # explicit L^-1 (ops/linalg.chol_and_inv)
    Yt: jnp.ndarray       # L^-1 y
    Ft: jnp.ndarray       # L^-1 F (or zeros when trend fixed)
    Q: jnp.ndarray        # economic QR of Ft
    G: jnp.ndarray
    beta: jnp.ndarray     # GLS trend coefficients (p, m)
    rho: jnp.ndarray      # residuals in whitened space (n_pad, m)
    min_pivot: jnp.ndarray  # smallest raw Cholesky pivot; <= ~0 => clamped
                            # (wrong) factorization (ops/linalg)


def _aux(R, Y, F, beta0, config: GPConfig) -> AuxState:
    """Cholesky + whitened GLS (ref parity: gpr.py:790-811).

    Uses the blocked Cholesky of ops/linalg.py: its explicit L^-1 turns
    every whitening solve into a matmul, and its custom VJP is GEMM-only."""
    hi = jax.lax.Precision.HIGHEST  # TF32 matmul passes corrupt the GLS fit
    m = Y.shape[1]
    L, L_inv, W, min_pivot = chol_inv_whiten(R, jnp.concatenate([Y, F], axis=1))
    Yt = W[:, :m]
    Ft = W[:, m:]
    if config.estimate_trend:
        Q, G = jnp.linalg.qr(Ft, mode="reduced")
        beta = solve_triangular(G, jnp.dot(Q.T, Yt, precision=hi), lower=False)
        rho = Yt - jnp.dot(Ft, beta, precision=hi)
    else:
        p = F.shape[1]
        Q = jnp.zeros_like(Ft)
        G = jnp.eye(p, dtype=R.dtype)
        beta = jnp.broadcast_to(beta0.reshape(p, -1), (p, Y.shape[1])).astype(R.dtype)
        rho = Yt - jnp.dot(Ft, beta, precision=hi)
    return AuxState(L, L_inv, Yt, Ft, Q, G, beta, rho, min_pivot)


def _resolve_variances(extra, rho, n, p, noise_var, config: GPConfig):
    """Per-mode (sigma2[m], noise_var[m], sigma2_total[m]) resolution."""
    m_ss = jnp.sum(rho * rho, axis=0)  # (m,)
    if config.mode == "noiseless":
        dof = n - (p if config.estimate_trend else 0)
        sigma2 = m_ss / jnp.maximum(dof, 1.0)
        return sigma2, jnp.zeros_like(sigma2), sigma2
    if config.mode == "noise_estim":
        alpha = extra
        sigma2_total = m_ss / jnp.maximum(n, 1.0)
        return alpha * sigma2_total, (1.0 - alpha) * sigma2_total, sigma2_total
    # 'noisy': sigma2 is a free hyperparameter, noise_var fixed
    sigma2 = jnp.broadcast_to(extra, m_ss.shape)
    nv = jnp.broadcast_to(jnp.asarray(noise_var, rho.dtype), m_ss.shape)
    return sigma2, nv, sigma2 + nv


def _correlation_for_mode(theta, extra, X, mask, noise_var, config: GPConfig, dtype):
    kern = kernel_fn(config.kernel)
    R0 = _masked_correlation(theta, X, mask, kern, config.jitter, dtype)
    eye = jnp.eye(X.shape[0], dtype=dtype)
    if config.mode == "noiseless":
        return R0
    if config.mode == "noise_estim":
        alpha = extra
        return alpha * R0 + (1.0 - alpha + config.jitter) * eye
    sigma2 = extra
    total = sigma2 + noise_var
    return (sigma2 * R0 + (noise_var + config.jitter) * eye) / (total + config.jitter)


def _masked_logdet_d(d, mask):
    safe = jnp.where(mask > 0, d, 1.0)
    return jnp.sum(jnp.log(jnp.maximum(safe, 1e-300)))


def _aux_nll(R, Y, F, mask, beta0, config: GPConfig):
    """Whitened GLS for the LIKELIHOOD only: no L matrices escape, so the
    factor+solve runs through ops/linalg.whiten — one compact blocked
    program per eval.
    Returns (logdet_L, Ft, G, beta, rho, min_pivot)."""
    hi = jax.lax.Precision.HIGHEST
    m = Y.shape[1]
    d, W, min_pivot = whiten(R, jnp.concatenate([Y, F], axis=1))
    Yt = W[:, :m]
    Ft = W[:, m:]
    if config.estimate_trend:
        Q, G = jnp.linalg.qr(Ft, mode="reduced")
        beta = solve_triangular(G, jnp.dot(Q.T, Yt, precision=hi), lower=False)
    else:
        p = F.shape[1]
        G = jnp.eye(p, dtype=R.dtype)
        beta = jnp.broadcast_to(beta0.reshape(p, -1), (p, m)).astype(R.dtype)
    rho = Yt - jnp.dot(Ft, beta, precision=hi)
    return _masked_logdet_d(d, mask), Ft, G, beta, rho, min_pivot


def neg_log_likelihood(
    log10_par: jnp.ndarray,
    X: jnp.ndarray,
    Y: jnp.ndarray,
    F: jnp.ndarray,
    mask: jnp.ndarray,
    n: jnp.ndarray,
    noise_var,
    beta0,
    config: GPConfig,
    prior_lo=None,
    prior_hi=None,
) -> jnp.ndarray:
    """Negative log-likelihood (summed over targets) for one log10-parameter
    vector; vmap over axis 0 of `log10_par` for batched evaluation.
    With config.theta_prior_strength > 0 and (prior_lo, prior_hi) the
    log10-space bounds, adds the MAP penalty described on GPConfig."""
    dtype = X.dtype
    theta, extra = split_params(log10_par.astype(dtype), config)
    R = _correlation_for_mode(theta, extra, X, mask, noise_var, config, dtype)
    logdet_L, Ft_w, G_w, _beta, rho, min_pivot = _aux_nll(R, Y, F, mask, beta0, config)
    p = F.shape[1]
    m = Y.shape[1]
    sigma2, nv, sigma2_total = _resolve_variances(extra, rho, n, p, noise_var, config)
    m_ss = jnp.sum(rho * rho, axis=0)

    if config.likelihood == "restricted":
        # REML (ref parity: gpr.py:849-869)
        if config.estimate_trend:
            FtF = jnp.dot(F.T, F, precision=jax.lax.Precision.HIGHEST)
            sign, logdet_FtF = jnp.linalg.slogdet(FtF)
            logdet_G = jnp.sum(jnp.log(jnp.maximum(jnp.abs(jnp.diagonal(G_w)), 1e-300)))
            ll = -0.5 * jnp.sum(
                (n - p) * (jnp.log(sigma2_total) + _LOG2PI)
                - logdet_FtF
                + 2.0 * logdet_L
                + 2.0 * logdet_G
                + m_ss / sigma2_total
            )
        else:
            ll = -0.5 * jnp.sum(
                n * (jnp.log(sigma2_total) + _LOG2PI) + 2.0 * logdet_L + m_ss / sigma2_total
            )
        nll = -ll
        ok = jnp.isfinite(nll) & (min_pivot > PIV_TOL)
        return jnp.where(ok, nll, jnp.asarray(1e12, dtype))

    # concentrated (ref parity: gpr.py:920-985)
    if config.mode == "noisy":
        ll = -0.5 * jnp.sum(
            n * (jnp.log(sigma2_total) + _LOG2PI) + 2.0 * logdet_L + m_ss / sigma2_total
        )
    else:
        # sigma2(_total) concentrated out
        s2 = sigma2_total
        ll = -0.5 * jnp.sum(n * (jnp.log(jnp.maximum(s2, 1e-300)) + _LOG2PI) + 2.0 * logdet_L + n)
    # guard: non-finite OR a clamped-pivot (indefinite/near-singular R)
    # factorization -> huge penalty so optimizers move away AND fit()'s
    # ok-check still sees the degeneracy (the clamp keeps values finite,
    # so isfinite alone can no longer fire; advisor finding r2). PIV_TOL
    # sits well below legitimate f32 pivots of jittered correlation
    # matrices (>= ~1e-7) but above the 1e-12 clamp floor.
    nll = -ll
    if config.theta_prior_strength > 0.0 and prior_lo is not None:
        mid = 0.5 * (prior_lo + prior_hi)
        sd = jnp.maximum(0.5 * (prior_hi - prior_lo), 1e-6)
        z = (log10_par.astype(dtype) - mid) / sd
        nll = nll + config.theta_prior_strength * 0.5 * jnp.sum(z * z)
    ok = jnp.isfinite(nll) & (min_pivot > PIV_TOL)
    return jnp.where(ok, nll, jnp.asarray(1e12, dtype))


class PosteriorState(NamedTuple):
    """Everything `predict` needs, all fixed-shape (padded) arrays."""

    theta: jnp.ndarray
    L: jnp.ndarray
    L_inv: jnp.ndarray     # (n_pad, n_pad): explicit L^-1 so per-query MSE is
                           # a GEMM instead of a triangular solve (an O(n)-deep
                           # dependency chain per acquisition evaluation)
    Ft: jnp.ndarray
    G: jnp.ndarray
    G_inv: jnp.ndarray     # (p, p): explicit G^-1 — the p x p triangular-solve
                           # custom-call cannot be partitioned by GSPMD over a
                           # population-sharded query axis (it forced an
                           # all-gather per generation in sharded argmax loops)
    beta: jnp.ndarray      # (p, m)
    gamma: jnp.ndarray     # (n_pad, m): scale * L^-T rho
    sigma2: jnp.ndarray    # (m,)
    noise_var: jnp.ndarray # (m,)
    scale: jnp.ndarray     # sigma2 / sigma2_total
    X: jnp.ndarray
    mask: jnp.ndarray
    min_pivot: jnp.ndarray  # smallest raw Cholesky pivot at the chosen
                            # hyperparameters; <= PIV_TOL => the explicit
                            # L_inv is garbage, fit() must escalate


def posterior_state(
    log10_par, X, Y, F, mask, n, noise_var, beta0, config: GPConfig
) -> PosteriorState:
    """Recompute the fit-time auxiliary state at the chosen hyperparameters
    (ref parity: env capture in gpr.py:986-996 + compute_beta_gamma:784-788)."""
    dtype = X.dtype
    theta, extra = split_params(jnp.asarray(log10_par, dtype), config)
    R = _correlation_for_mode(theta, extra, X, mask, noise_var, config, dtype)
    aux = _aux(R, Y, F, beta0, config)
    p = F.shape[1]
    sigma2, nv, sigma2_total = _resolve_variances(extra, aux.rho, n, p, noise_var, config)
    scale = sigma2 / jnp.maximum(sigma2_total, 1e-300)
    hi = jax.lax.Precision.HIGHEST
    gamma = jnp.dot(aux.L_inv.T, aux.rho, precision=hi) * scale[None, :]
    gamma = gamma * mask[:, None]
    L_inv = aux.L_inv
    G_inv = solve_triangular(aux.G, jnp.eye(aux.G.shape[0], dtype=dtype), lower=False)
    return PosteriorState(
        theta=theta, L=aux.L, L_inv=L_inv, Ft=aux.Ft, G=aux.G, G_inv=G_inv,
        beta=aux.beta, gamma=gamma, sigma2=sigma2, noise_var=nv, scale=scale,
        X=X, mask=mask, min_pivot=aux.min_pivot,
    )


def predict(
    state: PosteriorState,
    Xq: jnp.ndarray,
    Fq: jnp.ndarray,
    config: GPConfig,
    eval_mse: bool = True,
):
    """Batched BLUP mean and MSE at query points (ref parity: gpr.py:424-535,
    but evaluated for the whole candidate batch in one XLA program).

    Returns (mu[Nq, m], mse[Nq, m]) — mse is the posterior variance of the
    latent process (no observation noise), clipped at 0.
    """
    kern = kernel_fn(config.kernel)
    hi = jax.lax.Precision.HIGHEST  # TF32 matmul passes corrupt posteriors
    r0 = kern(state.theta, Xq, state.X) * state.mask[None, :]  # (Nq, n_pad)
    mu = jnp.dot(Fq, state.beta, precision=hi) + jnp.dot(r0, state.gamma, precision=hi)
    if not eval_mse:
        return mu, None
    rt = jnp.dot(state.L_inv, r0.T, precision=hi)  # (n_pad, Nq), pure GEMM
    reduction = jnp.sum(rt * rt, axis=0)  # (Nq,)
    if config.estimate_trend:
        u = jnp.dot(
            state.G_inv.T, jnp.dot(state.Ft.T, rt, precision=hi) - Fq.T,
            precision=hi,
        )  # (p, Nq), pure GEMM: (G^T)^-1 B = (G^-1)^T B
        correction = jnp.sum(u * u, axis=0)
    else:
        correction = jnp.zeros_like(reduction)
    base = 1.0 - state.scale[None, :] * reduction[:, None] + correction[:, None]
    mse = jnp.maximum(base * state.sigma2[None, :], 0.0)
    return mu, mse


def predict_ensemble(state: PosteriorState, Xq, Fq, config: GPConfig, eval_mse: bool = True):
    """Posterior-mixture prediction for a stacked PosteriorState with a
    leading sample axis (hyperparameter posterior from HMC/VI): the mixture
    mean and the law-of-total-variance mixture variance."""
    point_cfg = config._replace(n_ensemble=0)
    mus, vars_ = jax.vmap(lambda st: predict(st, Xq, Fq, point_cfg, True))(state)
    mu = jnp.mean(mus, axis=0)
    if not eval_mse:
        return mu, None
    var = jnp.mean(vars_ + mus**2, axis=0) - mu**2
    return mu, jnp.maximum(var, 0.0)
