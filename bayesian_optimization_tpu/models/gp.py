"""Gaussian-process surrogate (Kriging) with batched, jitted fitting.

Capability parity with the reference's `GaussianProcess`
(ref: bayes_optim/surrogate/gaussian_process/gpr.py:78-1248): anisotropic
length-scales `theta` box-bounded in [thetaL, thetaU] and optimized in log10
space; three estimation modes (noiseless / noisy / noise_estim via the alpha
split); concentrated and restricted (REML) likelihoods; universal/ordinary
kriging trends; BLUP predict with MSE; posterior-mean/variance gradients;
automatic nugget escalation when the likelihood degenerates
(ref: gpr.py:384-399).

Accelerator design:
- multi-restart MLE runs as ONE vmapped L-BFGS program (all restarts
  advance together; each step is a batched Cholesky) instead of
  the reference's sequential `fmin_l_bfgs_b` loop (gpr.py:1127-1162);
- observations are padded to size buckets so refits during a BO run reuse
  compiled programs instead of recompiling at every n;
- predict evaluates arbitrary candidate batches in one fused program
  (the reference's acquisition path calls predict one point at a time);
- all gradients (theta-likelihood, x-posterior) come from autodiff; the
  reference's ~400 lines of hand-written kernel derivatives
  (gpr.py:600-770) have no counterpart.
"""
from __future__ import annotations

import os as _os
from functools import partial, wraps
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.optimize import minimize_restarts
from .likelihood import (
    GPConfig,
    PosteriorState,
    n_hyper_params,
    neg_log_likelihood,
    posterior_state,
    predict as _predict_point,
    predict_ensemble as _predict_ens,
)


def _predict_impl(state, Xq, Fq, config, eval_mse=True):
    if config.n_ensemble > 0:
        return _predict_ens(state, Xq, Fq, config, eval_mse)
    return _predict_point(state, Xq, Fq, config, eval_mse)
from .trend import BasisExpansionTrend, NonparametricTrend, constant_trend


def _mle_ladder_plan(n, n_pad, n_restarts, max_iter, multi_fidelity):
    """Successive-halving MLE schedule shared by fit() and precompile().

    Returns (rungs, final): rungs is a list of (ns, n_starts_in, iters)
    explore stages on data subsets; final is (n_starts_in, iters) for the
    full-data _fit_kernel stage.

    Rung sizes are capped at the largest 128-multiple <= n (the blocked
    Cholesky requires n % 128 == 0 above 128): deriving them from n_pad
    alone crashed fit() for n in the upper-middle of a padding bucket —
    e.g. n = 1100 pads to 4096 and the n_pad // 2 = 2048 rung asked
    rng.choice for a 2048-subset of 1100 points."""
    if multi_fidelity and n >= 512 and n_restarts > 4:
        cap = max(128, (n // 128) * 128)  # floor to a 128-multiple
        if n_pad // 4 >= 256:
            # 3 rungs: all restarts on ~n/4, top 6 on ~n/2, top 2 on full data
            r1 = min(n_pad // 4, cap)
            r2 = min(n_pad // 2, cap)
            rungs = [(r1, n_restarts, max(5, max_iter // 2))]
            if r2 > r1:
                rungs.append((r2, 6, max(5, max_iter // 4)))
            return rungs, (2 if r2 > r1 else 4, max(6, (3 * max_iter) // 10))
        # 2 rungs: all restarts on ~n/2, top 4 on full data
        return (
            [(min(n_pad // 2, cap), n_restarts, max(5, max_iter // 2))],
            (4, max(5, max_iter // 2)),
        )
    return [], (n_restarts, max_iter)


def _bucket(n: int) -> int:
    """Pad count n up to a size bucket to bound recompilation.

    Buckets are geometric (x4) so that a BO run from DoE to max_FEs
    crosses at most a couple of buckets instead of recompiling every 64
    observations; the price is padded Cholesky FLOPs (n=1100 factorizes
    at 4096)."""
    b = 16
    while b < n:
        b *= 4
    return b


@partial(jax.jit, static_argnames=("config", "plan", "max_ls"))
def _ladder_kernel(x0_batch, lo, hi, stages, noise_var, beta0, config, plan, max_ls=12):
    """Fused successive-halving MLE ladder: every explore rung AND the final
    full-data stage run inside ONE XLA program — restarts are ranked and
    culled between rungs by an on-device argsort+gather instead of a host
    round trip. One executable to compile per fit shape.

    stages: tuple of (X, Y, F, mask, n) data tuples, one per plan entry,
            full-data stage last.
    plan:   static tuple of (n_starts_in, max_iter), aligned with stages.
    """
    xs = x0_batch
    res = None
    for i, (stage, (n_in, iters)) in enumerate(zip(stages, plan)):
        X, Y, F, mask, n = stage
        nll = lambda p, s=stage: neg_log_likelihood(
            p, s[0], s[1], s[2], s[3], s[4], noise_var, beta0, config,
            prior_lo=lo, prior_hi=hi,
        )
        res = minimize_restarts(
            nll, xs[:n_in], lo, hi, max_iter=iters, max_linesearch_steps=max_ls
        )
        if i + 1 < len(plan):
            xs = res.x[jnp.argsort(res.fun)]
    X, Y, F, mask, n = stages[-1]
    state = posterior_state(res.x_best, X, Y, F, mask, n, noise_var, beta0, config)
    return res.x_best, res.fun_best, state


@jax.jit
def _fit_summary(par, nll, state):
    """Everything fit() needs back on the host, computed on device and
    returned as ONE small pytree so a single device_get replaces
    per-array pulls (each np.asarray is its own device-to-host copy). ok folds
    the degenerate-likelihood check: finite nll below the 1e12 penalty,
    finite gamma, and the factorization's raw pivots above PIV_TOL at the
    chosen hyperparameters (the clamp keeps values finite, so isfinite
    alone cannot fire; advisor finding r2)."""
    from .likelihood import PIV_TOL

    ok = (
        jnp.isfinite(nll)
        & (nll < 1e11)
        & jnp.all(jnp.isfinite(state.gamma))
        & (jnp.min(state.min_pivot) > PIV_TOL)
    )
    return ok, 10.0 ** par, nll, state.sigma2, state.beta


@partial(jax.jit, static_argnames=("config",))
def _probe_kernel(x0_batch, lo, hi, X, Y, F, mask, n, noise_var, beta0, config):
    """Batched likelihood probe at the restart points on the FULL data —
    one vmapped eval that tells whether every start sits in the 1e12
    penalty region (non-finite / clamped factorization). When they all do,
    the MLE ladder would burn its whole budget idling on the zero-gradient
    plateau before the nugget escalation fires; the probe lets fit()
    escalate immediately instead."""
    nll = lambda p: neg_log_likelihood(
        p, X, Y, F, mask, n, noise_var, beta0, config, prior_lo=lo, prior_hi=hi
    )
    return jax.vmap(nll)(x0_batch)


def _ensemble_posterior(pars, logp, X, Y, F, mask, n, noise_var, beta0, config):
    """Stack per-sample point posteriors for an (S, d) hyperparameter
    ensemble and return (mean nll, stacked states) — shared tail of the
    HMC/NUTS and VI fit kernels."""
    point_cfg = config._replace(n_ensemble=0)
    states = jax.vmap(
        lambda p: posterior_state(p, X, Y, F, mask, n, noise_var, beta0, point_cfg)
    )(pars)
    return -jnp.mean(jax.vmap(logp)(pars)), states


@partial(jax.jit, static_argnames=("config", "n_ensemble", "n_warmup", "sampler", "n_warmup2"))
def _fit_kernel_hmc(
    key, x0_batch, lo, hi, X, Y, F, mask, n, noise_var, beta0, config,
    n_ensemble, n_warmup, sampler="hmc", warm_stage=None, carry=None, n_warmup2=None,
):
    """Posterior over hyperparameters by vectorized adaptive HMC or NUTS
    (north star): chains = rows of x0_batch; returns a stacked
    PosteriorState of n_ensemble samples plus the chain acceptance rate and
    the adapted (inv_mass, step_size) for carrying across BO refits.

    warm_stage: optional (Xs, Ys, Fs, masks, ns) data SUBSET — phase-1
    adaptation runs on its likelihood (an n/4 subset makes each warmup
    Cholesky ~64x cheaper; the multi-fidelity trick of the MLE ladder
    applied to the sampler). carry: optional (inv_mass, step_size) from the
    previous refit — skips phase 1 entirely."""
    from .hmc import hmc_sample, nuts_sample

    logp = lambda p: -neg_log_likelihood(
        p, X, Y, F, mask, n, noise_var, beta0, config, prior_lo=lo, prior_hi=hi
    )
    warm_logp = None
    if warm_stage is not None:
        Xs, Ys, Fs, masks, ns = warm_stage
        warm_logp = lambda p: -neg_log_likelihood(
            p, Xs, Ys, Fs, masks, ns, noise_var, beta0, config, prior_lo=lo, prior_hi=hi
        )
    init_inv_mass = carry[0] if carry is not None else None
    init_step = carry[1] if carry is not None else None
    C = x0_batch.shape[0]
    per_chain = max(1, -(-n_ensemble // C))
    if sampler == "nuts":
        res = nuts_sample(
            key, logp, x0_batch, lo, hi,
            n_warmup=n_warmup, n_samples=per_chain, max_depth=6, thin=2,
            warmup_log_prob_fn=warm_logp, init_inv_mass=init_inv_mass,
            init_step_size=init_step, n_warmup2=n_warmup2,
        )
    else:
        res = hmc_sample(
            key, logp, x0_batch, lo, hi,
            n_warmup=n_warmup, n_samples=per_chain, n_leapfrog=12, thin=2,
            warmup_log_prob_fn=warm_logp, init_inv_mass=init_inv_mass,
            init_step_size=init_step, n_warmup2=n_warmup2,
        )
    pars = res.samples.reshape(-1, x0_batch.shape[1])[:n_ensemble]  # (S, d)
    nll, states = _ensemble_posterior(pars, logp, X, Y, F, mask, n, noise_var, beta0, config)
    return pars, nll, states, res.accept_rate, res.inv_mass, res.step_size, res.samples


@partial(jax.jit, static_argnames=("config", "n_ensemble", "n_steps"))
def _fit_kernel_vi(key, lo, hi, X, Y, F, mask, n, noise_var, beta0, config, n_ensemble, n_steps):
    """Posterior over hyperparameters by mean-field Gaussian ADVI (the
    "marginal-likelihood VI" half of the project's north star; the
    reference's validated optimizer switch is gpr.py:1127-1181 — it has no
    VI option at all). The variational family lives in the sigmoid-
    unconstrained space; the fitted (mean, log_std) are sampled S times and
    mapped to box coordinates, then stacked into the same ensemble
    PosteriorState the HMC/NUTS paths produce, so prediction and the fused
    acquisition argmax mix the posterior identically downstream."""
    from .hmc import _to_box, fit_vi

    logp = lambda p: -neg_log_likelihood(
        p, X, Y, F, mask, n, noise_var, beta0, config, prior_lo=lo, prior_hi=hi
    )
    k_fit, k_sample = jax.random.split(key)
    mean, log_std = fit_vi(k_fit, logp, lo, hi, n_steps=n_steps)
    eps = jax.random.normal(k_sample, (n_ensemble, lo.shape[0]), lo.dtype)
    pars = _to_box(mean[None, :] + jnp.exp(log_std)[None, :] * eps, lo, hi)
    nll, states = _ensemble_posterior(pars, logp, X, Y, F, mask, n, noise_var, beta0, config)
    return pars, nll, states, (mean, log_std)


@partial(jax.jit, static_argnames=("config", "n_generations"))
def _fit_kernel_cma(key, x0_batch, lo, hi, X, Y, F, mask, n, noise_var, beta0, config, n_generations):
    """MLE by population (1+1)-Cholesky-CMA chains over log10 hyperparameters
    (replaces the reference's IPOP-CMA-ES option, ref: gpr.py:1164-1181 +
    cma_es.py — restarts become parallel chains instead of sequential
    lambda-doubling runs)."""
    from ..optim.cma import run_cma

    nll_batch = jax.vmap(
        lambda p: neg_log_likelihood(
            p, X, Y, F, mask, n, noise_var, beta0, config, prior_lo=lo, prior_hi=hi
        )
    )
    xb, fb, _, _ = run_cma(key, nll_batch, x0_batch, lo, hi, n_generations)
    state = posterior_state(xb, X, Y, F, mask, n, noise_var, beta0, config)
    return xb, fb, state


@partial(jax.jit, static_argnames=("config", "eval_mse"))
def _predict_kernel(state, Xq, Fq, config, eval_mse):
    return _predict_impl(state, Xq, Fq, config, eval_mse)


def _x64(fn):
    """Scope jax's x64 mode around a host-facing method when the model's
    dtype is float64 (without it, device_put/tracing silently canonicalize
    f64 arrays down to f32)."""

    @wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self.dtype == jnp.float64:
            with jax.enable_x64():
                return fn(self, *args, **kwargs)
        return fn(self, *args, **kwargs)

    return wrapper


class GaussianProcess:
    """Kriging surrogate over a numeric feature space (use
    `SpaceEncoding.unit_to_embed` upstream for mixed spaces)."""

    def __init__(
        self,
        mean: Optional[BasisExpansionTrend] = None,
        corr: str = "matern",
        theta0=None,
        thetaL=None,
        thetaU=None,
        sigma2=None,
        nugget: float = 1e-6,
        noise_estim: bool = False,
        optimizer: str = "BFGS",
        likelihood: str = "concentrated",
        random_start: Optional[int] = None,
        wait_iter: int = 5,
        eval_budget: Optional[int] = None,
        random_state=None,
        verbose: bool = False,
        dtype=jnp.float32,
        max_iter: int = 40,
        max_linesearch_steps: int = 12,
        multi_fidelity: bool = True,
        theta_prior_strength: float = 0.0,
    ):
        self.mean = mean
        self.corr_type = corr if isinstance(corr, str) else "custom"
        self._corr = corr
        self.theta0 = None if theta0 is None else np.atleast_1d(np.asarray(theta0, float))
        self.thetaL = None if thetaL is None else np.atleast_1d(np.asarray(thetaL, float))
        self.thetaU = None if thetaU is None else np.atleast_1d(np.asarray(thetaU, float))
        if self.thetaL is not None and not (
            np.isfinite(self.thetaL).all() and np.isfinite(self.thetaU).all()
        ):
            raise ValueError("all theta bounds must be finite")
        self.sigma2 = sigma2
        self.nugget = float(nugget) if nugget else 0.0
        self.noise_estim = bool(noise_estim)
        # validated dispatch (ref parity: the reference's optimizer switch
        # accepts exactly its two options, gpr.py:1127-1181; a typo here must
        # not silently fall through to the MLE ladder)
        if optimizer not in ("BFGS", "CMA", "HMC", "NUTS", "VI"):
            raise ValueError(
                f"unknown optimizer {optimizer!r}; expected one of "
                "'BFGS', 'CMA', 'HMC', 'NUTS', 'VI'"
            )
        self.optimizer = optimizer
        self.likelihood = likelihood
        self.random_start = random_start
        self.wait_iter = wait_iter
        self.eval_budget = eval_budget
        self.max_iter = int(max_iter)
        self.max_linesearch_steps = int(max_linesearch_steps)
        self.multi_fidelity = bool(multi_fidelity)
        self.theta_prior_strength = float(theta_prior_strength)
        self.verbose = verbose
        if isinstance(dtype, str):
            dtype = {
                "f32": jnp.float32, "float32": jnp.float32,
                "f64": jnp.float64, "float64": jnp.float64,
            }[dtype]
        # f64 runs the likelihood/posterior stack at reference-grade
        # precision (ref: the f64 numpy/LAPACK MLE of gpr.py:790-811,
        # 920-1040) through the same blocked linalg path; fit/predict scope
        # jax's x64 mode so the rest of the process stays canonical f32
        self.dtype = dtype
        self._rng = np.random.default_rng(
            random_state if isinstance(random_state, (int, np.integer)) else None
        )
        self.is_fitted = False
        self._state: Optional[PosteriorState] = None
        self._estimate_trend_user: Optional[bool] = None  # frozen on first _config()

        # estimation-mode resolution (ref parity: gpr.py:256-263)
        if self.noise_estim:
            self.estimation_mode = "noise_estim"
        elif self.nugget:
            self.estimation_mode = "noisy"
        else:
            self.estimation_mode = "noiseless"
        self.noise_var = self.nugget

    # ------------------------------------------------------------------
    def _config(self, dim: int) -> GPConfig:
        from .trend import constant_trend as _ct, linear_trend as _lt, quadratic_trend as _qt

        mean = self.mean
        # Whether trend coefficients are GLS-estimated is decided ONCE from
        # the user's constructor intent (beta=None) and then frozen: fit()
        # writes the estimated beta back into the trend for prediction, and
        # letting that writeback flip `estimate_coefficients` would (a) stop
        # re-estimating the trend on refits (diverging from the reference,
        # gpr.py:273-277) and (b) change this static config field, forcing a
        # full XLA recompile on the second fit.
        if self._estimate_trend_user is None:
            self._estimate_trend_user = (
                isinstance(mean, BasisExpansionTrend) and mean.estimate_coefficients
            )
        estimate_trend = self._estimate_trend_user
        n_basis = mean.n_basis if isinstance(mean, BasisExpansionTrend) else 1
        if isinstance(mean, NonparametricTrend):
            # residual GP: y - m(X) is fitted with a FIXED zero constant
            # trend (simple kriging), m(Xq) added back at predict time
            # (ref intent: trend.py:145-151 — the reference sets
            # mean_type="nonparametric" at gpr.py:276-277 but never consumes
            # it; here the residual route makes it actually work)
            trend_name = "constant"
        else:
            trend_name = {_ct: "constant", _lt: "linear", _qt: "quadratic"}.get(type(mean), "custom")
        return GPConfig(
            kernel=self.corr_type if isinstance(self._corr, str) else self._corr,
            mode=self.estimation_mode,
            likelihood=self.likelihood,
            estimate_trend=estimate_trend,
            n_basis=n_basis,
            trend=trend_name,
            jitter=1e-6,
            theta_prior_strength=self.theta_prior_strength,
        )

    def _trend_F(self, X: jnp.ndarray) -> jnp.ndarray:
        if isinstance(self.mean, BasisExpansionTrend):
            return self.mean.F(X)
        # NonparametricTrend (residual GP) and default: constant basis
        return jnp.ones((X.shape[0], 1), X.dtype)

    def _prior_mean(self, X: np.ndarray) -> Optional[np.ndarray]:
        """m(X) of a nonparametric prior trend, (n, m); None otherwise."""
        if isinstance(self.mean, NonparametricTrend):
            return np.asarray(self.mean(X), dtype=float).reshape(X.shape[0], -1)
        return None

    # ------------------------------------------------------------------
    def _hyper_bounds(self, dim: int, y: np.ndarray) -> np.ndarray:
        """log10-space bounds rows [lo, hi] (ref parity: gpr.py:1041-1056)."""
        rows = [np.log10(np.c_[self.thetaL, self.thetaU])]
        if self.estimation_mode == "noisy":
            hi = max(1e-3, float(np.std(y)) ** 2)
            rows.append(np.log10(np.atleast_2d([1e-5, hi])))
        elif self.estimation_mode == "noise_estim":
            rows.append(np.log10(np.atleast_2d([1e-10, 1.0 - 1e-10])))
        return np.concatenate(rows, axis=0)

    def _escalate_nugget(self, dim, y, noise_var, config, bounds, starts, R):
        """Degenerate-likelihood escalation (ref parity: gpr.py:384-399):
        a noiseless fit becomes noisy with a 1e-5 floor (new hyperparameter
        => fresh config/bounds/starts); an already-noisy fit bumps the
        noise x10. Shared by the all-dead probe and the post-fit ok check."""
        if self.estimation_mode == "noiseless":
            self.estimation_mode = "noisy"
            noise_var = 1e-5
            config = self._config(dim)
            bounds = self._hyper_bounds(dim, y)
            n_par = n_hyper_params(dim, config)
            starts = self._rng.uniform(bounds[:, 0], bounds[:, 1], size=(R, n_par))
        else:
            noise_var = max(noise_var, 1e-8) * 10.0
        return noise_var, config, bounds, starts

    def _data_subset_stage(self, Xp, Yp, n, n_pad):
        """Device-resident (Xs, Ys, Fs, ones, ns) likelihood stage on a
        random ~n/4 subset (128-multiple): the multi-fidelity trick shared
        by the MLE ladder and the sampler's phase-1 warmup."""
        cap = max(128, (n // 128) * 128)
        ns = min(n_pad // 4, cap)
        idx = self._rng.choice(n, size=ns, replace=False)
        Xs, Ys = jax.device_put(
            (Xp[idx].astype(self.dtype), Yp[idx].astype(self.dtype))
        )
        if not hasattr(self, "_const_cache"):
            self._const_cache = {}
        if ns not in self._const_cache:
            self._const_cache[ns] = (
                jnp.ones(ns, self.dtype),
                jnp.asarray(float(ns), self.dtype),
            )
        ones_ns, ns_j = self._const_cache[ns]
        return (Xs, Ys, self._trend_F(Xs), ones_ns, ns_j)

    def _run_mle_ladder(
        self, starts, lo_b, hi_b, data_host, data_dev, n, n_pad, nv_j, beta0, config,
        iters_scale: float = 1.0,
        warm_refit: bool = False,
    ):
        """Multi-fidelity MLE: a successive-halving ladder over data subsets
        replaces the reference's flat multi-restart budget (gpr.py:1058-1197).
        Each halving of the subset makes the Cholesky 8x cheaper, so wide
        exploration is nearly free and only the best basins ever touch the
        full data. The whole ladder is ONE jitted program (_ladder_kernel).
        iters_scale < 1 runs a shortened ladder (e.g. to seed sampler chains
        at the MAP).

        warm_refit=True (a BO-loop refit with < 25% new data since the last
        FULL ladder, fit() decides) skips the exploration rungs entirely:
        the previous optimum + the data-derived median-heuristic start
        polish on the full data at the full iteration budget. With the
        L-BFGS stall exit both lanes terminate within a few steps of
        convergence, so the refit pays ~one short full-data stage instead
        of the whole schedule; the 25%-growth trigger re-runs the global
        schedule periodically so the fit cannot track a stale local basin
        across a long run."""
        Xp, Yp = data_host
        Xj, Yj, Fj, maskj, n_j = data_dev
        max_iter = max(4, int(self.max_iter * iters_scale))
        if warm_refit:
            rungs, (n_final, iters_b) = [], (min(2, len(starts)), max_iter)
        else:
            rungs, (n_final, iters_b) = _mle_ladder_plan(
                n, n_pad, len(starts), max_iter, self.multi_fidelity
            )
        # rung subsets ship in ONE batched device_put; the per-size
        # constants (all-ones mask, count scalar) are cached across
        # refits, so a warm fit's rung uploads are one transfer
        idxs = [self._rng.choice(n, size=ns, replace=False) for ns, _, _ in rungs]
        subsets = jax.device_put(tuple(
            (Xp[idx].astype(self.dtype), Yp[idx].astype(self.dtype))
            for idx in idxs
        ))
        if not hasattr(self, "_const_cache"):
            self._const_cache = {}
        stages = []
        plan = []
        for (Xs, Ys), (ns, n_in, iters) in zip(subsets, rungs):
            if ns not in self._const_cache:
                self._const_cache[ns] = (
                    jnp.ones(ns, self.dtype),
                    jnp.asarray(float(ns), self.dtype),
                )
            ones_ns, ns_j = self._const_cache[ns]
            stages.append((Xs, Ys, self._trend_F(Xs), ones_ns, ns_j))
            plan.append((n_in, iters))
        stages.append((Xj, Yj, Fj, maskj, n_j))
        plan.append((n_final, iters_b))
        return _ladder_kernel(
            jnp.asarray(starts, self.dtype), lo_b, hi_b, tuple(stages),
            nv_j, beta0, config, tuple(plan), self.max_linesearch_steps,
        )

    @_x64
    def fit(self, X, y) -> "GaussianProcess":
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        n, dim = X.shape
        m = y.shape[1]
        if self.mean is None:
            self.mean = constant_trend(dim)
        # nonparametric prior mean: fit the GP on residuals y - m(X)
        # (simple kriging on the residual process); predict adds m back
        prior = self._prior_mean(X)
        if prior is not None:
            y = y - prior
        if self.thetaL is None or self.thetaU is None:
            raise ValueError("thetaL/thetaU are required for fitting")
        if len(self.thetaL) == 1 and dim > 1:
            self.thetaL = np.repeat(self.thetaL, dim)
            self.thetaU = np.repeat(self.thetaU, dim)

        config = self._config(dim)
        n_pad = _bucket(n)
        Xp = np.zeros((n_pad, dim))
        Xp[:n] = X
        Yp = np.zeros((n_pad, m))
        Yp[:n] = y
        mask = np.zeros(n_pad)
        mask[:n] = 1.0

        # ONE batched host->device transfer for the padded data
        Xj, Yj, maskj = jax.device_put(
            (Xp.astype(self.dtype), Yp.astype(self.dtype), mask.astype(self.dtype))
        )
        Fj = self._trend_F(Xj) * maskj[:, None]
        # beta0 is only consumed when the trend is NOT estimated; keep its
        # shape fixed at (n_basis, m) across fits so refits reuse the
        # compiled program instead of retracing on a (p,) -> (p, m) change.
        if self._estimate_trend_user is None:
            self._config(dim)  # freezes _estimate_trend_user
        if (
            not self._estimate_trend_user
            and isinstance(self.mean, BasisExpansionTrend)
            and self.mean.beta is not None
            and self.mean.beta.size
        ):
            beta0 = jnp.broadcast_to(
                jnp.asarray(self.mean.beta, self.dtype).reshape(Fj.shape[1], -1),
                (Fj.shape[1], m),
            )
        else:
            beta0 = jnp.zeros((Fj.shape[1], m), self.dtype)

        bounds = self._hyper_bounds(dim, y)
        n_par = n_hyper_params(dim, config)
        R = self.random_start or max(10, dim)

        # first start: previous optimum / theta0; others log10-uniform
        starts = self._rng.uniform(bounds[:, 0], bounds[:, 1], size=(R, n_par))
        warm = getattr(self, "theta_", None)
        if warm is not None and len(warm) == dim:
            starts[0, :dim] = np.log10(np.clip(warm, self.thetaL, self.thetaU))
        elif self.theta0 is not None:
            t0 = np.repeat(self.theta0, dim) if len(self.theta0) == 1 else self.theta0
            starts[0, :dim] = np.log10(np.clip(t0, self.thetaL, self.thetaU))
        if R > 1 and n >= 2:
            # second start: the anisotropic median heuristic — theta_d such
            # that the median total weighted squared distance is ~1, i.e.
            # theta_d = 1 / (dim * median_pairs (x_d - x'_d)^2). Lands a
            # restart in the length-scale regime of the DATA regardless of
            # how wide the user's log-uniform window is (at wide windows and
            # large n, random starts often sit entirely in flat/degenerate
            # basins and the MLE pins theta at a bound).
            sub = X[self._rng.choice(n, size=min(n, 256), replace=False)]
            d2 = (sub[:, None, :] - sub[None, :, :]) ** 2  # (s, s, dim)
            med = np.median(d2[np.triu_indices(len(sub), k=1)], axis=0)
            theta_med = 1.0 / np.maximum(dim * med, 1e-30)
            starts[1, :dim] = np.log10(np.clip(theta_med, self.thetaL, self.thetaU))

        noise_var = self.noise_var if self.estimation_mode == "noisy" else 0.0
        # BO-loop refits with < 25% new data since the last FULL ladder skip
        # the exploration rungs: the previous optimum + median-heuristic
        # starts polish on the full data (the stall exit makes this a few
        # L-BFGS steps). The growth trigger periodically re-runs the global
        # schedule; BOTPU_NO_WARM_REFIT=1 disables the fast path.
        warm_ok = (
            warm is not None
            and len(warm) == dim
            and _os.environ.get("BOTPU_NO_WARM_REFIT") is None
            and getattr(self, "_full_ladder_n", 0) > 0
            and n <= int(self._full_ladder_n * 1.25)
        )
        n_j = jnp.asarray(float(n), self.dtype)
        for attempt in range(6):
            lo_b = jnp.asarray(bounds[:, 0], self.dtype)
            hi_b = jnp.asarray(bounds[:, 1], self.dtype)
            nv_j = jnp.asarray(float(noise_var), self.dtype)
            if self.optimizer in ("HMC", "NUTS", "VI"):
                S = int(getattr(self, "n_ensemble", 16))
                key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31 - 1)))
                if self.optimizer == "VI":
                    par_s, nll, state, vi_params = _fit_kernel_vi(
                        key, lo_b, hi_b, Xj, Yj, Fj, maskj, n_j, nv_j,
                        beta0, config, S, getattr(self, "vi_steps", 400),
                    )
                    self.vi_params_ = tuple(np.asarray(p) for p in vi_params)
                else:
                    C = max(4, min(R, 8))
                    n_par = bounds.shape[0]
                    n_warm = int(getattr(self, "hmc_warmup", 64))
                    # chain seeds at n >= 512: jittered around the MAP
                    # instead of raw restarts (round-5 verdict item 3) —
                    # warm refits reuse the previous MAP, cold fits run a
                    # half-length MLE ladder first (~1 ladder vs the many
                    # full-data warmup transitions it saves). Small fits
                    # keep the dispersed raw restarts (warmup is cheap
                    # there and wider starts explore more of the posterior).
                    if n >= 512:
                        map_par = getattr(self, "_map_par_log10", None)
                        if map_par is None or len(map_par) != n_par:
                            map_j, _, _ = self._run_mle_ladder(
                                starts, lo_b, hi_b, (Xp, Yp),
                                (Xj, Yj, Fj, maskj, n_j),
                                n, n_pad, nv_j, beta0, config, iters_scale=0.5,
                            )
                            map_par = np.asarray(map_j, dtype=float)
                        width = bounds[:, 1] - bounds[:, 0]
                        chain0 = np.clip(
                            map_par[None, :]
                            + 0.1 * width[None, :] * self._rng.standard_normal((C, n_par)),
                            bounds[:, 0], bounds[:, 1],
                        )
                    else:
                        chain0 = starts[:C]
                    # phase-1 warmup on an n/4 subset (64x cheaper Cholesky);
                    # carried (inv_mass, step) from the previous refit skips
                    # phase 1 entirely and shortens phase 2
                    warm_stage = (
                        self._data_subset_stage(Xp, Yp, n, n_pad) if n >= 512 else None
                    )
                    carry = getattr(self, "_sampler_carry", None)
                    if carry is not None and (
                        carry[0].shape != (C, n_par) or carry[2] != (self.optimizer, n_pad)
                    ):
                        carry = None
                    if carry is not None:
                        carry_j = (
                            jnp.asarray(carry[0], self.dtype),
                            jnp.asarray(carry[1], self.dtype),
                        )
                        n_w2 = max(8, n_warm // 4)
                    else:
                        carry_j = None
                        n_w2 = max(8, n_warm // 4) if warm_stage is not None else None
                    par_s, nll, state, acc, inv_mass, step, chains = _fit_kernel_hmc(
                        key, jnp.asarray(chain0, self.dtype),
                        lo_b, hi_b, Xj, Yj, Fj, maskj, n_j, nv_j,
                        beta0, config, S, n_warm,
                        "nuts" if self.optimizer == "NUTS" else "hmc",
                        warm_stage, carry_j, n_w2,
                    )
                    self.accept_rate_ = np.asarray(acc, dtype=float)
                    # (draws, chains, d) box-coordinate draws for ESS
                    # diagnostics (models/hmc.effective_sample_size)
                    self.sample_chains_ = np.asarray(chains, dtype=float)
                    self._sampler_carry = (
                        np.asarray(inv_mass, dtype=float),
                        np.asarray(step, dtype=float),
                        (self.optimizer, n_pad),
                    )
                self.theta_samples_ = np.asarray(10.0 ** np.asarray(par_s)[:, :dim])
                par = jnp.median(par_s, axis=0)
                config = config._replace(n_ensemble=S)
            elif self.optimizer == "CMA":
                par, nll, state = _fit_kernel_cma(
                    jax.random.PRNGKey(int(self._rng.integers(0, 2**31 - 1))),
                    jnp.asarray(starts, self.dtype), lo_b, hi_b,
                    Xj, Yj, Fj, maskj, n_j, nv_j,
                    beta0, config, 4 * self.max_iter,
                )
            else:
                # cheap all-dead probe: if EVERY start lands in the 1e12
                # penalty (the f32 factorization is non-finite over most of
                # theta space — seen at n >= ~2k with a tiny nugget), skip
                # the ladder and escalate the nugget right away.
                # Gated to (a) the big buckets, where the plateau problem
                # exists and the ladder is expensive (small fits should not
                # pay an extra executable per shape); (b) already-noisy
                # modes, where escalation only bumps a hyperparameter — a
                # noiseless fit keeps its old behavior (run the ladder; its
                # subset rungs may guide a start into the feasible basin) so
                # the probe can never flip the model class on full-data-only
                # evidence;
                # (c) attempt < 5, so a state/par always exists at the end.
                if (
                    attempt < 5
                    and n_pad > 1024
                    and self.estimation_mode != "noiseless"
                ):
                    probe = _probe_kernel(
                        jnp.asarray(starts, self.dtype), lo_b, hi_b,
                        Xj, Yj, Fj, maskj, n_j, nv_j, beta0, config,
                    )
                    if bool(np.all(np.asarray(probe) >= 1e11)):
                        noise_var, config, bounds, starts = self._escalate_nugget(
                            dim, y, noise_var, config, bounds, starts, R
                        )
                        continue
                wr = warm_ok and attempt == 0  # escalation regenerates starts
                par, nll, state = self._run_mle_ladder(
                    starts, lo_b, hi_b, (Xp, Yp), (Xj, Yj, Fj, maskj, n_j),
                    n, n_pad, nv_j, beta0, config, warm_refit=wr,
                )
                if not wr:
                    self._full_ladder_n = n
            ok_h, theta_h, nll_h, s2_h, beta_h = jax.device_get(
                _fit_summary(par, nll, state)
            )
            self.fit_ok_ = bool(ok_h)
            if self.fit_ok_:
                break
            noise_var, config, bounds, starts = self._escalate_nugget(
                dim, y, noise_var, config, bounds, starts, R
            )
        self.noise_var = noise_var

        self._state = state
        self._config_cache = config
        full_par = np.asarray(theta_h, dtype=float).reshape(-1)
        # log10 MAP (or posterior-median) parameter vector: seeds the next
        # refit's sampler chains (round-5 verdict item 3)
        self._map_par_log10 = np.log10(np.maximum(full_par, 1e-300))
        self.theta_ = full_par[:dim]
        self.log_likelihood_ = -float(nll_h)
        self.sigma2 = np.asarray(s2_h, dtype=float)
        if (
            config.n_ensemble == 0
            and isinstance(self.mean, BasisExpansionTrend)
            and self._estimate_trend_user
        ):
            self.mean.beta = jnp.asarray(beta_h)
        self.is_fitted = True
        self._n = n
        self._dim = dim
        self._m = m
        return self

    # ------------------------------------------------------------------
    def precompile(
        self, n: int, dim: int, m: int = 1, concurrent: object = None
    ) -> "GaussianProcess":
        """Ahead-of-time compile the one XLA program a BFGS-path fit() at
        (n observations, dim features, m targets) needs: the fused
        `_ladder_kernel` (every MLE rung + the posterior state run inside a
        single executable since round 2, so there is exactly one compile to
        warm). The program is compiled by CALLING the jitted kernel on
        throwaway inputs of the right shape — that lands the executable in
        the jit call cache the subsequent fit() actually consults (an AOT
        .lower().compile() would be discarded there and the compile paid
        twice). On an accelerator the throwaway execution is cheap; on the
        CPU backend it would cost a full fit's FLOPs, so there we
        AOT-compile instead — the persistent compile cache bridges AOT to
        call.
        No-op for non-BFGS optimizers. `concurrent` is accepted for
        backward compatibility and ignored (the fused single-program ladder
        left exactly one compile to warm, so there is nothing to overlap).
        """
        del concurrent
        if self.optimizer in ("HMC", "NUTS", "VI", "CMA"):
            return self

        if self.mean is None:
            self.mean = constant_trend(dim)
        if self.thetaL is None or self.thetaU is None:
            raise ValueError("thetaL/thetaU are required")
        if len(self.thetaL) == 1 and dim > 1:
            self.thetaL = np.repeat(self.thetaL, dim)
            self.thetaU = np.repeat(self.thetaU, dim)
        config = self._config(dim)
        n_pad = _bucket(n)
        npar = n_hyper_params(dim, config)
        nb = config.n_basis
        R = self.random_start or max(10, dim)
        rungs, (n_final, iters_b) = _mle_ladder_plan(
            n, n_pad, R, self.max_iter, self.multi_fidelity
        )

        def dummy(*shape):
            return jnp.zeros(shape, self.dtype)

        def grid(ns):
            # non-degenerate dummy X: a low-discrepancy (golden-ratio
            # Kronecker) point set, so the warm-path execution factorizes a
            # well-conditioned kernel matrix instead of the rank-1 all-ones
            # matrix all-zero X would produce (which exercises the clamped-
            # pivot penalty path, not the one fit() takes on real data)
            i = jnp.arange(1, ns + 1, dtype=self.dtype)[:, None]
            alpha = jnp.asarray(
                [(0.5 * (np.sqrt(5) - 1)) ** (k + 1) for k in range(dim)], self.dtype
            )[None, :]
            return (i * alpha) % 1.0

        def stage_for(ns):
            return (
                grid(ns), dummy(ns, m), jnp.ones((ns, nb), self.dtype),
                jnp.ones((ns,), self.dtype),
                jnp.asarray(float(ns), self.dtype),
            )

        stages = tuple(stage_for(ns) for ns, _, _ in rungs) + (stage_for(n_pad),)
        plan = tuple((n_in, iters) for _, n_in, iters in rungs) + ((n_final, iters_b),)
        # the statics are appended POSITIONALLY, exactly as fit() passes
        # them: jax's tracing cache keys on the (args, kwargs) pytree, so a
        # keyword-passed `config=...` would never match fit's positional call
        args = (
            dummy(R, npar),
            jnp.full((npar,), -1.0, self.dtype),
            jnp.full((npar,), 1.0, self.dtype),
            stages,
            jnp.asarray(1e-6, self.dtype),
            dummy(nb, m),
            config, plan, self.max_linesearch_steps,
        )
        if jax.default_backend() == "cpu":
            _ladder_kernel.lower(*args).compile()
        else:
            jax.block_until_ready(_ladder_kernel(*args))
        return self

    def _predict_padded(self, X: np.ndarray, eval_mse: bool):
        nq = X.shape[0]
        nq_pad = _bucket(nq)
        Xq = np.zeros((nq_pad, self._dim))
        Xq[:nq] = X
        Xj = jnp.asarray(Xq, self.dtype)
        Fq = self._trend_F(Xj)
        mu, mse = _predict_kernel(self._state, Xj, Fq, self._config_cache, eval_mse)
        mu = mu[:nq]
        prior = self._prior_mean(X)  # residual GP: add the prior mean back
        if prior is not None:
            mu = mu + jnp.asarray(prior, self.dtype)
        return mu, (mse[:nq] if mse is not None else None)

    @_x64
    def predict(self, X, eval_MSE: bool = False):
        """BLUP mean (and MSE) at X: (n_eval, n_targets), squeezed to
        (n_eval,) for single-target models (ref parity: gpr.py:424-535)."""
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        X = np.asarray(X, dtype=float)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        mu, mse = self._predict_padded(X, eval_MSE)
        mu = np.asarray(mu, dtype=float)
        if self._m == 1:
            mu = mu.ravel()
        if eval_MSE:
            mse = np.asarray(mse, dtype=float)
            if self._m == 1:
                mse = mse.ravel()
            return mu, mse
        return mu

    @_x64
    def gradient(self, x):
        """Gradients of posterior mean and variance at a single point
        (ref parity: gpr.py:537-576); computed by autodiff."""
        x = jnp.asarray(np.asarray(x, dtype=float).ravel(), self.dtype)
        state, config = self._state, self._config_cache

        def mu_fn(xx):
            Xq = xx.reshape(1, -1)
            mu, _ = _predict_impl(state, Xq, self._trend_F(Xq), config, False)
            return jnp.sum(mu)

        def mse_fn(xx):
            Xq = xx.reshape(1, -1)
            _, mse = _predict_impl(state, Xq, self._trend_F(Xq), config, True)
            return jnp.sum(mse)

        dmu = np.asarray(jax.grad(mu_fn)(x), dtype=float).reshape(-1, 1)
        dmse = np.asarray(jax.grad(mse_fn)(x), dtype=float).reshape(-1, 1)
        return dmu, dmse

    @_x64
    def Hessian(self, x, of: str = "mean"):
        """Hessian matrix (dim, dim) of the posterior mean — or, with
        of="mse", of the posterior variance — at a single point
        (ref parity: gpr.py:578-598 provides the mean Hessian through
        ~160 lines of hand-written trend/correlation second derivatives,
        corr_Hessian gpr.py:663-734, and has no variance counterpart;
        both are one jax.hessian call here)."""
        if of not in ("mean", "mse"):
            raise ValueError("of must be 'mean' or 'mse'")
        x = np.asarray(x, dtype=float)
        if x.ndim == 2:
            if x.shape[0] != 1:
                raise ValueError("x must be a single point")
            x = x.ravel()
        if x.shape[0] != self._dim:
            raise ValueError("x does not have the right size")
        xj = jnp.asarray(x, self.dtype)
        state, config = self._state, self._config_cache

        def scalar_fn(xx):
            Xq = xx.reshape(1, -1)
            mu, mse = _predict_impl(
                state, Xq, self._trend_F(Xq), config, of == "mse"
            )
            return jnp.sum(mu if of == "mean" else mse)

        return np.asarray(jax.hessian(scalar_fn)(xj), dtype=float)

    # -- device-side handles for fused acquisition programs ---------------
    @property
    def posterior(self) -> PosteriorState:
        """The fixed-shape posterior state for building fused jit programs."""
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        return self._state

    @property
    def config(self) -> GPConfig:
        return self._config_cache

    def predict_jax(self, Xq: jnp.ndarray, eval_mse: bool = True):
        """Pure-JAX predict on device arrays (jit/vmap/grad-compatible);
        Xq: (Nq, dim) -> (mu[Nq, m], mse[Nq, m])."""
        mu, mse = _predict_impl(
            self._state, Xq, self._trend_F(Xq), self._config_cache, eval_mse
        )
        if isinstance(self.mean, NonparametricTrend):
            # a jax-traversable prior (our RandomForest) adds its mean
            # inside the program; arbitrary host regressors cannot be
            # traced — fail loudly instead of silently dropping the prior
            from .random_forest import RandomForest, rf_predict

            wrapped = self.mean.model
            if isinstance(wrapped, RandomForest) and wrapped.is_fitted:
                pm, _ = rf_predict(wrapped.posterior, Xq, wrapped.config)
                mu = mu + pm.reshape(mu.shape)
            else:
                raise ValueError(
                    "predict_jax with a NonparametricTrend requires the prior "
                    "to wrap a fitted bayesian_optimization_tpu RandomForest "
                    "(XLA tree traversal); host-only regressors work through "
                    ".predict() but cannot run inside jitted programs"
                )
        return mu, mse
