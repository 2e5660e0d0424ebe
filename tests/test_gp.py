"""GP engine tests: golden numerics vs an independent numpy implementation
of the Kriging equations, plus behavioral fit/predict coverage (the
reference's test_surrogate.py tests only behavior; the numeric goldens are
the addition SURVEY.md section 4 calls for)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bayesian_optimization_tpu.models import GaussianProcess, constant_trend, linear_trend
from bayesian_optimization_tpu.models.likelihood import (
    GPConfig, neg_log_likelihood, posterior_state, predict,
)
from bayesian_optimization_tpu.ops import minimize_restarts


def _numpy_matern32_K(theta, X, Y=None):
    Y = X if Y is None else Y
    d2 = ((X[:, None, :] - Y[None, :, :]) ** 2 * theta[None, None, :]).sum(-1)
    r = np.sqrt(np.maximum(d2, 0))
    s = np.sqrt(3) * r
    return (1 + s) * np.exp(-s)


def _numpy_concentrated_nll_noiseless(theta, X, y, jitter=1e-6):
    """Straight transcription of the standard concentrated log-likelihood
    (constant trend, GLS beta, sigma2 concentrated)."""
    n = len(X)
    R = _numpy_matern32_K(theta, X) + jitter * np.eye(n)
    L = np.linalg.cholesky(R)
    F = np.ones((n, 1))
    Yt = np.linalg.solve(L, y.reshape(-1, 1))
    Ft = np.linalg.solve(L, F)
    Q, G = np.linalg.qr(Ft)
    beta = np.linalg.solve(G, Q.T @ Yt)
    rho = Yt - Ft @ beta
    sigma2 = float((rho**2).sum()) / (n - 1)
    ll = -0.5 * (n * np.log(2 * np.pi * sigma2) + 2 * np.log(np.diag(L)).sum() + n)
    return -ll, sigma2, beta, L, rho


def _pad(X, y, n_pad):
    n, d = X.shape
    Xp = np.zeros((n_pad, d)); Xp[:n] = X
    Yp = np.zeros((n_pad, 1)); Yp[:n] = y.reshape(-1, 1)
    mask = np.zeros(n_pad); mask[:n] = 1
    F = np.zeros((n_pad, 1)); F[:n] = 1
    return map(jnp.asarray, (Xp, Yp, F, mask))


def test_nll_matches_numpy_golden():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (12, 3))
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=12)
    theta = np.array([0.7, 1.3, 0.4])

    config = GPConfig(kernel="matern", mode="noiseless", estimate_trend=True, jitter=1e-6)
    Xj, Yj, Fj, mask = _pad(X, y, 16)
    nll = neg_log_likelihood(
        jnp.log10(jnp.asarray(theta, jnp.float32)), Xj, Yj, Fj, mask,
        jnp.asarray(12.0), 0.0, jnp.zeros(1), config,
    )
    nll_np, *_ = _numpy_concentrated_nll_noiseless(theta, X, y)
    assert np.isclose(float(nll), nll_np, rtol=2e-3), (float(nll), nll_np)


def test_padding_invariance():
    """The same data padded to different buckets must give the same nll."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (10, 2))
    y = (X**2).sum(1)
    theta = jnp.log10(jnp.asarray([0.5, 0.8], jnp.float32))
    config = GPConfig(kernel="matern", mode="noisy", estimate_trend=True)
    vals = []
    for n_pad in (16, 32, 64):
        Xj, Yj, Fj, mask = _pad(X, y, n_pad)
        par = jnp.concatenate([theta, jnp.asarray([-1.0], jnp.float32)])
        vals.append(float(neg_log_likelihood(par, Xj, Yj, Fj, mask, jnp.asarray(10.0), 1e-6, jnp.zeros(1), config)))
    assert np.allclose(vals, vals[0], rtol=1e-4), vals


def test_predict_matches_numpy_golden():
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (15, 2))
    y = np.cos(X[:, 0]) + 0.5 * X[:, 1]
    theta = np.array([1.1, 0.6])
    Xq = rng.uniform(-2, 2, (7, 2))

    config = GPConfig(kernel="matern", mode="noiseless", estimate_trend=True, jitter=1e-6)
    Xj, Yj, Fj, mask = _pad(X, y, 16)
    state = posterior_state(
        jnp.log10(jnp.asarray(theta, jnp.float32)), Xj, Yj, Fj, mask,
        jnp.asarray(15.0), 0.0, jnp.zeros(1), config,
    )
    Fq = jnp.ones((8, 1), jnp.float32)
    Xqp = np.zeros((8, 2)); Xqp[:7] = Xq
    mu, mse = predict(state, jnp.asarray(Xqp, jnp.float32), Fq, config)

    # numpy reference: BLUP + universal-kriging MSE
    nll_np, sigma2, beta, L, rho = _numpy_concentrated_nll_noiseless(theta, X, y)
    r0 = _numpy_matern32_K(theta, Xq, X)
    gamma = np.linalg.solve(L.T, rho)
    mu_np = beta.ravel() + (r0 @ gamma).ravel()
    rt = np.linalg.solve(L, r0.T)
    F = np.ones((15, 1)); Ft = np.linalg.solve(L, F)
    Q, G = np.linalg.qr(Ft)
    u = np.linalg.solve(G.T, Ft.T @ rt - np.ones((1, 7)))
    mse_np = sigma2 * (1 - (rt**2).sum(0) + (u**2).sum(0))

    # exactness verified at 1e-14 in float64; these tolerances are f32 round-off
    assert np.allclose(np.asarray(mu[:7]).ravel(), mu_np, rtol=2e-2, atol=2e-2)
    assert np.allclose(np.asarray(mse[:7]).ravel(), np.maximum(mse_np, 0), rtol=5e-2, atol=2e-3)


def test_vmapped_lbfgs_minimizes_quadratic():
    A = jnp.asarray(np.diag([1.0, 4.0, 9.0]), jnp.float32)
    b = jnp.asarray([1.0, -2.0, 0.5], jnp.float32)
    fun = lambda x: 0.5 * x @ A @ x - b @ x
    x_star = np.linalg.solve(np.asarray(A), np.asarray(b))
    x0 = jnp.asarray(np.random.default_rng(3).uniform(-4, 4, (6, 3)), jnp.float32)
    res = minimize_restarts(fun, x0, jnp.full(3, -5.0), jnp.full(3, 5.0), max_iter=40)
    assert np.allclose(np.asarray(res.x_best), x_star, atol=1e-3)


def test_lbfgs_exits_at_line_search_fixed_point():
    """Once a lane's line search exhausts without improving, its state is a
    deterministic fixed point — the while_loop must exit instead of burning
    the rest of max_iter replaying it (round-5 headline 2x). Counted with
    the loop run eagerly (disable_jit) so a host-side counter sees every
    objective evaluation."""
    import jax

    A = jnp.asarray(np.diag([1.0, 4.0, 9.0]), jnp.float32)
    b = jnp.asarray([1.0, -2.0, 0.5], jnp.float32)
    n_evals = 0

    def fun(x):
        nonlocal n_evals
        n_evals += 1
        return 0.5 * x @ A @ x - b @ x

    x0 = jnp.asarray(np.random.default_rng(3).uniform(-4, 4, (2, 3)), jnp.float32)
    with jax.disable_jit():
        res = minimize_restarts(
            fun, x0, jnp.full(3, -5.0), jnp.full(3, 5.0), max_iter=500
        )
    x_star = np.linalg.solve(np.asarray(A), np.asarray(b))
    assert np.allclose(np.asarray(res.x_best), x_star, atol=1e-3)
    # a 3-D strongly-convex quadratic converges (then stalls at f32 line-
    # search precision) in tens of steps; without the exit this is >= 1000
    assert n_evals < 400, n_evals


def test_gp_fit_predict_interpolates():
    rng = np.random.default_rng(4)
    X = rng.uniform(-3, 3, (20, 2))
    y = X[:, 0] ** 2 + np.sin(X[:, 1])
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=1e-6, random_state=0,
    )
    gp.fit(X, y)
    assert gp.is_fitted
    mu, mse = gp.predict(X, eval_MSE=True)
    assert mu.shape == (20,)
    # near-interpolation at training points
    resid = np.abs(mu - y) / (np.abs(y).max())
    assert resid.max() < 0.05, resid.max()
    assert mse.min() >= 0

    # generalization sanity on held-out points
    Xt = rng.uniform(-2.5, 2.5, (50, 2))
    yt = Xt[:, 0] ** 2 + np.sin(Xt[:, 1])
    mu_t = gp.predict(Xt)
    r2 = 1 - np.sum((mu_t - yt) ** 2) / np.sum((yt - yt.mean()) ** 2)
    assert r2 > 0.9, r2


def test_gp_mle_beats_random_theta():
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 1, (25, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(3 * X[:, 1])
    gp = GaussianProcess(thetaL=1e-2 * np.ones(2), thetaU=1e3 * np.ones(2), nugget=1e-6, random_state=0)
    gp.fit(X, y)
    assert np.all(gp.theta_ >= 1e-2) and np.all(gp.theta_ <= 1e3)
    assert np.isfinite(gp.log_likelihood_)


def test_gp_multioutput():
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (18, 2))
    Y = np.stack([X.sum(1), (X**2).sum(1)], axis=1)
    gp = GaussianProcess(thetaL=1e-3 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=1e-6, random_state=1)
    gp.fit(X, Y)
    mu, mse = gp.predict(X[:5], eval_MSE=True)
    assert mu.shape == (5, 2) and mse.shape == (5, 2)
    assert np.allclose(mu, Y[:5], atol=0.3)


def test_gp_noise_estim_mode():
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (30, 1))
    y = np.sin(X[:, 0]) + 0.2 * rng.normal(size=30)
    gp = GaussianProcess(
        thetaL=np.array([1e-2]), thetaU=np.array([1e2]),
        noise_estim=True, nugget=1e-6, random_state=2,
    )
    gp.fit(X, y)
    mu, mse = gp.predict(X, eval_MSE=True)
    # with noise estimation the fit must not hard-interpolate the noise
    assert float(np.mean(mse)) > 1e-8
    assert np.corrcoef(mu, y)[0, 1] > 0.7


def test_gp_gradient_matches_fd():
    rng = np.random.default_rng(8)
    X = rng.uniform(-2, 2, (15, 2))
    y = X[:, 0] * X[:, 1]
    gp = GaussianProcess(thetaL=1e-3 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=1e-6, random_state=3)
    gp.fit(X, y)
    x = np.array([0.3, -0.4])
    dmu, dmse = gp.gradient(x)
    eps = 1e-3
    for i in range(2):
        e = np.zeros(2); e[i] = eps
        mu_p, mse_p = gp.predict(x + e, eval_MSE=True)
        mu_m, mse_m = gp.predict(x - e, eval_MSE=True)
        assert np.isclose(dmu[i, 0], (mu_p - mu_m) / (2 * eps), rtol=0.05, atol=1e-3)
        assert np.isclose(dmse[i, 0], (mse_p - mse_m) / (2 * eps), rtol=0.15, atol=1e-3)


def test_nonparametric_trend_residual_gp():
    # a GP with an RF prior mean must beat the same GP with a constant trend
    # on data whose mean structure the RF captures (step function + smooth
    # residual); also asserts the prior is actually consumed: predictions
    # with and without the prior must differ (the round-2 version silently
    # fitted a zero trend — VERDICT r2 "What's weak" #4)
    from bayesian_optimization_tpu.models.trend import NonparametricTrend, constant_trend
    from bayesian_optimization_tpu import GaussianProcess

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (80, 2))
    step = np.where(X[:, 0] > 0.5, 5.0, 0.0)
    y = step + np.sin(4 * X[:, 1])

    trend = NonparametricTrend(X, y)  # reference-style (X, y) ctor
    gp_np = GaussianProcess(
        mean=trend, thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=1e-6, random_state=0,
    ).fit(X, y)
    gp_const = GaussianProcess(
        mean=constant_trend(2), thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=1e-6, random_state=0,
    ).fit(X, y)

    Xq = rng.uniform(0, 1, (64, 2))
    yq = np.where(Xq[:, 0] > 0.5, 5.0, 0.0) + np.sin(4 * Xq[:, 1])
    mu_np = np.asarray(gp_np.predict(Xq), dtype=float)
    mu_c = np.asarray(gp_const.predict(Xq), dtype=float)
    assert not np.allclose(mu_np, mu_c, atol=1e-3)  # the prior is live
    rmse_np = float(np.sqrt(np.mean((mu_np - yq) ** 2)))
    assert rmse_np < 1.0, rmse_np

    # predict_jax path (fused argmax) includes the prior via XLA traversal
    import jax.numpy as jnp

    mu_j, _ = gp_np.predict_jax(jnp.asarray(Xq, jnp.float32))
    assert np.allclose(np.asarray(mu_j).ravel(), mu_np.ravel(), atol=1e-3)


def test_hessian_mean_and_mse_vs_finite_differences():
    from bayesian_optimization_tpu import GaussianProcess
    from bayesian_optimization_tpu.models.trend import constant_trend

    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (48, 2))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 1])
    gp = GaussianProcess(
        mean=constant_trend(2), corr="squared_exponential",
        thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=1e-6, random_state=0,
    ).fit(X, y)
    x0 = np.array([0.4, 0.6])
    # central 2nd differences on f32 predictions: eps must be large enough
    # that the f32 quantization (~1e-6) stays small against 4*eps^2
    eps = 2e-2
    for of in ("mean", "mse"):
        H = gp.Hessian(x0, of=of)
        assert H.shape == (2, 2)
        def f(p):
            out = gp.predict(p.reshape(1, -1), eval_MSE=True)
            return float(np.asarray(out[0 if of == "mean" else 1]).ravel()[0])
        Hfd = np.zeros((2, 2))
        for i in range(2):
            for j in range(2):
                ei = np.eye(2)[i] * eps
                ej = np.eye(2)[j] * eps
                Hfd[i, j] = (
                    f(x0 + ei + ej) - f(x0 + ei - ej) - f(x0 - ei + ej) + f(x0 - ei - ej)
                ) / (4 * eps * eps)
        scale = max(1.0, float(np.abs(Hfd).max()))
        assert np.abs(H - Hfd).max() / scale < 0.15, (of, H, Hfd)


def test_mle_ladder_plan_respects_n():
    """Rung sizes must never exceed n (review finding: n in the upper-middle
    of a padding bucket, e.g. 1100 in the 4096 bucket, crashed
    rng.choice(n, size=2048)) and must stay 128-aligned for the blocked
    Cholesky."""
    from bayesian_optimization_tpu.models.gp import _mle_ladder_plan

    for n, n_pad in ((1100, 4096), (1025, 4096), (4097, 16384), (2047, 4096),
                     (1000, 1024), (600, 1024), (512, 1024)):
        rungs, final = _mle_ladder_plan(n, n_pad, 10, 40, True)
        for ns, n_in, iters in rungs:
            assert ns <= n, (n, n_pad, rungs)
            assert ns <= 128 or ns % 128 == 0, (n, n_pad, rungs)
        sizes = [ns for ns, _, _ in rungs]
        assert sizes == sorted(set(sizes)), (n, n_pad, rungs)  # strictly increasing


def test_theta_prior_pulls_away_from_white_noise_basin():
    """With few points in high-D, pure MLE can prefer theta at the upper
    bound (kernel ~ I, a 'white noise' fit). A strong MAP prior must pull
    the estimate toward mid-bounds; strength 0 must reproduce pure MLE."""
    from bayesian_optimization_tpu import GaussianProcess
    from bayesian_optimization_tpu.models.trend import constant_trend

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (20, 10))
    y = rng.standard_normal(20)  # pure noise: MLE loves theta -> huge
    kw = dict(mean=constant_trend(10), thetaL=1e-2 * np.ones(10),
              thetaU=1e6 * np.ones(10), nugget=1e-6, random_state=0)
    gp0 = GaussianProcess(**kw).fit(X, y)
    gp1 = GaussianProcess(theta_prior_strength=50.0, **kw).fit(X, y)
    # strong prior => log10 theta near the mid of [-2, 6] (i.e. 2)
    mid_dist0 = np.abs(np.log10(gp0.theta_) - 2.0).mean()
    mid_dist1 = np.abs(np.log10(gp1.theta_) - 2.0).mean()
    assert mid_dist1 < mid_dist0
    assert mid_dist1 < 1.0, gp1.theta_


def test_escalate_nugget_contract():
    """The shared escalation helper (ref parity: gpr.py:384-399), used by
    both the all-dead probe and the post-fit ok check: a noiseless model
    flips to noisy with a 1e-5 floor and fresh config/bounds/starts (one
    extra hyperparameter); an already-noisy model bumps the noise x10."""
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=0.0, random_start=4, random_state=0,
    )
    assert gp.estimation_mode == "noiseless"
    y = np.linspace(-1, 1, 8)
    config0 = gp._config(2)
    bounds0 = gp._hyper_bounds(2, y)
    starts0 = np.zeros((4, bounds0.shape[0]))
    nv, config, bounds, starts = gp._escalate_nugget(
        2, y, 0.0, config0, bounds0, starts0, 4
    )
    assert gp.estimation_mode == "noisy"
    assert nv == 1e-5
    assert config.mode == "noisy"
    assert bounds.shape[0] == bounds0.shape[0] + 1   # noise hyperparameter
    assert starts.shape == (4, bounds.shape[0])
    # second escalation: already noisy -> x10, everything else unchanged
    nv2, config2, bounds2, starts2 = gp._escalate_nugget(
        2, y, nv, config, bounds, starts, 4
    )
    assert nv2 == pytest.approx(1e-4)
    assert config2 is config and bounds2 is bounds and starts2 is starts
    # fit on duplicated conflicting data in noiseless mode stays FINITE
    # (the likelihood jitter absorbs rank deficiency without escalation)
    rng = np.random.default_rng(0)
    Xb = rng.uniform(0, 1, (12, 2))
    gp2 = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=0.0, random_start=4, random_state=0,
    )
    gp2.fit(np.vstack([Xb, Xb]), np.concatenate([Xb.sum(1), Xb.sum(1) + 0.5]))
    assert np.isfinite(gp2.log_likelihood_)
    mu, mse = gp2.predict(Xb[:4], eval_MSE=True)
    assert np.all(np.isfinite(mu)) and np.all(mse >= 0.0)


def test_gp_f64_likelihood_option():
    """dtype='f64' runs the whole fit/predict stack in float64 through the
    pure-XLA linalg path (ref parity: the reference's f64 numpy/LAPACK MLE,
    gpr.py:790-811) and matches the f32 fit on a well-conditioned problem."""
    rng = np.random.default_rng(0)
    n, dim = 80, 3
    X = rng.uniform(-1, 1, (n, dim))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * X[:, 2]
    Xq = rng.uniform(-1, 1, (50, dim))
    yq = np.sin(3 * Xq[:, 0]) + Xq[:, 1] ** 2 + 0.1 * Xq[:, 2]
    results = {}
    for dt in ("f32", "f64"):
        gp = GaussianProcess(
            mean=constant_trend(dim), corr="matern",
            thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
            nugget=1e-6, random_state=1, dtype=dt,
        )
        gp.fit(X, y)
        assert str(gp._state.L.dtype) == ("float64" if dt == "f64" else "float32")
        mu, mse = gp.predict(Xq, eval_MSE=True)
        assert np.all(np.isfinite(mu)) and np.all(mse >= 0)
        results[dt] = (np.corrcoef(mu.ravel(), yq)[0, 1], np.asarray(gp.theta_))
    # both precisions solve this easy problem, and agree on theta
    assert results["f32"][0] > 0.99 and results["f64"][0] > 0.99
    assert np.allclose(results["f32"][1], results["f64"][1], rtol=0.2)
    # gradients flow in f64 too
    gp64 = GaussianProcess(
        mean=constant_trend(dim), corr="matern",
        thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
        nugget=1e-6, random_state=1, dtype="f64",
    )
    gp64.fit(X, y)
    dmu, dmse = gp64.gradient(Xq[0])
    assert np.all(np.isfinite(dmu)) and np.all(np.isfinite(dmse))


def test_gp_cma_mle_path():
    """GaussianProcess(optimizer='CMA') — the population-chain replacement
    for the reference's IPOP-CMA-ES MLE option (ref: gpr.py:1164-1181 +
    cma_es.py:565-620) — fits, predicts, and reaches an optimum NLL
    comparable to the BFGS ladder on fixed datasets."""
    for seed, dim, fn in [
        (0, 2, lambda X: np.sin(3 * X[:, 0]) + X[:, 1] ** 2),
        (3, 3, lambda X: np.exp(-np.sum(X**2, 1)) + X[:, 0]),
    ]:
        rng = np.random.default_rng(seed)
        X = rng.uniform(-1, 1, (60, dim))
        y = fn(X) + 0.05 * rng.standard_normal(60)
        nlls = {}
        for opt in ("BFGS", "CMA"):
            gp = GaussianProcess(
                mean=constant_trend(dim), corr="matern",
                thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
                nugget=1e-6, random_start=8, random_state=1, optimizer=opt,
            )
            gp.fit(X, y)
            assert gp.is_fitted
            mu, mse = gp.predict(X, eval_MSE=True)
            assert np.all(np.isfinite(mu)) and np.all(mse >= 0)
            # in-sample interpolation quality
            assert np.corrcoef(mu.ravel(), y)[0, 1] > 0.95, (opt, seed)
            nlls[opt] = -gp.log_likelihood_
        # CMA's optimum NLL within a few nats of the gradient ladder's
        # (|nll| here is O(10-100); 5.0 nats = same basin quality)
        assert nlls["CMA"] <= nlls["BFGS"] + 5.0, nlls


@pytest.mark.parametrize("backend, want", [("cpu", ["lower", "compile"]), ("gpu", ["call"])])
def test_precompile_warms_by_executing_off_cpu(monkeypatch, backend, want):
    """precompile AOT-compiles on the CPU backend (a throwaway run would cost
    a full fit there) and executes the ladder on an accelerator, which lands
    the executable in the jit cache fit() consults."""
    from bayesian_optimization_tpu.models import gp as gp_mod

    calls = []

    class FakeKernel:
        def __call__(self, *args):
            calls.append("call")
            return jnp.zeros(())

        def lower(self, *args):
            calls.append("lower")

            class Lowered:
                def compile(self):
                    calls.append("compile")

            return Lowered()

    monkeypatch.setattr(gp_mod, "_ladder_kernel", FakeKernel())
    monkeypatch.setattr(gp_mod.jax, "default_backend", lambda: backend)
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern", thetaL=1e-2 * np.ones(2),
        thetaU=1e2 * np.ones(2), random_start=4, random_state=0,
    )
    gp.precompile(100, 2)
    assert calls == want
