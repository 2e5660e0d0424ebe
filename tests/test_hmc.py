"""HMC/VI hyperparameter-posterior inference (the project's north star;
no reference counterpart — its fit is point-estimate L-BFGS)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_optimization_tpu import BO, GaussianProcess, RealSpace
from bayesian_optimization_tpu.models.hmc import fit_vi, hmc_sample
from bayesian_optimization_tpu.models.trend import constant_trend


def test_hmc_recovers_gaussian_moments():
    """Sampling a known correlated Gaussian: moments must match."""
    cov = jnp.asarray([[1.0, 0.6], [0.6, 0.8]])
    prec = jnp.linalg.inv(cov)
    logp = lambda x: -0.5 * (x - 2.0) @ prec @ (x - 2.0)
    x0 = jax.random.uniform(jax.random.PRNGKey(0), (8, 2), minval=-2.0, maxval=6.0)
    res = hmc_sample(
        jax.random.PRNGKey(1), logp, x0,
        lo=jnp.full(2, -10.0), hi=jnp.full(2, 10.0),
        n_warmup=300, n_samples=300, n_leapfrog=12, thin=1,
    )
    S = np.asarray(res.samples).reshape(-1, 2)
    assert np.all(np.asarray(res.accept_rate) > 0.4), res.accept_rate
    assert np.allclose(S.mean(0), [2.0, 2.0], atol=0.15), S.mean(0)
    emp_cov = np.cov(S.T)
    assert np.allclose(emp_cov, np.asarray(cov), atol=0.3), emp_cov


def test_vi_recovers_gaussian_mean():
    logp = lambda x: -0.5 * jnp.sum((x - 1.5) ** 2) / 0.25
    mean, log_std = fit_vi(
        jax.random.PRNGKey(2), logp,
        lo=jnp.full(2, -10.0), hi=jnp.full(2, 10.0), n_steps=500,
    )
    # box coordinates via sigmoid: check mapped mean
    x_mean = -10.0 + 20.0 * jax.nn.sigmoid(mean)
    assert np.allclose(np.asarray(x_mean), 1.5, atol=0.2)


def test_gp_hmc_fit_predict():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (20, 2))
    y = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(20)
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, optimizer="HMC", random_state=0,
    )
    gp.hmc_warmup = 100
    gp.n_ensemble = 8
    gp.fit(X, y)
    assert gp.theta_samples_.shape == (8, 2)
    mu, mse = gp.predict(X, eval_MSE=True)
    assert np.all(mse >= 0)
    resid = np.abs(mu - y)
    assert resid.max() < 0.5, resid.max()
    # held-out generalization
    Xt = rng.uniform(-1.5, 1.5, (40, 2))
    yt = np.sin(2 * Xt[:, 0]) + 0.5 * Xt[:, 1]
    r = np.corrcoef(gp.predict(Xt), yt)[0, 1]
    assert r > 0.95, r


def test_bo_with_hmc_gp():
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, optimizer="HMC", random_state=0,
    )
    gp.hmc_warmup = 60
    gp.n_ensemble = 4
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = BO(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, DoE_size=5, max_FEs=10, random_seed=0,
    )
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 10
    assert fopt[0] < 10.0
    # the ensemble (posterior-mixture) path must actually be what the fused
    # acquisition argmax consumed — not a silent point-posterior fallback
    assert opt.model._config_cache.n_ensemble == 4
    assert opt.model.theta_samples_.shape == (4, 2)


def test_unknown_optimizer_raises():
    """A typo'd optimizer string must fail fast, not silently run BFGS
    (ref parity: the reference validates its switch, gpr.py:1127-1181)."""
    with pytest.raises(ValueError, match="unknown optimizer"):
        GaussianProcess(
            thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), optimizer="VII"
        )


def _fit_moments(optimizer, X, y, seed=0, **extra):
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, optimizer=optimizer, random_state=seed,
    )
    for k, v in extra.items():
        setattr(gp, k, v)
    gp.n_ensemble = 8
    gp.fit(X, y)
    Xt = np.random.default_rng(99).uniform(-1.5, 1.5, (30, 2))
    mu, mse = gp.predict(Xt, eval_MSE=True)
    return gp, np.asarray(mu), np.asarray(mse)


def test_gp_vi_fit_matches_hmc_moments():
    """VI-fit GP posterior moments must agree with the HMC-fit GP on the
    same data (the VERDICT round-3 'wire VI into the GP' criterion)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (20, 2))
    y = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(20)
    gp_vi, mu_vi, mse_vi = _fit_moments("VI", X, y, vi_steps=500)
    gp_hmc, mu_hmc, mse_hmc = _fit_moments("HMC", X, y, hmc_warmup=100)
    assert gp_vi.theta_samples_.shape == (8, 2)
    assert gp_vi._config_cache.n_ensemble == 8
    assert np.all(np.isfinite(mu_vi)) and np.all(mse_vi >= 0)
    # posterior means agree within the scale of the function
    scale = np.std(y)
    assert np.max(np.abs(mu_vi - mu_hmc)) < 0.5 * scale, np.max(np.abs(mu_vi - mu_hmc))
    # both generalize: correlation with truth on held-out points
    Xt = np.random.default_rng(99).uniform(-1.5, 1.5, (30, 2))
    yt = np.sin(2 * Xt[:, 0]) + 0.5 * Xt[:, 1]
    assert np.corrcoef(mu_vi, yt)[0, 1] > 0.9


def test_bo_with_vi_gp():
    """End-to-end BO with a VI posterior-ensemble GP (north star e2e)."""
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, optimizer="VI", random_state=0,
    )
    gp.vi_steps = 200
    gp.n_ensemble = 4
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = BO(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, DoE_size=5, max_FEs=10, random_seed=0,
    )
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 10
    assert fopt[0] < 10.0
    assert opt.model._config_cache.n_ensemble == 4


def test_bo_with_nuts_gp():
    """End-to-end BO with a NUTS posterior-ensemble GP through
    DoE -> fit -> ask -> tell to budget (VERDICT round-3 item 3)."""
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, optimizer="NUTS", random_state=0,
    )
    gp.hmc_warmup = 40
    gp.n_ensemble = 4
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = BO(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, DoE_size=5, max_FEs=10, random_seed=0,
    )
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 10
    # regret sane on the 2-D sphere over [-5,5]^2 (random search median ~2.5)
    assert fopt[0] < 10.0
    assert opt.model._config_cache.n_ensemble == 4
    assert opt.model.theta_samples_.shape == (4, 2)


def test_nuts_moments_match_truth_and_hmc():
    """NUTS posterior moments on a correlated Gaussian must match the
    analytic truth (and hence long-HMC) within Monte-Carlo error."""
    import jax
    import jax.numpy as jnp

    from bayesian_optimization_tpu.models.hmc import nuts_sample

    mean = jnp.asarray([0.5, -0.3, 0.2], jnp.float32)
    cov = jnp.asarray(
        [[1.0, 0.8, 0.2], [0.8, 1.0, 0.4], [0.2, 0.4, 0.5]], jnp.float32
    )
    prec = jnp.linalg.inv(cov)

    def logp(x):
        d = x - mean
        return -0.5 * d @ prec @ d

    lo = jnp.full(3, -8.0)
    hi = jnp.full(3, 8.0)
    x0 = jax.random.uniform(jax.random.PRNGKey(1), (8, 3), jnp.float32, -2.0, 2.0)
    res = nuts_sample(jax.random.PRNGKey(0), logp, x0, lo, hi,
                      n_warmup=300, n_samples=400, max_depth=6)
    s = np.asarray(res.samples).reshape(-1, 3)
    assert np.abs(s.mean(0) - np.asarray(mean)).max() < 0.08
    assert np.abs(s.var(0) - np.diag(np.asarray(cov))).max() < 0.15
    assert abs(float(np.cov(s.T)[0, 1]) - 0.8) < 0.15
    acc = float(np.asarray(res.accept_rate).mean())
    assert 0.6 < acc <= 1.0, acc
    # dynamic trajectories actually engaged (depth > 1 on average)
    assert float(np.asarray(res.mean_depth).mean()) > 1.0


def test_gp_fit_with_nuts_ensemble():
    from bayesian_optimization_tpu import GaussianProcess
    from bayesian_optimization_tpu.models.trend import constant_trend

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, 2))
    y = np.sin(3 * X[:, 0]) + 0.3 * rng.standard_normal(40)
    gp = GaussianProcess(
        mean=constant_trend(2), thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2),
        nugget=1e-6, optimizer="NUTS", random_state=0,
    )
    gp.hmc_warmup = 60
    gp.n_ensemble = 8
    gp.fit(X, y)
    assert gp.is_fitted
    mu, mse = gp.predict(X[:5], eval_MSE=True)
    assert np.all(np.isfinite(mu)) and np.all(mse >= 0)
    # ensemble prediction mixes 8 posterior samples
    assert gp.theta_samples_.shape[0] == 8
