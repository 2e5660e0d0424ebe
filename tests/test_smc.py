"""SMC-resampling population argmax (optim/smc.py — the project's
north-star particle loop; VERDICT round-3 item 9)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_optimization_tpu import BO, GaussianProcess, ParallelBO, RealSpace
from bayesian_optimization_tpu.models.trend import constant_trend
from bayesian_optimization_tpu.optim.cma import init_chains
from bayesian_optimization_tpu.optim.smc import (
    resample_chains,
    run_smc,
    systematic_resample,
)


def test_systematic_resample_matches_weights():
    """Index frequencies must match the weights to within 1/P (the
    defining property of systematic resampling)."""
    log_w = jnp.log(jnp.asarray([0.5, 0.25, 0.125, 0.125]))
    counts = np.zeros(4)
    for s in range(50):
        idx = np.asarray(systematic_resample(jax.random.PRNGKey(s), log_w))
        assert idx.shape == (4,)
        counts += np.bincount(idx, minlength=4)
    freq = counts / counts.sum()
    assert np.allclose(freq, [0.5, 0.25, 0.125, 0.125], atol=0.05), freq


def test_resample_chains_multiplies_best():
    """With sharp annealing the best chain must dominate after resampling,
    and duplicated chains must not share identical RNG streams."""
    P, d = 16, 3
    key = jax.random.PRNGKey(0)
    x0 = jax.random.uniform(key, (P, d))
    f0 = jnp.arange(P, dtype=jnp.float32)  # chain 0 is best
    state = init_chains(key, x0, f0, 0.25)
    out = resample_chains(jax.random.PRNGKey(1), state, jnp.asarray(50.0))
    # near-greedy rho: (almost) every slot is a copy of chain 0
    assert float(jnp.mean(out.f == 0.0)) > 0.8
    assert np.allclose(np.asarray(out.x[0]), np.asarray(x0[0]))
    # fresh shared key so duplicates diverge
    assert not np.array_equal(np.asarray(out.key), np.asarray(state.key))


def _multimodal(U):
    z = (U - 0.3) * 8.0
    return jnp.sum(z**2 - 2.0 * jnp.cos(3 * z), axis=-1)


def test_run_smc_finds_global_optimum_multimodal():
    d = 4
    key = jax.random.PRNGKey(0)
    x0 = jax.random.uniform(key, (64, d))
    xb, fb, X, F = run_smc(
        key, _multimodal, x0, jnp.zeros(d), jnp.ones(d), n_rounds=6, n_moves=12
    )
    # global minimum is -2d = -8 at U = 0.3 exactly
    assert float(fb) < -7.9, float(fb)
    assert np.allclose(np.asarray(xb), 0.3, atol=0.02)
    assert X.shape == (64, d) and F.shape == (64,)


def test_bo_with_smc_engine():
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, random_state=0,
    )
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = BO(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, DoE_size=5, max_FEs=15, random_seed=0,
        acquisition_optimization={"optimizer": "SMC"},
    )
    assert opt._argmax.method == "SMC"
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 15
    assert fopt[0] < 1.0, fopt


def test_parallelbo_q4_with_smc_engine():
    """The q-criteria batch path through _smc_argmax_batch: 4 MGFI
    criteria maximized jointly, distinct points returned."""
    gp = GaussianProcess(
        mean=constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, random_state=0,
    )
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = ParallelBO(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, n_point=4, acquisition_fun="MGFI", acquisition_par={"t": 2.0},
        DoE_size=4, max_FEs=16, random_seed=0,
        acquisition_optimization={"optimizer": "SMC"},
    )
    opt.run()
    assert opt.eval_count == 16
    assert float(opt.xopt.fitness.ravel()[0]) < 5.0
