"""SMC-resampling population argmax (the project north star's
"SMC-style loop ... acquisition candidates sharded as particles ... with
resampling").

The reference proposes each batch point by an independent restart loop
(ref: bayes_optim/bayes_opt.py:100-115); the collective-free population
CMA replaces the restarts. This engine goes one step further: blocks of
vectorized (1+1)-Cholesky-CMA generations (optim/cma.py) are interleaved
with SYSTEMATIC RESAMPLING of whole chains — state and all: position,
step size, Cholesky factors, evolution path — by annealed rank-based
acquisition weights. Chains that found good acquisition basins multiply
(inheriting their adapted covariances); stagnant chains are culled. Ranks
rather than raw values keep the weights scale-free (EI spans orders of
magnitude), and the annealing schedule sharpens selection from mild to
near-greedy across rounds, the standard SMC tempering ladder.

Everything is one jitted program: the resampling gather is a global
permutation of the particle axis, which under a sharded `particles` mesh
axis XLA lowers to a cross-device collective.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from .cma import CMAState, _constants, cma_step, init_chains


def systematic_resample(key: jax.Array, log_w: jnp.ndarray) -> jnp.ndarray:
    """Systematic resampling: indices (P,) drawn with one uniform offset —
    lower variance than multinomial and a single sorted pass."""
    P = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), log_w.dtype) / P
    pos = u0 + jnp.arange(P, dtype=log_w.dtype) / P
    return jnp.clip(jnp.searchsorted(cdf, pos), 0, P - 1)


def resample_chains(key: jax.Array, state: CMAState, rho: jnp.ndarray) -> CMAState:
    """Resample every per-chain leaf of the CMA state by annealed
    rank-based weights exp(-rho * rank / P) (rank 0 = best chain)."""
    P = state.f.shape[0]
    f = jnp.where(jnp.isfinite(state.f), state.f, jnp.inf)
    ranks = jnp.argsort(jnp.argsort(f)).astype(f.dtype)
    idx = systematic_resample(key, -rho * ranks / P)
    resampled = jax.tree_util.tree_map(lambda a: a[idx], state._replace(key=None))
    # fresh shared key: duplicated chains draw independent proposal noise
    # from the next generation on and diverge immediately
    return resampled._replace(key=jax.random.fold_in(key, 1))


def run_smc(
    key: jax.Array,
    fun: Callable,
    x0: jnp.ndarray,
    lo,
    hi,
    n_rounds: int,
    n_moves: int,
    sigma0: float = 0.25,
    rho0: float = 2.0,
    rho_growth: float = 1.6,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Minimize `fun` ((P, d) -> (P,)) with P CMA chains resampled between
    move blocks; returns (x_best[d], f_best, x_final, f_final)."""
    dim = x0.shape[-1]
    consts = _constants(dim)
    k_init, k_loop = jax.random.split(key)
    f0 = fun(x0)
    f0 = jnp.where(jnp.isfinite(f0), f0, jnp.inf)
    state = init_chains(k_init, x0, f0, sigma0)

    def move_block(state):
        def body(st, _):
            return cma_step(st, fun, lo, hi, consts)

        state, _ = jax.lax.scan(body, state, None, length=n_moves)
        return state

    def round_body(carry, rnd):
        state, best_x, best_f = carry
        state = move_block(state)
        i = jnp.argmin(state.f)
        better = state.f[i] < best_f
        best_x = jnp.where(better, state.x[i], best_x)
        best_f = jnp.where(better, state.f[i], best_f)
        rho = rho0 * rho_growth ** rnd.astype(state.f.dtype)
        k_res = jax.random.fold_in(k_loop, rnd)
        state = resample_chains(k_res, state, rho)
        return (state, best_x, best_f), None

    i0 = jnp.argmin(state.f)
    carry = (state, state.x[i0], state.f[i0])
    (state, best_x, best_f), _ = jax.lax.scan(
        round_body, carry, jnp.arange(n_rounds)
    )
    # the final move block runs un-resampled so the last exploitation
    # sweep's improvements are kept
    state = move_block(state)
    i = jnp.argmin(state.f)
    better = state.f[i] < best_f
    best_x = jnp.where(better, state.x[i], best_x)
    best_f = jnp.where(better, state.f[i], best_f)
    return best_x, best_f, state.x, state.f
