"""Acquisition argmax as one sharded population program.

Capability parity with the reference's `argmax_restart` dispatcher
(ref: bayes_optim/acquisition/optim/__init__.py:55-153): multi-restart
maximization of an acquisition criterion over the search space, with
L-BFGS for differentiable criteria on continuous spaces and
(1+1)-Cholesky-CMA-ES / MIES-style evolution otherwise, dynamic-penalty
constraint handling and best-of-restarts selection. Budget defaults mirror
acquisition/optim/option.py:5-12 (BFGS ~100*dim evals, ES ~1000*dim evals,
n_restart = 5*dim).

Accelerator design: the reference runs restarts sequentially, each calling the
GP predict one point at a time (SURVEY section 3.2 — the primary wall-clock
sink). Here the *entire* argmax — criterion evaluation through the fused GP
posterior, all restarts/chains, all generations — is ONE jitted XLA program:
restarts are a leading batch axis, every generation is a single batched
Cholesky-solve + acquisition, and the final argmax is a reduce.
Everything operates on the unit-cube representation of the space
(space/encoding.py); mixed variables ride along via quantized embedding.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.likelihood import (
    GPConfig, PosteriorState, predict as _gp_point_predict, predict_ensemble, trend_basis,
)


def predict(state, Xq, Fq, config, eval_mse=True):
    """GP predict dispatch: point posterior or hyperparameter-ensemble mixture."""
    if isinstance(config, GPConfig) and config.n_ensemble > 0:
        return predict_ensemble(state, Xq, Fq, config, eval_mse)
    return _gp_point_predict(state, Xq, Fq, config, eval_mse)
from ..ops.acquisition import acquisition_fn
from ..ops.optimize import maximize_restarts
from .cma import run_cma
from .mies import MIESSpec, run_mies



def _inject_seeds(x0, x0_seed, dtype):
    """Overwrite the head of a restart/chain pool (last-two dims (P, dim),
    optionally with a leading q axis) with caller-supplied unit-cube seed
    rows; the rest of the pool stays random."""
    if x0_seed is None:
        return x0
    seeds = jnp.asarray(np.atleast_2d(np.asarray(x0_seed, float)), dtype)
    s = min(seeds.shape[0], x0.shape[-2])
    if x0.ndim == 3:
        return x0.at[:, :s, :].set(seeds[None, :s, :])
    return x0.at[:s].set(seeds[:s])


def make_unit_criterion(
    encoding,
    state: PosteriorState,
    config: GPConfig,
    acq_name: str,
    acq_params: Dict,
    minimize: bool = True,
    fixed_mask: Optional[jnp.ndarray] = None,
    fixed_vals: Optional[jnp.ndarray] = None,
    constraints=None,
) -> Callable:
    """Build crit(U[P, dim]) -> value[P]: unit cube -> embed -> fused GP
    posterior -> acquisition. Larger is better.

    constraints: optional `ConstraintProgram`; its dynamic penalty is
    SUBTRACTED from the criterion inside the program (ref parity: the
    `Penalized` wrapper of optim/__init__.py:33-52, with autodiff replacing
    the reference's finite-difference penalty gradient when the user's
    callables trace)."""
    # reserved "_"-prefixed keys are NOT acquisition kwargs:
    # - "_pca*" carry PCABO's out-of-box penalty parameters
    #   (ref parity: extension.py:62-86);
    # - "_prior_state"/"_prior_depth" carry a NonparametricTrend's
    #   XLA-traversable RF prior mean, added to the GP's RESIDUAL posterior
    #   mean so acquisition values see the full prediction (without this
    #   the fused argmax silently optimized the residual process only)
    # - "_penalty_t" is the dynamic-penalty time parameter for `constraints`
    reserved = {k: v for k, v in acq_params.items() if k.startswith("_")}
    _PCA_KEYS = ("_pca_C", "_pca_offset", "_box_lo", "_box_hi", "_red_lo", "_red_hi")
    pca_info = {k: reserved[k] for k in _PCA_KEYS if k in reserved}
    prior_state = reserved.get("_prior_state")
    prior_depth = reserved.get("_prior_depth")
    penalty_t = reserved.get("_penalty_t", 10.0)
    acq_params = {k: v for k, v in acq_params.items() if not k.startswith("_")}

    def subst_fixed(U: jnp.ndarray) -> jnp.ndarray:
        if fixed_mask is not None:
            return jnp.where(fixed_mask[None, :] > 0, fixed_vals[None, :], U)
        return U

    def apply_penalty(value: jnp.ndarray, U2d: jnp.ndarray) -> jnp.ndarray:
        """value (P,) minus the dynamic penalty of unit rows (P', dim) with
        P' an integer multiple of P (joint-q criteria sum per-copy terms)."""
        if constraints is None:
            return value
        pen = constraints.penalty(U2d, penalty_t)
        if pen.shape[0] != value.shape[0]:
            pen = pen.reshape(value.shape[0], -1).sum(axis=1)
        return value - pen

    def box_penalty(U: jnp.ndarray) -> jnp.ndarray:
        """Negative total violation of the ORIGINAL box after inverse PCA."""
        z = pca_info["_red_lo"][None, :] + U * (
            pca_info["_red_hi"][None, :] - pca_info["_red_lo"][None, :]
        )
        x = z @ pca_info["_pca_C"] + pca_info["_pca_offset"][None, :]
        viol = jnp.sum(jnp.maximum(pca_info["_box_lo"][None, :] - x, 0.0), axis=1) + jnp.sum(
            jnp.maximum(x - pca_info["_box_hi"][None, :], 0.0), axis=1
        )
        return -viol

    def moments(U: jnp.ndarray):
        if fixed_mask is not None:
            U = jnp.where(fixed_mask[None, :] > 0, fixed_vals[None, :], U)
        E = encoding.unit_to_embed(U)
        if isinstance(config, GPConfig):
            Fq = trend_basis(config, E)
            mu, var = predict(state, E, Fq, config, True)
            if prior_state is not None:
                # residual GP + XLA-traversed RF prior mean (NonparametricTrend)
                from ..models.random_forest import RFConfig as _RFC, rf_predict as _rfp

                pm, _ = _rfp(prior_state, E, _RFC(max_depth=prior_depth))
                mu = mu + pm.reshape(mu.shape)
        else:  # RF (or any surrogate exposing an (state, X, config) predict)
            from ..models.random_forest import rf_predict

            mu, var = rf_predict(state, E, config)
        return mu, jnp.sqrt(jnp.maximum(var, 0.0))

    if acq_name == "EHVI":
        from ..ops.ehvi import ehvi

        def crit(U: jnp.ndarray) -> jnp.ndarray:
            mu, sd = moments(U)  # (P, m) — maximization-oriented outputs
            value = ehvi(mu, sd, acq_params["cell_lower"], acq_params["cell_upper"])
            return apply_penalty(value, subst_fixed(U))

        return crit

    if acq_name.startswith("qEHVI"):
        # joint q-point criterion over a q-replicated space; the static q is
        # encoded in the name (e.g. "qEHVI4") so it stays jit-static
        from ..ops.ehvi import QEHVI_N_SAMPLES, qehvi

        q = int(acq_name[5:] or 1)

        def crit(U: jnp.ndarray) -> jnp.ndarray:
            # U: (P, q*dim) joint candidates on the replicated space; its
            # embedding is the concatenation of q per-copy blocks
            P = U.shape[0]
            if fixed_mask is not None:
                Uv = jnp.where(fixed_mask[None, :] > 0, fixed_vals[None, :], U)
            else:
                Uv = U
            E = encoding.unit_to_embed(Uv).reshape(P * q, -1)
            if isinstance(config, GPConfig):
                mu, var = predict(state, E, trend_basis(config, E), config, True)
            else:
                from ..models.random_forest import rf_predict

                mu, var = rf_predict(state, E, config)
            sd = jnp.sqrt(jnp.maximum(var, 0.0))
            mu = mu.reshape(P, q, -1)
            sd = sd.reshape(P, q, -1)
            value = jax.vmap(
                lambda m, s: qehvi(
                    m, s, acq_params["cell_lower"], acq_params["cell_upper"],
                    acq_params["key"], n_samples=QEHVI_N_SAMPLES,
                )
            )(mu, sd)
            # per-copy constraint penalties summed over the q block
            return apply_penalty(value, Uv.reshape(P * q, -1))

        return crit

    if acq_name.startswith("GEI"):
        # static improvement order encoded in the name ("GEI3"), since the
        # moment recursion unrolls over g at trace time
        from functools import partial as _partial

        from ..ops.acquisition import gei

        fn = _partial(gei, g=int(acq_name[3:] or 2))
    else:
        fn = acquisition_fn(acq_name)

    def crit(U: jnp.ndarray) -> jnp.ndarray:
        mu, sd = moments(U)
        mu0, sd0 = mu[:, 0], sd[:, 0]
        if not minimize:
            mu0 = -mu0
        value = fn(mu0, sd0, **acq_params)
        if pca_info:
            pen = box_penalty(U)
            value = jnp.where(pen < 0.0, pen, value)
        return apply_penalty(value, subst_fixed(U))

    return crit


def _select_feasible(constraints, X, F, x_fallback, f_fallback):
    """Prefer the best FEASIBLE restart/chain winner over the population
    finals (X: (P, dim) unit rows, F: (P,) maximized values); fall back to
    the penalized best when no winner is feasible
    (ref parity: optim/__init__.py:124-126 feasibility filter).

    On a q-replicated space (joint-q criteria: X is (P, q*dim)) every copy
    must be feasible."""
    d = constraints.encoding.dim
    if X.shape[-1] != d:
        qrep = X.shape[-1] // d
        feas_flat = constraints.feasible_in_program(X.reshape(-1, d))
        feas = jnp.all(feas_flat.reshape(X.shape[0], qrep), axis=1)
    else:
        feas = constraints.feasible_in_program(X)
    masked = jnp.where(feas, F, -jnp.inf)
    i = jnp.argmax(masked)
    any_f = jnp.any(feas)
    xb = jnp.where(any_f, X[i], x_fallback)
    fb = jnp.where(any_f, masked[i], f_fallback)
    return xb, fb


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "max_iter", "constraints"),
)
def _bfgs_argmax(
    key, state, config, encoding, acq_name, acq_params, minimize,
    x0, fixed_mask, fixed_vals, max_iter, constraints=None,
):
    crit = make_unit_criterion(
        encoding, state, config, acq_name, acq_params, minimize, fixed_mask, fixed_vals,
        constraints,
    )
    one = lambda u: crit(u[None, :])[0]
    dim = x0.shape[-1]
    res = maximize_restarts(one, x0, jnp.zeros(dim), jnp.ones(dim), max_iter=max_iter)
    if constraints is not None:
        u, val = _select_feasible(constraints, res.x, res.fun, res.x_best, res.fun_best)
    else:
        u, val = res.x_best, res.fun_best
    if fixed_mask is not None:
        u = jnp.where(fixed_mask > 0, fixed_vals, u)
    return u, val


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "n_generations", "constraints"),
)
def _cma_argmax(
    key, state, config, encoding, acq_name, acq_params, minimize,
    x0, fixed_mask, fixed_vals, n_generations, constraints=None,
):
    crit = make_unit_criterion(
        encoding, state, config, acq_name, acq_params, minimize, fixed_mask, fixed_vals,
        constraints,
    )
    dim = x0.shape[-1]
    neg = lambda U: -crit(U)
    xb, fb, xs, fs = run_cma(key, neg, x0, jnp.zeros(dim), jnp.ones(dim), n_generations)
    if constraints is not None:
        xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb)
        fb = -nfb
    if fixed_mask is not None:
        xb = jnp.where(fixed_mask > 0, fixed_vals, xb)
    return xb, -fb


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "spec", "n_restarts", "n_generations", "constraints"),
)
def _mies_argmax(
    key, state, config, encoding, acq_name, acq_params, minimize,
    fixed_mask, fixed_vals, spec, n_restarts, n_generations, constraints=None,
):
    crit = make_unit_criterion(
        encoding, state, config, acq_name, acq_params, minimize, fixed_mask, fixed_vals,
        constraints,
    )
    xb, fb, xs, fs = run_mies(
        key, lambda U: -crit(U), spec,
        n_restarts=n_restarts, n_generations=n_generations,
    )
    if constraints is not None:
        xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb)
        fb = -nfb
    if fixed_mask is not None:
        xb = jnp.where(fixed_mask > 0, fixed_vals, xb)
    return xb, -fb


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "n_rounds", "n_moves", "constraints"),
)
def _smc_argmax(
    key, state, config, encoding, acq_name, acq_params, minimize,
    x0, fixed_mask, fixed_vals, n_rounds, n_moves, constraints=None,
):
    from .smc import run_smc

    crit = make_unit_criterion(
        encoding, state, config, acq_name, acq_params, minimize, fixed_mask, fixed_vals,
        constraints,
    )
    dim = x0.shape[-1]
    xb, fb, xs, fs = run_smc(
        key, lambda U: -crit(U), x0, jnp.zeros(dim), jnp.ones(dim), n_rounds, n_moves
    )
    if constraints is not None:
        xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb)
        fb = -nfb
    if fixed_mask is not None:
        xb = jnp.where(fixed_mask > 0, fixed_vals, xb)
    return xb, -fb


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "n_rounds", "n_moves", "constraints"),
)
def _smc_argmax_batch(
    key, state, config, encoding, acq_name, acq_params_batch, minimize,
    x0_batch, fixed_mask, fixed_vals, n_rounds, n_moves, constraints=None,
):
    from .smc import run_smc

    def one(k, params, x0):
        crit = make_unit_criterion(
            encoding, state, config, acq_name, params, minimize, fixed_mask, fixed_vals,
            constraints,
        )
        dim = x0.shape[-1]
        xb, fb, xs, fs = run_smc(
            k, lambda U: -crit(U), x0, jnp.zeros(dim), jnp.ones(dim), n_rounds, n_moves
        )
        if constraints is not None:
            xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb)
            fb = -nfb
        if fixed_mask is not None:
            xb = jnp.where(fixed_mask > 0, fixed_vals, xb)
        return xb, -fb

    q = x0_batch.shape[0]
    keys = jax.random.split(key, q)
    return jax.vmap(one)(keys, acq_params_batch, x0_batch)


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "max_iter", "constraints"),
)
def _bfgs_argmax_batch(
    key, state, config, encoding, acq_name, acq_params_batch, minimize,
    x0_batch, fixed_mask, fixed_vals, max_iter, constraints=None,
):
    """q-criteria batch: vmap the whole multi-start maximization over the
    leading axis of the parameter pytree and x0 (q, R, dim) — the
    ParallelBO ask as ONE program (SURVEY parallelism item 1)."""

    def one(params, x0):
        crit = make_unit_criterion(
            encoding, state, config, acq_name, params, minimize, fixed_mask, fixed_vals,
            constraints,
        )
        dim = x0.shape[-1]
        res = maximize_restarts(
            lambda u: crit(u[None, :])[0], x0, jnp.zeros(dim), jnp.ones(dim), max_iter=max_iter
        )
        if constraints is not None:
            u, val = _select_feasible(constraints, res.x, res.fun, res.x_best, res.fun_best)
        else:
            u, val = res.x_best, res.fun_best
        if fixed_mask is not None:
            u = jnp.where(fixed_mask > 0, fixed_vals, u)
        return u, val

    return jax.vmap(one)(acq_params_batch, x0_batch)


@partial(
    jax.jit,
    static_argnames=("encoding", "config", "acq_name", "minimize", "n_generations", "constraints"),
)
def _cma_argmax_batch(
    key, state, config, encoding, acq_name, acq_params_batch, minimize,
    x0_batch, fixed_mask, fixed_vals, n_generations, constraints=None,
):
    def one(k, params, x0):
        crit = make_unit_criterion(
            encoding, state, config, acq_name, params, minimize, fixed_mask, fixed_vals,
            constraints,
        )
        dim = x0.shape[-1]
        xb, fb, xs, fs = run_cma(k, lambda U: -crit(U), x0, jnp.zeros(dim), jnp.ones(dim), n_generations)
        if constraints is not None:
            xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb)
            fb = -nfb
        if fixed_mask is not None:
            xb = jnp.where(fixed_mask > 0, fixed_vals, xb)
        return xb, -fb

    q = x0_batch.shape[0]
    keys = jax.random.split(key, q)
    return jax.vmap(one)(keys, acq_params_batch, x0_batch)


class AcquisitionArgmax:
    """Maximizes acquisition criteria over a `SpaceEncoding`'s unit cube.

    method: 'BFGS' (gradient multi-start; continuous spaces),
            'OnePlusOne_Cholesky_CMA' (vectorized ES; any space),
            'MIES' (real (mu, lambda)-MIES with self-adaptive per-type
            strategy parameters — optim/mies.py),
            'SMC' (CMA chains with annealed systematic resampling between
            move blocks — optim/smc.py, the north-star particle loop),
            'auto' — BFGS for all-real spaces, ES otherwise
            (ref parity: the optimizer selection logic of base.py:192-229).

    constraints: optional `ConstraintProgram` applied to EVERY criterion
    this instance maximizes — dynamic penalty inside the program plus the
    reference's feasibility preference on restart winners.
    """

    def __init__(
        self,
        encoding,
        method: str = "auto",
        n_restart: Optional[int] = None,
        max_FEs: Optional[int] = None,
        n_chains: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        constraints=None,
    ):
        # mesh: optional jax.sharding.Mesh with a 'particles' axis; the
        # population axis (restarts / CMA chains) is sharded across it and
        # the best-of-population argmax becomes an XLA collective
        self.mesh = mesh
        self.constraints = constraints
        self.encoding = encoding
        dim = encoding.dim
        all_real = bool(np.all(encoding.is_real))
        if method == "auto":
            method = "BFGS" if all_real else "MIES"
        self.method = method
        self.n_restart = n_restart or 5 * dim
        # ES budget ~1000*dim evals split over chains x generations
        self.n_chains = n_chains or max(32, 4 * dim)
        budget = max_FEs or (1000 * dim if method != "BFGS" else 100 * dim)
        self.max_FEs = budget
        self.n_generations = max(16, int(budget // self.n_chains))
        self.max_iter = 40
        # SMC: same chain budget split into resampling rounds x move blocks
        self.n_smc_rounds = 6
        self.n_smc_moves = max(4, self.n_generations // (self.n_smc_rounds + 1))
        self._spec = MIESSpec.from_encoding(encoding)
        # MIES budget: n_restart runs of (4,10)-ES; lambda evals/generation
        self.n_mies_restarts = max(4, (n_restart or 5 * dim) // 4)
        self.n_mies_generations = max(16, int(budget // (10 * self.n_mies_restarts)))
        self._key = jax.random.PRNGKey(seed)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def __call__(
        self,
        state: PosteriorState,
        config: GPConfig,
        acq_name: str,
        acq_params: Dict,
        minimize: bool = True,
        fixed: Optional[Dict[int, float]] = None,
        x0_seed: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, float]:
        """Returns (u_best[dim] on the unit cube, criterion value).

        x0_seed: optional (s, dim) unit-cube points injected into the
        restart/chain pool (e.g. PCABO's incumbent projected into the
        current reduced space) — the rest of the pool stays random."""
        dim = self.encoding.dim
        dtype = self.encoding.dtype
        fixed_mask = jnp.zeros(dim, dtype)
        fixed_vals = jnp.zeros(dim, dtype)
        if fixed:
            fm = np.zeros(dim)
            fv = np.zeros(dim)
            for j, u in fixed.items():
                fm[j] = 1.0
                fv[j] = u
            fixed_mask = jnp.asarray(fm, dtype)
            fixed_vals = jnp.asarray(fv, dtype)

        # keep typed arrays (PRNG keys, cell bounds) and pytrees (e.g. the
        # RFState of a nonparametric prior) as-is; cast Python scalars
        params = {
            k: v if (hasattr(v, "dtype") or isinstance(v, tuple)) else jnp.asarray(v, dtype)
            for k, v in acq_params.items()
        }

        def seed_pool(x0):
            return _inject_seeds(x0, x0_seed, dtype)

        def shard(x0):
            if self.mesh is None:
                return x0
            from ..parallel.mesh import shard_population

            return shard_population(x0, self.mesh)

        if self.mesh is not None:
            # replicate the (small) posterior state across the mesh up front;
            # otherwise it lives on device 0 and GSPMD inserts per-use
            # broadcasts inside the generation loop
            from ..parallel.mesh import replicated

            state = jax.device_put(state, replicated(self.mesh))

        key = self._next_key()
        if self.method == "BFGS":
            x0 = shard(seed_pool(jax.random.uniform(key, (self.n_restart, dim), dtype)))
            u, val = _bfgs_argmax(
                key, state, config, self.encoding, acq_name, params, minimize,
                x0, fixed_mask, fixed_vals, self.max_iter, self.constraints,
            )
        elif self.method == "MIES":
            u, val = _mies_argmax(
                key, state, config, self.encoding, acq_name, params, minimize,
                fixed_mask, fixed_vals, self._spec,
                self.n_mies_restarts, self.n_mies_generations, self.constraints,
            )
        elif self.method == "SMC":
            x0 = shard(seed_pool(jax.random.uniform(key, (self.n_chains, dim), dtype)))
            u, val = _smc_argmax(
                key, state, config, self.encoding, acq_name, params, minimize,
                x0, fixed_mask, fixed_vals, self.n_smc_rounds, self.n_smc_moves,
                self.constraints,
            )
        else:
            x0 = shard(seed_pool(jax.random.uniform(key, (self.n_chains, dim), dtype)))
            u, val = _cma_argmax(
                key, state, config, self.encoding, acq_name, params, minimize,
                x0, fixed_mask, fixed_vals, self.n_generations, self.constraints,
            )
        u = np.asarray(self.encoding.quantize_unit(u)).clip(0.0, 1.0)
        return u, float(val)

    def batch(
        self,
        state: PosteriorState,
        config: GPConfig,
        acq_name: str,
        acq_params_list,
        minimize: bool = True,
        fixed: Optional[Dict[int, float]] = None,
        x0_seed: Optional[np.ndarray] = None,
    ):
        """q criteria (same acquisition, different parameters) maximized in
        ONE jitted program. Returns (list of unit vectors, list of values).
        x0_seed rows are injected at the head of EVERY criterion's pool."""
        dim = self.encoding.dim
        dtype = self.encoding.dtype
        q = len(acq_params_list)
        fixed_mask = jnp.zeros(dim, dtype)
        fixed_vals = jnp.zeros(dim, dtype)
        if fixed:
            fm = np.zeros(dim)
            fv = np.zeros(dim)
            for j, uval in fixed.items():
                fm[j] = 1.0
                fv[j] = uval
            fixed_mask = jnp.asarray(fm, dtype)
            fixed_vals = jnp.asarray(fv, dtype)

        # stack parameter dicts (same keys) along a leading q axis;
        # pytree values (NamedTuples like a prior's RFState) stack per leaf
        keys_set = set(acq_params_list[0])
        if any(set(p) != keys_set for p in acq_params_list):
            raise ValueError("all parameter dicts must share the same keys")

        def stack_key(k):
            vals = [
                p[k] if (hasattr(p[k], "dtype") or isinstance(p[k], tuple))
                else jnp.asarray(p[k], dtype)
                for p in acq_params_list
            ]
            if isinstance(vals[0], tuple):
                return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *vals)
            return jnp.stack(vals)

        params_batch = {k: stack_key(k) for k in keys_set}
        key = self._next_key()
        def seed_pool(x0):
            return _inject_seeds(x0, x0_seed, dtype)

        if self.method == "BFGS":
            x0 = seed_pool(jax.random.uniform(key, (q, self.n_restart, dim), dtype))
            us, vals = _bfgs_argmax_batch(
                key, state, config, self.encoding, acq_name, params_batch, minimize,
                x0, fixed_mask, fixed_vals, self.max_iter, self.constraints,
            )
        elif self.method == "SMC":
            x0 = seed_pool(jax.random.uniform(key, (q, self.n_chains, dim), dtype))
            us, vals = _smc_argmax_batch(
                key, state, config, self.encoding, acq_name, params_batch, minimize,
                x0, fixed_mask, fixed_vals, self.n_smc_rounds, self.n_smc_moves,
                self.constraints,
            )
        else:
            x0 = seed_pool(jax.random.uniform(key, (q, self.n_chains, dim), dtype))
            us, vals = _cma_argmax_batch(
                key, state, config, self.encoding, acq_name, params_batch, minimize,
                x0, fixed_mask, fixed_vals, self.n_generations, self.constraints,
            )
        us = np.asarray(self.encoding.quantize_unit(us)).clip(0.0, 1.0)
        return [us[i] for i in range(q)], [float(v) for v in np.asarray(vals)]
