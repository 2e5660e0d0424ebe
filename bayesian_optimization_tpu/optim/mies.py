"""Population-vectorized Mixed-Integer Evolution Strategy (MIES).

Capability parity with the reference's serial MIES
(ref: bayes_optim/acquisition/optim/mies.py:14-344): (mu=4, lambda=10)-ES
over mixed real/integer/categorical spaces; genome = x ++ per-real sigma ++
per-int eta ++ categorical flip-probability P; self-adaptive log-normal
strategy mutation with tau = 1/sqrt(2 N), tau' = 1/sqrt(2 sqrt(N))
(mies.py:160-173); Gaussian real mutation with the |dx/N| step-size
correction (mies.py:221-245), double-geometric integer mutation with
p = 1 - (eta/N_i)/(1 + sqrt(1 + (eta/N_i)^2)) (mies.py:247-262), logistic
flip-probability mutation clipped to [1/(3 N_d), 1/2] (mies.py:264-274);
dominant recombination for x, intermediate for strategy parameters
(mies.py:175-185); (mu, lambda) selection with optional elitism.

Accelerator design: the reference mutates one individual at a time in Python
(mies.py:320-344, the file even asks to "compile it with cython"). Here R
independent restarts x lambda offspring form a single (R, lambda, dim)
array program on the unit-cube representation of the space: one fused
criterion evaluation per generation for the entire population, one
`lax.scan` over generations, global best via reduce.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.penalty import reflect_into_box


class MIESState(NamedTuple):
    x: jnp.ndarray         # (R, mu, dim) unit-cube parents
    strength: jnp.ndarray  # (R, mu, dim) sigma/eta/P per column type
    f: jnp.ndarray         # (R, mu)
    key: jax.Array


class MIESSpec(NamedTuple):
    """Static per-dimension type info derived from a SpaceEncoding."""

    real_mask: tuple
    int_mask: tuple
    cat_mask: tuple
    n_levels: tuple

    @classmethod
    def from_encoding(cls, enc) -> "MIESSpec":
        real = enc.is_real
        ordered = (~enc.is_real) & (~enc.is_onehot)
        cat = (~enc.is_real) & enc.is_onehot
        return cls(
            real_mask=tuple(bool(b) for b in real),
            int_mask=tuple(bool(b) for b in ordered),
            cat_mask=tuple(bool(b) for b in cat),
            n_levels=tuple(int(n) for n in enc.n_levels),
        )


def _taus(n: int) -> Tuple[float, float]:
    if n == 0:
        return 0.0, 0.0
    return 1.0 / np.sqrt(2.0 * n), 1.0 / np.sqrt(2.0 * np.sqrt(n))


def _geometric(key, p, shape, dtype):
    """Geometric(p) samples via inverse CDF (jax lacks a native sampler)."""
    u = jax.random.uniform(key, shape, dtype, minval=1e-12, maxval=1.0)
    return jnp.floor(jnp.log(u) / jnp.log1p(-jnp.clip(p, 1e-12, 1 - 1e-12))) + 1.0


def init_mies(key, spec: MIESSpec, R: int, mu: int, dtype=jnp.float32,
              fun: Optional[Callable] = None, x0: Optional[jnp.ndarray] = None) -> MIESState:
    dim = len(spec.real_mask)
    k1, k2 = jax.random.split(key)
    x = jax.random.uniform(k1, (R, mu, dim), dtype) if x0 is None else x0
    real = jnp.asarray(spec.real_mask, dtype)
    intm = jnp.asarray(spec.int_mask, dtype)
    catm = jnp.asarray(spec.cat_mask, dtype)
    nlev = jnp.asarray(spec.n_levels, dtype)
    n_cat = max(1, int(sum(spec.cat_mask)))
    # sigma0 = 0.05 of unit range; eta0 = 0.05 * n_levels; P0 = 1/N_d
    strength = (
        real * 0.05 + intm * 0.05 * jnp.maximum(nlev, 1.0) + catm * (1.0 / n_cat)
    )
    strength = jnp.broadcast_to(strength, (R, mu, dim))
    f = fun(x.reshape(R * mu, dim)).reshape(R, mu) if fun is not None else jnp.full((R, mu), jnp.inf, dtype)
    return MIESState(x=x, strength=strength, f=f, key=k2)


def mies_generation(
    state: MIESState,
    fun: Callable,
    spec: MIESSpec,
    lam: int,
    elitism: bool = False,
) -> MIESState:
    """One (mu, lambda) generation for all R restarts at once; `fun` maps
    (N, dim) unit batches to (N,) values to MINIMIZE."""
    R, mu, dim = state.x.shape
    state, x_off, s_off = _variation(state, spec, lam)
    f_off = fun(x_off.reshape(R * lam, dim)).reshape(R, lam)
    return _mies_select(state, x_off, s_off, f_off, elitism)


def run_mies(
    key,
    fun: Callable,
    spec: MIESSpec,
    n_restarts: int = 8,
    n_generations: int = 50,
    mu: int = 4,
    lam: int = 10,
    elitism: bool = False,
    dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Minimize `fun` over the unit cube with R parallel (mu, lambda)-MIES
    runs; returns (x_best[dim], f_best, final_x[R*mu, dim], final_f[R*mu])
    — the flattened final parent populations let callers apply the
    reference's per-winner feasibility preference (optim/__init__.py:124-126)."""
    state = init_mies(key, spec, n_restarts, mu, dtype, fun=fun)

    def body(st, _):
        st = mies_generation(st, fun, spec, lam, elitism)
        return st, st.f[:, 0]

    state, _ = jax.lax.scan(body, state, None, length=n_generations)
    flat_f = state.f.reshape(-1)
    flat_x = state.x.reshape(-1, state.x.shape[-1])
    best = jnp.argmin(flat_f)
    return flat_x[best], flat_f[best], flat_x, flat_f


class MIES:
    """Host-facing optimizer with the reference's surface (search_space,
    obj_func, eq/ineq constraints, max_eval) for black-box objectives; the
    population arithmetic is the vectorized kernel above, with one host
    callback per generation for the whole offspring batch."""

    def __init__(
        self,
        search_space,
        obj_func: Callable,
        eq_func: Optional[Callable] = None,
        ineq_func: Optional[Callable] = None,
        x0=None,
        ftarget: Optional[float] = None,
        max_eval: float = np.inf,
        minimize: bool = True,
        elitism: bool = False,
        mu_: int = 4,
        lambda_: int = 10,
        n_restarts: int = 1,
        verbose: bool = False,
        eval_type: str = "list",
        random_seed: int = 0,
    ):
        self.space = search_space
        self.encoding = search_space.encoding()
        self.spec = MIESSpec.from_encoding(self.encoding)
        self.obj_func = obj_func
        self.eq_func, self.ineq_func = eq_func, ineq_func
        self.minimize = minimize
        self.ftarget = ftarget
        self.max_eval = float(max_eval)
        self.elitism = elitism
        self.mu_, self.lambda_ = mu_, lambda_
        self.n_restarts = n_restarts
        self.eval_count = 0
        self.iter_count = 0
        self._eval_type = eval_type
        self.verbose = verbose
        self.stop_dict = {}
        self._key = jax.random.PRNGKey(random_seed)
        self._x0 = x0
        self.xopt, self.fopt = None, np.inf

    def _eval_host(self, U: np.ndarray) -> np.ndarray:
        from ..utils.penalty import eval_constraints_host

        X = self.encoding.decode_unit(U)
        vals = np.empty(len(X))
        for i, row in enumerate(X):
            x = list(row)
            if self._eval_type == "dict":
                x = dict(zip(self.space.var_name, x))
            y = float(self.obj_func(x))
            if not self.minimize:
                y = -y
            if self.eq_func is not None or self.ineq_func is not None:
                hv, gv = eval_constraints_host(list(row), self.eq_func, self.ineq_func)
                pen = 0.0
                if hv is not None:
                    pen += np.sum(np.abs(hv)[np.abs(hv) > 0.01])
                if gv is not None:
                    pen += np.sum(np.maximum(gv, 0.0) ** 2)
                y += 0.5 * (self.iter_count + 1) * pen
            vals[i] = y
        self.eval_count += len(X)
        return vals

    def optimize(self):
        R, mu, lam = self.n_restarts, self.mu_, self.lambda_
        dim = self.encoding.dim
        k0, self._key = jax.random.split(self._key)
        x0 = None
        if self._x0 is not None:
            u0 = self.encoding.encode_unit(np.atleast_2d(np.asarray(self._x0, dtype=object)))
            x0 = jnp.broadcast_to(jnp.asarray(u0[0], jnp.float32), (R, mu, dim))
        state = init_mies(k0, self.spec, R, mu, x0=x0)
        f0 = self._eval_host(np.asarray(state.x.reshape(R * mu, dim)))
        state = state._replace(f=jnp.asarray(f0, jnp.float32).reshape(R, mu))

        gen = jax.jit(
            lambda st: _mies_propose(st, self.spec, lam),
        )
        accept = jax.jit(
            lambda st, xo, so, fo: _mies_select(st, xo, so, fo, self.elitism),
        )
        while self.eval_count < self.max_eval:
            self.iter_count += 1
            st_mid, x_off, s_off = gen(state)
            f_off = self._eval_host(np.asarray(x_off.reshape(R * lam, dim)))
            state = accept(st_mid, x_off, s_off, jnp.asarray(f_off, jnp.float32).reshape(R, lam))
            fbest = float(jnp.min(state.f))
            if self.ftarget is not None and fbest <= (self.ftarget if self.minimize else -self.ftarget):
                self.stop_dict["ftarget"] = fbest
                break
        self.stop_dict.setdefault("max_eval", self.eval_count >= self.max_eval)
        flat_f = np.asarray(state.f).reshape(-1)
        i = int(np.argmin(flat_f))
        u = np.asarray(state.x.reshape(-1, dim))[i]
        self.xopt = list(self.encoding.decode_unit(u[None, :])[0])
        self.fopt = float(flat_f[i]) * (1.0 if self.minimize else -1.0)
        return self.xopt, self.fopt, self.stop_dict


def _mies_propose(state: MIESState, spec: MIESSpec, lam: int):
    """Recombine+mutate only (host evaluates); returns (state', x_off, s_off)."""
    return _variation(state, spec, lam)


def _variation(state: MIESState, spec: MIESSpec, lam: int):
    R, mu, dim = state.x.shape
    dtype = state.x.dtype
    real = jnp.asarray(spec.real_mask, dtype)
    intm = jnp.asarray(spec.int_mask, dtype)
    catm = jnp.asarray(spec.cat_mask, dtype)
    nlev = jnp.maximum(jnp.asarray(spec.n_levels, dtype), 1.0)
    n_r, n_i, n_d = int(sum(spec.real_mask)), int(sum(spec.int_mask)), int(sum(spec.cat_mask))
    tau_r, taup_r = _taus(n_r)
    tau_i, taup_i = _taus(n_i)
    tau_d, _ = _taus(n_d)
    keys = jax.random.split(state.key, 12)
    p1 = jax.random.randint(keys[0], (R, lam), 0, mu)
    p2 = jax.random.randint(keys[1], (R, lam), 0, mu)
    take = lambda arr, idx: jnp.take_along_axis(arr, idx[:, :, None], axis=1)
    x1, x2 = take(state.x, p1), take(state.x, p2)
    s1, s2 = take(state.strength, p1), take(state.strength, p2)
    dom = jax.random.uniform(keys[2], (R, lam, dim), dtype) > 0.5
    x = jnp.where(dom, x2, x1)
    strength = 0.5 * (s1 + s2)
    g_r = jax.random.normal(keys[3], (R, lam, 1), dtype)
    l_r = jax.random.normal(keys[4], (R, lam, dim), dtype)
    sigma = strength * jnp.exp(tau_r * g_r + taup_r * l_r)
    g_i = jax.random.normal(keys[5], (R, lam, 1), dtype)
    l_i = jax.random.normal(keys[6], (R, lam, dim), dtype)
    eta = jnp.minimum(strength * jnp.exp(tau_i * g_i + taup_i * l_i), nlev)
    g_d = jax.random.normal(keys[7], (R, lam, 1), dtype)
    P = 1.0 / (1.0 + (1.0 - strength) / jnp.clip(strength, 1e-8, 1.0) * jnp.exp(-tau_d * g_d))
    P = jnp.clip(P, 1.0 / (3.0 * max(n_d, 1)), 0.5)
    Z = jax.random.normal(keys[8], (R, lam, dim), dtype)
    x_real_new = reflect_into_box(x + sigma * Z, 0.0, 1.0)
    sigma_corr = jnp.abs((x_real_new - x) / jnp.where(jnp.abs(Z) > 1e-12, Z, 1.0))
    lev = jnp.minimum(jnp.floor(jnp.clip(x, 0, 1) * nlev), nlev - 1.0)
    eta_n = eta / max(n_i, 1)
    p_geo = 1.0 - eta_n / (1.0 + jnp.sqrt(1.0 + eta_n**2))
    gk1, gk2 = jax.random.split(keys[9])
    step = _geometric(gk1, p_geo, (R, lam, dim), dtype) - _geometric(gk2, p_geo, (R, lam, dim), dtype)
    lev_new = reflect_into_box(lev + step, 0.0, nlev - 1.0)
    x_int_new = (jnp.round(lev_new) + 0.5) / nlev
    flip = jax.random.uniform(keys[10], (R, lam, dim), dtype) < P
    u_new = jax.random.uniform(keys[11], (R, lam, dim), dtype)
    x_cat_new = jnp.where(flip, u_new, x)
    x_off = real * x_real_new + intm * x_int_new + catm * x_cat_new
    s_off = real * sigma_corr + intm * eta + catm * P
    return state._replace(key=jax.random.fold_in(state.key, 1)), x_off, s_off


def _mies_select(state: MIESState, x_off, s_off, f_off, elitism: bool) -> MIESState:
    mu = state.x.shape[1]
    f_off = jnp.where(jnp.isfinite(f_off), f_off, jnp.inf)
    if elitism:
        pool_x = jnp.concatenate([state.x, x_off], axis=1)
        pool_s = jnp.concatenate([state.strength, s_off], axis=1)
        pool_f = jnp.concatenate([state.f, f_off], axis=1)
    else:
        pool_x, pool_s, pool_f = x_off, s_off, f_off
    order = jnp.argsort(pool_f, axis=1)[:, :mu]
    sel = lambda arr: jnp.take_along_axis(arr, order[:, :, None], axis=1)
    return MIESState(
        x=sel(pool_x), strength=sel(pool_s),
        f=jnp.take_along_axis(pool_f, order, axis=1), key=state.key,
    )
