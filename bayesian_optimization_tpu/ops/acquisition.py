"""Acquisition functions as pure, batched JAX criteria.

Capability parity with the reference's acquisition layer
(ref: bayes_optim/acquisition/acquisition_fun.py:22-331): UCB, EI, PI /
epsilon-PI, and MGFI with the t <= 22.36 overflow clamp, all for
minimization with an improvement plugin (best observed value).

Design difference: the reference's criteria are objects that call
`model.predict` one candidate at a time inside scipy/CMA loops
(acquisition_fun.py:127-310); here each criterion is a pure function of
batched posterior moments `(mu[N], sd[N]) -> value[N]`, so an entire
candidate population — and a whole batch of q parameter-sampled criteria —
evaluates as one fused XLA program, with gradients via autodiff. Numerical
guard rails (sd ~ 0 -> 0, non-finite -> 0) mirror the reference's
try/except-to-zero behavior (acquisition_fun.py:136-137, 177-179, 286-287).

Convention: problems are minimization; every criterion is *maximized* by
the argmax engines.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

_SD_FLOOR = 1e-10
MGFI_T_MAX = 22.36  # ref parity: acquisition_fun.py:271


def _guard(value: jnp.ndarray, sd: jnp.ndarray) -> jnp.ndarray:
    value = jnp.where(jnp.isfinite(value), value, 0.0)
    return jnp.where(sd > _SD_FLOOR, value, 0.0)


def ei(mu: jnp.ndarray, sd: jnp.ndarray, plugin, **_) -> jnp.ndarray:
    """Expected improvement below `plugin` (ref parity: acquisition_fun.py:150-189)."""
    sd_safe = jnp.maximum(sd, _SD_FLOOR)
    imp = plugin - mu
    u = imp / sd_safe
    value = imp * norm.cdf(u) + sd_safe * norm.pdf(u)
    return _guard(value, sd)


def pi(mu, sd, plugin, epsilon: float = 0.0, **_) -> jnp.ndarray:
    """(epsilon-)probability of improvement (ref parity: acquisition_fun.py:192-236)."""
    sd_safe = jnp.maximum(sd, _SD_FLOOR)
    coef = jnp.where(mu > 0, 1.0 - epsilon, 1.0 + epsilon)
    value = norm.cdf((plugin - coef * mu) / sd_safe)
    return _guard(value, sd)


def epsilon_pi(mu, sd, plugin, epsilon: float = 1e-10, **_) -> jnp.ndarray:
    return pi(mu, sd, plugin, epsilon=epsilon)


def ucb(mu, sd, alpha: float = 0.5, **_) -> jnp.ndarray:
    """Lower-confidence bound for minimization, maximized as -mu + alpha sd
    (ref parity: acquisition_fun.py:107-147 after its maximization sign flip)."""
    return -mu + alpha * sd


def mgfi(mu, sd, plugin, t: float = 1.0, **_) -> jnp.ndarray:
    """Moment-generating function of the improvement [Wang et al., SMC'17]
    (ref parity: acquisition_fun.py:238-310)."""
    t = jnp.clip(t, 1e-12, MGFI_T_MAX)
    sd_safe = jnp.maximum(sd, _SD_FLOOR)
    mu_p = mu - t * sd_safe**2
    beta_p = (plugin - mu_p) / sd_safe
    # evaluate in log space to tame exp overflow, then zero non-finites
    log_term = t * (plugin - mu - 1.0) + 0.5 * t**2 * sd_safe**2
    value = norm.cdf(beta_p) * jnp.exp(jnp.minimum(log_term, 60.0))
    return _guard(value, sd)


def gei(mu, sd, plugin, g: int = 2, **_) -> jnp.ndarray:
    """Generalized expected improvement E[I^g] (Schonlau et al. 1998) —
    left as a stub in the reference (acquisition_fun.py:313-331). Closed
    form via the truncated-moment recursion
    M_0 = Phi(u), M_1 = -phi(u), M_k = -u^{k-1} phi(u) + (k-1) M_{k-2}
    with u = (plugin - mu)/sd:
        E[I^g] = sd^g * sum_k C(g,k) u^{g-k} (-1)^k M_k.
    g = 1 reduces to EI; larger g rewards heavier right tails (more
    exploratory)."""
    g = int(g)
    sd_safe = jnp.maximum(sd, _SD_FLOOR)
    u = (plugin - mu) / sd_safe
    phi_u = norm.pdf(u)
    moments = [norm.cdf(u), -phi_u]
    for k in range(2, g + 1):
        moments.append(-(u ** (k - 1)) * phi_u + (k - 1) * moments[k - 2])
    total = 0.0
    for k in range(g + 1):
        total = total + math.comb(g, k) * (u ** (g - k)) * ((-1.0) ** k) * moments[k]
    return _guard(sd_safe**g * total, sd)


ACQUISITIONS: Dict[str, Callable] = {
    "EI": ei,
    "PI": pi,
    "EpsilonPI": epsilon_pi,
    "UCB": ucb,
    "MGFI": mgfi,
    "GEI": gei,
}


def acquisition_fn(name: str) -> Callable:
    if callable(name):
        return name
    if name not in ACQUISITIONS:
        raise ValueError(f"unknown acquisition {name!r}; available: {sorted(ACQUISITIONS)}")
    return ACQUISITIONS[name]


class Criterion(NamedTuple):
    """A fully-bound acquisition criterion: name + per-criterion parameters.

    `params` may hold arrays with a leading batch axis to express q
    parameter-sampled criteria (ParallelBO-style) evaluated in one program.
    """

    name: str
    params: dict

    def __call__(self, mu: jnp.ndarray, sd: jnp.ndarray) -> jnp.ndarray:
        return acquisition_fn(self.name)(mu, sd, **self.params)


# ---------------------------------------------------------------------------
# Reference-style object API: criteria bound to a fitted surrogate.
# ---------------------------------------------------------------------------
class AcquisitionFunction:
    """Object wrapper for API parity with the reference's class-based
    criteria (ref: acquisition_fun.py:22-84): binds a fitted model, handles
    the minimize/maximize sign flip, and offers __call__(X, return_dx)."""

    _fn_name: str = "EI"

    def __init__(self, model=None, plugin: Optional[float] = None, minimize: bool = True, **params):
        self.minimize = minimize
        self.params = params
        self._model = model
        self.plugin = plugin

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, model):
        self._model = model

    @property
    def plugin(self):
        return self._plugin

    @plugin.setter
    def plugin(self, plugin):
        if plugin is None:
            self._plugin = None
        else:
            self._plugin = plugin if self.minimize else -plugin

    def _moments(self, X):
        import numpy as np

        mu, var = self._model.predict(np.atleast_2d(np.asarray(X, float)), eval_MSE=True)
        mu = jnp.asarray(mu).ravel()
        sd = jnp.sqrt(jnp.maximum(jnp.asarray(var).ravel(), 0.0))
        if not self.minimize:
            mu = -mu
        return mu, sd

    def criterion_params(self) -> dict:
        p = dict(self.params)
        if self._fn_name in ("EI", "PI", "EpsilonPI", "MGFI", "GEI"):
            p["plugin"] = self._plugin
        return p

    def __call__(self, X, return_dx: bool = False):
        import numpy as np

        mu, sd = self._moments(X)
        fn = acquisition_fn(self._fn_name)
        value = np.asarray(fn(mu, sd, **self.criterion_params()), dtype=float)
        out = value if value.size > 1 else float(value.reshape(-1)[0])
        if not return_dx:
            return out

        # gradient through the fused posterior program (single point)
        model, cfg = self._model, getattr(self._model, "config", None)
        x = jnp.asarray(np.asarray(X, float).reshape(-1), jnp.float32)

        def scalar_acq(xx):
            mu_j, var_j = model.predict_jax(xx.reshape(1, -1), eval_mse=True)
            mu_j = mu_j.ravel()[0]
            mu_j = jnp.where(self.minimize, mu_j, -mu_j)
            sd_j = jnp.sqrt(jnp.maximum(var_j.ravel()[0], 0.0))
            return fn(mu_j, sd_j, **self.criterion_params())

        dx = np.asarray(jax.grad(scalar_acq)(x), dtype=float).reshape(-1, 1)
        return out, np.where(np.isfinite(dx), dx, 0.0)


class EI(AcquisitionFunction):
    _fn_name = "EI"


class PI(AcquisitionFunction):
    _fn_name = "PI"


class EpsilonPI(AcquisitionFunction):
    _fn_name = "EpsilonPI"

    def __init__(self, epsilon: float = 1e-10, **kwargs):
        super().__init__(epsilon=epsilon, **kwargs)


class UCB(AcquisitionFunction):
    _fn_name = "UCB"

    def __init__(self, alpha: float = 0.5, **kwargs):
        super().__init__(alpha=alpha, **kwargs)


class GEI(AcquisitionFunction):
    _fn_name = "GEI"

    def __init__(self, g: int = 2, **kwargs):
        if int(g) < 1:
            raise ValueError("g must be a positive integer")
        super().__init__(g=int(g), **kwargs)


class MGFI(AcquisitionFunction):
    _fn_name = "MGFI"

    def __init__(self, t: float = 1.0, **kwargs):
        super().__init__(t=min(t, MGFI_T_MAX), **kwargs)

    @property
    def t(self):
        return self.params["t"]

    @t.setter
    def t(self, t):
        self.params["t"] = min(float(t), MGFI_T_MAX)
