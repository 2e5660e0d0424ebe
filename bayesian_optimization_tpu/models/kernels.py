"""Stationary GP correlation kernels, batched and matmul-based.

Capability parity with the reference's functional kernels
(ref: bayes_optim/surrogate/gaussian_process/kernel.py:159-466): matern
(nu in {1/2, 3/2, 5/2}), absolute_exponential, squared_exponential,
generalized_exponential, cubic, pure_nugget — all with anisotropic
length-scale weights `theta` acting on componentwise distances.

Accelerator design: the reference materializes the (n*(n-1)/2, dim) pairwise
|dx| table once and loops kernels over it with numpy (ref: gpr.py:21-61,
772-782). Here the weighted squared distance is computed as one matmul
via the expansion  r2 = |Xs|^2 + |Ys|^2 - 2 Xs Ys^T  with Xs = X*sqrt(theta)
(O(n^2 d), no (n,n,d) tensor in device memory), and every kernel
is a jittable function of `theta` so likelihood evaluations vmap over whole
batches of hyperparameter vectors. Gradients w.r.t. theta and x come from
autodiff; the reference's hand-written corr_dx/corr_grad_theta
(gpr.py:600-770) have no counterpart here by design.

L1 (absolute-distance) kernels cannot use the matmul trick; they fall back
to a broadcast reduce which XLA fuses.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

_SAFE_EPS = 1e-30


def weighted_sq_dist(theta: jnp.ndarray, X: jnp.ndarray, Y: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """r2[i,j] = sum_d theta_d * (X[i,d] - Y[j,d])^2 via a single matmul."""
    theta = jnp.broadcast_to(jnp.atleast_1d(theta), (X.shape[-1],))
    sq = jnp.sqrt(jnp.maximum(theta, 0.0))
    Xs = X * sq
    symmetric = Y is None
    Ys = Xs if symmetric else Y * sq
    xx = jnp.sum(Xs * Xs, axis=-1)
    yy = xx if symmetric else jnp.sum(Ys * Ys, axis=-1)
    # HIGHEST precision: a GPU's default float32 matmul may run in TF32
    # (10 mantissa bits), far too coarse for kernel distances (relative
    # error ~1e-3 corrupts gradients)
    r2 = xx[:, None] + yy[None, :] - 2.0 * jnp.dot(
        Xs, Ys.T, preferred_element_type=Xs.dtype, precision=jax.lax.Precision.HIGHEST
    )
    r2 = jnp.maximum(r2, 0.0)
    if symmetric:
        # exact zeros on the diagonal (matmul round-off otherwise leaks
        # spurious theta-gradients through sqrt at r ~ 0)
        r2 = r2 * (1.0 - jnp.eye(X.shape[0], dtype=r2.dtype))
    return r2


def weighted_l1_dist(theta: jnp.ndarray, X: jnp.ndarray, Y: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """l1[i,j] = sum_d theta_d * |X[i,d] - Y[j,d]| (broadcast reduce)."""
    theta = jnp.broadcast_to(jnp.atleast_1d(theta), (X.shape[-1],))
    Y = X if Y is None else Y
    return jnp.sum(theta * jnp.abs(X[:, None, :] - Y[None, :, :]), axis=-1)


def _safe_sqrt(r2: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(r2, _SAFE_EPS))


def _matern_half_integer(r: jnp.ndarray, nu: float) -> jnp.ndarray:
    """Closed-form Matern for any half-integer nu = p + 1/2 — a degree-p
    polynomial times exp(-s), fully on-device (no Bessel function needed):
        K = exp(-s) * (p!/(2p)!) * sum_i (p+i)!/(i!(p-i)!) (2s)^(p-i),
    s = sqrt(2 nu) r. Recovers the 1/2, 3/2, 5/2 specials and extends the
    XLA path to 7/2, 9/2, ... (the reference only reaches these through
    scipy's K_nu: kernel.py:203-209)."""
    p = int(nu - 0.5)
    s = math.sqrt(2.0 * nu) * r
    poly = jnp.zeros_like(s)
    for i in range(p + 1):
        coef = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
        poly = poly + coef * (2.0 * s) ** (p - i)
    return (math.factorial(p) / math.factorial(2 * p)) * poly * jnp.exp(-s)


def _matern_generic_fn(nu: float) -> Callable:
    """phi(s) = 2^(1-nu)/Gamma(nu) * s^nu * K_nu(s) for arbitrary nu > 0
    (ref parity: kernel.py:203-209). K_nu has no XLA lowering, so phi is a
    differentiable host callback: the full product is computed in float64
    on host (s^nu alone under/overflows float32 near s=0), and the theta
    gradient uses the Bessel identity d/ds [s^nu K_nu(s)] = -s^nu K_(nu-1)(s)
    as a custom JVP. Slow relative to the on-device kernels — intended for
    capability parity, not the hot path; prefer half-integer nu."""
    c = 2.0 ** (1.0 - nu) / math.gamma(nu)

    def _host(order: float, scale: float):
        def host(sv):
            import numpy as np
            from scipy.special import kv

            s64 = np.asarray(sv, dtype=np.float64)
            with np.errstate(invalid="ignore", over="ignore"):
                out = scale * s64 ** nu * kv(order, s64)
            # s -> 0 limit: phi -> 1 for the primal, derivative -> 0
            out = np.where(s64 <= 1e-12, 1.0 if order == nu else 0.0, out)
            return np.nan_to_num(out, nan=1.0 if order == nu else 0.0).astype(sv.dtype)

        return host

    @jax.custom_jvp
    def phi(s):
        return jax.pure_callback(
            _host(nu, c), jax.ShapeDtypeStruct(s.shape, s.dtype), s,
            vmap_method="expand_dims",
        )

    @phi.defjvp
    def phi_jvp(primals, tangents):
        (s,), (sd,) = primals, tangents
        dphi = jax.pure_callback(
            _host(nu - 1.0, -c), jax.ShapeDtypeStruct(s.shape, s.dtype), s,
            vmap_method="expand_dims",
        )
        return phi(s), dphi * sd

    return phi


def matern(theta, X, Y=None, nu: float = 1.5) -> jnp.ndarray:
    """Matern correlation with r = sqrt(sum_d theta_d dx_d^2)
    (ref parity: kernel.py:159-244, incl. the generic-nu branch :203-209)."""
    r2 = weighted_sq_dist(theta, X, Y)
    r = _safe_sqrt(r2)
    if nu == 0.5:
        K = jnp.exp(-r)
    elif nu == 1.5:
        s = math.sqrt(3.0) * r
        K = (1.0 + s) * jnp.exp(-s)
    elif nu == 2.5:
        s = math.sqrt(5.0) * r
        K = (1.0 + s + s * s / 3.0) * jnp.exp(-s)
    elif nu > 0 and float(nu - 0.5).is_integer():
        K = _matern_half_integer(r, float(nu))
    elif nu > 0:
        K = _matern_generic_fn(float(nu))(math.sqrt(2.0 * nu) * r)
    else:
        raise ValueError(f"matern requires nu > 0, got {nu}")
    if Y is None:
        K = _unit_diag(K)
    return K


def squared_exponential(theta, X, Y=None) -> jnp.ndarray:
    """exp(-sum_d theta_d dx_d^2) (ref parity: kernel.py:289-329)."""
    K = jnp.exp(-weighted_sq_dist(theta, X, Y))
    return _unit_diag(K) if Y is None else K


def absolute_exponential(theta, X, Y=None) -> jnp.ndarray:
    """exp(-sum_d theta_d |dx_d|), the OU kernel (ref parity: kernel.py:247-286)."""
    K = jnp.exp(-weighted_l1_dist(theta, X, Y))
    return _unit_diag(K) if Y is None else K


def generalized_exponential(theta, X, Y=None, power: float = 1.5) -> jnp.ndarray:
    """exp(-sum_d theta_d |dx_d|^p), 0 < p <= 2 (ref parity: kernel.py:332-379)."""
    theta = jnp.broadcast_to(jnp.atleast_1d(theta), (X.shape[-1],))
    Yv = X if Y is None else Y
    d = jnp.sum(theta * jnp.abs(X[:, None, :] - Yv[None, :, :]) ** power, axis=-1)
    K = jnp.exp(-d)
    return _unit_diag(K) if Y is None else K


def cubic(theta, X, Y=None) -> jnp.ndarray:
    """Product of per-dimension cubic correlations over td = min(theta_d |dx_d|, 1):
    prod_d (1 - 3 td^2 + 2 td^3) (ref parity: kernel.py:419-466)."""
    theta = jnp.broadcast_to(jnp.atleast_1d(theta), (X.shape[-1],))
    Yv = X if Y is None else Y
    td = jnp.minimum(theta * jnp.abs(X[:, None, :] - Yv[None, :, :]), 1.0)
    K = jnp.prod(1.0 - 3.0 * td**2 + 2.0 * td**3, axis=-1)
    return _unit_diag(K) if Y is None else K


def pure_nugget(theta, X, Y=None) -> jnp.ndarray:
    """White-noise correlation: 1 iff same point (ref parity: kernel.py:382-416)."""
    del theta
    if Y is None:
        return jnp.eye(X.shape[0], dtype=X.dtype)
    d = jnp.sum(jnp.abs(X[:, None, :] - Y[None, :, :]), axis=-1)
    return jnp.where(d == 0.0, 1.0, 0.0).astype(X.dtype)


def _unit_diag(K: jnp.ndarray) -> jnp.ndarray:
    n = K.shape[0]
    eye = jnp.eye(n, dtype=K.dtype)
    return K * (1.0 - eye) + eye


_KERNELS: dict = {
    "matern": partial(matern, nu=1.5),
    "matern12": partial(matern, nu=0.5),
    "matern32": partial(matern, nu=1.5),
    "matern52": partial(matern, nu=2.5),
    "squared_exponential": squared_exponential,
    "rbf": squared_exponential,
    "absolute_exponential": absolute_exponential,
    "generalized_exponential": generalized_exponential,
    "cubic": cubic,
    "pure_nugget": pure_nugget,
}


def kernel_fn(name) -> Callable:
    """Look up a kernel by (reference-compatible) name. Also accepts a
    callable, or a ("matern", nu) / ("generalized_exponential", power)
    tuple for parameterized families."""
    if callable(name):
        return name
    if isinstance(name, tuple) and len(name) == 2:
        family, param = name
        if family == "matern":
            return partial(matern, nu=float(param))
        if family == "generalized_exponential":
            return partial(generalized_exponential, power=float(param))
        raise ValueError(f"unknown parameterized kernel family {family!r}")
    if name not in _KERNELS:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(_KERNELS)}")
    return _KERNELS[name]
