"""Vectorized box-constrained minimization for hyperparameter fitting and
gradient-based acquisition argmax.

Batched replacement for the reference's serial `fmin_l_bfgs_b` restart
loops (ref: bayes_optim/surrogate/gaussian_process/gpr.py:1127-1162 and
bayes_optim/acquisition/optim/__init__.py:76-93): all restarts run *at once*
under `vmap` as one XLA program — each likelihood/acquisition evaluation for
R restarts is a single batched Cholesky/matmul instead of R
sequential scipy calls.

Box bounds are enforced by a smooth sigmoid reparameterization
x = lo + (hi - lo) * sigmoid(z) seen by a compact two-loop-recursion
L-BFGS with Armijo backtracking (_lbfgs_compact; it replaced optax's
lbfgs+zoom, whose ~15x objective inlining bloated the fused-fit
executable), rather than L-BFGS-B's active-set projection. Behavioral effect is the same: iterates stay strictly inside the
box, optima in the interior are reached to line-search precision.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

_Z_CLIP = 12.0  # |z| beyond this is numerically saturated in f32


def to_box(z: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    return lo + (hi - lo) * jax.nn.sigmoid(z)


def from_box(x: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    frac = jnp.clip((x - lo) / jnp.maximum(hi - lo, 1e-30), 1e-6, 1.0 - 1e-6)
    return jnp.clip(jnp.log(frac) - jnp.log1p(-frac), -_Z_CLIP, _Z_CLIP)


class MinimizeResult(NamedTuple):
    x: jnp.ndarray        # (R, d) final points, in box coordinates
    fun: jnp.ndarray      # (R,) final objective values
    x_best: jnp.ndarray   # (d,) best point over restarts
    fun_best: jnp.ndarray # () best value


def _lbfgs_compact(zfun, z0, max_iter, memory_size, max_linesearch_steps):
    """Two-loop-recursion L-BFGS with Armijo backtracking, flattened into a
    SINGLE while_loop state machine so the objective is instantiated
    EXACTLY ONCE in the generated code: every evaluation — the initial
    point, each backtracking probe, and the accepted step — flows through
    the one value_and_grad call in the loop body. Two prior designs
    motivated this: optax's lbfgs+zoom inlined the objective ~15x per call
    site (45 Cholesky instantiations in one executable, slow to compile
    and load), and the scan-of-
    while successor still instantiated it 3x (init vg + line-search value
    + accept vg), with XLA cloning the likelihood's Cholesky loop bodies
    at every site. One site also deletes real FLOPs: the accepted point
    used to be evaluated twice (value in the line search, value+grad on
    accept). Optimization quality is golden-tested in tests/test_gp.py."""
    d = z0.shape[0]
    dtype = z0.dtype
    m = memory_size
    vg = jax.value_and_grad(zfun)
    c1 = 1e-4

    class St(NamedTuple):
        z: jnp.ndarray
        f: jnp.ndarray
        g: jnp.ndarray
        S: jnp.ndarray      # (m, d) s-history (circular)
        Y: jnp.ndarray      # (m, d) y-history
        rho: jnp.ndarray    # (m,)
        k: jnp.ndarray      # number of accepted curvature pairs
        gamma: jnp.ndarray  # initial Hessian scale
        p: jnp.ndarray      # (d,) current search direction
        gTp: jnp.ndarray    # directional derivative at the step base
        t: jnp.ndarray      # current trial step length
        n_probe: jnp.ndarray   # backtracking probes taken this step
        n_accept: jnp.ndarray  # completed iterations
        done: jnp.ndarray      # stalled: the state machine is at a fixed point

    def direction(st: St) -> jnp.ndarray:
        nv = jnp.minimum(st.k, m)

        def bwd(i, carry):
            q, alphas = carry
            j = jnp.mod(st.k - 1 - i, m)
            valid = (i < nv).astype(dtype)
            a = valid * st.rho[j] * jnp.dot(st.S[j], q)
            return q - a * st.Y[j], alphas.at[j].set(a)

        q, alphas = jax.lax.fori_loop(
            0, m, bwd, (st.g, jnp.zeros((m,), dtype))
        )
        r = st.gamma * q

        def fwd(i, r):
            ii = m - 1 - i  # oldest-to-newest = reverse of bwd order
            j = jnp.mod(st.k - 1 - ii, m)
            valid = (ii < nv).astype(dtype)
            b = valid * st.rho[j] * jnp.dot(st.Y[j], r)
            return r + valid * (alphas[j] - b) * st.S[j]

        r = jax.lax.fori_loop(0, m, fwd, r)
        # fall back to steepest descent until history exists / if not a
        # descent direction
        p = -r
        ok = (st.k > 0) & (jnp.dot(p, st.g) < 0.0) & jnp.all(jnp.isfinite(p))
        return jnp.where(ok, p, -st.g)

    def cond(st: St):
        # +1: the first "iteration" is the state machine evaluating z0
        return (st.n_accept < max_iter + 1) & jnp.logical_not(st.done)

    def body(st: St):
        z_trial = jnp.clip(st.z + st.t * st.p, -_Z_CLIP, _Z_CLIP)
        f_t, g_t = vg(z_trial)  # the ONE objective instantiation
        # a non-finite gradient (the objective's penalty plateau, e.g. the
        # GP likelihood's 1e12 region) must not poison the direction or the
        # curvature history: zero it — the chain then idles in place
        # instead of stepping to NaN (a finite f at a NaN iterate would
        # otherwise be ACCEPTED, and x_best comes out NaN)
        g_t = jnp.where(jnp.isfinite(g_t), g_t, 0.0)
        armijo = f_t <= st.f + c1 * st.t * st.gTp
        exhausted = st.n_probe >= max_linesearch_steps
        stop_probing = armijo | exhausted

        # -------- line-search continues: halve t, try again -------------
        probe_st = st._replace(t=0.5 * st.t, n_probe=st.n_probe + 1)

        # -------- step concludes: accept if finite and improving --------
        good = jnp.isfinite(f_t) & (f_t <= st.f) & jnp.all(jnp.isfinite(z_trial))
        z_new = jnp.where(good, z_trial, st.z)
        f_new = jnp.where(good, f_t, st.f)
        g_new = jnp.where(good, g_t, st.g)
        s = z_new - st.z
        y = g_new - st.g
        sy = jnp.dot(s, y)
        curv_ok = good & (sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y) + 1e-30)
        slot = jnp.mod(st.k, m)
        S = jnp.where(curv_ok, st.S.at[slot].set(s), st.S)
        Y = jnp.where(curv_ok, st.Y.at[slot].set(y), st.Y)
        rho = jnp.where(curv_ok, st.rho.at[slot].set(1.0 / jnp.maximum(sy, 1e-30)), st.rho)
        k = st.k + curv_ok.astype(jnp.int32)
        gamma = jnp.where(curv_ok, sy / jnp.maximum(jnp.dot(y, y), 1e-30), st.gamma)
        # a concluded step that did NOT move (line search exhausted, or an
        # armijo pass at a non-improving value) leaves (z, f, g, history)
        # bit-identical — the next iteration recomputes the SAME direction,
        # resets t=1, and replays the SAME failed probes: a deterministic
        # fixed point. Exiting here changes nothing about the result and
        # stops the while_loop burning the remaining budget (a batched
        # program exits once EVERY restart lane is done/at max_iter).
        acc_st = St(
            z=z_new, f=f_new, g=g_new, S=S, Y=Y, rho=rho, k=k, gamma=gamma,
            p=jnp.zeros((d,), dtype), gTp=jnp.zeros((), dtype),
            t=jnp.ones((), dtype), n_probe=jnp.zeros((), jnp.int32),
            n_accept=st.n_accept + 1,
            done=jnp.logical_not(good),
        )
        p_new = direction(acc_st)
        acc_st = acc_st._replace(p=p_new, gTp=jnp.dot(g_new, p_new))

        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(stop_probing, b, a), probe_st, acc_st
        )

    # the state machine's first trip evaluates z0 itself: p = 0 and
    # f = +inf make the trial point z0 and force acceptance
    init = St(
        z=z0, f=jnp.asarray(jnp.inf, dtype), g=jnp.zeros((d,), dtype),
        S=jnp.zeros((m, d), dtype), Y=jnp.zeros((m, d), dtype),
        rho=jnp.zeros((m,), dtype), k=jnp.asarray(0, jnp.int32),
        gamma=jnp.asarray(1.0, dtype),
        p=jnp.zeros((d,), dtype), gTp=jnp.asarray(0.0, dtype),
        t=jnp.ones((), dtype), n_probe=jnp.zeros((), jnp.int32),
        n_accept=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.z, out.f


def minimize_restarts(
    fun: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    max_iter: int = 60,
    memory_size: int = 10,
    tol: float = 1e-8,
    max_linesearch_steps: int = 20,
) -> MinimizeResult:
    """Minimize `fun` from each row of x0 (R, d) inside [lo, hi], all
    restarts in parallel; returns per-restart results and the overall best.

    `fun` maps (d,) -> scalar and must be jit/vmap-compatible.
    """
    lo = jnp.asarray(lo, x0.dtype)
    hi = jnp.asarray(hi, x0.dtype)

    def zfun(z):
        return fun(to_box(z, lo, hi))

    def run_one(z0):
        return _lbfgs_compact(zfun, z0, max_iter, memory_size, max_linesearch_steps)

    z0 = from_box(x0, lo, hi)
    zs, vals = jax.vmap(run_one)(z0)
    xs = to_box(zs, lo, hi)
    vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
    best = jnp.argmin(vals)
    return MinimizeResult(x=xs, fun=vals, x_best=xs[best], fun_best=vals[best])


def maximize_restarts(fun, x0, lo, hi, **kw) -> MinimizeResult:
    """Maximization convenience wrapper (negates fun and the results)."""
    res = minimize_restarts(lambda x: -fun(x), x0, lo, hi, **kw)
    return MinimizeResult(x=res.x, fun=-res.fun, x_best=res.x_best, fun_best=-res.fun_best)
