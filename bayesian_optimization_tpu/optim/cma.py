"""Population-vectorized (1+1)-Cholesky-CMA-ES.

Capability parity with the reference's serial implementation
(ref: bayes_optim/acquisition/optim/one_plus_one_cma_es.py:17-468): 2/11
success-rule step-size control (ccov = 2/(d^2+6), cp = 1/12, cc = 2/(d+2),
damping d_s = 1 + d/2, threshold 0.44), evolution-path covariance learning,
and the rank-one Cholesky update of A and A^-1 without refactorization
(:451-468). Box handling by reflection, exception reset of degenerate state
(:410-418).

Accelerator design: the reference advances ONE chain and evaluates ONE
candidate per objective call — the main wall-clock sink of its acquisition
argmax (SURVEY section 3.2). Here P independent chains advance together under
`vmap`, so each generation evaluates a (P, d) candidate batch in a single
fused XLA call (one batched GP predict as a matmul), and `lax.scan` runs the
generations inside one compiled program. The best-of-chains argmax at the
end replaces the reference's best-of-restarts loop.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.expr import evaluate_size
from ..utils.penalty import reflect_into_box


class CMAState(NamedTuple):
    x: jnp.ndarray            # (P, d) current parents
    f: jnp.ndarray            # (P,) parent objective values (minimized)
    sigma: jnp.ndarray        # (P,)
    A: jnp.ndarray            # (P, d, d) cholesky factor of C
    A_inv: jnp.ndarray        # (P, d, d)
    pc: jnp.ndarray           # (P, d) evolution path
    success_rate: jnp.ndarray # (P,)
    key: jax.Array


def _constants(dim: int) -> dict:
    return dict(
        prob_target=2.0 / 11.0,
        threshold=0.44,
        d_damp=1.0 + dim / 2.0,
        ccov=2.0 / (dim**2 + 6.0),
        cp=1.0 / 12.0,
        cc=2.0 / (dim + 2.0),
    )


def init_chains(key: jax.Array, x0: jnp.ndarray, f0: jnp.ndarray, sigma0: float) -> CMAState:
    P, d = x0.shape
    eye = jnp.broadcast_to(jnp.eye(d, dtype=x0.dtype), (P, d, d))
    return CMAState(
        x=x0,
        f=f0,
        sigma=jnp.full((P,), sigma0, x0.dtype),
        A=eye,
        A_inv=eye,
        pc=jnp.zeros((P, d), x0.dtype),
        success_rate=jnp.full((P,), 2.0 / 11.0, x0.dtype),
        key=key,
    )


def cma_step(state: CMAState, fun: Callable, lo, hi, consts: dict) -> Tuple[CMAState, jnp.ndarray]:
    """One (1+1) generation for every chain; `fun` maps (P, d) -> (P,)
    objective values to MINIMIZE."""
    state, x_new = _host_propose(state, lo, hi)
    f_new = fun(x_new)
    new_state = _host_generation(state, x_new, f_new, consts, lo, hi)
    return new_state, new_state.f


def run_cma(
    key: jax.Array,
    fun: Callable,
    x0: jnp.ndarray,
    lo,
    hi,
    n_generations: int,
    sigma0: float = 0.25,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Minimize `fun` ((P, d) -> (P,)) with P parallel (1+1)-Cholesky chains;
    returns (x_best[d], f_best) over all chains after `n_generations`."""
    dim = x0.shape[-1]
    consts = _constants(dim)
    f0 = fun(x0)
    f0 = jnp.where(jnp.isfinite(f0), f0, jnp.inf)
    state = init_chains(key, x0, f0, sigma0)

    def body(st, _):
        return cma_step(st, fun, lo, hi, consts)

    state, _ = jax.lax.scan(body, state, None, length=n_generations)
    best = jnp.argmin(state.f)
    return state.x[best], state.f[best], state.x, state.f


# ---------------------------------------------------------------------------
# Reference-compatible host-facing optimizer class
# ---------------------------------------------------------------------------
class OnePlusOne_Cholesky_CMA:
    """Drop-in style wrapper matching the reference optimizer surface
    (search_space, obj_fun, h/g, max_FEs, ftarget, minimize, ...) for
    black-box host objectives; the chain arithmetic is the vectorized JAX
    kernel above; the objective is called once per generation on the whole
    chain batch."""

    def __init__(
        self,
        search_space=None,
        obj_fun: Callable = None,
        h: Callable = None,
        g: Callable = None,
        x0=None,
        sigma0: Optional[float] = None,
        ftarget: Optional[float] = None,
        max_FEs: float = np.inf,
        minimize: bool = True,
        xtol: float = 1e-4,
        ftol: float = 1e-4,
        n_chains: int = 16,
        verbose: bool = False,
        random_seed: int = 42,
        **kwargs,
    ):
        bounds = np.asarray(search_space.bounds, dtype=float)
        self.search_space = search_space
        self.dim = search_space.dim
        self.lb, self.ub = bounds[:, 0], bounds[:, 1]
        self.obj_fun = obj_fun
        self.h, self.g = h, g
        self.minimize = minimize
        self.ftarget = ftarget
        self.max_FEs = float(
            np.inf if max_FEs is None else evaluate_size(max_FEs, self.dim)
        )
        self.xtol, self.ftol = xtol, ftol
        self.n_chains = int(n_chains)
        self.sigma0 = sigma0 if sigma0 is not None else 0.25 * float(np.max(self.ub - self.lb))
        self.verbose = verbose
        self.random_seed = random_seed
        self._rng = np.random.default_rng(random_seed)
        self.x0 = None if x0 is None else np.asarray(x0, dtype=float)
        self.eval_count = 0
        self.iter_count = 0
        self.xopt = None
        self.fopt = np.inf

    def _eval_batch(self, X: np.ndarray):
        """Host objective + raw constraint violation over a batch. Penalty
        weighting happens per-generation with the *current* t on both parents
        and offspring (the reference compares stale parent penalties,
        one_plus_one_cma_es.py:304-330 — corrected here)."""
        from ..utils.penalty import eval_constraints_host

        vals = np.empty(len(X))
        viol = np.zeros(len(X))
        for i, x in enumerate(X):
            y = float(self.obj_fun(x))
            if not self.minimize:
                y = -y
            if self.h is not None or self.g is not None:
                hv, gv = eval_constraints_host(x, self.h, self.g)
                pen = 0.0
                if hv is not None:
                    pen += np.sum(np.abs(hv)[np.abs(hv) > 0.01])
                if gv is not None:
                    pen += np.sum(np.maximum(gv, 0.0) ** 2)
                viol[i] = pen
            vals[i] = y
        self.eval_count += len(X)
        return vals, viol

    def run(self):
        # The host objective forces a device sync every generation, so the
        # tiny (P, d, d) chain state lives on the host CPU backend: an
        # accelerator would add a transfer per generation for no compute
        # win. (The BO-internal argmax path fuses the acquisition INTO the
        # device program instead — optim/argmax.py — and never takes this
        # loop.)
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                return self._run_loop()
        return self._run_loop()

    def _run_loop(self):
        P, d = self.n_chains, self.dim
        lo = jnp.asarray(self.lb, jnp.float32)
        hi = jnp.asarray(self.ub, jnp.float32)
        consts = _constants(d)
        x0 = self._rng.uniform(self.lb, self.ub, (P, d))
        if self.x0 is not None:
            x0[0] = self.x0
        obj_p, viol_p = self._eval_batch(x0)
        state = init_chains(
            jax.random.PRNGKey(self.random_seed), jnp.asarray(x0, jnp.float32),
            jnp.asarray(obj_p + 0.5 * viol_p, jnp.float32), self.sigma0,
        )
        step = jax.jit(lambda st, x_new, f_new: _host_generation(st, x_new, f_new, consts, lo, hi))
        propose = jax.jit(lambda st: _host_propose(st, lo, hi))

        max_gens = int(max(1, self.max_FEs // P))
        f_hist = []
        n_restart = 0
        best_x, best_f, best_viol = None, np.inf, np.inf
        for gen in range(max_gens):
            self.iter_count = gen
            st_mid, x_new = propose(state)
            obj_n, viol_n = self._eval_batch(np.asarray(x_new, dtype=float))
            # dynamic penalty with the CURRENT weight on both sides
            w = 0.5 * (gen + 1)
            f_parent = jnp.asarray(obj_p + w * viol_p, jnp.float32)
            f_new = jnp.asarray(obj_n + w * viol_n, jnp.float32)
            accepted = np.asarray(f_new <= np.asarray(f_parent))
            state = step(st_mid._replace(f=f_parent), x_new, f_new)
            obj_p = np.where(accepted, obj_n, obj_p)
            viol_p = np.where(accepted, viol_n, viol_p)
            # running champion across restarts: feasible-first ranking
            feas_rank = np.where(viol_p > 1e-9, viol_p * 1e6, 0.0) + obj_p
            i = int(np.argmin(feas_rank))
            best_rank = (best_viol * 1e6 if best_viol > 1e-9 else 0.0) + best_f
            if feas_rank[i] < best_rank:
                best_x = np.asarray(state.x[i], dtype=float)
                best_f, best_viol = float(obj_p[i]), float(viol_p[i])
            fbest = float(jnp.min(state.f))
            f_hist.append(fbest)
            if self.ftarget is not None and best_f <= (self.ftarget if self.minimize else -self.ftarget):
                break
            if self.eval_count >= self.max_FEs:
                break
            # per-chain restart on step-size collapse: a chain whose sigma
            # shrank below xtol (relative to the box) has converged — its
            # best is already in the champion above, so reseed it uniformly
            # (the reference's restart-on-stop, one_plus_one_cma_es.py:354-377,
            # vectorized per chain instead of serially for the whole run)
            sig = np.asarray(state.sigma)
            sig_restart = self.xtol * float(np.min(self.ub - self.lb))
            if self.ftarget is not None and self.ftarget > 0:
                # keep reseeding below the step size a chain needs to reach
                # ftarget, or it would be killed on final approach
                sig_restart = min(sig_restart, 1e-2 * np.sqrt(self.ftarget))
            done = sig < sig_restart
            if np.any(done):
                n_restart += int(done.sum())
                x0 = np.asarray(state.x, dtype=float)
                x0[done] = self._rng.uniform(self.lb, self.ub, (int(done.sum()), d))
                obj_r, viol_r = self._eval_batch(x0[done])
                obj_p[done], viol_p[done] = obj_r, viol_r
                m = jnp.asarray(done)
                eye = jnp.broadcast_to(jnp.eye(d, dtype=state.x.dtype), (P, d, d))
                state = state._replace(
                    x=jnp.where(m[:, None], jnp.asarray(x0, jnp.float32), state.x),
                    f=jnp.where(m, jnp.asarray(obj_p + 0.5 * viol_p, jnp.float32), state.f),
                    sigma=jnp.where(m, self.sigma0, state.sigma),
                    A=jnp.where(m[:, None, None], eye, state.A),
                    A_inv=jnp.where(m[:, None, None], eye, state.A_inv),
                    pc=jnp.where(m[:, None], 0.0, state.pc),
                    success_rate=jnp.where(m, 2.0 / 11.0, state.success_rate),
                )
        self.xopt = best_x
        self.fopt = best_f * (1.0 if self.minimize else -1.0)
        self.stop_dict = {"FEs": self.eval_count, "n_restart": n_restart}
        return self.xopt, self.fopt, self.stop_dict


def _host_propose(state: CMAState, lo, hi):
    """First half of a generation for host-evaluated objectives: sample the
    offspring batch; the accept/update half is `_host_generation`."""
    P, d = state.x.shape
    key, sub = jax.random.split(state.key)
    z = jax.random.normal(sub, (P, d), state.x.dtype)
    step = jnp.einsum("pij,pj->pi", state.A, z)
    x_new = reflect_into_box(state.x + state.sigma[:, None] * step, lo, hi)
    return state._replace(key=key), x_new


def _host_generation(state: CMAState, x_new, f_new, consts, lo, hi):
    """Accept/update for host-evaluated generation (x_new, f_new given)."""
    P, d = state.x.shape
    success = (f_new <= state.f).astype(state.x.dtype)
    pt = consts["prob_target"]
    sr = (1.0 - consts["cp"]) * state.success_rate + consts["cp"] * success
    sigma = state.sigma * jnp.exp((sr - pt) / (1.0 - pt) / consts["d_damp"])
    cc, ccov = consts["cc"], consts["ccov"]
    coeff = cc * (2.0 - cc)
    below = sr < consts["threshold"]
    y = (x_new - state.x) / jnp.maximum(state.sigma[:, None], 1e-20)
    pc_hit = (1.0 - cc) * state.pc + jnp.sqrt(coeff) * y
    pc_miss = (1.0 - cc) * state.pc
    pc_new = jnp.where(below[:, None], pc_hit, pc_miss)
    ca = jnp.where(below, 1.0 - ccov, 1.0 - ccov + ccov * coeff)
    w = jnp.einsum("pij,pj->pi", state.A_inv, pc_new)
    w_ = jnp.einsum("pji,pj->pi", state.A_inv, w)
    L = jnp.maximum(jnp.sum(w * w, axis=-1), 1e-20)
    root = jnp.sqrt(1.0 + L * ccov / ca)
    A_upd = (state.A + ((root - 1.0) / L)[:, None, None] * jnp.einsum("pi,pj->pij", pc_new, w)) * jnp.sqrt(ca)[:, None, None]
    Ainv_upd = (state.A_inv - ((1.0 - 1.0 / root) / L)[:, None, None] * jnp.einsum("pi,pj->pij", w, w_)) / jnp.sqrt(ca)[:, None, None]
    succ = success[:, None, None] > 0
    A = jnp.where(succ, A_upd, state.A)
    A_inv = jnp.where(succ, Ainv_upd, state.A_inv)
    pc = jnp.where(success[:, None] > 0, pc_new, pc_miss)
    bad = (sigma < 1e-8) | (sigma > 1e8) | ~jnp.isfinite(jnp.sum(A.reshape(P, -1), axis=-1))
    eye = jnp.broadcast_to(jnp.eye(d, dtype=state.x.dtype), (P, d, d))
    A = jnp.where(bad[:, None, None], eye, A)
    A_inv = jnp.where(bad[:, None, None], eye, A_inv)
    pc = jnp.where(bad[:, None], 0.0, pc)
    sigma = jnp.where(bad, 0.25, sigma)
    x = jnp.where(success[:, None] > 0, x_new, state.x)
    f = jnp.minimum(jnp.where(jnp.isfinite(f_new), f_new, jnp.inf), state.f)
    return CMAState(x=x, f=f, sigma=sigma, A=A, A_inv=A_inv, pc=pc, success_rate=sr, key=state.key)
