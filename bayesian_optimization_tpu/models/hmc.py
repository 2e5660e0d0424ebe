"""Vectorized adaptive HMC over GP hyperparameters.

This is the project's north star: replace point-estimate MLE restarts
with a *posterior* over GP hyperparameters, fit by gradient-based MCMC whose
chains advance as one batched XLA program (every leapfrog step = one batched
Cholesky across all chains), sharded over the `particles` mesh
axis on multi-chip systems.

Algorithm: Hamiltonian Monte Carlo with
- dual-averaging step-size adaptation to a target acceptance rate
  (Hoffman & Gelman 2014, the NUTS paper's Algorithm 5 adaptation),
- diagonal mass-matrix estimation from warmup sample variances,
- jittered trajectory lengths (randomized L) to avoid periodicity,
- unconstrained parameterization: box-bounded log10 hyperparameters are
  mapped through a sigmoid with the log-Jacobian added to the target.

The reference has no counterpart (its fit is scipy L-BFGS restarts,
ref: gpr.py:1127-1162); the variational alternative lives in
`fit_vi` below (mean-field Gaussian ADVI with reparameterized gradients).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class HMCResult(NamedTuple):
    samples: jnp.ndarray       # (n_samples, n_chains, d) in box coordinates
    accept_rate: jnp.ndarray   # (n_chains,)
    step_size: jnp.ndarray     # (n_chains,)
    log_prob: jnp.ndarray      # (n_samples, n_chains)
    inv_mass: jnp.ndarray      # (n_chains, d) adapted diagonal inverse mass


def effective_sample_size(samples) -> "np.ndarray":
    """Per-dimension multi-chain ESS (Geyer initial-positive-sequence
    estimator over the chain-mean autocorrelation), host-side numpy.

    samples: (S, C, d) array of draws. Returns (d,) ESS estimates. The
    reference has no sampler so no counterpart exists; this is the standard
    diagnostic the round-5 verdict asked `bench.py --nuts` to report."""
    import numpy as np

    x = np.asarray(samples, dtype=float)
    S, C, d = x.shape
    if S < 4:
        return np.full(d, float(S * C))
    x = x - x.mean(axis=0, keepdims=True)  # demean per chain
    ess = np.empty(d)
    nfft = int(2 ** np.ceil(np.log2(2 * S)))
    for j in range(d):
        f = np.fft.rfft(x[:, :, j], n=nfft, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:S].real
        acov /= np.arange(S, 0, -1)[:, None]
        var0 = acov[0].mean()
        if var0 <= 0:
            ess[j] = float(S * C)
            continue
        rho = acov.mean(axis=1) / var0  # chain-averaged autocorrelation
        # Geyer: sum consecutive pairs while they stay positive
        tau = 1.0
        for t in range(1, S - 1, 2):
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            tau += 2.0 * pair
        ess[j] = S * C / max(tau, 1.0)
    return ess


def _to_box(z, lo, hi):
    return lo + (hi - lo) * jax.nn.sigmoid(z)


def _log_jac(z, lo, hi):
    """log |d box / d z| for the sigmoid reparameterization."""
    return jnp.sum(jnp.log(hi - lo) + jax.nn.log_sigmoid(z) + jax.nn.log_sigmoid(-z), axis=-1)


def _leapfrog(z, p, eps, n_steps, grad_fn, inv_mass):
    def body(_, carry):
        z, p = carry
        p = p + 0.5 * eps[..., None] * grad_fn(z)
        z = z + eps[..., None] * inv_mass * p
        p = p + 0.5 * eps[..., None] * grad_fn(z)
        return (z, p)

    return jax.lax.fori_loop(0, n_steps, body, (z, p))


def hmc_sample(
    key: jax.Array,
    log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    n_warmup: int = 200,
    n_samples: int = 64,
    n_leapfrog: int = 16,
    target_accept: float = 0.8,
    thin: int = 1,
    warmup_log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray] = None,
    init_inv_mass: jnp.ndarray = None,
    init_step_size: jnp.ndarray = None,
    n_warmup2: int = None,
) -> HMCResult:
    """Sample box-constrained parameters with C parallel chains.

    log_prob_fn maps a single (d,) box-coordinate vector to a scalar log
    density; it is vmapped internally. x0: (C, d) initial chain states.
    warmup_log_prob_fn / init_inv_mass / init_step_size / n_warmup2 are the
    same cost levers as in `nuts_sample` (subset-target phase-1 warmup and
    carried adaptation state); without them the behavior is unchanged.
    """
    C, d = x0.shape
    dtype = x0.dtype
    lo = jnp.asarray(lo, dtype)
    hi = jnp.asarray(hi, dtype)

    def logp_z(z):  # single-chain target in unconstrained coords
        x = _to_box(z, lo, hi)
        return log_prob_fn(x) + _log_jac(z, lo, hi)

    logp_batch = jax.vmap(logp_z)
    grad_batch = jax.vmap(jax.grad(logp_z))

    if warmup_log_prob_fn is not None:
        def logp_z_warm(z):
            x = _to_box(z, lo, hi)
            return warmup_log_prob_fn(x) + _log_jac(z, lo, hi)

        logp_batch_warm = jax.vmap(logp_z_warm)
        grad_batch_warm = jax.vmap(jax.grad(logp_z_warm))
    else:
        logp_batch_warm, grad_batch_warm = logp_batch, grad_batch

    frac = jnp.clip((x0 - lo) / jnp.maximum(hi - lo, 1e-30), 1e-4, 1 - 1e-4)
    z0 = jnp.log(frac) - jnp.log1p(-frac)

    # dual-averaging state (per chain): Hoffman-Gelman constants
    eps0 = jnp.full((C,), 0.05, dtype) if init_step_size is None else jnp.broadcast_to(
        jnp.asarray(init_step_size, dtype), (C,)
    )
    mu_da = jnp.log(10.0 * eps0)
    gamma, t0, kappa = 0.05, 10.0, 0.75

    class Carry(NamedTuple):
        z: jnp.ndarray
        logp: jnp.ndarray
        key: jax.Array
        log_eps: jnp.ndarray
        log_eps_bar: jnp.ndarray
        h_bar: jnp.ndarray
        m1: jnp.ndarray  # running mean of z (for mass)
        m2: jnp.ndarray  # running sum of squared deviations
        count: jnp.ndarray
        inv_mass: jnp.ndarray
        n_accept: jnp.ndarray

    def one_transition(c: Carry, it, adapt: bool, warm_target: bool = False):
        lp_b, g_b = (logp_batch_warm, grad_batch_warm) if warm_target else (logp_batch, grad_batch)
        k1, k2, k3, key = jax.random.split(c.key, 4)
        eps = jnp.exp(c.log_eps)
        p0 = jax.random.normal(k1, (C, d), dtype) / jnp.sqrt(c.inv_mass)
        # jitter trajectory length in [ceil(L/2), L]
        L = jax.random.randint(k2, (), n_leapfrog // 2 + 1, n_leapfrog + 1)
        z_new, p_new = _leapfrog(c.z, p0, eps, L, g_b, c.inv_mass)
        logp_new = lp_b(z_new)
        ke0 = 0.5 * jnp.sum(c.inv_mass * p0 * p0, axis=-1)
        ke1 = 0.5 * jnp.sum(c.inv_mass * p_new * p_new, axis=-1)
        log_alpha = jnp.minimum(0.0, (logp_new - ke1) - (c.logp - ke0))
        log_alpha = jnp.where(jnp.isfinite(log_alpha), log_alpha, -jnp.inf)
        accept = jnp.log(jax.random.uniform(k3, (C,), dtype)) < log_alpha
        z = jnp.where(accept[:, None], z_new, c.z)
        logp = jnp.where(accept, logp_new, c.logp)

        if adapt:
            # dual averaging on E[alpha] (per chain)
            alpha = jnp.exp(log_alpha)
            t = it + 1.0 + t0
            h_bar = (1.0 - 1.0 / t) * c.h_bar + (target_accept - alpha) / t
            log_eps = mu_da - jnp.sqrt(it + 1.0) / gamma * h_bar
            w = (it + 1.0) ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * c.log_eps_bar
            # Welford running variance for the diagonal mass
            count = c.count + 1.0
            delta = z - c.m1
            m1 = c.m1 + delta / count[:, None]
            m2 = c.m2 + delta * (z - m1)
            inv_mass = c.inv_mass
        else:
            h_bar, log_eps, log_eps_bar = c.h_bar, c.log_eps, c.log_eps_bar
            m1, m2, count, inv_mass = c.m1, c.m2, c.count, c.inv_mass
        return Carry(
            z=z, logp=logp, key=key, log_eps=log_eps, log_eps_bar=log_eps_bar,
            h_bar=h_bar, m1=m1, m2=m2, count=count, inv_mass=inv_mass,
            n_accept=c.n_accept + accept.astype(dtype),
        )

    fast_path = warmup_log_prob_fn is None and init_inv_mass is None and n_warmup2 is None
    if init_inv_mass is not None:
        inv_mass = jnp.broadcast_to(jnp.asarray(init_inv_mass, dtype), (C, d))
        warm = Carry(
            z=z0, logp=logp_batch(z0), key=key,
            log_eps=jnp.log(eps0), log_eps_bar=jnp.log(eps0),
            h_bar=jnp.zeros((C,), dtype),
            m1=jnp.zeros((C, d), dtype), m2=jnp.ones((C, d), dtype),
            count=jnp.zeros((C,), dtype), inv_mass=inv_mass,
            n_accept=jnp.zeros((C,), dtype),
        )
    else:
        init = Carry(
            z=z0, logp=logp_batch_warm(z0), key=key,
            log_eps=jnp.log(eps0), log_eps_bar=jnp.log(eps0),
            h_bar=jnp.zeros((C,), dtype),
            m1=jnp.zeros((C, d), dtype), m2=jnp.ones((C, d), dtype),
            count=jnp.zeros((C,), dtype), inv_mass=jnp.ones((C, d), dtype),
            n_accept=jnp.zeros((C,), dtype),
        )
        warm = jax.lax.fori_loop(
            0, n_warmup,
            lambda i, c: one_transition(c, jnp.asarray(i, dtype), True, True), init,
        )
        # freeze adapted quantities
        var = warm.m2 / jnp.maximum(warm.count[:, None] - 1.0, 1.0)
        inv_mass = jnp.clip(var, 1e-4, 1e4)
        warm = warm._replace(inv_mass=inv_mass)
    if fast_path:
        sampling_init = warm._replace(
            log_eps=warm.log_eps_bar, n_accept=jnp.zeros((C,), dtype)
        )
    else:
        # re-score on the true target and re-adapt eps under the frozen mass
        warm2_init = warm._replace(
            logp=logp_batch(warm.z), h_bar=jnp.zeros((C,), dtype),
            log_eps=warm.log_eps_bar, log_eps_bar=warm.log_eps_bar,
        )
        warm2 = jax.lax.fori_loop(
            0, n_warmup2 if n_warmup2 is not None else max(1, n_warmup // 2),
            lambda i, c: one_transition(c, jnp.asarray(i, dtype), True), warm2_init,
        )
        sampling_init = warm2._replace(
            log_eps=warm2.log_eps_bar, n_accept=jnp.zeros((C,), dtype)
        )

    def sample_step(c, _):
        c = one_transition(c, jnp.asarray(0.0, dtype), False)
        return c, (c.z, c.logp)

    final, (zs, logps) = jax.lax.scan(sample_step, sampling_init, None, length=n_samples * thin)
    zs = zs[::thin]
    logps = logps[::thin]
    xs = _to_box(zs, lo, hi)
    return HMCResult(
        samples=xs,
        accept_rate=final.n_accept / (n_samples * thin),
        step_size=jnp.exp(final.log_eps),
        log_prob=logps,
        inv_mass=final.inv_mass,
    )


def fit_vi(
    key: jax.Array,
    log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray],
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    n_steps: int = 400,
    n_mc: int = 8,
    lr: float = 0.05,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean-field Gaussian ADVI in the unconstrained space; returns
    (mean, log_std) of the variational posterior over z (map through
    sigmoid for box coordinates)."""
    import optax

    d = lo.shape[0]
    dtype = lo.dtype

    def logp_z(z):
        x = _to_box(z, lo, hi)
        return log_prob_fn(x) + _log_jac(z, lo, hi)

    def neg_elbo(params, k):
        mean, log_std = params
        eps = jax.random.normal(k, (n_mc, d), dtype)
        z = mean[None, :] + jnp.exp(log_std)[None, :] * eps
        logq = jnp.sum(
            -0.5 * eps**2 - log_std[None, :] - 0.5 * jnp.log(2 * jnp.pi), axis=-1
        )
        return jnp.mean(logq - jax.vmap(logp_z)(z))

    params = (jnp.zeros(d, dtype), jnp.full((d,), -1.0, dtype))
    opt = optax.adam(lr)
    state = opt.init(params)

    def step(carry, k):
        params, state = carry
        loss, g = jax.value_and_grad(neg_elbo)(params, k)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        return (params, state), loss

    (params, _), losses = jax.lax.scan(step, (params, state), jax.random.split(key, n_steps))
    return params[0], params[1]


# ---------------------------------------------------------------------------
# NUTS: dynamic (U-turn-terminated) trajectories, iterative formulation.
#
# The recursive tree of Hoffman & Gelman 2014 is hostile to XLA; this is the
# memory-efficient ITERATIVE equivalent (Phan et al. 2019, as popularized by
# numpyro/TFP): leaves of the current subtree are generated by a streaming
# leapfrog loop, an O(max_depth) stack holds the first state of every open
# power-of-two block, and the exact per-subtree U-turn checks are performed
# between stored block heads and the current leaf. Proposal selection is
# progressive multinomial within a subtree and biased-progressive across
# doublings (Betancourt 2017). Everything is fixed-shape: one transition is
# bounded by 2^max_depth leapfrog steps, chains advance together under vmap
# (each doubling is a batched Cholesky through the GP likelihood).
# ---------------------------------------------------------------------------


class NUTSResult(NamedTuple):
    samples: jnp.ndarray      # (n_samples, n_chains, d) box coordinates
    accept_rate: jnp.ndarray  # (n_chains,) mean Metropolis alpha proxy
    step_size: jnp.ndarray    # (n_chains,)
    log_prob: jnp.ndarray     # (n_samples, n_chains)
    mean_depth: jnp.ndarray   # (n_chains,) average tree depth
    inv_mass: jnp.ndarray     # (n_chains, d) adapted diagonal inverse mass
                              # (carry into the next BO refit's sampler)


def _uturn(dz, p_a, p_b, inv_mass):
    """U-turn criterion between trajectory ends (velocities = M^-1 p)."""
    return (jnp.dot(dz, inv_mass * p_a) < 0.0) | (jnp.dot(dz, inv_mass * p_b) < 0.0)


def _nuts_transition(key, z0, logp0, log_eps, inv_mass, logp_z, grad_z, max_depth):
    """One NUTS transition for a SINGLE chain (vmap over chains outside).

    Returns (z_new, logp_new, alpha_mean, depth_used).
    """
    d = z0.shape[0]
    dtype = z0.dtype
    eps = jnp.exp(log_eps)
    k_mom, k_loop = jax.random.split(key)
    p0 = jax.random.normal(k_mom, (d,), dtype) / jnp.sqrt(inv_mass)
    ke0 = 0.5 * jnp.sum(inv_mass * p0 * p0)
    H0 = -logp0 + ke0  # joint energy of the initial leaf

    def leapfrog1(z, p, e):
        p = p + 0.5 * e * grad_z(z)
        z = z + e * inv_mass * p
        p = p + 0.5 * e * grad_z(z)
        return z, p

    class Tree(NamedTuple):
        key: jax.Array
        depth: jnp.ndarray
        z_minus: jnp.ndarray
        p_minus: jnp.ndarray
        z_plus: jnp.ndarray
        p_plus: jnp.ndarray
        z_prop: jnp.ndarray       # current multinomial proposal
        logp_prop: jnp.ndarray
        log_sum_w: jnp.ndarray    # total multinomial weight of the trajectory
        turning: jnp.ndarray
        diverged: jnp.ndarray
        sum_alpha: jnp.ndarray
        n_alpha: jnp.ndarray

    def build_subtree(key, z_start, p_start, signed_eps, n_leaves):
        """Stream n_leaves leapfrog steps; exact block U-turn checks via the
        power-of-two stack. Returns end state, subtree proposal and stats."""
        stack_z = jnp.zeros((max_depth + 1, d), dtype)
        stack_p = jnp.zeros((max_depth + 1, d), dtype)
        levels = jnp.arange(max_depth + 1)

        class Sub(NamedTuple):
            key: jax.Array
            z: jnp.ndarray
            p: jnp.ndarray
            stack_z: jnp.ndarray
            stack_p: jnp.ndarray
            cand: jnp.ndarray
            logp_cand: jnp.ndarray
            log_w: jnp.ndarray
            turning: jnp.ndarray
            diverged: jnp.ndarray
            sum_alpha: jnp.ndarray
            n_alpha: jnp.ndarray

        def leaf(i, s: Sub):
            done = s.turning | s.diverged
            k_sel, key = jax.random.split(s.key)
            z, p = leapfrog1(s.z, s.p, signed_eps)
            lp = logp_z(z)
            H = -lp + 0.5 * jnp.sum(inv_mass * p * p)
            dH = H - H0
            diverged = s.diverged | ~jnp.isfinite(dH) | (dH > 1000.0)
            logw = jnp.where(jnp.isfinite(dH), -dH, -jnp.inf)
            # streaming progressive multinomial within the subtree
            log_w_new = jnp.logaddexp(s.log_w, logw)
            take = jnp.log(jax.random.uniform(k_sel, (), dtype)) < (logw - log_w_new)
            cand = jnp.where(take & ~done, z, s.cand)
            logp_cand = jnp.where(take & ~done, lp, s.logp_cand)
            log_w = jnp.where(done, s.log_w, log_w_new)
            alpha = jnp.minimum(1.0, jnp.exp(-dH))
            alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
            sum_alpha = s.sum_alpha + jnp.where(done, 0.0, alpha)
            n_alpha = s.n_alpha + jnp.where(done, 0.0, 1.0)

            # store the leaf as the head of every block that OPENS at i
            # (i % 2^l == 0); check the U-turn of every block that CLOSES
            # at i ((i+1) % 2^l == 0), between the stored head and the leaf
            pow2 = jnp.left_shift(jnp.ones((), jnp.int32), levels.astype(jnp.int32))
            opens = (jnp.mod(i, pow2) == 0)
            closes = (jnp.mod(i + 1, pow2) == 0) & (levels > 0)
            stack_z = jnp.where(opens[:, None], z[None, :], s.stack_z)
            stack_p = jnp.where(opens[:, None], p[None, :], s.stack_p)
            dz = z[None, :] - stack_z  # (L+1, d)
            t_low = jnp.sum(dz * (inv_mass[None, :] * stack_p), axis=-1) < 0.0
            t_cur = jnp.sum(dz * (inv_mass[None, :] * p[None, :]), axis=-1) < 0.0
            turning_blocks = jnp.any(closes & (t_low | t_cur))
            turning = s.turning | (~done & turning_blocks)
            return Sub(
                key=key,
                z=jnp.where(done, s.z, z), p=jnp.where(done, s.p, p),
                stack_z=jnp.where(done, s.stack_z, stack_z),
                stack_p=jnp.where(done, s.stack_p, stack_p),
                cand=cand, logp_cand=logp_cand, log_w=log_w,
                turning=turning, diverged=diverged,
                sum_alpha=sum_alpha, n_alpha=n_alpha,
            )

        init = Sub(
            key=key, z=z_start, p=p_start, stack_z=stack_z, stack_p=stack_p,
            cand=z_start, logp_cand=jnp.asarray(-jnp.inf, dtype),
            log_w=jnp.asarray(-jnp.inf, dtype),
            turning=jnp.asarray(False), diverged=jnp.asarray(False),
            sum_alpha=jnp.asarray(0.0, dtype), n_alpha=jnp.asarray(0.0, dtype),
        )
        return jax.lax.fori_loop(0, n_leaves, leaf, init)

    def doubling_cond(t: Tree):
        return (t.depth < max_depth) & ~t.turning & ~t.diverged

    def doubling(t: Tree):
        k_dir, k_sub, k_acc, key = jax.random.split(t.key, 4)
        go_right = jax.random.bernoulli(k_dir)
        n_leaves = jnp.left_shift(jnp.ones((), jnp.int32), t.depth.astype(jnp.int32))
        z_start = jnp.where(go_right, t.z_plus, t.z_minus)
        p_start = jnp.where(go_right, t.p_plus, t.p_minus)
        signed = jnp.where(go_right, eps, -eps)
        sub = build_subtree(k_sub, z_start, p_start, signed, n_leaves)

        ok = ~sub.turning & ~sub.diverged
        # biased progressive sampling toward the NEW subtree
        acc = jnp.minimum(0.0, sub.log_w - t.log_sum_w)
        take = ok & (jnp.log(jax.random.uniform(k_acc, (), dtype)) < acc)
        z_prop = jnp.where(take, sub.cand, t.z_prop)
        logp_prop = jnp.where(take, sub.logp_cand, t.logp_prop)
        log_sum_w = jnp.where(ok, jnp.logaddexp(t.log_sum_w, sub.log_w), t.log_sum_w)

        z_minus = jnp.where(go_right, t.z_minus, sub.z)
        p_minus = jnp.where(go_right, t.p_minus, sub.p)
        z_plus = jnp.where(go_right, sub.z, t.z_plus)
        p_plus = jnp.where(go_right, sub.p, t.p_plus)
        whole_turn = _uturn(z_plus - z_minus, p_minus, p_plus, inv_mass)
        return Tree(
            key=key, depth=t.depth + 1,
            z_minus=z_minus, p_minus=p_minus, z_plus=z_plus, p_plus=p_plus,
            z_prop=z_prop, logp_prop=logp_prop, log_sum_w=log_sum_w,
            turning=sub.turning | whole_turn, diverged=sub.diverged,
            sum_alpha=t.sum_alpha + sub.sum_alpha, n_alpha=t.n_alpha + sub.n_alpha,
        )

    init = Tree(
        key=k_loop, depth=jnp.asarray(0, jnp.int32),
        z_minus=z0, p_minus=p0, z_plus=z0, p_plus=p0,
        z_prop=z0, logp_prop=logp0, log_sum_w=jnp.asarray(0.0, dtype),
        turning=jnp.asarray(False), diverged=jnp.asarray(False),
        sum_alpha=jnp.asarray(0.0, dtype), n_alpha=jnp.asarray(0.0, dtype),
    )
    out = jax.lax.while_loop(doubling_cond, doubling, init)
    alpha_mean = out.sum_alpha / jnp.maximum(out.n_alpha, 1.0)
    return out.z_prop, out.logp_prop, alpha_mean, out.depth.astype(dtype)


def nuts_sample(
    key: jax.Array,
    log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    n_warmup: int = 200,
    n_samples: int = 64,
    max_depth: int = 6,
    target_accept: float = 0.8,
    thin: int = 1,
    warmup_log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray] = None,
    init_inv_mass: jnp.ndarray = None,
    init_step_size: jnp.ndarray = None,
    n_warmup2: int = None,
) -> NUTSResult:
    """No-U-Turn sampling of box-constrained parameters with C vmapped
    chains; same reparameterization / dual-averaging / diagonal-mass warmup
    as `hmc_sample`, but trajectory lengths are dynamic (U-turn-terminated,
    capped at 2^max_depth leapfrogs per transition).

    Cost levers (round-5: make the posterior path affordable):
    - warmup_log_prob_fn: a CHEAP surrogate target (e.g. the GP likelihood
      on a data subset — an n/4 subset makes each warmup Cholesky ~64x
      cheaper) used for phase-1 adaptation only; phase 2 re-adapts the step
      size on the true target under the frozen mass.
    - init_inv_mass / init_step_size: carry the adapted state from the
      previous BO refit; phase 1 is skipped entirely and phase 2 just
      re-tunes the step size (n_warmup2 transitions, default n_warmup//2).
    """
    C, d = x0.shape
    dtype = x0.dtype
    lo = jnp.asarray(lo, dtype)
    hi = jnp.asarray(hi, dtype)

    def logp_z(z):
        x = _to_box(z, lo, hi)
        return log_prob_fn(x) + _log_jac(z, lo, hi)

    grad_z = jax.grad(logp_z)
    logp_batch = jax.vmap(logp_z)

    if warmup_log_prob_fn is not None:
        def logp_z_warm(z):
            x = _to_box(z, lo, hi)
            return warmup_log_prob_fn(x) + _log_jac(z, lo, hi)
    else:
        logp_z_warm = logp_z
    grad_z_warm = jax.grad(logp_z_warm)
    logp_batch_warm = jax.vmap(logp_z_warm)

    frac = jnp.clip((x0 - lo) / jnp.maximum(hi - lo, 1e-30), 1e-4, 1 - 1e-4)
    z0 = jnp.log(frac) - jnp.log1p(-frac)

    eps0 = jnp.full((C,), 0.05, dtype) if init_step_size is None else jnp.broadcast_to(
        jnp.asarray(init_step_size, dtype), (C,)
    )
    mu_da = jnp.log(10.0 * eps0)
    gamma, t0, kappa = 0.05, 10.0, 0.75

    vmapped_transition = jax.vmap(
        _nuts_transition, in_axes=(0, 0, 0, 0, 0, None, None, None)
    )

    class Carry(NamedTuple):
        z: jnp.ndarray
        logp: jnp.ndarray
        key: jax.Array
        log_eps: jnp.ndarray
        log_eps_bar: jnp.ndarray
        h_bar: jnp.ndarray
        m1: jnp.ndarray
        m2: jnp.ndarray
        count: jnp.ndarray
        inv_mass: jnp.ndarray
        sum_alpha: jnp.ndarray
        sum_depth: jnp.ndarray
        n_trans: jnp.ndarray

    def one_transition(c: Carry, it, adapt: bool, warm_target: bool = False):
        lp_fn, g_fn = (logp_z_warm, grad_z_warm) if warm_target else (logp_z, grad_z)
        key, *chain_keys = jax.random.split(c.key, C + 1)
        z, logp, alpha, depth = vmapped_transition(
            jnp.stack(chain_keys), c.z, c.logp, c.log_eps, c.inv_mass,
            lp_fn, g_fn, max_depth,
        )
        if adapt:
            t = it + 1.0 + t0
            h_bar = (1.0 - 1.0 / t) * c.h_bar + (target_accept - alpha) / t
            log_eps = mu_da - jnp.sqrt(it + 1.0) / gamma * h_bar
            w = (it + 1.0) ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * c.log_eps_bar
            count = c.count + 1.0
            delta = z - c.m1
            m1 = c.m1 + delta / count[:, None]
            m2 = c.m2 + delta * (z - m1)
            inv_mass = c.inv_mass
        else:
            h_bar, log_eps, log_eps_bar = c.h_bar, c.log_eps, c.log_eps_bar
            m1, m2, count, inv_mass = c.m1, c.m2, c.count, c.inv_mass
        return Carry(
            z=z, logp=logp, key=key, log_eps=log_eps, log_eps_bar=log_eps_bar,
            h_bar=h_bar, m1=m1, m2=m2, count=count, inv_mass=inv_mass,
            sum_alpha=c.sum_alpha + alpha, sum_depth=c.sum_depth + depth,
            n_trans=c.n_trans + 1.0,
        )

    if init_inv_mass is not None:
        # carried adaptation state from the previous refit: skip phase 1
        inv_mass = jnp.broadcast_to(jnp.asarray(init_inv_mass, dtype), (C, d))
        warm = Carry(
            z=z0, logp=logp_batch(z0), key=key,
            log_eps=jnp.log(eps0), log_eps_bar=jnp.log(eps0),
            h_bar=jnp.zeros((C,), dtype),
            m1=jnp.zeros((C, d), dtype), m2=jnp.ones((C, d), dtype),
            count=jnp.zeros((C,), dtype), inv_mass=inv_mass,
            sum_alpha=jnp.zeros((C,), dtype), sum_depth=jnp.zeros((C,), dtype),
            n_trans=jnp.zeros((C,), dtype),
        )
    else:
        init = Carry(
            z=z0, logp=logp_batch_warm(z0), key=key,
            log_eps=jnp.log(eps0), log_eps_bar=jnp.log(eps0),
            h_bar=jnp.zeros((C,), dtype),
            m1=jnp.zeros((C, d), dtype), m2=jnp.ones((C, d), dtype),
            count=jnp.zeros((C,), dtype), inv_mass=jnp.ones((C, d), dtype),
            sum_alpha=jnp.zeros((C,), dtype), sum_depth=jnp.zeros((C,), dtype),
            n_trans=jnp.zeros((C,), dtype),
        )
        # phase 1: adapt eps under identity mass while collecting z
        # variances — on the CHEAP warmup target when one is provided
        warm = jax.lax.fori_loop(
            0, n_warmup,
            lambda i, c: one_transition(c, jnp.asarray(i, dtype), True, True), init,
        )
        var = warm.m2 / jnp.maximum(warm.count[:, None] - 1.0, 1.0)
        inv_mass = jnp.clip(var, 1e-4, 1e4)
        warm = warm._replace(
            inv_mass=inv_mass, logp=logp_batch(warm.z),  # re-score on the true target
        )
    # phase 2: the new mass (or the new data under a carried mass) changes
    # the effective step scale, so re-run the dual averaging from scratch
    # under the frozen mass on the TRUE target
    warm2_init = warm._replace(
        h_bar=jnp.zeros((C,), dtype),
        log_eps=warm.log_eps_bar, log_eps_bar=warm.log_eps_bar,
    )
    warm2 = jax.lax.fori_loop(
        0, n_warmup2 if n_warmup2 is not None else max(1, n_warmup // 2),
        lambda i, c: one_transition(c, jnp.asarray(i, dtype), True), warm2_init,
    )
    sampling_init = warm2._replace(
        log_eps=warm2.log_eps_bar,
        sum_alpha=jnp.zeros((C,), dtype), sum_depth=jnp.zeros((C,), dtype),
        n_trans=jnp.zeros((C,), dtype),
    )

    def sample_step(c, _):
        c = one_transition(c, jnp.asarray(0.0, dtype), False)
        return c, (c.z, c.logp)

    final, (zs, logps) = jax.lax.scan(sample_step, sampling_init, None, length=n_samples * thin)
    zs = zs[::thin]
    logps = logps[::thin]
    return NUTSResult(
        samples=_to_box(zs, lo, hi),
        accept_rate=final.sum_alpha / jnp.maximum(final.n_trans, 1.0),
        step_size=jnp.exp(final.log_eps),
        log_prob=logps,
        mean_depth=final.sum_depth / jnp.maximum(final.n_trans, 1.0),
        inv_mass=final.inv_mass,
    )
