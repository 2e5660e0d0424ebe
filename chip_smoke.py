"""Run the GP-BO loop once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py           # one card: phases 1-7 below
    python chip_smoke.py --four    # four cards: the sharded ask against one card

One process drives the card(s). Phases, in order:

1. device: refuses to run unless JAX's default device is a GPU; prints the
   card's name and power limit, the device kind and the JAX version.
2. main path: `BO` with the harness GP (Matern, constant trend,
   theta in [1e-3, 1e3]^5, nugget 1e-6, 10 restarts) and an EI argmax (BFGS,
   25 restarts), started from 1000 seeded warm points of BBOB F15 in 5-D;
   one warm-up ask->tell (set-up, with the compiles) and 3 timed ones, each
   a refit at n~1000 (bucket 1024) plus an argmax. Checks the proposals,
   the fit's ok flag, the NLL (1e-3 relative) and the posterior mean at 256
   held-out points (1e-2 absolute, y standardized) against float64 numpy.
3. large n: one fit at n=4000 (bucket 4096) with the same NLL check.
4. factorization routes: the blocked `whiten` against cuSOLVER
   (jnp.linalg.cholesky + solve_triangular), vmapped over 10 restarts at
   n=1024 and n=4096 on Matern-5/2 matrices at nugget 1e-6: median ms and
   max error against float64. Then `whiten`'s value and gradient at the
   tolerances of tests/test_linalg.py (1e-2 and 1e-3 relative).
5. NUTS: an optimizer="NUTS" fit at n=1000 with the default warmup, plus an
   EI ask; accept rates and predictions must be finite.
6. breadth: one ask->tell each of a mixed-integer space (MIES), ParallelBO
   q=8 and a 2-objective MOBO (EHVI), at n~100.
7. card tests: the `card`-marked tests, run inside this process.

`--four` runs only `BO(mesh=make_particle_mesh(4))`, one ask at n=1000,
d=5, against the same ask on one card, and `dryrun_multichip(4)`.

Every time is printed beside the card's name. A failed phase makes the
exit code non-zero; the last line of stdout is
{"ok": true, "device": {...}} only when every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

D = 5
FID = 15  # BBOB rotated Rastrigin: multimodal with global structure
LB, UB = -5.0, 5.0
CARD = "no card"


class CheckFailed(AssertionError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def timed(phase: str, what: str, seconds: float) -> None:
    say(phase, f"{what}: {seconds:.4f} s ({CARD})")


def check(phase: str, ok: bool, msg: str) -> None:
    say(phase, ("PASS " if ok else "FAIL ") + msg)
    if not ok:
        raise CheckFailed(f"{phase}: {msg}")


def harness_gp(d: int, seed: int, **kw):
    """The GP of bench.py and benchmark/harness.py."""
    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend

    return GaussianProcess(
        mean=constant_trend(d), corr="matern",
        thetaL=1e-3 * np.ones(d), thetaU=1e3 * np.ones(d),
        nugget=1e-6, random_start=10, random_state=seed, **kw,
    )


def bbob_data(n: int, seed: int, d: int = D):
    from benchmark.bbob import BBOBFunction

    f = BBOBFunction(FID, d, 1)
    X = np.random.default_rng(seed).uniform(LB, UB, (n, d))
    return f, X, f(X)


def make_bo(n: int, seed: int, d: int = D, mesh=None, **gp_kw):
    """BO on [-5, 5]^d started from n seeded warm points of BBOB F15."""
    from bayesian_optimization_tpu import BO, RealSpace

    f, X0, y0 = bbob_data(n, seed, d)
    return BO(
        search_space=RealSpace([[LB, UB]] * d, random_seed=seed), obj_fun=f,
        model=harness_gp(d, seed, **gp_kw), warm_data=(X0, y0),
        acquisition_fun="EI",
        acquisition_optimization={"optimizer": "BFGS", "n_restart": 5 * d},
        random_seed=seed, mesh=mesh,
    )


def bo_features(opt, values) -> np.ndarray:
    """The features the BO's GP is fitted on (the unit embedding)."""
    enc = opt.encoding
    return enc.unit_to_embed_np(enc.encode_unit(np.asarray(values, dtype=object)))


def bo_targets(opt) -> np.ndarray:
    """The standardized fitness the BO's GP is fitted on."""
    f = np.asarray(opt.data.fitness[:, 0], float)
    return (f - f.mean()) / f.std()


def gp_reference_errors(gp, X, y, Xq=None):
    """(nll, float64 nll, relative NLL error, max |posterior mean error| at
    Xq) of a fitted 'noisy'-mode GP against benchmark/reference.py."""
    from benchmark import reference as ref

    if gp.estimation_mode != "noisy":
        raise CheckFailed(f"reference covers the 'noisy' mode, got {gp.estimation_mode!r}")
    theta = np.asarray(gp.theta_, float)
    sigma2 = float(np.ravel(gp.sigma2)[0])
    args = (theta, sigma2, float(gp.noise_var), gp.corr_type)
    nll = -float(gp.log_likelihood_)
    nll_ref = ref.concentrated_nll(X, y, *args)
    err = abs(nll - nll_ref) / max(1.0, abs(nll_ref))
    mu_err = None
    if Xq is not None:
        mu = np.asarray(gp.predict(Xq), float).ravel()
        mu_err = float(np.max(np.abs(mu - ref.posterior_mean(X, y, Xq, *args))))
    return nll, nll_ref, err, mu_err


def check_proposals(phase: str, P, n: int, d: int = D) -> None:
    P = np.asarray(P, float)
    check(
        phase,
        P.shape == (n, d) and bool(np.all(np.isfinite(P))) and bool(np.all((P >= LB) & (P <= UB))),
        f"{n} proposal(s) of shape {P.shape} finite and inside [{LB}, {UB}]^{d}",
    )


# --------------------------------------------------------------------- phases
def phase_device() -> dict:
    import jax

    from benchmark.device import nvidia_smi_lines, require_gpu

    dev = require_gpu()
    global CARD
    lines = nvidia_smi_lines()
    CARD = lines[0]
    for line in lines:
        say("device", f"card: {line}")
    say("device", f"jax {jax.__version__}; platform {dev['platform']}, "
                  f"kind {dev['kind']}, count {dev['count']}")
    return dev


def phase_main(n: int = 1000, iters: int = 3, n_heldout: int = 256, seed: int = 0) -> None:
    ph = "main"
    t0 = time.perf_counter()
    opt = make_bo(n, seed)
    timed(ph, f"set-up: BO from {n} warm points, first fit (compile included)",
          time.perf_counter() - t0)
    proposals = []

    def ask_tell():
        t = time.perf_counter()
        X = opt.ask()
        t_ask = time.perf_counter() - t
        proposals.extend(X)
        t = time.perf_counter()
        opt.tell(X, opt.evaluate(X))
        return t_ask, time.perf_counter() - t

    t_ask, t_tell = ask_tell()
    timed(ph, "set-up: warm-up ask->tell (argmax and warm-refit compiles)", t_ask + t_tell)
    walls = []
    for i in range(iters):
        t_ask, t_tell = ask_tell()
        walls.append(t_ask + t_tell)
        timed(ph, f"iteration {i + 1} at n={len(opt.data) - 1}: ask {t_ask:.4f} s + tell "
                  f"{t_tell:.4f} s", walls[-1])
    timed(ph, f"median iteration wall over {iters}", float(np.median(walls)))
    check_proposals(ph, proposals, iters + 1)
    gp = opt.model
    check(ph, bool(gp.fit_ok_), "the last fit's ok flag is set")
    Xh = np.random.default_rng(seed + 1).uniform(LB, UB, (n_heldout, D))
    Xq = bo_features(opt, Xh)
    nll, nll_ref, err, mu_err = gp_reference_errors(
        gp, bo_features(opt, opt.data.values), bo_targets(opt), Xq
    )
    corr = np.corrcoef(np.asarray(gp.predict(Xq), float).ravel(), opt.obj_fun(Xh))[0, 1]
    say(ph, f"theta {np.round(gp.theta_, 4).tolist()}, noise {gp.noise_var:.3g}, "
            f"held-out correlation with the objective {corr:.4f}")
    check(ph, err <= 1e-3, f"NLL {nll:.6f} vs float64 {nll_ref:.6f}: relative error {err:.2e} <= 1e-3")
    check(ph, mu_err <= 1e-2, f"posterior mean at {n_heldout} held-out points: max |error| "
                              f"{mu_err:.2e} <= 1e-2")


def phase_large(n: int = 4000, seed: int = 1) -> None:
    ph = "large n"
    _f, X, y = bbob_data(n, seed)
    y = (y - y.mean()) / y.std()
    gp = harness_gp(D, seed)
    t0 = time.perf_counter()
    gp.fit(X, y)
    timed(ph, f"one fit at n={n} (compile included)", time.perf_counter() - t0)
    check(ph, bool(gp.fit_ok_), "fit ok flag is set")
    nll, nll_ref, err, _ = gp_reference_errors(gp, X, y)
    say(ph, f"theta {np.round(gp.theta_, 4).tolist()}, noise {gp.noise_var:.3g}")
    check(ph, err <= 1e-3, f"NLL {nll:.6f} vs float64 {nll_ref:.6f}: relative error {err:.2e} <= 1e-3")


def _whiten_objective(R, B):
    import jax.numpy as jnp

    from bayesian_optimization_tpu.ops.linalg import whiten

    d, W, _ = whiten(R, B)
    return jnp.sum(jnp.log(d)) + jnp.sum(W * W)


def _cusolver_objective(R, B):
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):
        L = jnp.linalg.cholesky(R)
        W = jax.scipy.linalg.solve_triangular(L, B, lower=True)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(W * W)


def kernel_matrix(n: int, seed: int, theta: float, d: int = D) -> np.ndarray:
    """Matern-5/2 correlation of n uniform points in [0, 1]^d plus 1e-6 I."""
    from benchmark import reference as ref

    X = np.random.default_rng(seed).uniform(0.0, 1.0, (n, d))
    return ref.kernel("matern52", theta, X) + 1e-6 * np.eye(n)


def easy_spd(n: int, seed: int) -> np.ndarray:
    """The well-conditioned SPD matrices of tests/test_linalg.py."""
    X = np.random.default_rng(seed).standard_normal((n, 16))
    return ((X @ X.T / 16 + np.eye(n) * n) / n).astype(np.float32)


def whiten_precision_errors(R, B):
    """(value, gradient) relative errors of `whiten` against float64."""
    import jax
    import jax.numpy as jnp

    from benchmark import reference as ref

    v, g = jax.jit(jax.value_and_grad(_whiten_objective))(
        jnp.asarray(R, jnp.float32), jnp.asarray(B, jnp.float32)
    )
    return ref.relative_errors(v, g, *ref.whiten_value_grad(R, B))


def phase_routes(ns=(1024, 4096), batch: int = 10, reps: int = 5, theta: float = 10.0) -> None:
    import jax
    import jax.numpy as jnp

    from benchmark import reference as ref

    ph = "routes"
    routes = {
        "blocked whiten": _whiten_objective,
        "cuSOLVER cholesky+solve_triangular": _cusolver_objective,
    }
    for n in ns:
        Rs = np.stack([kernel_matrix(n, s, theta) for s in range(batch)])
        Bs = np.random.default_rng(n).standard_normal((batch, n, 2))
        refs = [ref.whiten_value_grad(R, B) for R, B in zip(Rs, Bs)]
        Rj = jnp.asarray(Rs, jnp.float32)
        Bj = jnp.asarray(Bs, jnp.float32)
        for name, obj in routes.items():
            row = []
            out = None
            for label, fn in (
                ("forward", jax.jit(jax.vmap(obj))),
                ("value+grad", jax.jit(jax.vmap(jax.value_and_grad(obj)))),
            ):
                t = time.perf_counter()
                out = jax.block_until_ready(fn(Rj, Bj))
                compile_s = time.perf_counter() - t
                ts = []
                for _ in range(reps):
                    t = time.perf_counter()
                    jax.block_until_ready(fn(Rj, Bj))
                    ts.append(time.perf_counter() - t)
                row.append(f"{label} {1e3 * np.median(ts):.3f} ms (first call {compile_s:.2f} s)")
            vals, grads = np.asarray(out[0], np.float64), np.asarray(out[1], np.float64)
            errs = np.array([
                ref.relative_errors(v, g, rv, rg)
                for v, g, (rv, rg) in zip(vals, grads, refs)
            ])
            finite = bool(np.all(np.isfinite(vals)) and np.all(np.isfinite(grads)))
            say(ph, f"n={n}, batch {batch}, {name}: {'; '.join(row)}, median of {reps} "
                    f"({CARD}); max error vs float64: value {errs[:, 0].max():.2e}, "
                    f"gradient {errs[:, 1].max():.2e}; finite {finite}")
            check(ph, finite, f"n={n} {name}: values and gradients finite")
    # whiten's precision at the tolerances of tests/test_linalg.py
    for n in ns:
        B = np.random.default_rng(5).standard_normal((n, 2))
        for label, R in (("test_linalg SPD", easy_spd(n, 4)),
                         ("Matern-5/2 theta=30", kernel_matrix(n, 7, 30.0))):
            ve, ge = whiten_precision_errors(R, B)
            check(ph, ve <= 1e-2 and ge <= 1e-3,
                  f"whiten n={n} {label}: value error {ve:.2e} <= 1e-2, gradient error "
                  f"{ge:.2e} <= 1e-3")


def phase_nuts(n: int = 1000, n_heldout: int = 256, seed: int = 3) -> None:
    ph = "nuts"
    t0 = time.perf_counter()
    opt = make_bo(n, seed, optimizer="NUTS")
    timed(ph, f"set-up: NUTS fit at n={n} (compile included)", time.perf_counter() - t0)
    t0 = time.perf_counter()
    X = opt.ask()
    timed(ph, "EI ask over the posterior ensemble (compile included)", time.perf_counter() - t0)
    check_proposals(ph, X, 1)
    gp = opt.model
    acc = np.atleast_1d(np.asarray(gp.accept_rate_, float))
    check(ph, bool(np.all(np.isfinite(acc))), f"accept rates finite: {np.round(acc, 3).tolist()}")
    Xq = bo_features(opt, np.random.default_rng(seed).uniform(LB, UB, (n_heldout, D)))
    mu, mse = gp.predict(Xq, eval_MSE=True)
    check(ph, bool(np.all(np.isfinite(mu)) and np.all(np.isfinite(mse))),
          f"posterior mean and variance finite at {n_heldout} points")


def _step(opt):
    """One ask->tell; returns the asked points and the seconds it took."""
    t0 = time.perf_counter()
    X = opt.ask()
    opt.tell(X, opt.evaluate(X))
    return X, time.perf_counter() - t0


def phase_breadth(n: int = 100, seed: int = 4) -> None:
    from bayesian_optimization_tpu import (
        BO, MOBO, DiscreteSpace, IntegerSpace, ParallelBO, RealSpace,
    )

    ph = "breadth"
    space = (RealSpace([[LB, UB]] * 2, var_name="r") + IntegerSpace([0, 10], var_name="i")
             + DiscreteSpace(["A", "B", "C"], var_name="c"))
    space.random_seed = seed

    def mixed(x):
        return float(x[0]) ** 2 + float(x[1]) ** 2 + (int(x[2]) - 3) ** 2 + "ABC".index(x[3])

    f, _, _ = bbob_data(1, seed)

    def f2(x):
        return float(np.sum((np.asarray(x, float) - 1.0) ** 2))

    cases = [
        ("mixed-integer BO", 1, BO(search_space=space, obj_fun=mixed, DoE_size=n, random_seed=seed)),
        ("ParallelBO q=8", 8, ParallelBO(
            search_space=RealSpace([[LB, UB]] * D, random_seed=seed), obj_fun=f,
            model=harness_gp(D, seed), n_point=8, DoE_size=n, random_seed=seed)),
        ("2-objective MOBO (EHVI)", 1, MOBO(
            search_space=RealSpace([[LB, UB]] * D, random_seed=seed), obj_fun=[f, f2],
            n_obj=2, DoE_size=n, random_seed=seed)),
    ]
    for what, q, opt in cases:
        _step(opt)  # the design of n points and the first fit
        X, seconds = _step(opt)
        timed(ph, f"{what}: one ask->tell after {n} points (compile included)", seconds)
        if opt.search_space is space:
            check(ph, opt._optimizer_name == "MIES" and len(X) == 1 and X[0] in space,
                  f"MIES proposal {X[0]} inside the mixed space")
        else:
            check_proposals(ph, X, q)


def phase_card_tests() -> None:
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    rc = pytest.main([
        "-q", "-m", "card", "-o", "addopts=", "-p", "no:cacheprovider",
        os.path.join(here, "tests", "test_card.py"),
    ])
    timed("card tests", "pytest -m card", time.perf_counter() - t0)
    check("card tests", rc == 0, f"pytest exit code {rc}")


def phase_four(n: int = 1000, seed: int = 0) -> None:
    import jax

    from __graft_entry__ import dryrun_multichip
    from bayesian_optimization_tpu.parallel import make_particle_mesh

    ph = "four"
    check(ph, len(jax.devices()) >= 4, f"{len(jax.devices())} devices >= 4")
    out = {}
    for label, mesh in (("one card", None), ("four cards", make_particle_mesh(4))):
        t0 = time.perf_counter()
        opt = make_bo(n, seed, mesh=mesh)
        timed(ph, f"{label}: set-up, first fit at n={n}", time.perf_counter() - t0)
        t0 = time.perf_counter()
        X = opt.ask()
        timed(ph, f"{label}: one ask (compile included)", time.perf_counter() - t0)
        check_proposals(ph, X, 1)
        t0 = time.perf_counter()
        _, vals = opt.arg_max_acquisition(return_value=True)
        timed(ph, f"{label}: second argmax (warm)", time.perf_counter() - t0)
        out[label] = (np.asarray(opt.model.theta_), np.asarray(X, float), float(vals[0]))
        say(ph, f"{label}: theta {np.round(out[label][0], 4).tolist()}, ask {np.round(out[label][1], 4).tolist()}, "
                f"EI of the second argmax {out[label][2]:.6g}")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    timed(ph, "dryrun_multichip(4) on the cards", time.perf_counter() - t0)
    (t1, x1, v1), (t4, x4, v4) = out["one card"], out["four cards"]
    check(ph, bool(np.allclose(t1, t4, rtol=1e-3)), "the same GP fit on both runs")
    # the sharded pool pads its restarts to a multiple of 4 devices and runs
    # in another summation order, so the L-BFGS lanes (40 iterations) stop
    # at nearby points: compare the maximized EI, not the bits
    check(ph, abs(v4 - v1) <= 1e-2 * max(abs(v1), abs(v4)),
          f"EI of the four-card argmax {v4:.6g} within 1e-2 relative of one card's {v1:.6g}; "
          f"asks differ by {np.abs(x1 - x4).max():.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the four-card path and what it is compared with")
    args = ap.parse_args(argv)
    dev = phase_device()
    phases = [("four", phase_four)] if args.four else [
        ("main", phase_main), ("large n", phase_large), ("routes", phase_routes),
        ("nuts", phase_nuts), ("breadth", phase_breadth), ("card tests", phase_card_tests),
    ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        timed(name, "phase wall", time.perf_counter() - t0)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
