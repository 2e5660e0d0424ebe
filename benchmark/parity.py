"""Regret-parity runner: the five pinned configs of BASELINE.md executed on
BOTH frameworks (this one and the reference at /root/reference via the
dependency shims), same seeds, recording best-found values and wall-clock.

Usage: python benchmark/parity.py [--out PARITY.json] [--seeds 3]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/benchmark/ref_shims")
sys.path.insert(0, "/root/reference")

# adapt the reference to the installed sklearn (API drift since v0.3.0)
# so every config produces a real head-to-head; see ref_sklearn_compat.py
import ref_sklearn_compat  # noqa: E402

ref_sklearn_compat.apply()

# minimal documented patches for the reference's OWN bugs that crash
# configs 2a/2b/4 before any head-to-head completes; see ref_bugfix.py
import ref_bugfix  # noqa: E402

ref_bugfix.apply()


def sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def ellipsoid20(x):
    x = np.asarray(x, dtype=float)
    w = 10 ** np.linspace(0, 4, len(x))
    return float(np.sum(w * x**2))


def mixed_obj(x):
    r0, r1, i0, c0 = x[0], x[1], x[2], x[3]
    return (
        float(r0) ** 2 + float(r1) ** 2 + abs(int(i0) - 5) / 5.0
        + {"A": 0.0, "B": 0.7, "C": 1.5}[c0]
    )


def noisy_ellipsoid(rng):
    def f(x):
        return ellipsoid20(x) * (1.0 + 0.05 * rng.standard_normal())

    return f


# ---------------------------------------------------------------- ours
def ours_config1(seed):
    from bayesian_optimization_tpu import fmin

    t0 = time.perf_counter()
    _, fopt, _, _, _ = fmin(sphere, [-5.0] * 2, [5.0] * 2, max_FEs=30, x0=5, seed=seed)
    return fopt, time.perf_counter() - t0


def ours_config2(seed, acq):
    from bayesian_optimization_tpu import BO, GaussianProcess, RealSpace
    from bayesian_optimization_tpu.models.trend import constant_trend

    space = RealSpace([[-5.0, 5.0]] * 5, random_seed=seed)
    # same RAW-coordinate theta bounds as the reference leg (_ref_gp);
    # BaseBO rescales them onto the unit embedding
    gp = GaussianProcess(mean=constant_trend(5), corr="matern",
                         thetaL=1e-2 * np.ones(5), thetaU=1e4 * np.ones(5),
                         nugget=1e-6, random_state=seed)
    opt = BO(search_space=space, obj_fun=sphere, model=gp, DoE_size=10,
             max_FEs=40, acquisition_fun=acq, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(opt.xopt.fitness.ravel()[0]), time.perf_counter() - t0


def ours_config3(seed):
    from bayesian_optimization_tpu import GaussianProcess, ParallelBO, RealSpace
    from bayesian_optimization_tpu.models.trend import constant_trend

    space = RealSpace([[-5.0, 5.0]] * 5, random_seed=seed)
    gp = GaussianProcess(mean=constant_trend(5), corr="matern",
                         thetaL=1e-2 * np.ones(5), thetaU=1e4 * np.ones(5),
                         nugget=1e-6, random_state=seed)
    opt = ParallelBO(search_space=space, obj_fun=sphere, model=gp, n_point=8,
                     acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                     DoE_size=8, max_FEs=48, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(opt.xopt.fitness.ravel()[0]), time.perf_counter() - t0


def _mixed_space_ours(seed):
    from bayesian_optimization_tpu import DiscreteSpace, IntegerSpace, RealSpace

    s = (RealSpace([[-3.0, 3.0]] * 2, var_name="r")
         + IntegerSpace([0, 10], var_name="i")
         + DiscreteSpace(["A", "B", "C"], var_name="c"))
    s.random_seed = seed
    return s


def ours_config4(seed):
    from bayesian_optimization_tpu import BO

    opt = BO(search_space=_mixed_space_ours(seed), obj_fun=mixed_obj,
             DoE_size=8, max_FEs=40, acquisition_fun="MGFI",
             acquisition_par={"t": 2.0}, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(opt.xopt.fitness.ravel()[0]), time.perf_counter() - t0


def ours_config5b(seed):
    """NoisyBO on the 20-D noisy ellipsoid (the pinned config's NoisyBO half;
    ref: bayes_opt.py:177-194). Regret is reported on the NOISELESS
    ellipsoid at the recommended point."""
    from bayesian_optimization_tpu import GaussianProcess, NoisyBO, RealSpace
    from bayesian_optimization_tpu.models.trend import constant_trend

    rng = np.random.default_rng(1000 + seed)
    f_noisy = noisy_ellipsoid(rng)
    space = RealSpace([[-5.0, 5.0]] * 20, random_seed=seed)
    gp = GaussianProcess(mean=constant_trend(20), corr="matern",
                         thetaL=1e-2 * np.ones(20), thetaU=1e4 * np.ones(20),
                         nugget=1e-4, random_state=seed)
    opt = NoisyBO(search_space=space, obj_fun=f_noisy, model=gp, n_point=4,
                  acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                  DoE_size=20, max_FEs=60, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    xbest = np.asarray(opt.xopt.tolist()[0] if hasattr(opt.xopt, "tolist") else opt.xopt, dtype=float).ravel()
    return ellipsoid20(xbest[:20]), time.perf_counter() - t0


def ref_config5b(seed):
    from bayes_optim import NoisyBO as RefNoisyBO
    from bayes_optim import RealSpace as RefRealSpace

    rng = np.random.default_rng(1000 + seed)
    f_noisy = noisy_ellipsoid(rng)
    space = RefRealSpace([[-5.0, 5.0]] * 20, random_seed=seed)
    opt = RefNoisyBO(search_space=space, obj_fun=f_noisy, model=_ref_gp(20, seed),
                     n_point=4, acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                     DoE_size=20, max_FEs=60, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    xbest = np.asarray(opt.xopt.tolist(), dtype=float).ravel()
    return ellipsoid20(xbest[:20]), time.perf_counter() - t0


def ours_config5(seed):
    from bayesian_optimization_tpu import PCABO, RealSpace

    space = RealSpace([[-5.0, 5.0]] * 20, random_seed=seed)
    opt = PCABO(search_space=space, obj_fun=ellipsoid20, n_components=5,
                DoE_size=20, max_FEs=60, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(opt.xopt.fitness.ravel()[0]), time.perf_counter() - t0


# ------------------------------------------------------------- reference
def ref_config1(seed):
    from bayes_optim import fmin as ref_fmin

    t0 = time.perf_counter()
    out = ref_fmin(sphere, [-5.0] * 2, [5.0] * 2, max_FEs=30, x0=5, seed=seed)
    return float(np.ravel(out[1])[0]), time.perf_counter() - t0


def _ref_gp(dim, seed):
    from bayes_optim.surrogate.gaussian_process import trend
    from bayes_optim.surrogate.gaussian_process.gpr import GaussianProcess as RefGP

    return RefGP(mean=trend.constant_trend(dim), corr="matern",
                 thetaL=1e-3 * 10 * np.ones(dim), thetaU=1e3 * 10 * np.ones(dim),
                 nugget=1e-6, noise_estim=False, optimizer="BFGS", wait_iter=3,
                 random_start=max(10, dim), likelihood="concentrated",
                 eval_budget=100 * dim, random_state=seed)


def ref_config2(seed, acq):
    from bayes_optim import BO as RefBO
    from bayes_optim import RealSpace as RefRealSpace

    space = RefRealSpace([[-5.0, 5.0]] * 5, random_seed=seed)
    opt = RefBO(search_space=space, obj_fun=sphere, model=_ref_gp(5, seed),
                DoE_size=10, max_FEs=40, acquisition_fun=acq, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(np.ravel(opt.xopt.fitness)[0]), time.perf_counter() - t0


def ref_config3(seed):
    from bayes_optim import ParallelBO as RefParallelBO
    from bayes_optim import RealSpace as RefRealSpace

    space = RefRealSpace([[-5.0, 5.0]] * 5, random_seed=seed)
    opt = RefParallelBO(search_space=space, obj_fun=sphere, model=_ref_gp(5, seed),
                        n_point=8, acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                        DoE_size=8, max_FEs=48, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(np.ravel(opt.xopt.fitness)[0]), time.perf_counter() - t0


def ref_config4(seed):
    from bayes_optim import BO as RefBO
    from bayes_optim.search_space import Discrete, Integer, Real, SearchSpace as RefSS
    from bayes_optim.surrogate import RandomForest as RefRF

    space = RefSS([Real([-3.0, 3.0], "r0"), Real([-3.0, 3.0], "r1"),
                   Integer([0, 10], "i"), Discrete(["A", "B", "C"], "c")],
                  random_seed=seed)
    model = RefRF(levels=space.levels)
    opt = RefBO(search_space=space, obj_fun=mixed_obj, model=model, DoE_size=8,
                max_FEs=40, acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(np.ravel(opt.xopt.fitness)[0]), time.perf_counter() - t0


def ref_config5(seed):
    from bayes_optim.extension import PCABO as RefPCABO
    from bayes_optim import RealSpace as RefRealSpace

    space = RefRealSpace([[-5.0, 5.0]] * 20, random_seed=seed)
    opt = RefPCABO(search_space=space, obj_fun=ellipsoid20, n_components=5,
                   DoE_size=20, max_FEs=60, random_seed=seed)
    t0 = time.perf_counter()
    opt.run()
    return float(np.ravel(opt.xopt.fitness)[0]), time.perf_counter() - t0


def _con_obj(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2)
                 + 5 * np.sum(np.asarray(x, dtype=float)) + 10)


def _con_h(x):
    return np.sum(x) - 1


def ours_config6(seed):
    """Equality-constrained BO (ref parity: unittest/test_constraint.py:29-56).
    Metric: fopt if the winner is near-feasible (|h| <= 0.1), else fopt plus
    a 1e3 feasibility penalty so violations are visible in the record."""
    from bayesian_optimization_tpu import BO, GaussianProcess, RealSpace

    dim = 2
    model = GaussianProcess(
        corr="squared_exponential", thetaL=1e-5 * np.ones(dim),
        thetaU=np.ones(dim), nugget=1e-1, random_state=seed,
    )
    opt = BO(search_space=RealSpace([0, 1]) * dim, obj_fun=_con_obj,
             eq_fun=_con_h, model=model, max_FEs=20, DoE_size=3,
             acquisition_fun="MGFI", acquisition_par={"t": 2},
             acquisition_optimization={"optimizer": "BFGS"}, random_seed=seed)
    t0 = time.perf_counter()
    xopt, fopt, _ = opt.run()
    viol = abs(float(_con_h(np.asarray(xopt, dtype=float).ravel())))
    f = float(np.ravel(fopt)[0]) + (0.0 if viol <= 0.1 else 1e3 * viol)
    return f, time.perf_counter() - t0


def ref_config6(seed):
    from bayes_optim import BO as RefBO, RealSpace as RefRealSpace
    from bayes_optim.surrogate import GaussianProcess as RefGP
    from bayes_optim.utils.exception import AskEmptyError as RefAskEmpty

    dim = 2
    model = RefGP(corr="squared_exponential", thetaL=1e-5 * np.ones(dim),
                  thetaU=np.ones(dim), theta0=0.5 * np.ones(dim),
                  nugget=1e-1, random_state=seed)
    opt = RefBO(search_space=RefRealSpace([0, 1]) * dim, obj_fun=_con_obj,
                eq_fun=_con_h, model=model, max_FEs=20, DoE_size=3,
                acquisition_fun="MGFI", acquisition_par={"t": 2},
                acquisition_optimization={"optimizer": "BFGS"},
                random_seed=seed, verbose=False)
    t0 = time.perf_counter()
    try:
        xopt, _, __ = opt.run()
        xv = np.asarray(xopt, dtype=float).ravel()
    except RefAskEmpty:
        # the reference stochastically dies mid-run on this config in this
        # environment (its create_DoE can return empty after 4 unlucky SCMC
        # rejection rounds, base.py:377-400); score its best-so-far, i.e.
        # the run truncated by its own failure
        xv = np.asarray(opt.xopt.tolist(), dtype=float).ravel()
    viol = abs(float(_con_h(xv)))
    f = _con_obj(xv) + (0.0 if viol <= 0.1 else 1e3 * viol)
    return f, time.perf_counter() - t0


CONFIGS = {
    "1_fmin_sphere2d": (ours_config1, ref_config1),
    "2a_bo_ucb_5d": (lambda s: ours_config2(s, "UCB"), lambda s: ref_config2(s, "UCB")),
    "2b_bo_pi_5d": (lambda s: ours_config2(s, "PI"), lambda s: ref_config2(s, "PI")),
    "3_parallelbo_mgfi_q8": (ours_config3, ref_config3),
    "4_mixed_mies": (ours_config4, ref_config4),
    "5_pcabo_elli20": (ours_config5, ref_config5),
    "5b_noisybo_elli20": (ours_config5b, ref_config5b),
    "6_constrained_eq": (ours_config6, ref_config6),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="PARITY.json")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--skip-ref", action="store_true")
    args = ap.parse_args()

    results = {}
    for name in args.configs:
        ours_fn, ref_fn = CONFIGS[name]
        rec = {"ours": [], "ref": [], "ours_wall": [], "ref_wall": []}
        for seed in range(args.seeds):
            f, w = ours_fn(42 + seed)
            rec["ours"].append(f)
            rec["ours_wall"].append(w)
            print(f"[{name}] seed {seed}: ours fopt={f:.5g} ({w:.1f}s)", flush=True)
            if not args.skip_ref:
                try:
                    f, w = ref_fn(42 + seed)
                    rec["ref"].append(f)
                    rec["ref_wall"].append(w)
                    print(f"[{name}] seed {seed}: ref  fopt={f:.5g} ({w:.1f}s)", flush=True)
                except Exception as e:  # noqa: BLE001 - record and continue
                    print(f"[{name}] seed {seed}: ref FAILED: {e}", flush=True)
                    rec.setdefault("ref_error", str(e))
        results[name] = rec
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({k: {"ours_med": float(np.median(v["ours"])),
                          "ref_med": float(np.median(v["ref"])) if v["ref"] else None}
                      for k, v in results.items()}, indent=1))


if __name__ == "__main__":
    main()
