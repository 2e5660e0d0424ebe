"""f64-vs-f32 likelihood control at large n (round-5 VERDICT item 4).

Question: is the large-n MLE quality gap (theta pinned at bounds, held-out
corr 0.65 at n=1000 on the bench function — BASELINE.md "Known limitation")
a float32 numerics artifact, or data sparsity? The reference's MLE stack is
float64 numpy/LAPACK (ref: gpr.py:790-811, 920-1040); this script fits the
SAME data with dtype='f32' and dtype='f64' (identical restarts/budget) and
reports theta, bound-pinning, NLL, and held-out correlation for both.

Run on CPU so precision is the only variable (no reduced-precision matmul
passes):

    JAX_PLATFORM_NAME=cpu python benchmark/f64_control.py [--n 1000]
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_data(n_obs, dim=5, seed=1):
    """The bench.py problem: X ~ U[0,1]^d, y = sum(sin(3x)) + noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n_obs, dim))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n_obs)
    return X, (y - y.mean()) / y.std()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--holdout", type=int, default=500)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend

    dim = args.dim
    X, y = bench_data(args.n + args.holdout, dim)
    Xtr, ytr = X[: args.n], y[: args.n]
    Xte, yte = X[args.n :], y[args.n :]

    out = {"n": args.n, "dim": dim}
    for dt in ("f32", "f64"):
        gp = GaussianProcess(
            mean=constant_trend(dim), corr="matern",
            thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
            nugget=1e-6, random_start=10, random_state=0, dtype=dt,
        )
        t0 = time.perf_counter()
        gp.fit(Xtr, ytr)
        wall = time.perf_counter() - t0
        mu, _ = gp.predict(Xte, eval_MSE=True)
        theta = np.asarray(gp.theta_)
        lo, hi = np.asarray(gp.thetaL), np.asarray(gp.thetaU)
        at_bound = int(np.sum((theta <= lo * 1.01) | (theta >= hi * 0.99)))
        out[dt] = {
            "wall_s": round(wall, 2),
            "theta": [float(f"{t:.5g}") for t in theta],
            "n_theta_at_bound": at_bound,
            "nll": float(np.asarray(gp.log_likelihood_)) * -1.0,
            "holdout_corr": round(float(np.corrcoef(mu.ravel(), yte)[0, 1]), 4),
            "holdout_rmse": round(float(np.sqrt(np.mean((mu.ravel() - yte) ** 2))), 4),
        }
        print(f"[{dt}] {out[dt]}", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
