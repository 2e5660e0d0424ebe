"""Scaling-efficiency report for the particle-sharded programs.

The reference's only multi-node story is an embarrassingly-parallel MPI
fan-out of independent BO runs (ref: benchmark/run_mpi.py:87-116). This
framework instead shards *population axes inside one optimization* — CMA-ES
acquisition chains and GP MLE restarts — over a `jax.sharding.Mesh` with a
'particles' axis, and lets XLA insert the collectives at the best-of-
population reductions.

This script measures strong scaling (fixed total population, more devices)
and weak scaling (fixed per-device population) of the fused CMA acquisition
argmax on a simulated multi-device mesh (host CPU split into 8 XLA devices —
the same mechanism the test suite and `__graft_entry__.dryrun_multichip`
use). On CPU the devices are host threads, so efficiencies reflect the
sharded program's structure, not interconnect bandwidth; on a multi-GPU
host the same program runs with the mesh over the cards.

Usage:  python benchmark/scaling.py    (writes markdown to stdout)
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORM_NAME"] = "cpu"

import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() == 8, jax.devices()

    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend
    from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax
    from bayesian_optimization_tpu.parallel.mesh import make_particle_mesh
    from bayesian_optimization_tpu.space import RealSpace

    D, N = 5, 256
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (N, D))
    y = np.sin(3 * X).sum(1)
    y_std = (y - y.mean()) / y.std()
    gp = GaussianProcess(
        mean=constant_trend(D), corr="matern",
        thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D),
        nugget=1e-6, random_start=8, random_state=0,
    )
    gp.fit(X, y_std)
    enc = RealSpace([[0.0, 1.0]] * D).encoding()
    params = {"plugin": float(y_std.min())}

    def make_gp(n_obs: int):
        rng_ = np.random.default_rng(0)
        X_ = rng_.uniform(0, 1, (n_obs, D))
        y_ = np.sin(3 * X_).sum(1)
        ys = (y_ - y_.mean()) / y_.std()
        g = GaussianProcess(
            mean=constant_trend(D), corr="matern",
            thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D),
            nugget=1e-6, random_start=8, random_state=0,
        )
        g.fit(X_, ys)
        return g, {"plugin": float(ys.min())}

    def bench(n_dev: int, n_chains: int, reps: int = 5, n_gen: int = 64,
              model=None, pars=None) -> float:
        model = model if model is not None else gp
        pars = pars if pars is not None else params
        mesh = make_particle_mesh(n_dev)
        am = AcquisitionArgmax(
            enc, method="OnePlusOne_Cholesky_CMA",
            n_chains=n_chains, max_FEs=n_chains * n_gen, seed=0, mesh=mesh,
        )
        am(model.posterior, model.config, "EI", pars)  # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            am(model.posterior, model.config, "EI", pars)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    print("# SCALING — particle-sharded acquisition argmax\n")
    print("Simulated mesh: host CPU split into 8 XLA devices "
          "(`--xla_force_host_platform_device_count=8`). CMA engine, 64 "
          "generations, EI on a GP posterior at n=256, d=5.\n")

    total = 2048
    print(f"## Strong scaling (fixed total population {total})\n")
    print("| devices | time (s) | speedup | efficiency |")
    print("|---|---|---|---|")
    t1 = None
    for nd in (1, 2, 4, 8):
        t = bench(nd, total)
        t1 = t1 or t
        s = t1 / t
        print(f"| {nd} | {t:.3f} | {s:.2f}x | {100*s/nd:.0f}% |")

    per_dev = 512
    print(f"\n## Weak scaling ({per_dev} chains per device)\n")
    print("| devices | population | time (s) | efficiency |")
    print("|---|---|---|---|")
    t1 = None
    for nd in (1, 2, 4, 8):
        t = bench(nd, per_dev * nd)
        t1 = t1 or t
        print(f"| {nd} | {per_dev*nd} | {t:.3f} | {100*t1/t:.0f}% |")

    # -- what the simulated-mesh efficiencies are made of -----------------
    # (a) per-generation work-size sweep at 8 devices: if the inefficiency
    # were communication, it would not shrink as per-generation work grows;
    # if it is shared-host compute + fixed per-program overhead, efficiency
    # climbs with work size.
    print("\n## Weak-scaling efficiency vs per-generation work (8 devices)\n")
    print("| GP n_obs | chains/device | 1-dev time | 8-dev time | efficiency |")
    print("|---|---|---|---|---|")
    for n_obs in (256, 1024):
        g, p = make_gp(n_obs)
        for cpd in (64, 512):
            ta = bench(1, cpd, model=g, pars=p)
            tb = bench(8, cpd * 8, model=g, pars=p)
            print(f"| {n_obs} | {cpd} | {ta:.3f} | {tb:.3f} | {100*ta/tb:.0f}% |")

    # (b) fixed-overhead decomposition: time(g generations) is affine in g,
    # so two generation counts separate per-generation compute from the
    # per-call overhead (dispatch + final reduce + host round trip).
    print("\n## Per-call overhead vs per-generation compute (population 4096)\n")
    print("| devices | per-generation (ms) | fixed per-call (ms) |")
    print("|---|---|---|")
    for nd in (1, 8):
        t8 = bench(nd, 4096, n_gen=8)
        t64 = bench(nd, 4096, n_gen=64)
        per_gen = (t64 - t8) / 56.0
        fixed = t8 - 8.0 * per_gen
        print(f"| {nd} | {1e3*per_gen:.2f} | {1e3*max(fixed,0):.2f} |")


if __name__ == "__main__":
    main()
