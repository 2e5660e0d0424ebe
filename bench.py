"""Headline benchmark: GP-fit + acquisition-argmax wall-clock per BO
iteration at n=1000 observations, 5-D.

Runs only on a GPU. Prints the device and the card's name and power limit
on stderr, then ONE JSON line on stdout:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup}

vs_baseline is the speedup over the CPU reference implementation
(wangronin/Bayesian-Optimization) with the same data/protocol, timed on a
CPU — see BASELINE.md "Measured reference timings".
"""
import json
import os
import sys
import time

_T0 = time.perf_counter()


def _mark(msg):
    # progress to stderr (stdout stays one pure JSON line): if a run is ever
    # killed by a timeout, the tail shows which phase stalled
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)

# Reference timing on a CPU (see BASELINE.md): seconds for one GP fit
# (concentrated MLE, 10 restarts, budget 100*d) + one EI argmax (BFGS, 25
# restarts, budget 500) at n=1000, d=5.
REF_SECONDS = float(os.environ.get("BENCH_REF_SECONDS", "447.8"))

N_OBS = 1000
DIM = 5
N_REPEATS = int(os.environ.get("BENCH_REPEATS", "7"))


def _bench_data(n_obs):
    """Shared bench problem: X ~ U[0,1]^d, y = sum(sin(3x)) + noise, standardized."""
    import numpy as np

    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (n_obs, DIM))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n_obs)
    return X, (y - y.mean()) / y.std()


def _measure(one_iter):
    """Warm up twice, then time N_REPEATS iterations; returns a stats dict
    (median is the headline, min the code's floor)."""
    import numpy as np

    _mark("setup done; warm-up iterations (cold XLA compiles)")
    one_iter()
    # second warm-up: the FIRST iteration runs the cold-fit program path
    # (full MLE ladder); iteration two hits the warm-refit program, whose
    # own first compile must not pollute the measured reps
    one_iter()
    _mark("warm-up done; measuring")
    times = []
    for _ in range(N_REPEATS):
        t0 = time.perf_counter()
        one_iter()
        times.append(time.perf_counter() - t0)
    _mark(f"measured {[round(t, 3) for t in times]}")
    return {
        "median": float(np.median(times)),
        "min": float(np.min(times)),
        "times": [round(t, 4) for t in times],
    }


def main():
    import numpy as np

    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend
    from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax
    from bayesian_optimization_tpu.space import RealSpace

    X, y_std = _bench_data(N_OBS)
    gp = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    space = RealSpace([[0.0, 1.0]] * DIM)
    argmax = AcquisitionArgmax(space.encoding(), method="BFGS", n_restart=5 * DIM, seed=0)

    stats = _measure(lambda: (
        gp.fit(X, y_std),
        argmax(gp.posterior, gp.config, "EI", {"plugin": float(y_std.min())}),
    ))

    print(json.dumps({
        "metric": "gp_fit_plus_acq_argmax_per_iter_n1000_d5",
        "value": round(stats["median"], 4),
        "unit": "s",
        "vs_baseline": round(REF_SECONDS / stats["median"], 2),
        "min": round(stats["min"], 4),
        "times": stats["times"],
        "n_repeats": N_REPEATS,
    }))


def main_nuts():
    """NUTS-fit wall-clock at bench shapes (VERDICT round-3 item 3): is the
    north-star sampler usable at n=1000? Prints the same one-line JSON
    (vs_baseline compares to the same CPU-reference MLE fit+argmax — the
    reference has no sampler at all, so the MLE protocol is the only
    baseline that exists)."""
    import numpy as np

    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend
    from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax
    from bayesian_optimization_tpu.space import RealSpace

    X, y_std = _bench_data(N_OBS)
    gp = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_state=0, optimizer="NUTS",
    )
    gp.n_ensemble = 8
    space = RealSpace([[0.0, 1.0]] * DIM)
    argmax = AcquisitionArgmax(space.encoding(), method="BFGS", n_restart=5 * DIM, seed=0)
    stats = _measure(lambda: (
        gp.fit(X, y_std),
        argmax(gp.posterior, gp.config, "EI", {"plugin": float(y_std.min())}),
    ))
    # sampler-quality diagnostics from the last fit (round-5 verdict item 3):
    # accept rate per chain plus multi-chain ESS over the box draws
    from bayesian_optimization_tpu.models.hmc import effective_sample_size

    ess = effective_sample_size(gp.sample_chains_)
    print(json.dumps({
        "metric": "nuts_gp_fit_plus_acq_argmax_per_iter_n1000_d5",
        "value": round(stats["median"], 4),
        "unit": "s",
        "vs_baseline": round(REF_SECONDS / stats["median"], 2),
        "min": round(stats["min"], 4),
        "times": stats["times"],
        "accept_rate": [round(float(a), 3) for a in np.atleast_1d(gp.accept_rate_)],
        "ess": [round(float(e), 1) for e in ess],
        "n_draws": int(np.prod(gp.sample_chains_.shape[:2])),
    }))


def main_fit_n(n_obs: int):
    """GP-fit-only wall at arbitrary n (the n>1024 cliff measurement,
    VERDICT round-3 item 6)."""
    import numpy as np

    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend

    X, y_std = _bench_data(n_obs)
    gp = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    stats = _measure(lambda: gp.fit(X, y_std))
    print(json.dumps({
        "metric": f"gp_fit_per_iter_n{n_obs}_d5",
        "value": round(stats["median"], 4),
        "unit": "s",
        "vs_baseline": None,
        "min": round(stats["min"], 4),
        "times": stats["times"],
    }))


def _device_banner():
    """Refuse to run without a GPU; name the device and the card on stderr."""
    from benchmark.device import nvidia_smi_lines, require_gpu

    dev = require_gpu()
    _mark(f"device {dev}")
    for line in nvidia_smi_lines():
        _mark(f"card {line}")


if __name__ == "__main__":
    _device_banner()
    if "--nuts" in sys.argv:
        main_nuts()
    elif "--fit-n" in sys.argv:
        main_fit_n(int(sys.argv[sys.argv.index("--fit-n") + 1]))
    else:
        main()
