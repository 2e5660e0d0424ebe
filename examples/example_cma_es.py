"""Standalone (1+1)-Cholesky-CMA-ES on a 30-D sphere (capability analog of
ref example/example_CMA_ES.py). This engine runs a batch of
vectorized chains in one XLA program; the host objective is called once per
generation on the whole batch."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import numpy as np

from bayesian_optimization_tpu import RealSpace
from bayesian_optimization_tpu.optim.cma import OnePlusOne_Cholesky_CMA


def obj_fun(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def main():
    opt = OnePlusOne_Cholesky_CMA(
        search_space=RealSpace([-5, 5]) * 30,
        obj_fun=obj_fun,
        sigma0=40,
        ftarget=1e-8,
        max_FEs=int(1e5),
        verbose=True,
    )
    opt.run()
    print("fopt:", opt.fopt)
    print("evals:", opt.eval_count)


if __name__ == "__main__":
    main()
