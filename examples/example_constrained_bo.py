"""Constrained Bayesian optimization: eq/ineq constraints ride INSIDE the
fused acquisition argmax.

Mirrors the reference's constrained usage (ref: unittest/test_constraint.py:
29-83): `BO(eq_fun=h)` / `BO(ineq_fun=g)`. Difference: the user's
constraint callables are traced into the jitted argmax program when possible
(exact autodiff penalty gradients for the BFGS engine; see
optim/constraints.ConstraintProgram) and the DoE comes from the constrained
SCMC sampler — so every proposed point, from the first design to the last
model-driven ask, respects the constraints.

Run: JAX_PLATFORM_NAME=cpu python examples/example_constrained_bo.py
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bayesian_optimization_tpu import BO, GaussianProcess, IntegerSpace, RandomForest, RealSpace


def main():
    # ---- equality constraint: minimize on the plane x0 + x1 = 1
    def obj(x):
        return np.sum(np.asarray(x) ** 2) + 5 * np.sum(np.asarray(x)) + 10

    def h(x):
        return np.sum(x) - 1  # np.sum on the traced vector: runs in-program

    dim = 2
    opt = BO(
        search_space=RealSpace([0, 1]) * dim,
        obj_fun=obj,
        eq_fun=h,
        model=GaussianProcess(
            corr="squared_exponential", thetaL=1e-5 * np.ones(dim),
            thetaU=np.ones(dim), nugget=1e-1, random_state=42,
        ),
        max_FEs=20, DoE_size=3,
        acquisition_fun="MGFI", acquisition_par={"t": 2},
        acquisition_optimization={"optimizer": "BFGS"},
        random_seed=42,
    )
    xopt, fopt, _ = opt.run()
    print(f"[eq] xopt={xopt} fopt={fopt} |h|={abs(h(np.asarray(xopt, float))):.4f}")

    # ---- inequality constraints on a mixed space with dict-style callables
    def obj2(x):
        return (x["pc"] - 0.2) ** 2 + x["mu"] + abs(x["p"] - 0.7)

    def g(x):  # feasible iff pc >= 0 and mu <= 1.9 (so mu == 1)
        return [-x["pc"], x["mu"] - 1.9]

    space = (
        IntegerSpace([1, 10], var_name="mu")
        + RealSpace([0, 1], var_name="pc")
        + RealSpace([0.005, 0.5], var_name="p")
    )
    opt2 = BO(
        search_space=space, obj_fun=obj2, ineq_fun=g,
        model=RandomForest(levels=space.levels),
        max_FEs=12, DoE_size=4, eval_type="dict",
        acquisition_fun="MGFI", acquisition_par={"t": 2}, random_seed=42,
    )
    xopt2, fopt2, _ = opt2.run()
    xd = xopt2[0] if isinstance(xopt2[0], dict) else dict(zip(space.var_name, xopt2[0]))
    print(f"[ineq] xopt={xd} fopt={fopt2} g={g(xd)}")


if __name__ == "__main__":
    main()
