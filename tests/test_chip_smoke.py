"""chip_smoke.py and what it stands on, checked on the CPU: the script
refuses to run without a GPU, its float64 references agree with the
package, and the package's main path needs no optional dependency."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
from benchmark import reference as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_chip_smoke_refuses_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("kernel", ["matern", "matern52", "squared_exponential"])
@pytest.mark.parametrize("n", [24, 60])
def test_references_match_package(kernel, n):
    """benchmark/reference.py's float64 NLL and posterior mean agree with a
    fitted GaussianProcess at its own hyperparameters."""
    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend

    rng = np.random.default_rng(n)
    X = rng.uniform(0.0, 1.0, (n, 3))
    y = np.sin(3.0 * X).sum(1)
    y = (y - y.mean()) / y.std()
    gp = GaussianProcess(
        mean=constant_trend(3), corr=kernel, thetaL=1e-2 * np.ones(3),
        thetaU=1e2 * np.ones(3), nugget=1e-6, random_start=4, max_iter=15,
        random_state=0,
    )
    gp.fit(X, y)
    assert gp.fit_ok_
    Xq = rng.uniform(0.0, 1.0, (16, 3))
    nll, nll_ref, err, mu_err = chip_smoke.gp_reference_errors(gp, X, y, Xq)
    assert err <= 1e-3, (nll, nll_ref)
    assert mu_err <= 1e-2, mu_err


def test_main_path_without_optional_dependencies():
    """fmin runs with scikit-learn, dill, tabulate and joblib unimportable:
    they stay lazy and off the main path."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("sklearn", "dill", "tabulate", "joblib"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        from bayesian_optimization_tpu import fmin
        xopt, fopt, *_ = fmin(lambda x: float(np.sum(x ** 2)), [-5.0] * 2, [5.0] * 2,
                              max_FEs=12, seed=0)
        assert np.isfinite(fopt) and len(xopt) == 2
        assert not {"sklearn", "dill", "tabulate", "joblib"} & set(sys.modules)
        print("OK")
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and the package sets nothing;
    otherwise the cache is <checkout>/.jax_cache."""
    env = _env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = "import jax, bayesian_optimization_tpu; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path / "cache") if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want
