"""Float32 numerics on the GPU against float64 numpy (`card` marker).

On a GPU the default float32 matmul may run in TF32; these check that the
blocked Cholesky stack keeps the tolerances of tests/test_linalg.py there.
They skip without a GPU; `python chip_smoke.py` runs them on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_optimization_tpu.ops.linalg import chol_and_inv
from chip_smoke import easy_spd, kernel_matrix, whiten_precision_errors

pytestmark = pytest.mark.card


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("matrix", ["test_linalg_spd", "matern52_theta30"])
def test_whiten_value_and_grad_on_card(card, matrix, n):
    R = easy_spd(n, 4) if matrix == "test_linalg_spd" else kernel_matrix(n, 7, 30.0)
    B = np.random.default_rng(5).standard_normal((n, 2))
    ve, ge = whiten_precision_errors(R, B)
    assert ve <= 1e-2, ve
    assert ge <= 1e-3, ge


def test_chol_and_inv_on_card(card):
    n = 1024
    R = easy_spd(n, 0)
    L_ref = np.linalg.cholesky(np.asarray(R, np.float64))
    L, Li, piv = jax.jit(chol_and_inv)(jnp.asarray(R))
    rel = np.abs(np.asarray(L, np.float64) - L_ref).max() / np.abs(L_ref).max()
    assert rel < 1e-5, rel
    assert np.abs(np.asarray(Li, np.float64) @ L_ref - np.eye(n)).max() < 1e-4
    assert float(piv) > 0.0
