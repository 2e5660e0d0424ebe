"""Tests for the masked continuous embedding (no reference counterpart —
this layer is the array-first addition that makes everything XLA-compilable)."""
import jax
import jax.numpy as jnp
import numpy as np

from bayesian_optimization_tpu import (
    BoolSpace, DiscreteSpace, IntegerSpace, OrdinalSpace, RealSpace,
)


def mixed_space():
    return (
        RealSpace([1e-3, 1e3], var_name="lr", scale="log10")
        + IntegerSpace([0, 9], var_name="k")
        + DiscreteSpace(["a", "b", "c"], var_name="cat")
        + BoolSpace(var_name="flag")
        + OrdinalSpace(["s", "m", "l"], var_name="size")
    )


def test_embed_layout():
    enc = mixed_space().encoding()
    # lr(1) + k(1) + cat(one-hot 3) + flag(1) + size(1)
    assert enc.d_embed == 7
    assert enc.dim == 5


def test_unit_roundtrip_through_raw():
    cs = mixed_space()
    enc = cs.encoding()
    X = cs.sample(32)
    U = enc.encode_unit(X)
    X2 = enc.decode_unit(U)
    for a, b in zip(X.ravel(), X2.ravel()):
        if isinstance(a, float):
            assert np.isclose(a, float(b), rtol=1e-5)
        else:
            assert a == b


def test_quantize_idempotent():
    enc = mixed_space().encoding()
    key = jax.random.PRNGKey(0)
    U = enc.sample_unit(key, 16)
    Q = enc.quantize_unit(U)
    assert jnp.allclose(Q, enc.quantize_unit(Q), atol=1e-6)
    # quantized decode equals unquantized decode
    a = enc.decode_unit(np.asarray(U))
    b = enc.decode_unit(np.asarray(Q))
    for x, y in zip(a.ravel(), b.ravel()):
        if not isinstance(x, float):
            assert x == y


def test_embed_is_jittable_and_onehot():
    enc = mixed_space().encoding()
    f = jax.jit(enc.unit_to_embed)
    U = enc.sample_unit(jax.random.PRNGKey(1), 8)
    E = f(U)
    assert E.shape == (8, enc.d_embed)
    # the categorical block (cols 2:5) is exactly one-hot
    block = np.asarray(E[:, 2:5])
    assert np.allclose(block.sum(axis=1), 1.0)
    assert set(np.unique(block)).issubset({0.0, 1.0})


def test_lhs_unit_sampler():
    cs = RealSpace([[0, 1]] * 3, var_name="x")
    enc = cs.encoding()
    U = np.asarray(enc.sample_unit(jax.random.PRNGKey(2), 10, method="lhs"))
    for j in range(3):
        strata = np.floor(U[:, j] * 10).astype(int)
        assert sorted(strata.tolist()) == list(range(10))


def test_real_gradients_flow():
    cs = RealSpace([[0, 1]] * 2, var_name="x") + IntegerSpace([0, 5], var_name="k")
    enc = cs.encoding()

    def loss(u):
        return jnp.sum(enc.unit_to_embed(u) ** 2)

    g = jax.grad(loss)(jnp.full((1, 3), 0.4))
    assert np.all(np.isfinite(np.asarray(g)))
    assert abs(float(g[0, 0])) > 0  # real coords carry gradient


def test_unit_to_embed_np_matches_traced():
    """The host (numpy) embedding used by tell/update_model must match the
    jittable one used inside the argmax programs exactly."""
    cs = mixed_space()
    enc = cs.encoding()
    rng = np.random.default_rng(7)
    U = rng.uniform(0, 1, (37, enc.dim))
    E_np = enc.unit_to_embed_np(U)
    E_tr = np.asarray(jax.jit(enc.unit_to_embed)(jnp.asarray(U, enc.dtype)))
    assert E_np.shape == E_tr.shape
    assert np.allclose(E_np, E_tr, atol=1e-6)
