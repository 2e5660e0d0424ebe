"""Blocked Cholesky: factor, triangular solves and explicit inverse as GEMMs.

The GP likelihood and posterior need a Cholesky factor of the correlation
matrix, solves against it, and gradients through both (the reference does
this with LAPACK, ref: bayes_optim/surrogate/gaussian_process/gpr.py:790-811).
This module does it with a fixed-shape blocked algorithm built only from
`lax` loops and matrix products:

- `chol_and_inv(R)` returns (L, L_inv, min_pivot) for SPD R — min_pivot
  is the smallest raw Cholesky pivot BEFORE clamping; callers MUST treat
  min_pivot <= ~0 as a failed factorization (the GP likelihood folds it
  into its 1e12 penalty). Structure:
  * panel loop (`lax.fori_loop`, n/128 iterations) with an unblocked
    128-wide Cholesky (`fori_loop` over columns) per diagonal block;
  * explicit L^-1 via the block-nilpotent identity: with D the block
    diagonal of L and N = D^-1 L (unit block triangular, S = N - I
    nilpotent with S^(n/128) = 0),  N^-1 = prod_k (I + (-S)^(2^k)) —
    log2(n/128) squaring rounds of full-size matmuls;
  * a closed-form custom VJP (Iain Murray, "Differentiation of the
    Cholesky decomposition", 2016, eq. 8 plus the d(L^-1) term), all GEMMs
    against the saved L_inv.
- `whiten(R, B)` returns (diag_L, L^-1 B, min_pivot) without forming L^-1,
  with a custom VJP built from the same blocked solves.

The generated code does not grow with n, every function vmaps over a batch
of hyperparameter vectors, and with L_inv explicit every downstream
whitening solve (L^-1 y, L^-1 F, L^-T rho) is a plain matmul. Accuracy: an
explicit triangular inverse is not backward-stable for ill-conditioned L,
but the GP likelihood already guards non-finite values and escalates the
nugget (models/gp.py). Validated against float64 numpy (tests/test_linalg.py).

Precision: every matmul here runs at "highest". On GPUs the default float32
matmul precision may use TF32 tensor-core passes, which keep 10 mantissa
bits; that is too coarse for triangular factors, inverses and the
likelihood gradient built from them at the nuggets GP fits use.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

BLOCK = 128


def _chol_unblocked(S: jnp.ndarray):
    """Cholesky of a small SPD block by the Cholesky-Banachiewicz column
    sweep as a fori_loop — O(1) generated code, vectorizes under vmap.

    Returns (L, min_pivot) where min_pivot is the smallest raw pivot
    sjj - rj.rj BEFORE clamping: the clamp keeps an indefinite pivot from
    cascading into overflow/NaN in the nilpotent-squaring inverse, but a
    clamped factorization is WRONG — callers must treat min_pivot <= ~0 as
    a failed factorization (the GP likelihood folds it into its 1e12
    penalty so nugget escalation still fires)."""
    b = S.shape[-1]
    iota = jnp.arange(b)

    def body(j, carry):
        L, piv = carry
        row = jax.lax.dynamic_slice(L, (j, 0), (1, b))[0]
        rj = row * (iota < j).astype(S.dtype)
        sjj = jax.lax.dynamic_slice(S, (j, j), (1, 1))[0, 0]
        raw = sjj - jnp.dot(rj, rj)
        d = jnp.sqrt(jnp.maximum(raw, 1e-12))
        scol = jax.lax.dynamic_slice(S, (0, j), (b, 1))[:, 0]
        c = (scol - L @ rj) / d
        col = jnp.where(iota == j, d, jnp.where(iota > j, c, 0.0))
        return (
            jax.lax.dynamic_update_slice(L, col[:, None], (0, j)),
            jnp.minimum(piv, raw),
        )

    init = (jnp.zeros_like(S), jnp.asarray(jnp.inf, S.dtype))
    return jax.lax.fori_loop(0, b, body, init)


def _tri_inv_unblocked(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a small lower-triangular block via nilpotent squaring:
    L = D(I + S) with S strictly lower => (I + S)^-1 = prod (I + (-S)^(2^k)).
    log2(b) rounds of (b, b) matmuls."""
    b = L.shape[-1]
    dinv = 1.0 / jnp.diagonal(L)
    N = L * dinv[:, None]
    eye = jnp.eye(b, dtype=L.dtype)
    T = eye - N  # == -S, strictly lower
    R = eye + T
    P = T
    for _ in range(max(0, int(math.ceil(math.log2(b))) - 1)):
        P = P @ P
        R = R + R @ P
    return R * dinv[None, :]


def _block_diag_apply(Binv: jnp.ndarray, L: jnp.ndarray, side: str) -> jnp.ndarray:
    """Multiply by a block-diagonal matrix stored as (nb, b, b) batches."""
    n = L.shape[-1]
    nb, b = Binv.shape[0], Binv.shape[1]
    if side == "left":  # D^-1 @ L : scale row blocks
        return jnp.einsum("kij,kjn->kin", Binv, L.reshape(nb, b, n)).reshape(n, n)
    # L @ D^-1 : scale column blocks
    return jnp.einsum("nkj,kji->nki", L.reshape(n, nb, b), Binv).reshape(n, n)


def _factor(R: jnp.ndarray):
    """Blocked Cholesky returning (L, Dinv, min_pivot) where Dinv stacks the
    inverses of the 128-wide diagonal blocks of L (free by-products of the
    panel loop, reused by every subsequent triangular solve) and min_pivot
    is the smallest raw pivot before clamping (see _chol_unblocked)."""
    n = R.shape[-1]
    dtype = R.dtype
    if n <= BLOCK:
        L, piv = _chol_unblocked(R)
        return L, _tri_inv_unblocked(L)[None], piv
    assert n % BLOCK == 0, f"_factor requires n % {BLOCK} == 0, got {n}"
    nb = n // BLOCK
    iota = jnp.arange(n)

    def panel(j, carry):
        L, Dinv, piv = carry
        jb = j * BLOCK
        colmask = (iota < jb).astype(dtype)
        Lrow = jax.lax.dynamic_slice(L, (jb, 0), (BLOCK, n)) * colmask[None, :]
        S = jax.lax.dynamic_slice(R, (jb, jb), (BLOCK, BLOCK)) - Lrow @ Lrow.T
        Ljj, pj = _chol_unblocked(S)
        Ljj_inv = _tri_inv_unblocked(Ljj)
        Rcol = jax.lax.dynamic_slice(R, (0, jb), (n, BLOCK))
        C = Rcol - (L * colmask[None, :]) @ Lrow.T
        P = (C @ Ljj_inv.T) * (iota >= jb + BLOCK).astype(dtype)[:, None]
        P = jax.lax.dynamic_update_slice(P, Ljj, (jb, 0))
        return (
            jax.lax.dynamic_update_slice(L, P, (0, jb)),
            jax.lax.dynamic_update_slice(Dinv, Ljj_inv[None], (j, 0, 0)),
            jnp.minimum(piv, pj),
        )

    L0 = jnp.zeros_like(R)
    D0 = jnp.zeros((nb, BLOCK, BLOCK), dtype)
    piv0 = jnp.asarray(jnp.inf, dtype)
    return jax.lax.fori_loop(0, nb, panel, (L0, D0, piv0))


def _block_tri_inv(L: jnp.ndarray, Dinv: jnp.ndarray) -> jnp.ndarray:
    """Explicit L^-1 from a blocked factor (L, Dinv) by block-nilpotent
    squaring — log2(nb) full GEMMs, no column loop (the diagonal-block
    inverses are already in Dinv)."""
    n = L.shape[-1]
    nb = Dinv.shape[0]
    if nb == 1:
        return Dinv[0]
    N = _block_diag_apply(Dinv, L, "left")  # unit block-lower
    eye = jnp.eye(n, dtype=L.dtype)
    T = eye - N  # -S, strictly block-lower, T^(nb) = 0
    Rm = eye + T
    P = T
    for _ in range(max(0, int(math.ceil(math.log2(nb))) - 1)):
        P = P @ P
        Rm = Rm + Rm @ P
    return _block_diag_apply(Dinv, Rm, "right")


def _chol_and_inv_impl(R: jnp.ndarray):
    with jax.default_matmul_precision("highest"):
        L, Dinv, piv = _factor(R)
        return L, _block_tri_inv(L, Dinv), piv


@jax.custom_vjp
def chol_and_inv(R: jnp.ndarray):
    """(L, L_inv, min_pivot) of SPD R with O(1)-size generated code and a
    GEMM-only VJP. min_pivot <= ~0 means the clamped factorization is wrong
    (see _chol_unblocked) — callers must check it, not assume SPD."""
    return _chol_and_inv_impl(R)


def _fwd(R):
    L, L_inv, piv = _chol_and_inv_impl(R)
    return (L, L_inv, piv), (L, L_inv)


def _bwd(res, cots):
    L, Li = res
    Lb, Lib, _pivb = cots  # min_pivot is a diagnostic: no gradient flow
    with jax.default_matmul_precision("highest"):
        # cotangent contribution of L_inv: d(L^-1) = -L^-1 dL L^-1
        Lb_total = jnp.tril(Lb) - jnp.tril(Li.T @ Lib @ Li.T)
        M = L.T @ Lb_total
        Phi = jnp.tril(M) - 0.5 * jnp.diag(jnp.diagonal(M))
        Rb = Li.T @ Phi @ Li
        return (0.5 * (Rb + Rb.T),)


chol_and_inv.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# factor + solve without the full inverse: the likelihood hot path.
# One likelihood eval needs L^-1 [Y F] (a handful of columns) and diag(L);
# materializing the full L^-1 per eval costs ~6 extra full-size GEMMs.
# `whiten` factors once and forward-substitutes block-wise, with a custom
# VJP built from the same blocked solves (GEMM-only, no O(n^2) scan
# residuals).
# ---------------------------------------------------------------------------


def tri_solve_lower(L: jnp.ndarray, Dinv: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve L X = B by blocked forward substitution (compact fori_loop)."""
    n = L.shape[-1]
    nb = Dinv.shape[0]
    b = n // nb
    iota = jnp.arange(n)
    dtype = L.dtype

    def body(j, X):
        jb = j * b
        colmask = (iota < jb).astype(dtype)
        Lrow = jax.lax.dynamic_slice(L, (jb, 0), (b, n)) * colmask[None, :]
        Bj = jax.lax.dynamic_slice(B, (jb, 0), (b, B.shape[1])) - Lrow @ X
        Xj = jax.lax.dynamic_index_in_dim(Dinv, j, keepdims=False) @ Bj
        return jax.lax.dynamic_update_slice(X, Xj, (jb, 0))

    return jax.lax.fori_loop(0, nb, body, jnp.zeros_like(B))


def tri_solve_upper_t(L: jnp.ndarray, Dinv: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T X = B by blocked backward substitution (compact)."""
    n = L.shape[-1]
    nb = Dinv.shape[0]
    b = n // nb
    iota = jnp.arange(n)
    dtype = L.dtype

    def body(i, X):
        j = nb - 1 - i
        jb = j * b
        rowmask = (iota >= jb + b).astype(dtype)
        Lcol = jax.lax.dynamic_slice(L, (0, jb), (n, b)) * rowmask[:, None]
        Bj = jax.lax.dynamic_slice(B, (jb, 0), (b, B.shape[1])) - Lcol.T @ X
        Xj = jax.lax.dynamic_index_in_dim(Dinv, j, keepdims=False).T @ Bj
        return jax.lax.dynamic_update_slice(X, Xj, (jb, 0))

    return jax.lax.fori_loop(0, nb, body, jnp.zeros_like(B))


def _whiten_parts(R, B):
    """Shared fwd implementation: returns (d, W, piv) + residuals (L, Dinv, W)."""
    with jax.default_matmul_precision("highest"):
        L, Dinv, piv = _factor(R)
        W = tri_solve_lower(L, Dinv, B)
    return (jnp.diagonal(L), W, piv), (L, Dinv, W)


@jax.custom_vjp
def whiten(R: jnp.ndarray, B: jnp.ndarray):
    """(diag(L), L^-1 B, min_pivot) for SPD R = L L^T — the entire
    GP-likelihood linear algebra in O(1) generated code with a GEMM-only
    VJP. min_pivot <= ~0 flags a clamped (wrong) factorization; the
    likelihood folds it into its 1e12 penalty."""
    out, _ = _whiten_parts(R, B)
    return out


def _whiten_fwd(R, B):
    return _whiten_parts(R, B)


def _whiten_bwd(res, cots):
    L, Dinv, W = res
    dbar, Wbar, _pivb = cots  # min_pivot is a diagnostic: no gradient flow
    with jax.default_matmul_precision("highest"):
        U = tri_solve_upper_t(L, Dinv, Wbar)  # L^-T Wbar
        Lbar = jnp.diag(dbar) - jnp.tril(U @ W.T)
        M = L.T @ Lbar
        Phi = jnp.tril(M) - 0.5 * jnp.diag(jnp.diagonal(M))
        Y1 = tri_solve_upper_t(L, Dinv, Phi)        # L^-T Phi
        Y2 = tri_solve_upper_t(L, Dinv, Y1.T).T     # (L^-T Phi) L^-1
        Rbar = 0.5 * (Y2 + Y2.T)
    return Rbar, U


whiten.defvjp(_whiten_fwd, _whiten_bwd)


def chol_inv_whiten(R: jnp.ndarray, B: jnp.ndarray):
    """(L, L_inv, W, piv) — factor, explicit inverse AND solve W = L^-1 B,
    the three pieces the posterior state needs."""
    L, L_inv, piv = chol_and_inv(R)
    W = jnp.dot(L_inv, B, precision=jax.lax.Precision.HIGHEST)
    return L, L_inv, W, piv
