"""Constraint programs for the fused acquisition argmax.

Capability parity with the reference's in-argmax constraint handling
(ref: bayes_optim/acquisition/optim/__init__.py:33-52 `Penalized` dynamic
penalty on the criterion, :124-126 feasibility filter on restart winners):
a user's black-box ``h``/``g`` callables are compiled once into *batched*
evaluators over the unit cube so the penalty rides inside the single jitted
argmax program.

Accelerator design: the reference re-evaluates the penalty point-by-point on
the host and finite-differences its gradient for BFGS. Here constraints are
traced into the XLA program whenever the user's callable is jax-traceable
(then the penalty gradient is exact via autodiff, batched over the whole
restart/chain population); otherwise they run as one host callback per
criterion evaluation (`jax.pure_callback`) and the BO loop falls back to a
derivative-free engine.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.exceptions import ConstraintEvaluationError
from ..utils.penalty import dynamic_penalty

#: feasibility tolerance on |h| for preferring restart winners
#: (ref parity: optim/__init__.py:124 `atol=1e-1`)
H_FEAS_ATOL = 1e-1


class ConstraintProgram:
    """Batched unit-cube evaluators for eq/ineq constraints.

    For each callable we first try to TRACE it on jax values (the raw
    decode `SpaceEncoding.unit_to_raw` is jittable for numeric variables,
    and plain-Python / numpy-method arithmetic traces), validate the traced
    values against the host decoder on probe points, and only fall back to
    a `jax.pure_callback` host loop when tracing fails or disagrees.

    Instances are immutable after construction and hashable by identity so
    they can ride as static arguments of the jitted argmax wrappers.
    """

    def __init__(
        self,
        encoding,
        h: Optional[Callable] = None,
        g: Optional[Callable] = None,
        eval_type: str = "list",
        var_names=None,
    ):
        self.encoding = encoding
        self.h = h
        self.g = g
        self.eval_type = eval_type
        self.var_names = list(var_names or [v.name for v in encoding.space.data])
        self.dtype = encoding.dtype

        # probe on one host-decoded point: determines output arity and
        # surfaces crashing constraints eagerly
        # (ref parity: utils/utils.py:328-336 ConstraintEvaluationError)
        U0 = np.full((1, encoding.dim), 0.5)
        self.n_h = self._probe(h, U0)
        self.n_g = self._probe(g, U0)

        self._h_traced = self._try_trace(h, self.n_h) if h is not None else None
        self._g_traced = self._try_trace(g, self.n_g) if g is not None else None

    # ------------------------------------------------------------- host path
    def _make_arg(self, row):
        """Build the user-visible argument from one row of per-variable
        values (host objects or traced scalars)."""
        vals = list(row)
        if self.eval_type == "dict":
            return dict(zip(self.var_names, vals))
        return vals

    def _host_batch(self, fn: Callable, n_out: int, U_np) -> np.ndarray:
        X = self.encoding.decode_unit(np.asarray(U_np, dtype=float))
        out = np.empty((len(X), n_out), dtype=float)
        for i, row in enumerate(X):
            out[i] = np.atleast_1d(np.asarray(fn(self._make_arg(row)), dtype=float))
        return out

    def _probe(self, fn: Optional[Callable], U0) -> int:
        if fn is None:
            return 0
        try:
            row = self.encoding.decode_unit(U0)[0]
            v = np.atleast_1d(np.asarray(fn(self._make_arg(row)), dtype=float))
        except Exception as e:  # noqa: BLE001 - any user crash => parity error
            raise ConstraintEvaluationError(
                f"constraint {getattr(fn, '__name__', fn)!r} failed on a probe "
                f"point: {e}"
            ) from None
        return int(v.size)

    # ----------------------------------------------------------- traced path
    def _try_trace(self, fn: Callable, n_out: int) -> Optional[Callable]:
        """Return a per-row traced evaluator or None (=> host callback)."""

        def traced_row(u_row):
            raw = self.encoding.unit_to_raw(u_row[None, :])[0]
            if self.eval_type == "dict":
                arg = dict(zip(self.var_names, [raw[j] for j in range(self.encoding.dim)]))
            else:
                # hand the traced vector itself: indexing, iteration, len()
                # and numpy METHOD dispatch (np.sum etc.) all trace
                arg = raw
            return jnp.atleast_1d(jnp.asarray(fn(arg), dtype=self.dtype)).reshape(n_out)

        try:
            jax.eval_shape(traced_row, jax.ShapeDtypeStruct((self.encoding.dim,), self.dtype))
        except Exception:  # noqa: BLE001 - non-traceable user code
            return None
        # numeric validation vs the host decoder (catches NaN columns from
        # non-numeric variables and precision-rounding semantics)
        rng = np.random.default_rng(0)
        U = rng.uniform(0.05, 0.95, (4, self.encoding.dim))
        try:
            got = np.asarray(jax.jit(jax.vmap(traced_row))(jnp.asarray(U, self.dtype)))
            want = self._host_batch(fn, n_out, U)
        except Exception:  # noqa: BLE001
            return None
        if not np.all(np.isfinite(got)) or not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            return None
        return traced_row

    @property
    def traceable(self) -> bool:
        """True iff every constraint runs in-program (=> autodiff gradients
        exist and gradient-based argmax engines are usable)."""
        ok_h = self.h is None or self._h_traced is not None
        ok_g = self.g is None or self._g_traced is not None
        return ok_h and ok_g

    # -------------------------------------------------------- batched eval
    def _unit_vals(self, fn, traced, n_out, U: jnp.ndarray) -> jnp.ndarray:
        if traced is not None:
            return jax.vmap(traced)(U)
        P = U.shape[0]
        return jax.pure_callback(
            lambda u: self._host_batch(fn, n_out, u).astype(np.float32),
            jax.ShapeDtypeStruct((P, n_out), jnp.float32),
            U,
            vmap_method="sequential",
        ).astype(U.dtype)

    def h_unit(self, U: jnp.ndarray) -> Optional[jnp.ndarray]:
        if self.h is None:
            return None
        return self._unit_vals(self.h, self._h_traced, self.n_h, U)

    def g_unit(self, U: jnp.ndarray) -> Optional[jnp.ndarray]:
        if self.g is None:
            return None
        return self._unit_vals(self.g, self._g_traced, self.n_g, U)

    def penalty(self, U: jnp.ndarray, t) -> jnp.ndarray:
        """Positive dynamic-penalty values for a unit batch (P, dim) -> (P,)
        (ref parity: utils/utils.py:272-344 via utils/penalty.py)."""
        return dynamic_penalty(self.h_unit(U), self.g_unit(U), t, minimize=True)

    def feasible_in_program(self, U: jnp.ndarray) -> jnp.ndarray:
        """Boolean mask (P,): |h| <= 0.1 per-component and g <= 0
        (ref parity: optim/__init__.py:124-126)."""
        feas = jnp.ones(U.shape[0], dtype=bool)
        hv = self.h_unit(U)
        if hv is not None:
            feas &= jnp.all(jnp.abs(hv) <= H_FEAS_ATOL, axis=-1)
        gv = self.g_unit(U)
        if gv is not None:
            feas &= jnp.all(gv <= 0.0, axis=-1)
        return feas

    # -------------------------------------------------------------- host API
    def feasible_rows(self, rows) -> np.ndarray:
        """Host-side winner filter over raw pheno rows (list of lists)."""
        out = np.ones(len(rows), dtype=bool)
        for i, row in enumerate(rows):
            arg = self._make_arg(list(row))
            try:
                if self.h is not None:
                    hv = np.atleast_1d(np.asarray(self.h(arg), dtype=float))
                    out[i] &= bool(np.all(np.abs(hv) <= H_FEAS_ATOL))
                if self.g is not None:
                    gv = np.atleast_1d(np.asarray(self.g(arg), dtype=float))
                    out[i] &= bool(np.all(gv <= 0.0))
            except Exception as e:  # noqa: BLE001
                raise ConstraintEvaluationError(
                    f"constraint evaluation failed on {row}: {e}"
                ) from None
        return out

    # identity hash/eq: immutable after build => usable as a jit-static arg
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
