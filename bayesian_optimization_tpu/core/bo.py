"""BO flavors: sequential, batch-sequential, annealing, self-adaptive, noisy.

Capability parity with the reference's optimizer classes
(ref: bayes_optim/bayes_opt.py:15-194):
- `BO` — sequential; plugin injection into improvement criteria and the
  duplicate filter (handled in BaseBO.pre_eval_check here).
- `ParallelBO` — q-point batch ask by sampling the acquisition
  hyperparameter: log-normal `t` for MGFI, logit-normal `alpha` for UCB
  (bayes_opt.py:82-94).
- `AnnealingBO` — exp/linear/log schedules on MGFI's t (bayes_opt.py:118-143).
- `SelfAdaptiveBO` — t adapted to the mean of the top half (bayes_opt.py:152-174).
- `NoisyBO` — plugin from model *predictions*, duplicates allowed
  (bayes_opt.py:177-194).

Accelerator design: the q sampled criteria become a leading batch axis of ONE
jitted argmax program — q criteria x chains x generations all advance
together — rather than the reference's joblib process pool over restarts.
"""
from __future__ import annotations

from copy import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.acquisition import MGFI_T_MAX
from .base import BaseBO


class BO(BaseBO):
    """Sequential Bayesian optimization (ref parity: bayes_opt.py:15-55)."""


class ParallelBO(BO):
    """Batch-sequential BO via acquisition-parameter sampling
    (ref parity: bayes_opt.py:58-115)."""

    def __init__(self, n_point: int = 3, acquisition_fun: str = "MGFI",
                 acquisition_par: Optional[dict] = None, **kwargs):
        if acquisition_par is None and acquisition_fun == "MGFI":
            acquisition_par = {"t": 2.0}
        super().__init__(
            n_point=n_point, acquisition_fun=acquisition_fun,
            acquisition_par=acquisition_par, **kwargs,
        )
        if self.n_point <= 1:
            raise ValueError("ParallelBO requires n_point > 1")
        if self.acquisition_fun == "MGFI":
            self._par_name = "t"
            self._acquisition_par.setdefault("t", 1.0)
            self._sampler = lambda par: float(
                np.exp(np.log(par["t"]) + 0.5 * self._rng.standard_normal())
            )
        elif self.acquisition_fun == "UCB":
            self._par_name = "alpha"
            self._acquisition_par.setdefault("alpha", 0.5)
            self._sampler = lambda par: float(
                1.0 / (1.0 + np.exp((par["alpha"] * 4.0 - 2.0) + 0.6 * self._rng.standard_normal()))
            )
        else:
            raise NotImplementedError(
                f"parameter sampling not defined for {self.acquisition_fun!r}"
            )

    def _sample_par_batch(self, n_point: int) -> List[dict]:
        out = []
        for _ in range(n_point):
            par = copy(self._acquisition_par)
            par[self._par_name] = self._sampler(self._acquisition_par)
            out.append(self._acq_par_defaults(par))
        return out

    def _batch_arg_max_acquisition(self, n_point: int, fixed_units):
        """All q parameter-sampled criteria maximized in ONE jitted program
        (the reference forks a joblib pool per criterion, bayes_opt.py:108-111)."""
        pars = self._sample_par_batch(n_point)
        self._last_batch_pars = pars
        us, vals = self._argmax.batch(
            self.model.posterior, self.model.config, self.acquisition_fun,
            pars, minimize=self.minimize, fixed=fixed_units,
        )
        return us, vals


class AnnealingBO(ParallelBO):
    """MGFI t annealed towards tf over the run (ref parity: bayes_opt.py:118-143)."""

    def __init__(self, t0: float = 2.0, tf: float = 1e-1, schedule: str = "exp", **kwargs):
        super().__init__(**kwargs)
        self.t0, self.tf, self.schedule = t0, tf, schedule
        self._acquisition_par["t"] = t0
        max_iter = max(1.0, (self.max_FEs - self._DoE_size) / self.n_point) if np.isfinite(self.max_FEs) else 100.0
        if schedule == "exp":
            alpha = (tf / t0) ** (1.0 / max_iter)
            self._annealer = lambda t: t * alpha
        elif schedule == "linear":
            eta = (t0 - tf) / max_iter
            self._annealer = lambda t: max(t - eta, tf)
        elif schedule == "log":
            c = tf * np.log(max_iter + 1.0)
            self._annealer = lambda t: t * c / np.log(self.iter_count + 2.0)
        else:
            raise NotImplementedError(f"unknown schedule {schedule!r}")
        self._acquisition_callbacks.append(
            lambda: self._acquisition_par.update(t=min(self._annealer(self._acquisition_par["t"]), MGFI_T_MAX))
        )


class SelfAdaptiveBO(ParallelBO):
    """t adapted from the top half of the batch (ref parity: bayes_opt.py:152-174)."""

    def _batch_arg_max_acquisition(self, n_point: int, fixed_units):
        """All q t-sampled criteria in ONE jitted program (same fused path
        as ParallelBO; the adaptation of t happens on the returned values)."""
        N = max(1, n_point // 2)
        ts, pars = [], []
        for _ in range(n_point):
            t = float(np.exp(self._acquisition_par["t"] * self._rng.standard_normal()))
            ts.append(t)
            par = copy(self._acquisition_par)
            par["t"] = t
            pars.append(self._acq_par_defaults(par))
        us, values = self._argmax.batch(
            self.model.posterior, self.model.config, self.acquisition_fun,
            pars, minimize=self.minimize, fixed=fixed_units,
        )
        top = np.argsort(values)[::-1][:N]
        self._acquisition_par["t"] = min(float(np.mean([ts[i] for i in top])), MGFI_T_MAX)
        return us, values


class MultiAcquisitionBO(BO):
    """Batch points alternate between MGFI and UCB criteria round-robin,
    each with its own hyperparameter sampler
    (ref parity: bayes_optim/extension.py:309-353)."""

    def __init__(self, n_point: int = 2, **kwargs):
        kwargs.pop("acquisition_fun", None)
        super().__init__(n_point=n_point, acquisition_fun="MGFI", **kwargs)
        if self.n_point < 2:
            raise ValueError("MultiAcquisitionBO requires n_point >= 2")
        self._acquisition_pool = ["MGFI", "UCB"]
        self._pool_par = {"MGFI": {"t": 1.0}, "UCB": {"alpha": 0.5}}
        self._pool_sampler = {
            "MGFI": lambda par: {"t": float(np.exp(np.log(par["t"]) + 0.5 * self._rng.standard_normal()))},
            "UCB": lambda par: {
                "alpha": float(1.0 / (1.0 + np.exp((par["alpha"] * 4.0 - 2.0) + 0.6 * self._rng.standard_normal())))
            },
        }

    def _batch_arg_max_acquisition(self, n_point: int, fixed_units):
        """Round-robin criteria grouped per acquisition NAME, each group
        maximized as ONE jitted batch program (the acquisition function is
        jit-static, so q points cost at most len(pool)=2 program launches
        instead of q)."""
        slots = [
            self._acquisition_pool[i % len(self._acquisition_pool)]
            for i in range(n_point)
        ]
        candidates: List = [None] * n_point
        values: List = [None] * n_point
        for name in self._acquisition_pool:
            idx = [i for i, s in enumerate(slots) if s == name]
            if not idx:
                continue
            self.acquisition_fun = name
            try:
                pars = [
                    self._acq_par_defaults(self._pool_sampler[name](self._pool_par[name]))
                    for _ in idx
                ]
                us, vals = self._argmax.batch(
                    self.model.posterior, self.model.config, name,
                    pars, minimize=self.minimize, fixed=fixed_units,
                )
            finally:
                self.acquisition_fun = "MGFI"
            for j, u, v in zip(idx, us, vals):
                candidates[j] = u
                values[j] = v
        return candidates, values


class NoisyBO(ParallelBO):
    """BO for noisy objectives (ref parity: bayes_opt.py:177-194): duplicates
    allowed, plugin comes from model predictions rather than observations."""

    def pre_eval_check(self, X: List) -> List:
        return [list(r) for r in np.atleast_2d(np.asarray(X, dtype=object))] if len(X) else X

    def _acq_par_defaults(self, par: dict) -> dict:
        out = dict(par)
        if self.acquisition_fun in ("EI", "PI", "EpsilonPI", "MGFI"):
            y_hat = np.asarray(self.model.predict(self._model_features(self.data))).ravel()
            out["plugin"] = float(np.min(y_hat) if self.minimize else -np.max(y_hat))
        return out
