"""COCO/BBOB-compatible experiment data writer (.info / .dat / .tdat).

The reference harness logs every run through fgeneric's ``LoggingFunction``
(ref: benchmark/fgeneric.py:52-376), producing the three-file COCO layout
that ``cocopp`` post-processes:

* ``<alg>_f<ID>.info``     — index file: one header line per (function, dim)
  with ``funcId``/``DIM``/``Precision``/``algId``, a comment line, and the
  relative data-file path followed by ``, <instance>:<evals>|<final regret>``
  entries, one per run.
* ``data_f<ID>/*.dat``     — aligned by target: a line whenever the best
  noise-free regret improves past the next 10^(1/5) decade trigger
  (ref: fgeneric.py:43-46 — ``evalsTrigger``/``idealTrigger``).
* ``data_f<ID>/*.tdat``    — aligned by budget: a line whenever the
  evaluation counter crosses 10^(i/20) for integer i, plus the final
  evaluation (ref: fgeneric.py:44 ``nbPtsEvals = 20``).

Data lines carry ``evals | Δf | best Δf | measured f | best measured | x...``
in the exact column layout cocopp expects (ref: fgeneric.py:99-110).

This module is a fresh implementation from the file-format contract; it
shares no code with the vendored COCO sources.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np

_HEADER = (
    "%% function evaluation | noise-free fitness - Fopt (%13.12e) | "
    "best noise-free fitness - Fopt | measured fitness | "
    "best measured fitness | x1 | x2...\n"
)


def _fmt_line(n_evals: int, f: float, best_f: float, f_opt: float, x: Sequence[float]) -> str:
    cols = "%d %+10.9e %+10.9e %+10.9e %+10.9e" % (
        n_evals, f - f_opt, best_f - f_opt, f, best_f,
    )
    xs = "".join(" %+5.4e" % xi for xi in x)
    return cols + xs + "\n"


class COCORun:
    """Trace writer for one (function, instance) run; appends to the shared
    .dat/.tdat files and registers itself in the .info index on close."""

    def __init__(
        self,
        logger: "COCOExperimentLogger",
        instance: int,
        f_opt: float,
    ):
        self._logger = logger
        self.instance = instance
        self.f_opt = float(f_opt)
        self.n_evals = 0
        self.best_f = math.inf
        # .dat: next regret decade to cross (5 triggers per decade)
        self._f_trigger = math.inf
        # .tdat: next eval-count trigger 10^(i/20)
        self._evals_trigger_i = 0
        self._dat_buf: List[str] = [_HEADER % self.f_opt]
        self._tdat_buf: List[str] = [_HEADER % self.f_opt]
        self._last_line: Optional[str] = None
        self._last_written_tdat = -1

    def update(self, f: float, x: Sequence[float]) -> None:
        self.n_evals += 1
        improved = f < self.best_f
        if improved:
            self.best_f = f
        line = _fmt_line(self.n_evals, f, self.best_f, self.f_opt, x)
        self._last_line = line
        regret = self.best_f - self.f_opt
        if improved and (regret <= self._f_trigger or math.isinf(self._f_trigger)):
            self._dat_buf.append(line)
            if regret > 0:
                # next trigger: one fifth of a decade below the current regret
                self._f_trigger = 10 ** (math.floor(5 * math.log10(regret) - 1e-9) / 5.0)
            else:
                self._f_trigger = -math.inf
        while self.n_evals >= math.floor(10 ** (self._evals_trigger_i / 20.0)):
            trig = math.floor(10 ** (self._evals_trigger_i / 20.0))
            if self.n_evals == trig and self._last_written_tdat != self.n_evals:
                self._tdat_buf.append(line)
                self._last_written_tdat = self.n_evals
            self._evals_trigger_i += 1

    def finalize(self) -> None:
        """Flush buffers and append this run's summary to the .info index
        (ref contract: fgeneric.py:348-376)."""
        if self._last_line is not None and self._last_written_tdat != self.n_evals:
            self._tdat_buf.append(self._last_line)
        self._logger._write_run(self)


class COCOExperimentLogger:
    """One (function, dimension) experiment producing the .info/.dat/.tdat
    triple. Use :meth:`start_run` once per instance."""

    def __init__(
        self,
        datapath: str,
        fun_id: int,
        dim: int,
        alg_id: str = "bo-jax",
        comments: str = "",
        precision: float = 1e-8,
    ):
        self.datapath = datapath
        self.fun_id = int(fun_id)
        self.dim = int(dim)
        self.alg_id = alg_id
        self.comments = comments
        self.precision = float(precision)
        self._runs: List[COCORun] = []
        subdir = os.path.join(datapath, "data_f%d" % self.fun_id)
        os.makedirs(subdir, exist_ok=True)
        base = "%s_f%d_DIM%d" % (self.alg_id, self.fun_id, self.dim)
        self.dat_file = os.path.join(subdir, base + ".dat")
        self.tdat_file = os.path.join(subdir, base + ".tdat")
        self.info_file = os.path.join(datapath, "%s_f%d.info" % (self.alg_id, self.fun_id))
        self._info_header_written = os.path.exists(self.info_file)
        for p in (self.dat_file, self.tdat_file):
            if os.path.exists(p):
                os.remove(p)

    def start_run(self, instance: int, f_opt: float) -> COCORun:
        return COCORun(self, instance, f_opt)

    def _write_run(self, run: COCORun) -> None:
        with open(self.dat_file, "a") as f:
            f.writelines(run._dat_buf)
        with open(self.tdat_file, "a") as f:
            f.writelines(run._tdat_buf)
        rel = os.path.relpath(self.dat_file, self.datapath)
        with open(self.info_file, "a") as f:
            if not self._info_header_written:
                f.write(
                    "funcId = %d, DIM = %d, Precision = %.3e, algId = '%s'\n"
                    % (self.fun_id, self.dim, self.precision, self.alg_id)
                )
                f.write("%% %s\n" % self.comments)
                f.write(rel)
                self._info_header_written = True
            f.write(
                ", %d:%d|%.1e"
                % (run.instance, run.n_evals, run.best_f - run.f_opt - self.precision)
            )
        self._runs.append(run)


class COCOLoggedFunction:
    """Objective wrapper feeding a :class:`COCORun` on every evaluation —
    drop-in analog of the reference's ``LoggingFunction.__call__``
    (ref: fgeneric.py:262-346)."""

    def __init__(self, problem, run: COCORun):
        self.problem = problem
        self.run = run

    def __call__(self, x) -> float:
        x = np.asarray(x, dtype=float)
        v = float(self.problem(x))
        self.run.update(v, x)
        return v
