"""BBOB experiment harness: regret traces + sequential / multi-process runners.

Capability analog of the reference's fgeneric logger and runner scripts
(ref: benchmark/fgeneric.py:44-60 — .dat/.tdat regret traces triggered per
Delta-f decade; benchmark/run_sequential.py:36-130; run_mpi.py:86-116 MPI
rank fan-out). The fan-out here keys off the BO_RANK / BO_WORLD env vars
or `jax.process_index` instead of mpi4py: each process takes every k-th
(fid, instance) task — the same embarrassingly-parallel split the
reference does with MPI ranks. The env-var fan-out runs on one host, where
each rank gets a GPU of its own, chosen before JAX starts.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

try:
    from .bbob import AVAILABLE_FIDS, BBOBFunction
except ImportError:  # direct `python benchmark/harness.py` invocation
    import os as _os
    import sys as _sys

    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
    from benchmark.bbob import AVAILABLE_FIDS, BBOBFunction


@dataclass
class RegretTrace:
    """Best-so-far trace with decade-style triggers (ref parity:
    fgeneric.py:43-46 — 5 triggers per Delta-f decade, target 1e-8)."""

    f_opt: float
    triggers_per_decade: int = 5
    target_precision: float = 1e-8
    evals: List[int] = field(default_factory=list)
    regrets: List[float] = field(default_factory=list)
    _n: int = 0
    _best: float = np.inf
    _next_trigger: float = np.inf

    def update(self, f_value: float) -> None:
        self._n += 1
        if f_value < self._best:
            self._best = f_value
            regret = max(self._best - self.f_opt, 0.0)
            if regret <= self._next_trigger or not self.evals:
                self.evals.append(self._n)
                self.regrets.append(regret)
                if regret > 0:
                    decade_step = 10 ** (1.0 / self.triggers_per_decade)
                    self._next_trigger = regret / decade_step
                else:
                    self._next_trigger = -np.inf

    @property
    def final_regret(self) -> float:
        return max(self._best - self.f_opt, 0.0)

    @property
    def n_evals(self) -> int:
        return self._n

    def solved(self) -> bool:
        return self.final_regret <= self.target_precision

    def to_dict(self) -> dict:
        return {
            "evals": self.evals,
            "regrets": self.regrets,
            "final_regret": self.final_regret,
            "n_evals": self._n,
        }


class LoggedFunction:
    """Wrap a BBOB problem so every evaluation feeds the regret trace
    (ref parity: fgeneric.LoggingFunction)."""

    def __init__(self, problem: BBOBFunction):
        self.problem = problem
        self.trace = RegretTrace(f_opt=problem.f_opt)

    def __call__(self, x) -> float:
        v = float(self.problem(np.asarray(x, dtype=float)))
        self.trace.update(v)
        return v


def run_bo_on_problem(
    fid: int,
    dim: int,
    instance: int = 1,
    max_FEs: Optional[int] = None,
    DoE_size: Optional[int] = None,
    seed: int = 0,
    optimizer_factory: Optional[Callable] = None,
    coco_logger=None,
) -> Dict:
    """One BO run on one BBOB problem; returns the regret trace record
    (ref parity: run_sequential.py:36-130 defaults). If ``coco_logger`` is a
    :class:`benchmark.coco_logger.COCOExperimentLogger`, the run also writes
    cocopp-compatible .info/.dat/.tdat traces (ref: fgeneric.py)."""
    from bayesian_optimization_tpu import BO, RealSpace
    from bayesian_optimization_tpu.models import GaussianProcess, constant_trend

    max_FEs = max_FEs or 50
    DoE_size = DoE_size or 10 * dim
    problem = BBOBFunction(fid, dim, instance)
    logged = LoggedFunction(problem)
    coco_run = None
    if coco_logger is not None:
        from .coco_logger import COCOLoggedFunction

        coco_run = coco_logger.start_run(instance, problem.f_opt)
        logged = COCOLoggedFunction(logged, coco_run)
        logged.trace = logged.problem.trace  # keep the JSON trace too
    space = RealSpace([[-5.0, 5.0]] * dim, random_seed=seed)
    if optimizer_factory is not None:
        opt = optimizer_factory(space, logged, max_FEs, seed)
    else:
        gp = GaussianProcess(
            mean=constant_trend(dim), corr="matern",
            thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
            nugget=1e-6, random_start=max(10, dim), random_state=seed,
        )
        opt = BO(
            search_space=space, obj_fun=lambda x: logged(x), model=gp,
            DoE_size=min(DoE_size, max_FEs // 2), max_FEs=max_FEs,
            random_seed=seed, verbose=False,
        )
    t0 = time.perf_counter()
    opt.run()
    wall = time.perf_counter() - t0
    if coco_run is not None:
        coco_run.finalize()
    return {
        "fid": fid, "dim": dim, "instance": instance, "seed": seed,
        "max_FEs": max_FEs, "wall_s": wall, **logged.trace.to_dict(),
    }


def _local_cards() -> List[str]:
    """IDs of this host's GPUs as CUDA_VISIBLE_DEVICES names them; [] on a
    host without NVIDIA GPUs."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return [c for c in visible.split(",") if c.strip()]
    if shutil.which("nvidia-smi") is None:
        return []
    out = subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, check=False
    ).stdout
    return [str(i) for i, line in enumerate(l for l in out.splitlines() if l.startswith("GPU "))]


def bind_rank_to_card(rank: int) -> Optional[str]:
    """Give this rank its own card by narrowing CUDA_VISIBLE_DEVICES; must
    run before JAX starts, since a JAX process reserves most of the memory
    of every card it sees. Returns the card's ID, or None on a host without
    GPUs (ranks then share the CPU). More ranks than cards is an error."""
    cards = _local_cards()
    if not cards:
        return None
    if not 0 <= rank < len(cards):
        raise RuntimeError(
            f"rank {rank} has no card: this host has {len(cards)} GPU(s), "
            "and each rank needs one of its own"
        )
    os.environ["CUDA_VISIBLE_DEVICES"] = cards[rank]
    return cards[rank]


def _my_shard() -> Tuple[int, int]:
    """(rank, world) for the fan-out: the BO_RANK / BO_WORLD env vars
    (binding the rank to its card), else jax.distributed's process index."""
    world = int(os.environ.get("BO_WORLD", 1))
    if world > 1:
        rank = int(os.environ.get("BO_RANK", 0))
        bind_rank_to_card(rank)
        return rank, world
    import jax

    return jax.process_index(), jax.process_count()


def run_suite(
    fids: Optional[List[int]] = None,
    dims: Tuple[int, ...] = (2,),
    instances: Tuple[int, ...] = (1,),
    max_FEs: int = 50,
    seed: int = 0,
    out_file: Optional[str] = None,
    coco_dir: Optional[str] = None,
) -> List[Dict]:
    """Run the (fid x dim x instance) grid, sharded across processes
    (ref parity: run_mpi.py:87-116 rank->task mapping). With ``coco_dir``,
    each (fid, dim) experiment additionally writes cocopp-compatible
    .info/.dat/.tdat files under that directory."""
    fids = fids or AVAILABLE_FIDS
    rank, world = _my_shard()
    tasks = [
        (fid, dim, inst)
        for dim in dims
        for fid in fids
        for inst in instances
    ]
    records = []
    loggers: Dict[Tuple[int, int], object] = {}
    for i, (fid, dim, inst) in enumerate(tasks):
        if i % world != rank:
            continue
        coco_logger = None
        if coco_dir is not None:
            from .coco_logger import COCOExperimentLogger

            if (fid, dim) not in loggers:
                loggers[(fid, dim)] = COCOExperimentLogger(
                    coco_dir, fid, dim,
                    alg_id="bo-jax", comments="max_FEs=%d seed=%d" % (max_FEs, seed),
                )
            coco_logger = loggers[(fid, dim)]
        rec = run_bo_on_problem(
            fid, dim, inst, max_FEs=max_FEs, seed=seed + inst, coco_logger=coco_logger,
        )
        records.append(rec)
        if out_file:
            with open(out_file, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="BBOB harness")
    ap.add_argument("--fids", type=int, nargs="*", default=[1, 2, 8])
    ap.add_argument("--dims", type=int, nargs="*", default=[2])
    ap.add_argument("--instances", type=int, nargs="*", default=[1])
    ap.add_argument("--max-fes", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--coco-dir", default=None, help="write cocopp-compatible .info/.dat/.tdat here")
    args = ap.parse_args()
    recs = run_suite(args.fids, tuple(args.dims), tuple(args.instances), args.max_fes, args.seed, args.out, args.coco_dir)
    for r in recs:
        print(json.dumps({k: r[k] for k in ("fid", "dim", "instance", "final_regret", "n_evals", "wall_s")}))
