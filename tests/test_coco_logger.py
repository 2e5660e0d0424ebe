"""Tests for the cocopp-compatible .info/.dat/.tdat writer
(ref contract: benchmark/fgeneric.py:52-376)."""
import math
import os

import numpy as np
import pytest

from benchmark.coco_logger import COCOExperimentLogger, COCOLoggedFunction


def _run_synthetic(tmp_path, n_evals=40, instances=(1, 2)):
    log = COCOExperimentLogger(str(tmp_path), fun_id=1, dim=2, alg_id="algx",
                               comments="unit test")
    rng = np.random.default_rng(0)
    for inst in instances:
        run = log.start_run(inst, f_opt=10.0)
        fn = COCOLoggedFunction(lambda x: 10.0 + float(np.sum(x ** 2)), run)
        for i in range(n_evals):
            fn(rng.uniform(-2, 2, 2) * (1.0 / (i + 1)))
        run.finalize()
    return log


def test_files_created(tmp_path):
    log = _run_synthetic(tmp_path)
    assert os.path.exists(log.info_file)
    assert os.path.exists(log.dat_file)
    assert os.path.exists(log.tdat_file)


def test_info_format(tmp_path):
    log = _run_synthetic(tmp_path)
    lines = open(log.info_file).read().splitlines()
    assert lines[0].startswith("funcId = 1, DIM = 2, Precision = 1.000e-08, algId = 'algx'")
    assert lines[1].startswith("% unit test")
    # data path + one ", inst:evals|regret" entry per run
    assert lines[2].startswith(os.path.join("data_f1", "algx_f1_DIM2.dat"))
    assert ", 1:40|" in lines[2] and ", 2:40|" in lines[2]


def test_dat_lines_monotone_regret(tmp_path):
    log = _run_synthetic(tmp_path)
    rows = [l.split() for l in open(log.dat_file) if not l.startswith("%")]
    # col 0 evals (int, per-run non-decreasing), col 2 best regret non-increasing
    evals = [int(r[0]) for r in rows]
    best = [float(r[2]) for r in rows]
    # two runs are concatenated; split at eval-counter resets
    splits = [0] + [i for i in range(1, len(evals)) if evals[i] < evals[i - 1]] + [len(evals)]
    assert len(splits) == 3  # two runs
    for a, b in zip(splits, splits[1:]):
        assert all(x <= y for x, y in zip(evals[a:b], evals[a:b][1:]))
        assert all(x >= y for x, y in zip(best[a:b], best[a:b][1:]))
    # 7 columns: evals, df, best df, f, best f, x1, x2
    assert all(len(r) == 7 for r in rows)


def test_tdat_triggers_are_eval_decades(tmp_path):
    log = _run_synthetic(tmp_path, n_evals=100, instances=(1,))
    rows = [l.split() for l in open(log.tdat_file) if not l.startswith("%")]
    evals = [int(r[0]) for r in rows]
    assert evals[0] == 1
    assert evals[-1] == 100  # final eval always written
    assert len(evals) == len(set(evals))  # no duplicates
    # every logged eval (except the forced final one) is floor(10^(i/20))
    allowed = {math.floor(10 ** (i / 20.0)) for i in range(60)}
    assert all(e in allowed or e == 100 for e in evals)


def test_measured_fitness_column(tmp_path):
    log = _run_synthetic(tmp_path, n_evals=10, instances=(1,))
    rows = [l.split() for l in open(log.dat_file) if not l.startswith("%")]
    for r in rows:
        df, f = float(r[1]), float(r[3])
        assert f - df == pytest.approx(10.0, abs=1e-6)  # f_opt recovered


def test_harness_integration(tmp_path):
    from benchmark.harness import run_suite

    recs = run_suite(fids=[1], dims=(2,), instances=(1,), max_FEs=12,
                     seed=3, coco_dir=str(tmp_path))
    assert len(recs) == 1
    info = os.path.join(str(tmp_path), "bo-jax_f1.info")
    assert os.path.exists(info)
    dat = os.path.join(str(tmp_path), "data_f1", "bo-jax_f1_DIM2.dat")
    rows = [l for l in open(dat) if not l.startswith("%")]
    assert rows, "at least one improvement line"
    assert ":12|" in open(info).read()
