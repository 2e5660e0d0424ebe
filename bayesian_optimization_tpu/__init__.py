"""Bayesian-optimization framework on JAX / XLA.

A from-scratch re-design of the capability surface of `bayes_optim`
(wangronin/Bayesian-Optimization) for accelerators: mixed search spaces
compiled to masked continuous embeddings, a batched Gaussian-process engine
with vectorized hyperparameter inference, acquisition maximization as sharded
particle populations, and ask/evaluate/tell BO loops on top. It runs on the
CPU and on NVIDIA GPUs.
"""
__version__ = "0.1.0"

import os as _os

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key and a directory that moves never hits
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache() -> None:
    """Persistent XLA compilation cache, on by default.

    BO loops re-enter the same jitted fit/argmax programs across process
    lifetimes, so a disk cache saves the cold compiles. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here; otherwise the cache goes to <checkout>/.jax_cache."""
    import jax

    if jax.config.jax_compilation_cache_dir is not None:
        return  # JAX_COMPILATION_CACHE_DIR, or set by the caller
    try:
        _os.makedirs(_DEFAULT_CACHE_DIR, exist_ok=True)
    except OSError:  # read-only install: run without a cache
        return
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)


_enable_persistent_compile_cache()

from .space import (
    Bool, BoolSpace, Discrete, DiscreteSpace, Integer, IntegerSpace, Node,
    Ordinal, OrdinalSpace, Real, RealSpace, SearchSpace, SpaceEncoding, Subset,
    SubsetSpace, Variable,
)
from .utils import (
    AskEmptyError, ConstraintEvaluationError, FlatFitnessError,
    ObjectiveEvaluationError, RecommendationUnavailableError,
)
from .core import (
    BO, AnnealingBO, BaseBO, BaseOptimizer, ConditionalBO, MOBO, MOBO_qEHVI,
    MultiAcquisitionBO, NoisyBO, ParallelBO, PCABO, SelfAdaptiveBO, Solution,
)
from .models import GaussianProcess
from .models import trend
from .models.random_forest import RandomForest, SurrogateAggregation
from .ops.acquisition import EI, GEI, MGFI, PI, UCB, EpsilonPI
from .fmin import fmin

__all__ = [
    "__version__", "fmin",
    "Variable", "Real", "Integer", "Ordinal", "Discrete", "Bool", "Subset",
    "SearchSpace", "RealSpace", "IntegerSpace", "OrdinalSpace", "DiscreteSpace",
    "BoolSpace", "SubsetSpace", "Node", "SpaceEncoding",
    "Solution", "BaseOptimizer", "BaseBO",
    "BO", "ParallelBO", "AnnealingBO", "SelfAdaptiveBO", "NoisyBO",
    "MultiAcquisitionBO", "MOBO", "MOBO_qEHVI", "PCABO", "ConditionalBO",
    "GaussianProcess", "RandomForest", "SurrogateAggregation", "trend",
    "EI", "PI", "EpsilonPI", "UCB", "MGFI", "GEI",
    "AskEmptyError", "FlatFitnessError", "RecommendationUnavailableError",
    "ObjectiveEvaluationError", "ConstraintEvaluationError",
]
