"""Multi-host initialization and sharded-population helpers.

The counterpart of the reference's only cross-process machinery — the
mpi4py rank fan-out in benchmark/run_mpi.py:87-116 — plus what it never had:
sharding a single optimization's populations across chips.

`initialize()` wraps `jax.distributed.initialize` (coordinator discovery via
the standard env vars); `population_mesh()` returns the 1-D particles mesh
spanning every addressable device across all hosts.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import make_particle_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-host; no-op (False)
    for single-process runs."""
    num = num_processes if num_processes is not None else int(os.environ.get("BO_WORLD", "1"))
    if num <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def population_mesh():
    """Particles mesh over all global devices (XLA routes the collectives
    through NCCL: NVLink between the cards of a host, the network between
    hosts)."""
    return make_particle_mesh(devices=jax.devices())


def is_primary() -> bool:
    return jax.process_index() == 0
