"""Device-mesh and sharding helpers for particle-parallel BO.

The reference's only parallelism is joblib process pools and an
embarrassingly-parallel MPI fan-out (ref: bayes_optim/_base.py:110-121,
benchmark/run_mpi.py:87-116). Here: a 1-D `particles` mesh axis over which
every population axis in the framework — GP MLE restarts, HMC chains,
CMA-ES/MIES chains, acquisition candidates, SMC particles — is sharded with
`NamedSharding`; XLA inserts the collectives (all-reduce argmax/argmin) at
the reduction points, through NCCL on GPUs. One axis is enough: the cards
of a GPU host are joined all to all by NVLink, so no device order is
closer than another.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"


def make_particle_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the first n) local devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (population) axis across the mesh."""
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, k: int) -> int:
    return int(-(-n // k) * k)


def shard_population(arr, mesh: Mesh):
    """Place `arr` with its leading axis sharded over the particle mesh,
    padding the axis to a device multiple if needed (mask-safe: callers use
    population reductions that ignore +inf/-inf fill)."""
    import jax.numpy as jnp

    n_dev = mesh.devices.size
    n = arr.shape[0]
    n_pad = pad_to_multiple(n, n_dev)
    if n_pad != n:
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
        arr = jnp.pad(arr, pad_width)
    return jax.device_put(arr, particle_sharding(mesh))
