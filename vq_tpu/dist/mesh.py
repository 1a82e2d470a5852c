"""Device-mesh setup and sharding helpers.

The reference has no distributed backend at all (SURVEY.md §2.3: scale-out is
Slurm jobs + OpenMP); here it is a 1-D `jax.sharding.Mesh` over all devices
with the corpus sharded along N ("tensor-sharded corpus", BASELINE.json north
star), codebooks/queries replicated, and XLA collectives for the top-k merge.
The cards of one host are joined all to all, so the mesh follows the
algorithm alone.  Multi-process runs call `jax.distributed.initialize()`
first; on a single device every sharding is a no-op (same code at toy and
full scale, SURVEY.md §4.3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def maybe_init_distributed() -> None:
    """Initialize the multi-process runtime when VQ_DIST_INIT is set.  A
    failure raises: a run asked to be distributed must not go on as a
    single process."""
    import os

    if os.environ.get("VQ_DIST_INIT") and jax.process_count() == 1:
        jax.distributed.initialize()


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D mesh over (up to) all visible devices, axis name "data"."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def shard_rows(mesh: Mesh, x: jax.Array) -> jax.Array:
    """Place an (N, ...) array row-sharded across the mesh.

    N must be divisible by mesh size; callers pad with rows whose scores the
    scan masks out (kernels already mask by true-n).
    """
    spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P(*([None] * x.ndim))))


def pad_rows_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """Pad rows so N divides the mesh size (host-side, before shard_rows)."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
