"""Device-mesh construction and sharding helpers.

The reference has no parallelism of any kind (SURVEY.md §2.5); this module
is the scale-out surface of the rebuild.  Two mesh axes cover the two
execution regimes:

* `batch` — data parallelism over independent NLS instances (BASELINE
  configs 2/5).  Everything in the solver is per-instance, so sharding the
  leading batch axis makes the whole state machine SPMD with zero
  communication; multi-host runs put `batch` on the DCN axis.
* `block` — tensor parallelism inside one large instance (BASELINE
  config 4): Jacobian rows (residual blocks) sharded across chips; the
  matrix-free products Jᵀ(Jv) then carry XLA-inserted psums over ICI.

Shardings are expressed declaratively (`NamedSharding` +
`with_sharding_constraint`); the solver core never names a collective —
XLA's SPMD partitioner inserts them (the scaling-book recipe).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def make_mesh(
    batch: Optional[int] = None,
    block: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('batch', 'block') mesh over the available devices.

    batch defaults to n_devices // block.  On a multi-host pod the device
    order from jax.devices() keeps hosts contiguous, so the batch axis
    spans DCN and block stays within a host's ICI domain.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if batch is None:
        batch = n // block
    assert batch * block == n, f"mesh {batch}x{block} != {n} devices"
    dev_array = np.asarray(devices).reshape(batch, block)
    return Mesh(dev_array, axis_names=("batch", "block"))


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch) axis; replicate the rest."""
    return NamedSharding(mesh, P("batch", *([None] * (ndim - 1))))


def block_rows_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (row/residual-block) axis over 'block'."""
    return NamedSharding(mesh, P("block", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a pytree of batched arrays with the batch axis sharded."""
    return jax.tree.map(
        lambda a: jax.device_put(a, batch_sharding(mesh, a.ndim)), tree
    )
