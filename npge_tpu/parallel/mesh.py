"""Device mesh + sharding helpers.

The reference has no distributed backend (single process + boost::thread
pool, SURVEY.md §2.6/§5.8); the parallelism surface BASELINE.json asks
for is data parallelism over a device mesh:

  - genome positions sharded across devices for the k-mer scan
    (codes replicated is also supported — bacterial genomes are tiny
    relative to HBM; position-sharded outputs avoid replicated writes),
  - extension batches sharded over the group axis,
  - k-mer index / candidate merges via gather + deterministic sorted dedup
    on host (results are bit-identical for any device count — SURVEY §7
    hard part 4).

Sharding is expressed with NamedSharding + jit (XLA SPMD inserts the halo
exchanges for the shifted-window ops); no manual collectives are needed for
these embarrassingly-parallel stages.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


def shard_1d(mesh: Mesh, x, pad_value=0):
    """Put a 1-D array on the mesh, sharded over its only axis (padded to a
    multiple of the device count). Returns (device_array, original_len)."""
    n = mesh.devices.size
    T = x.shape[0]
    Tp = -(-T // n) * n
    if Tp != T:
        x = np.concatenate([np.asarray(x), np.full(Tp - T, pad_value, x.dtype)])
    sharding = NamedSharding(mesh, P("d"))
    return jax.device_put(x, sharding), T


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_batch(mesh: Mesh, x, pad_value=0):
    """Shard an [B, ...] array over its batch axis (padded)."""
    n = mesh.devices.size
    B = x.shape[0]
    Bp = -(-B // n) * n
    if Bp != B:
        pad = np.full((Bp - B,) + x.shape[1:], pad_value, x.dtype)
        x = np.concatenate([np.asarray(x), pad])
    return jax.device_put(
        x, NamedSharding(mesh, P("d", *([None] * (x.ndim - 1))))
    ), B
