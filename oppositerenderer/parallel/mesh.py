"""Device mesh construction for sharded rendering.

Replaces the reference's distribution topology (a TCP star of render servers,
``Client/client/RenderServerConnections.cpp``) with a jax.sharding Mesh: one
``tile`` axis over all devices; image tiles, light subpaths, and photons
shard along it, and collectives (psum/all_gather) ride the device
interconnect (NVLink between the cards of one host).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tile"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # silently truncating turns every "sharded" check into a
            # vacuous 1-device pass — fail loudly instead
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} "
                f"available (set XLA_FLAGS="
                f"--xla_force_host_platform_device_count={n_devices} "
                f"JAX_PLATFORMS=cpu for a virtual mesh)")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (TILE_AXIS,))


def tile_sharding(mesh: Mesh, ndims: int = 1) -> NamedSharding:
    """First axis sharded over tiles, rest replicated."""
    return NamedSharding(mesh, P(TILE_AXIS, *([None] * (ndims - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
