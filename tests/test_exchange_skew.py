"""Photon exchange under adversarial skew (round-3 verdict weak #7).

The cell-owner all-to-all uses fixed per-destination slab capacities
(static shapes). A spot-light-like photon distribution concentrates the
map in a handful of grid rows, so one owner device receives far more than
its fair share. These tests drive exactly that regime and assert the
overflow path is UNBIASED: over-capacity groups are systematically
subsampled with inverse-inclusion-probability reweighting, so the
exchanged map conserves total energy (the reference's single full map,
OptixRenderer_SpatialHash.cu:209-283, is lossless; the sharded design
trades variance — never energy — under overflow).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.parallel import make_mesh
from oppositerenderer.parallel.exchange import exchange_photons_by_cell
from oppositerenderer.photon_map import PhotonBatch

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

D = 8
P_LOCAL = 512          # photons per device
RES = 16


def _run_exchange(positions, capacity_factor):
    """positions [D*P_LOCAL, 3] -> (grid powers psum, overflow count)."""
    mesh = make_mesh(D)
    power = jnp.ones((D * P_LOCAL, 3), jnp.float32)
    direction = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (D * P_LOCAL, 1))
    valid = jnp.ones((D * P_LOCAL,), bool)
    batch = PhotonBatch(position=positions, power=power,
                        direction=direction, valid=valid)

    from jax.sharding import PartitionSpec as P

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("tile"),), out_specs=(P(), P()), check_vma=False)
    def go(b):
        grid, stats = exchange_photons_by_cell(
            b, RES, "tile", D, capacity_factor=capacity_factor,
            subsample_u=0.37)
        live = (jnp.arange(grid.power.shape[0]) < grid.n_valid)[:, None]
        kept = jnp.sum(jnp.where(live, grid.power, 0.0))
        return (jax.lax.psum(kept, "tile"),
                stats["photon_exchange_overflow"])

    kept, overflow = go(batch)
    return float(kept), int(overflow)


def test_balanced_distribution_no_overflow(rng_np):
    """Uniform photons: every destination under capacity, zero overflow,
    exact energy conservation (identity pick path)."""
    pos = jnp.asarray(rng_np.uniform(0, 1, (D * P_LOCAL, 3)),
                      jnp.float32)
    kept, overflow = _run_exchange(pos, capacity_factor=2.0)
    assert overflow == 0
    np.testing.assert_allclose(kept, 3.0 * D * P_LOCAL, rtol=1e-6)


def test_spotlight_skew_overflows_but_conserves_energy(rng_np):
    """All photons in ONE grid cell -> one owner receives everything.
    Per-device fair-share capacity is ~2*P/D, so ~75% of each device's
    photons exceed capacity — the overflow counter must fire AND the
    subsample reweighting must keep total exchanged energy exact (equal
    photon powers make systematic subsampling exactly energy-preserving,
    not just in expectation).

    The grid adapts to the photon AABB, so skew needs outliers pinning the
    domain: 94% of photons cluster inside one cell of a [0,1]^3 domain
    held open by the remaining 6%."""
    pos = np.asarray(rng_np.uniform(0, 1, (D * P_LOCAL, 3)), np.float32)
    cluster = rng_np.uniform(0, 1, D * P_LOCAL) < 0.94
    base = np.asarray([0.503, 0.497, 0.501])
    pos[cluster] = base + rng_np.uniform(-1e-3, 1e-3,
                                         (int(cluster.sum()), 3))
    kept, overflow = _run_exchange(jnp.asarray(pos), capacity_factor=2.0)
    assert overflow > 0.4 * D * P_LOCAL          # heavy skew detected
    np.testing.assert_allclose(kept, 3.0 * D * P_LOCAL, rtol=1e-5)


def test_skew_bias_bound_with_unequal_powers(rng_np):
    """Unequal powers under skew: systematic subsampling is unbiased in
    expectation; a single draw over 8 devices must stay within a few
    percent of the true total (documented bound: variance, not bias)."""
    pos_np = np.asarray(rng_np.uniform(0, 1, (D * P_LOCAL, 3)), np.float32)
    cluster = rng_np.uniform(0, 1, D * P_LOCAL) < 0.94
    base = np.asarray([0.503, 0.497, 0.501])
    pos_np[cluster] = base + rng_np.uniform(-1e-3, 1e-3,
                                            (int(cluster.sum()), 3))
    pos = jnp.asarray(pos_np)
    mesh = make_mesh(D)
    pw = jnp.asarray(rng_np.uniform(0.1, 1.9, (D * P_LOCAL, 3)),
                     jnp.float32)
    batch = PhotonBatch(
        position=pos, power=pw,
        direction=jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]),
                           (D * P_LOCAL, 1)),
        valid=jnp.ones((D * P_LOCAL,), bool))

    from jax.sharding import PartitionSpec as P

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("tile"),), out_specs=P(), check_vma=False)
    def go(b):
        grid, _ = exchange_photons_by_cell(b, RES, "tile", D,
                                           capacity_factor=2.0,
                                           subsample_u=0.37)
        live = (jnp.arange(grid.power.shape[0]) < grid.n_valid)[:, None]
        kept = jnp.sum(jnp.where(live, grid.power, 0.0))
        return jax.lax.psum(kept, "tile")

    kept = float(go(batch))
    total = float(jnp.sum(pw))
    assert abs(kept - total) / total < 0.05
