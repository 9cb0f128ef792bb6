"""Photon exchange by grid-cell owner (all-to-all between devices).

The reference builds ONE full photon map on one GPU per iteration
(``OptixRenderer_SpatialHash.cu:209-283``); replicating that across the
mesh with an ``all_gather`` (PhotonExchange.ALL_GATHER: every device
receives every photon and builds an identical grid) costs O(P*D) traffic
and redundant sort work. This module partitions the map instead, the
multi-device capability:

1. every device computes the GLOBAL photon AABB with ``pmin``/``pmax``
   collectives so all partial grids share one coordinate system;
2. each photon's grid cell is hashed to an OWNER device. Ownership is by
   x-ROW (the ``(y, z)`` pair): the gather scans each x-contiguous run of
   cells as one interval (IndirectRadianceEstimation.cu:104-112 — kept in
   :func:`..photon_map.gather_photons`), so whole rows must live on one
   device for that trick to survive sharding. A multiplicative hash of the
   row id decorrelates spatially-dense regions across devices;
3. photons are bucketed per destination into fixed-capacity slabs (static
   shapes; overflow is *counted*, and only overflows past 2x the fair share)
   and exchanged with ONE ``lax.all_to_all`` — per-device traffic O(P/D),
   per-device photon memory O(P/D * safety) instead of O(P);
4. each device sorts only its owned photons into a partial
   :class:`..photon_map.PhotonGrid`.

Queries (hitpoint gathers) are then evaluated against the partial maps:
``all_gather`` the query points (queries are ~20x smaller than the photon
map at reference scale: 0.26M pixels vs 4.2M photons), each device gathers
its partial contribution, and a ``psum_scatter`` returns each device its own
pixel band of the summed power — exact, because kernel-weighted photon power
is additive over the disjoint cell partition.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.rng import _lowbias32
from ..photon_map import (PhotonBatch, PhotonGrid, build_photon_grid,
                          cell_coords, cell_index_1d, photon_grid_geometry)


def _row_owner(cells: jax.Array, resolution: int, n_devices: int) -> jax.Array:
    """Owner device of a linear cell id — constant along x so each
    x-contiguous interval of the gather lives on exactly one device."""
    row = (cells // resolution).astype(jnp.uint32)   # y + z*R
    return (_lowbias32(row) % jnp.uint32(n_devices)).astype(jnp.int32)


def exchange_photons_by_cell(photons: PhotonBatch, resolution: int,
                             axis_name: str, n_devices: int,
                             min_cell_size: jax.Array | None = None,
                             capacity_factor: float = 2.0,
                             subsample_u: jax.Array | float = None):
    """Inside ``shard_map``: redistribute this device's photons to their
    cell owners and build the local partial grid.

    Returns ``(grid, stats)`` where ``grid`` holds ONLY the photons whose
    cells this device owns (shared origin/cell_size), and ``stats`` counts
    photons affected by the fixed per-destination capacity.

    Overflow handling: a destination group larger
    than its slab capacity is NOT truncated (silent energy loss at skew —
    e.g. a spot light concentrating the map in a handful of grid rows).
    Instead the group is SYSTEMATICALLY SUBSAMPLED to capacity with inverse-
    inclusion-probability reweighting (power *= count/cap) — the same
    unbiased budget trick the gather uses — so the exchanged map conserves
    energy in expectation at ANY skew; the reference's single full map
    (OptixRenderer_SpatialHash.cu:209-283) is lossless, and this is the
    sharded design's precise trade: variance, not bias, under overflow.
    ``subsample_u`` in [0,1) randomizes the systematic-sampling phase and
    is REQUIRED: unbiasedness needs u ~ Uniform[0,1) fresh per iteration —
    a fixed phase silently biases overflowed groups.
    """
    if subsample_u is None:
        raise TypeError(
            "subsample_u is required: pass u ~ Uniform[0,1) per iteration "
            "(e.g. jax.random.uniform(key, ())) — the systematic subsample "
            "is only unbiased with a random phase")
    p_local = photons.position.shape[0]
    # --- shared grid geometry from the GLOBAL masked AABB ---
    origin_l, cs_l = photon_grid_geometry(photons, resolution, min_cell_size)
    # pmin/pmax collectives: recompute AABB from per-device reductions
    v = photons.valid
    big = jnp.float32(1e30)
    pmin = jax.lax.pmin(
        jnp.min(jnp.where(v[:, None], photons.position, big), axis=0),
        axis_name)
    pmax = jax.lax.pmax(
        jnp.max(jnp.where(v[:, None], photons.position, -big), axis=0),
        axis_name)
    any_valid = jax.lax.pmax(jnp.any(v).astype(jnp.int32), axis_name) > 0
    pmin = jnp.where(any_valid, pmin, 0.0)
    pmax = jnp.where(any_valid, pmax, 1.0)
    extent = jnp.maximum(pmax - pmin, 1e-6)
    cell_size = jnp.max(extent) / resolution
    if min_cell_size is not None:
        cell_size = jnp.maximum(cell_size, min_cell_size)
    origin = pmin
    del origin_l, cs_l

    # --- owner per photon ---
    cells = cell_index_1d(
        cell_coords(photons.position, origin, cell_size, resolution),
        resolution)
    owner = _row_owner(cells, resolution, n_devices)
    owner = jnp.where(photons.valid, owner, n_devices)  # invalid sorts last

    # --- sort by owner: argsort + row gather (multi-operand co-sorts
    # compile slower — photon_map.sort_rows_by_key) ---
    pos, pw, dr = photons.position, photons.power, photons.direction
    owner_s, order = jax.lax.sort(
        (owner, jnp.arange(p_local, dtype=jnp.int32)), num_keys=1)
    cols = jnp.concatenate([pos, pw, dr], axis=1)[order]   # [P, 9]

    # --- slab capacity: fair share x safety, 8-row aligned ---
    cap = int(-(-p_local * capacity_factor // n_devices))
    cap = max(8, (cap + 7) // 8 * 8)

    # group starts via searchsorted; slab rows gathered (not scattered)
    starts = jnp.searchsorted(owner_s, jnp.arange(n_devices, dtype=owner_s.dtype),
                              method="sort").astype(jnp.int32)
    ends = jnp.searchsorted(owner_s,
                            jnp.arange(1, n_devices + 1, dtype=owner_s.dtype),
                            method="sort").astype(jnp.int32)
    counts = ends - starts
    ks = jnp.arange(cap, dtype=jnp.int32)[None, :]                 # [1,cap]
    # over-capacity groups: systematic subsample at stride count/cap with
    # a random phase; under-capacity groups reduce to the identity pick
    # (stride 1, floor(k + u) = k for u < 1)
    stride = jnp.maximum(counts.astype(jnp.float32) / cap, 1.0)    # [D]
    u = jnp.clip(jnp.asarray(subsample_u, jnp.float32), 0.0, 0.999)
    pick = jnp.floor((ks.astype(jnp.float32) + u) * stride[:, None]
                     ).astype(jnp.int32)                           # [D,cap]
    pick = jnp.minimum(pick, jnp.maximum(counts[:, None] - 1, 0))
    src = starts[:, None] + pick                                   # [D,cap]
    ok = ks < counts[:, None]
    src_flat = jnp.minimum(src, p_local - 1).reshape(-1)
    slab = cols[src_flat].reshape(n_devices, cap, 9)
    # inverse inclusion probability on the POWER columns keeps the
    # exchanged map's energy unbiased under subsampling
    w = jnp.where(counts > cap, counts.astype(jnp.float32) / cap, 1.0)
    slab = slab.at[:, :, 3:6].multiply(w[:, None, None])
    slab_valid = ok
    overflow = jnp.sum(jnp.maximum(counts - cap, 0))

    # --- ONE all_to_all: row d of the slab goes to device d ---
    recv = jax.lax.all_to_all(slab, axis_name, split_axis=0, concat_axis=0,
                              tiled=True).reshape(-1, 9)       # [D*cap, 9]
    recv_valid = jax.lax.all_to_all(
        slab_valid, axis_name, split_axis=0, concat_axis=0,
        tiled=True).reshape(-1)                                # [D*cap]

    owned = PhotonBatch(position=recv[:, 0:3], power=recv[:, 3:6],
                        direction=recv[:, 6:9], valid=recv_valid)
    grid = build_photon_grid(owned, resolution, origin=origin,
                             cell_size=cell_size)
    stats = {"photon_exchange_overflow":
             jax.lax.psum(overflow, axis_name).astype(jnp.int32)}
    return grid, stats


def sharded_gather(grid: PhotonGrid, q_position: jax.Array,
                   q_normal: jax.Array, radius, axis_name: str, *,
                   budget_total: int, u_stride: jax.Array | None = None,
                   check_normal: bool = True, max_cells_per_axis: int = 4,
                   tiled_wh: tuple[int, int, bool] | None = None,
                   q_valid: jax.Array | None = None):
    """Gather against a cell-partitioned photon map: all_gather the local
    queries, accumulate each device's partial kernel-weighted power, and
    psum_scatter each device its own band of the sum.

    Exact (not approximate): the cell partition is disjoint, so the full-map
    gather decomposes into the sum of partial gathers; per-device stride
    subsampling of over-budget boxes stays unbiased per partition.

    ``tiled_wh=(W, H, interpret)``: run the tile-shared gather
    (:func:`..accel.pallas_gather.gather_photons_tiled`) against the
    partial grid instead of the budgeted XLA row gather, so the multi-chip
    path gets the same gather as the single-chip one.
    The all-gathered queries ARE the full image in raster order (band
    sharding), so the same host-static 16x16 block permutation applies;
    u_stride and the sampler's lane keying are global lane ids, so the
    sharded gather consumes EXACTLY the unsharded one's uniforms and the
    result stays bit-comparable per partition.
    """
    from ..photon_map import gather_photons

    q_pos = jax.lax.all_gather(q_position, axis_name, tiled=True)
    q_nrm = jax.lax.all_gather(q_normal, axis_name, tiled=True)
    u = None
    if u_stride is not None:
        u = jax.lax.all_gather(u_stride, axis_name, tiled=True)
    if tiled_wh is not None:
        from ..accel.pallas_gather import (ROWS, TILE, gather_photons_tiled,
                                           tile_block_order)
        W, H, interpret = tiled_wh
        n = W * H
        perm, inv = tile_block_order(W, H)
        perm = jnp.asarray(perm)
        inv = jnp.asarray(inv)
        valid = None
        if q_valid is not None:
            valid = jax.lax.all_gather(q_valid, axis_name, tiled=True)[perm]
        u_rows = u.reshape(n // TILE, TILE)[:, :ROWS + 2]
        acc_b, stats = gather_photons_tiled(
            grid, q_pos[perm], q_nrm[perm], radius, u_rows=u_rows,
            valid=valid, check_normal=check_normal, interpret=interpret)
        partial = acc_b[inv]
        stats = {k: v[inv] for k, v in stats.items()}
    else:
        partial, stats = gather_photons(
            grid, q_pos, q_nrm, radius,
            max_cells_per_axis=max_cells_per_axis,
            budget_total=budget_total, check_normal=check_normal,
            u_stride=u)
    mine = jax.lax.psum_scatter(partial, axis_name, scatter_dimension=0,
                                tiled=True)
    return mine, stats
