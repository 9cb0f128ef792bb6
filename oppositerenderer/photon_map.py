"""Photon map: sorted-uniform-grid build + fixed-budget gather.

Array re-design of the reference's GPU photon-map builders
(``renderer/OptixRenderer_SpatialHash.cu``):

* build (:209-283): thrust AABB reduce -> cell hash -> atomic histogram ->
  ``sort_by_key`` -> ``exclusive_scan`` offset table. Here: masked min/max ->
  cell ids -> ``jnp.argsort`` -> ``searchsorted`` offsets. Pure, functional,
  differentiable-through-gather, no atomics.
* gather (``ppm/IndirectRadianceEstimation.cu:69-237``): per-hitpoint walk of
  the grid cells within the radius, using the reference's trick of scanning
  each x-contiguous run of cells as one photon interval (:104-112). The
  variable-length interval scan becomes a fixed photon budget per run
  (static shapes); overflow is counted and reported in the stats dict.
* stochastic-hash variant (:286-334 + helpers/store_photon.h): fixed-size
  table, one photon per slot with collision counting; kept as the O(1)-memory
  fallback (``PhotonMapStructure.STOCHASTIC_HASH``).

Photon validity + kernel weight follow IndirectRadianceEstimation.cu:55-67
(Jensen gaussian). The BRDF application is done by the caller (ppm
integrator) — with the 1/pi the reference omits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .core import pytree as struct

from .core.math import Array, dot

BIG = 1e30


@struct.dataclass
class PhotonBatch:
    """SoA photons (ppm/Photon.h:9-34). Fixed capacity, masked validity."""

    position: Array   # [P,3]
    power: Array      # [P,3]
    direction: Array  # [P,3] incident ray direction at deposit
    valid: Array      # [P] bool


@struct.dataclass
class PhotonGrid:
    """Sorted uniform grid over a PhotonBatch."""

    # sorted photon arrays (invalid photons sorted to the end)
    position: Array   # [P,3]
    power: Array      # [P,3]
    direction: Array  # [P,3]
    offsets: Array    # [R^3+1] int32 prefix offsets into sorted arrays
    origin: Array     # [3] grid world origin
    cell_size: Array  # [] scalar
    resolution: int = struct.field(static=True)
    n_valid: Array = None  # [] int32


def sort_rows_by_key(key: Array, cols: Array) -> tuple[Array, Array]:
    """Sort [P] ``key`` with an [P, C] f32 payload co-moved IN the sort.

    Trade space: the C-operand co-sort is the faster graph and the slower
    compile; (key, iota) argsort + one [P, C] row gather compiles faster
    and runs slower. The HOT per-iteration photon build keeps the co-sort
    (compile is paid once); cold/rare paths (sharded exchange, VM vertex
    grid) use argsort+gather for compile.
    """
    P, C = cols.shape
    out = jax.lax.sort((key,) + tuple(cols[:, i] for i in range(C)),
                       num_keys=1)
    return out[0], jnp.stack(out[1:], axis=-1)


def cell_coords(p: Array, origin: Array, cell_size: Array,
                resolution: int) -> Array:
    """Integer cell coords [...,3], clipped to the grid."""
    c = jnp.floor((p - origin) / cell_size).astype(jnp.int32)
    return jnp.clip(c, 0, resolution - 1)


def cell_index_1d(c: Array, resolution: int) -> Array:
    """x-major linearization (x runs fastest), matching the reference's
    x-contiguous interval scan."""
    return (c[..., 0] + c[..., 1] * resolution
            + c[..., 2] * resolution * resolution)


def min_cell_size_for_window(radius: Array, max_cells_per_axis: int) -> Array:
    """Smallest cell size for which a [p-r, p+r] search box is guaranteed to
    span at most ``max_cells_per_axis`` cells per axis (cells touched =
    floor(2r/cs)+2 in the worst alignment), so gather_photons' static window
    covers the whole sphere — no silent energy truncation when the radius is
    large relative to the photon AABB (e.g. the volumetric gather's 3x
    radius, or a user-set Gui-default r0=0.20)."""
    return (2.0 * radius / (max_cells_per_axis - 1)) * (1.0 + 1e-5)


def photon_grid_geometry(photons: PhotonBatch, resolution: int,
                         min_cell_size: Array | None = None):
    """(origin, cell_size) of the uniform grid over the photons' masked AABB
    (the thrust transform_reduce step of
    OptixRenderer_SpatialHash.cu:209-283), with an optional cell-size floor."""
    p = photons.position
    v = photons.valid
    pmin = jnp.min(jnp.where(v[:, None], p, BIG), axis=0)
    pmax = jnp.max(jnp.where(v[:, None], p, -BIG), axis=0)
    any_valid = jnp.any(v)
    pmin = jnp.where(any_valid, pmin, 0.0)
    pmax = jnp.where(any_valid, pmax, 1.0)
    extent = jnp.maximum(pmax - pmin, 1e-6)
    cell_size = jnp.max(extent) / resolution
    if min_cell_size is not None:
        cell_size = jnp.maximum(cell_size, min_cell_size)
    return pmin, cell_size


def build_photon_grid(photons: PhotonBatch, resolution: int,
                      min_cell_size: Array | None = None,
                      origin: Array | None = None,
                      cell_size: Array | None = None,
                      sort_form: str = "cosort") -> PhotonGrid:
    """createUniformGridPhotonMap (OptixRenderer_SpatialHash.cu:209-283).

    ``min_cell_size`` (traced ok) floors the cell size — pass
    :func:`min_cell_size_for_window` of the gather radius so the gather's
    fixed cell window is exact (over-budget cells are handled by the
    gather's unbiased stride subsampling, never dropped).

    ``origin``/``cell_size`` pin the grid geometry externally — the sharded
    all-to-all exchange computes them from the GLOBAL photon AABB so every
    device's partial grid shares one coordinate system.
    """
    if origin is None or cell_size is None:
        origin, cell_size = photon_grid_geometry(photons, resolution,
                                                 min_cell_size)
    p = photons.position
    v = photons.valid

    n_cells = resolution ** 3
    cells = cell_index_1d(cell_coords(p, origin, cell_size, resolution),
                          resolution)
    cells = jnp.where(v, cells, n_cells)  # invalid -> sentinel, sorts last

    # co-sort: the payload moves IN the sort (the compile/runtime trade is
    # in the sort_rows_by_key docstring).
    # ``sort_form`` selects the compile-cheap argsort form for the tiered
    # first executable (RenderConfig.photon_grid_sort); both lax.sort
    # forms are stable, so the grids are bit-identical.
    pw, dr = photons.power, photons.direction
    payload = jnp.concatenate([p, pw, dr], axis=1)         # [P,9]
    if sort_form == "argsort":
        cells_sorted, order = jax.lax.sort(
            (cells, jnp.arange(p.shape[0], dtype=jnp.int32)), num_keys=1)
        cols = payload[order]
    else:
        cells_sorted, cols = sort_rows_by_key(cells, payload)
    # method="sort": one extra vectorized sort instead of the default
    # per-query binary-search while-loop.
    # The compile-cheap tier keeps the binary search — the offsets sort
    # is another large-sort compile the first executable can skip.
    offsets = jnp.searchsorted(cells_sorted,
                               jnp.arange(n_cells + 1, dtype=cells.dtype),
                               method=("scan" if sort_form == "argsort"
                                       else "sort"))
    return PhotonGrid(
        position=cols[:, 0:3],
        power=cols[:, 3:6],
        direction=cols[:, 6:9],
        offsets=offsets.astype(jnp.int32), origin=origin,
        cell_size=cell_size, resolution=resolution,
        n_valid=jnp.sum(v).astype(jnp.int32))


# Jensen gaussian filter constants (IndirectRadianceEstimation.cu:60-67);
# shared with the Pallas tile-gather kernel (accel/pallas_gather.py)
GAUSS_ALPHA = 1.818
GAUSS_BETA = 1.953
GAUSS_EXP_NEG_BETA = 0.141847


def gaussian_kernel_weight(distance2: Array, radius2: Array) -> Array:
    """Jensen gaussian filter (IndirectRadianceEstimation.cu:60-67)."""
    return GAUSS_ALPHA * (
        1.0 - (1.0 - jnp.exp(-GAUSS_BETA * distance2 / (2.0 * radius2)))
        / (1.0 - GAUSS_EXP_NEG_BETA))


def gather_cell_indices(offsets: Array, origin: Array, cell_size: Array,
                        resolution: int, position: Array, radius: Array, *,
                        max_cells_per_axis: int = 4, budget_total: int = 256,
                        u_stride: Array | None = None):
    """Shared interval-walk of the sorted uniform grid: row indices of the
    (strided) grid entries inside the [p-r, p+r] box of each query.

    Follows IndirectRadianceEstimation.cu:85-128: cells in the box, each
    (y,z) row's x-range scanned as one contiguous interval; the intervals
    are flattened into one fixed-budget gather index block, with unbiased
    stride subsampling when a box holds more than ``budget_total`` entries
    (see :func:`gather_photons`). Used by the photon gather AND the VCM
    vertex-merging gather.

    Returns (gidx [N,B] int32, gok [N,B] bool, stride [N] int32, total [N]).
    """
    res = resolution
    r = jnp.broadcast_to(radius, position.shape[:-1])
    npos = position - origin
    inv_cs = 1.0 / cell_size
    lo = jnp.clip(jnp.floor((npos - r[..., None]) * inv_cs), 0,
                  res - 1).astype(jnp.int32)
    hi = jnp.clip(jnp.floor((npos + r[..., None]) * inv_cs), 0,
                  res - 1).astype(jnp.int32)

    # phase 1: per-lane (start, len) interval per (y,z) row of the box
    starts, lens = [], []
    for dz in range(max_cells_per_axis):
        z = lo[..., 2] + dz
        z_ok = z <= hi[..., 2]
        for dy in range(max_cells_per_axis):
            y = lo[..., 1] + dy
            ok = z_ok & (y <= hi[..., 1])
            cfrom = (lo[..., 0] + y * res + z * res * res)
            cto = (hi[..., 0] + y * res + z * res * res)
            start = offsets[jnp.where(ok, cfrom, 0)]
            end = offsets[jnp.where(ok, cto, 0) + 1]
            starts.append(jnp.where(ok, start, 0))
            lens.append(jnp.where(ok, end - start, 0))
    starts = jnp.stack(starts, axis=-1)           # [N, R]
    lens = jnp.stack(lens, axis=-1)               # [N, R]
    prefix = jnp.cumsum(lens, axis=-1) - lens     # exclusive [N, R]
    total = prefix[..., -1] + lens[..., -1]       # entries in the box [N]

    # phase 3 prep: stride subsampling of over-budget boxes
    stride = jnp.maximum(1, -(-total // budget_total))          # ceil
    if u_stride is None:
        offset = jnp.zeros_like(stride)
    else:
        offset = jnp.minimum((u_stride * stride).astype(stride.dtype),
                             stride - 1)

    # phase 2: flatten (strided) intervals into one gather index block
    ks = jnp.arange(budget_total, dtype=jnp.int32)
    fk = offset[..., None] + ks * stride[..., None]             # [N, B]
    shape_k = position.shape[:-1] + (budget_total,)
    gidx = jnp.zeros(shape_k, jnp.int32)
    gok = jnp.zeros(shape_k, jnp.bool_)
    for rn in range(starts.shape[-1]):
        off = fk - prefix[..., rn:rn + 1]
        sel = (off >= 0) & (off < lens[..., rn:rn + 1])
        gidx = jnp.where(sel, starts[..., rn:rn + 1] + off, gidx)
        gok = gok | sel
    return gidx, gok, stride, total


def gather_photons(grid: PhotonGrid, position: Array, normal: Array,
                   radius: Array, *, max_cells_per_axis: int = 4,
                   budget_total: int = 256, check_normal: bool = True,
                   u_stride: Array | None = None):
    """Accumulate kernel-weighted photon power within ``radius`` of each
    query point [N,3].

    Follows IndirectRadianceEstimation.cu:85-128: cells in the [p-r, p+r]
    box, each (y,z) row's x-range scanned as one contiguous photon interval.

    Wavefront redesign (the reference walks a variable-length per-pixel
    loop):

    1. the interval (start, length) list over the box's (y,z) rows is
       built from offset-table reads only;
    2. the intervals are FLATTENED into one [N, budget_total] gather per
       photon array — random row gathers price per row, so the row count
       is what must shrink;
    3. when a box holds more than ``budget_total`` photons, every s-th
       photon (s = ceil(total/budget), random offset ``u_stride``) is
       gathered and the contribution scaled by s — *systematic
       subsampling with reweighting*, an unbiased estimator of the full
       box sum, instead of truncation (which loses energy exactly where
       the photon map is dense).

    Returns (power [N,3], stats dict).
    """
    r = jnp.broadcast_to(radius, position.shape[:-1])
    radius2 = r * r
    gidx, gok, stride, total = gather_cell_indices(
        grid.offsets, grid.origin, grid.cell_size, grid.resolution,
        position, radius, max_cells_per_axis=max_cells_per_axis,
        budget_total=budget_total, u_stride=u_stride)

    # three separate [N,B,3] gathers: XLA fuses each narrow gather with
    # its consumer, where one wide [N,B,9] gather would materialize
    ppos = grid.position[gidx]        # [N,B,3]
    ppow = grid.power[gidx]
    pdir = grid.direction[gidx]
    diff = position[..., None, :] - ppos
    d2 = dot(diff, diff)
    # validity: in radius + photon direction opposes the normal
    # (IndirectRadianceEstimation.cu:55-58); volumetric gathers skip the
    # normal test
    ok_p = gok & (d2 <= radius2[..., None])
    if check_normal:
        ok_p = ok_p & (dot(-pdir, normal[..., None, :]) >= 0.0)
    w = gaussian_kernel_weight(d2, radius2[..., None])
    accum = jnp.sum(jnp.where(ok_p[..., None], ppow * w[..., None], 0.0),
                    axis=-2)
    accum = accum * stride[..., None].astype(jnp.float32)  # reweight
    visited = jnp.sum(gok, axis=-1).astype(jnp.int32)
    stats = dict(photons_visited=visited,
                 photon_subsampled=jnp.maximum(total - visited, 0))
    return accum, stats


# ---------------------------------------------------------------------------
# stochastic hash variant (O(1) memory per cell)
# ---------------------------------------------------------------------------

@struct.dataclass
class StochasticHashMap:
    """Fixed-size hash: one surviving photon per slot + collision count
    (store_photon.h:17-24; counts scale surviving photon power). Cell size
    is tied to the gather radius so the 3^3 neighborhood covers the gather
    sphere and the count-scaling stays representative."""

    position: Array   # [H,3]
    power: Array      # [H,3]
    direction: Array  # [H,3]
    count: Array      # [H] int32 photons hashed to the slot
    origin: Array
    cell_size: Array


def _hash_cell(c: Array, n_slots: int) -> Array:
    """3D integer cell -> slot via large-prime mixing."""
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) \
        ^ (c[..., 2] * 83492791)
    return (h & (n_slots - 1)).astype(jnp.int32)


def build_stochastic_hash(photons: PhotonBatch, cell_size: Array,
                          table_size_log2: int, key: Array
                          ) -> StochasticHashMap:
    """initializeStochasticHashPhotonMap
    (OptixRenderer_SpatialHash.cu:286-334)."""
    p = photons.position
    v = photons.valid
    pmin = jnp.min(jnp.where(v[:, None], p, BIG), axis=0)
    any_valid = jnp.any(v)
    pmin = jnp.where(any_valid, pmin, 0.0)
    n_slots = 1 << table_size_log2
    c = jnp.floor((p - pmin) / cell_size).astype(jnp.int32)
    slot = _hash_cell(c, n_slots)
    slot = jnp.where(v, slot, n_slots)  # drop invalid

    count = jnp.zeros((n_slots + 1,), jnp.int32).at[slot].add(1)
    # "stochastic": survivor chosen by random priority per photon,
    # deterministic given the key (reference: last-writer-wins race)
    prio = jax.random.uniform(key, (p.shape[0],))
    order = jnp.argsort(prio)
    # scatter in priority order; the last write per slot survives
    pos_t = jnp.zeros((n_slots + 1, 3)).at[slot[order]].set(p[order])
    pow_t = jnp.zeros((n_slots + 1, 3)).at[slot[order]].set(
        photons.power[order])
    dir_t = jnp.zeros((n_slots + 1, 3)).at[slot[order]].set(
        photons.direction[order])
    return StochasticHashMap(
        position=pos_t[:n_slots], power=pow_t[:n_slots],
        direction=dir_t[:n_slots], count=count[:n_slots],
        origin=pmin, cell_size=cell_size)


def gather_stochastic_hash(h: StochasticHashMap, position: Array,
                           normal: Array, radius: Array):
    """3^3 neighborhood scan x collision count
    (IndirectRadianceEstimation.cu:131-166)."""
    n_slots = h.count.shape[0]
    radius2 = jnp.broadcast_to(radius * radius, position.shape[:-1])
    base = jnp.floor((position - h.origin) / h.cell_size).astype(jnp.int32)
    accum = jnp.zeros(position.shape[:-1] + (3,), jnp.float32)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                slot = _hash_cell(base + jnp.asarray([dx, dy, dz]), n_slots)
                diff = position - h.position[slot]
                d2 = dot(diff, diff)
                ok = ((h.count[slot] > 0) & (d2 <= radius2)
                      & (dot(-h.direction[slot], normal) >= 0.0))
                w = gaussian_kernel_weight(d2, radius2)
                contrib = h.power[slot] * (w * h.count[slot])[..., None]
                accum = accum + jnp.where(ok[..., None], contrib, 0.0)
    return accum, {}


# ---------------------------------------------------------------------------
# CPU kd-tree variant (reference OptixRenderer_CPUKdTree.cpp:27-129)
# ---------------------------------------------------------------------------

@struct.dataclass
class PhotonKdTree:
    """Left-balanced kd-tree photon map (children of slot i at 2i+1/2i+2).

    The parity analog of the reference's ACCELERATION_STRUCTURE_KD_TREE_CPU
    (config.h:18-21): the tree is median-built on the HOST (native C++
    builder, native/kdtree_builder.cpp) exactly like the reference builds
    on the CPU, then traversed on the device with a fixed stack. The sorted
    uniform grid remains the production structure — host build + pointer
    chasing is the slow path on both platforms.
    """

    position: Array   # [m,3] photon at tree slot (zeros on null slots)
    power: Array      # [m,3]
    direction: Array  # [m,3]
    axis: Array       # [m] int32: 0/1/2 split axis, 3 leaf, 4 null
    n_valid: Array    # [] int32


def _kdtree_callback(pos: "np.ndarray", valid: "np.ndarray"):
    import numpy as np
    from .native import build_photon_kdtree_native
    m = _kd_capacity(pos.shape[0])
    sel = np.nonzero(valid)[0]
    perm_c, axis = build_photon_kdtree_native(pos[sel])
    # remap compacted indices back to original photon rows
    perm = np.where(perm_c >= 0, sel[np.clip(perm_c, 0, None)], -1)
    out_p = np.full((m,), -1, np.int32)
    out_a = np.full((m,), 4, np.int32)
    out_p[:perm.shape[0]] = perm.astype(np.int32)
    out_a[:axis.shape[0]] = axis
    return out_p, out_a


def _kd_capacity(n_rows: int) -> int:
    m = 1
    while m < n_rows:
        m = 2 * m + 1
    return m


def build_photon_kdtree(photons: PhotonBatch) -> PhotonKdTree:
    """Host-built kd-tree (createPhotonKdTreeOnCPU,
    OptixRenderer_CPUKdTree.cpp:89-129) wrapped as a jit-safe callback."""
    import numpy as np  # noqa: F401 (doc: host side)
    p = photons.position
    m = _kd_capacity(p.shape[0])
    perm, axis = jax.pure_callback(
        _kdtree_callback,
        (jax.ShapeDtypeStruct((m,), jnp.int32),
         jax.ShapeDtypeStruct((m,), jnp.int32)),
        p, photons.valid, vmap_method="sequential")
    safe = jnp.clip(perm, 0, p.shape[0] - 1)
    null = perm < 0
    return PhotonKdTree(
        position=jnp.where(null[:, None], 0.0, photons.position[safe]),
        power=jnp.where(null[:, None], 0.0, photons.power[safe]),
        direction=jnp.where(null[:, None], 0.0, photons.direction[safe]),
        axis=jnp.where(null, 4, axis).astype(jnp.int32),
        n_valid=jnp.sum(photons.valid).astype(jnp.int32))


def gather_kdtree(tree: PhotonKdTree, position: Array, normal: Array,
                  radius: Array, *, max_visits: int = 512,
                  check_normal: bool = True):
    """Range query over the kd-tree (IndirectRadianceEstimation.cu:168-210's
    stack traversal, vectorized over query lanes with a fixed [N,S] stack).

    Bounded at ``max_visits`` node pops per lane (the reference's traversal
    is unbounded; overruns are reported in the stats dict).
    """
    m = tree.axis.shape[0]
    depth = max(1, m.bit_length())
    stack_size = depth + 2
    n = position.shape[0]
    radius2 = jnp.broadcast_to(radius * radius, (n,))

    stack = jnp.zeros((n, stack_size), jnp.int32)   # root=0 pre-pushed
    sp = jnp.ones((n,), jnp.int32)
    accum = jnp.zeros((n, 3), jnp.float32)
    visited = jnp.zeros((n,), jnp.int32)

    def cond(state):
        step, sp, *_ = state
        return (step < max_visits) & jnp.any(sp > 0)

    def body(state):
        step, sp, stack, accum, visited = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        slot = stack[jnp.arange(n), top]
        sp = jnp.where(active, sp - 1, sp)

        ax = tree.axis[slot]
        ppos = tree.position[slot]
        is_null = ax == 4
        ok = active & ~is_null

        diff = position - ppos
        d2 = dot(diff, diff)
        in_r = ok & (d2 <= radius2)
        if check_normal:
            in_r = in_r & (dot(-tree.direction[slot], normal) >= 0.0)
        w = gaussian_kernel_weight(d2, radius2)
        accum = accum + jnp.where(in_r[:, None],
                                  tree.power[slot] * w[:, None], 0.0)
        visited = visited + ok.astype(jnp.int32)

        # internal: descend near child, push far child if the splitting
        # plane is within the radius
        is_internal = ok & (ax < 3)
        axc = jnp.clip(ax, 0, 2)
        delta = (position[jnp.arange(n), axc]
                 - ppos[jnp.arange(n), axc])
        near = jnp.where(delta < 0.0, 2 * slot + 1, 2 * slot + 2)
        far = jnp.where(delta < 0.0, 2 * slot + 2, 2 * slot + 1)
        push_far = is_internal & (delta * delta <= radius2) & (far < m)
        idx = jnp.arange(n)
        stack = stack.at[idx, jnp.minimum(sp, stack_size - 1)].set(
            jnp.where(push_far, far, stack[idx, jnp.minimum(
                sp, stack_size - 1)]))
        sp = sp + push_far.astype(jnp.int32)
        push_near = is_internal & (near < m)
        stack = stack.at[idx, jnp.minimum(sp, stack_size - 1)].set(
            jnp.where(push_near, near, stack[idx, jnp.minimum(
                sp, stack_size - 1)]))
        sp = sp + push_near.astype(jnp.int32)
        return step + 1, sp, stack, accum, visited

    state = (jnp.int32(0), sp, stack, accum, visited)
    step, sp, stack, accum, visited = jax.lax.while_loop(cond, body, state)
    stats = dict(photons_visited=visited,
                 kd_overrun=jnp.sum((sp > 0).astype(jnp.int32)))
    return accum, stats
