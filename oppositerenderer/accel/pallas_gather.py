"""Tile-shared photon gather: Pallas on the Triton route.

The XLA gather (photon_map.gather_photons) fetches up to ``budget`` photon
rows PER QUERY with random row gathers: about ``[N, 128, 9]`` f32 gathered
rows per iteration (1.2 GB at 512^2, 4.8 GB at 1024^2). This kernel uses
what the reference's per-pixel loop cannot: a TILE of 256 pixels taken as
a 16x16 image block (``tile_block_order``) is a compact surface patch whose
hitpoints span only a few grid cells. Per tile:

1. the table pass (XLA, ``_tile_tables``) takes the UNION of the tile's
   query cell boxes and enumerates its (y,z) rows — each row is one
   contiguous interval of the cell-sorted photon array (the x-contiguity
   trick the reference scans per pixel, IndirectRadianceEstimation.cu:
   104-112);
2. the kernel reads each interval ONCE per block of queries and tests it
   densely against all of them (distance, normal opposition, Jensen
   gaussian);
3. over-budget tiles stay UNBIASED as in gather_photons: y/z rows beyond
   the 8x8 slot grid are systematically stride-sampled, and rows longer
   than CHUNK photons contribute one random CHUNK-block, each reweighted
   by its inverse inclusion probability.

Hopper layout: one program per (tile, QB-query block); it loops over the
64 row slots and, inside each, over PC-photon sub-chunks, so the live
``[QB, PC]`` tile stays in registers. Photons are packed SoA
(``[9, P + CHUNK]``: position, power, direction rows) so each sub-chunk is
nine coalesced contiguous loads; ``num_stages`` lets Triton pipeline them.

Precision: every product and sum is float32 on the CUDA cores. The power
accumulation ``sum_p w(q,p) * power(p)`` is elementwise FMAs into
``[QB, PC]`` accumulators reduced once at the end, not a ``dot`` (a
Triton dot on f32 would run in TF32, and a ``[PC, 3]`` right-hand side is
too narrow for the tensor cores anyway).
``d2`` is taken per axis: ``(q - p)`` of nearby f32 points is exact, so
there is none of the ``|q|^2 + |p|^2 - 2 q.p`` cancellation against the
shrinking PPM radius.

Differentiation: pallas_call has no AD rule, so the kernel is wrapped in
a ``custom_vjp`` whose backward pass is the VJP of the plain reference
(``gather_photons_tiled_reference``, the same estimator with the same
intervals and weights, rematerialised tile by tile). Gradients through
the photon powers, positions and query points are those of the XLA
gather's estimator family, on every backend.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import Array

TILE = 256          # queries per table tile
BLOCK = 16          # square image block edge (BLOCK^2 == TILE)
ROWS_Y = 8          # (y,z) row slot grid per tile
ROWS_Z = 8
ROWS = ROWS_Y * ROWS_Z
CHUNK = 256         # photons per row slot (longer rows: one random block)
# block shape from a sweep on the H100 (PERF.md, Findings)
QB = 32             # queries per kernel program
PC = 32             # photons per inner sub-chunk
NUM_WARPS = 4
NUM_STAGES = 2


def tile_block_order(width: int, height: int):
    """(perm, inv_perm) int32 [H*W] mapping raster order to 16x16 image
    blocks. 256 CONSECUTIVE raster pixels span a half image row —
    wall-to-wall hitpoints whose cell-box union covers the whole grid —
    while a 16x16 pixel block is a compact surface patch, which is the
    coherence the tile kernel feeds on."""
    if width % BLOCK or height % BLOCK:
        raise ValueError(f"{width}x{height} is not a multiple of {BLOCK}")
    idx = np.arange(height * width, dtype=np.int32).reshape(height, width)
    perm = (idx.reshape(height // BLOCK, BLOCK, width // BLOCK, BLOCK)
            .transpose(0, 2, 1, 3).reshape(-1))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def gather_mode(use_pallas_gather: bool | None, width: int, height: int,
                backend: str | None = None) -> str:
    """Which gather the PPM estimate runs: "kernel" (compiled for the
    GPU), "interpret" (the same kernel in the Pallas interpreter, CPU
    only) or "xla" (photon_map.gather_photons).

    ``None`` picks the kernel on the GPU and the XLA gather elsewhere;
    ``True`` asks for the tile gather and raises on a backend that can
    neither compile nor interpret it. Frames that are not whole 16x16
    blocks always take the XLA gather."""
    if use_pallas_gather is False or width % BLOCK or height % BLOCK:
        return "xla"
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return "kernel"
    if use_pallas_gather is None:
        return "xla"
    if backend == "cpu":
        return "interpret"
    raise ValueError(f"the tile photon gather has no route on {backend!r}")


def _pack_photons(grid) -> Array:
    """[9, P + CHUNK] f32 SoA: rows 0-2 position, 3-5 power, 6-8
    direction. The CHUNK tail keeps every sub-chunk load in bounds; its
    positions park at 1e30 so they never pass the distance test."""
    cols = jnp.concatenate([grid.position, grid.power, grid.direction],
                           axis=1).T                           # [9, P]
    tail = jnp.zeros((9, CHUNK), jnp.float32).at[0:3].set(1e30)
    return jnp.concatenate([cols.astype(jnp.float32), tail], axis=1)


def _tile_tables(grid, position: Array, radius, u_row: Array,
                 valid: Array | None = None):
    """Per-tile interval tables: (starts, lens, weights) each
    [n_tiles, ROWS], plus per-tile (visited, total) photon counts.

    ``u_row`` [n_tiles, ROWS + 2] uniforms drive the unbiased subsampling
    (stride offsets for y/z row sampling + the per-row chunk pick).
    ``valid`` masks queries out of the tile box union (miss lanes carry
    junk positions that would otherwise blow the union up to the whole
    grid); an all-invalid tile gets zero-length rows.
    """
    res = grid.resolution
    n = position.shape[0]
    n_tiles = n // TILE
    r = jnp.broadcast_to(radius, (n,))
    npos = position - grid.origin
    inv = 1.0 / grid.cell_size
    lo = jnp.clip(jnp.floor((npos - r[:, None]) * inv), 0,
                  res - 1).astype(jnp.int32)
    hi = jnp.clip(jnp.floor((npos + r[:, None]) * inv), 0,
                  res - 1).astype(jnp.int32)
    if valid is not None:
        lo = jnp.where(valid[:, None], lo, res)   # min ignores invalid
        hi = jnp.where(valid[:, None], hi, -1)    # max ignores invalid
    lo_t = lo.reshape(n_tiles, TILE, 3).min(axis=1)     # [Tt,3]
    hi_t = hi.reshape(n_tiles, TILE, 3).max(axis=1)

    def axis_rows(axis, slots, u):
        span = hi_t[:, axis] - lo_t[:, axis] + 1               # [Tt]
        stride = jnp.maximum(1, -(-span // slots))              # ceil
        off = jnp.minimum((u * stride.astype(jnp.float32))
                          .astype(jnp.int32), stride - 1)
        ks = jnp.arange(slots, dtype=jnp.int32)
        vals = lo_t[:, axis, None] + off[:, None] + ks[None, :] \
            * stride[:, None]                                   # [Tt,slots]
        ok = vals <= hi_t[:, axis, None]
        return vals, ok, stride

    ys, ok_y, stride_y = axis_rows(1, ROWS_Y, u_row[:, 0])
    zs, ok_z, stride_z = axis_rows(2, ROWS_Z, u_row[:, 1])

    y = jnp.repeat(ys, ROWS_Z, axis=1)                   # [Tt, ROWS]
    oky = jnp.repeat(ok_y, ROWS_Z, axis=1)
    z = jnp.tile(zs, (1, ROWS_Y))
    okz = jnp.tile(ok_z, (1, ROWS_Y))
    ok = oky & okz
    w_row = (stride_y * stride_z).astype(jnp.float32)[:, None]  # [Tt,1]

    cfrom = lo_t[:, 0, None] + y * res + z * res * res
    cto = hi_t[:, 0, None] + y * res + z * res * res
    start = grid.offsets[jnp.where(ok, cfrom, 0)]
    end = grid.offsets[jnp.where(ok, cto, 0) + 1]
    ln = jnp.where(ok, end - start, 0)                   # [Tt, ROWS]

    # rows longer than CHUNK: pick one random C-block, weight = #blocks
    n_blocks = jnp.maximum(1, -(-ln // CHUNK))
    u_blk = u_row[:, 2:2 + ROWS]
    blk = jnp.minimum((u_blk * n_blocks.astype(jnp.float32))
                      .astype(jnp.int32), n_blocks - 1)
    start_s = start + blk * CHUNK
    ln_s = jnp.clip(ln - blk * CHUNK, 0, CHUNK)
    weight = jnp.where(ok, w_row * n_blocks.astype(jnp.float32), 0.0)
    visited = jnp.sum(ln_s, axis=1)                      # per tile
    total = jnp.sum(jnp.where(ok, ln, 0) * w_row.astype(ln.dtype), axis=1)
    return (start_s.astype(jnp.int32), ln_s.astype(jnp.int32),
            weight.astype(jnp.float32), visited, total)


def _gather_kernel(check_normal: bool, starts_ref, lens_ref, w_ref, r2_ref,
                   q_ref, p_ref, o0_ref, o1_ref, o2_ref):
    """One program: QB queries of one tile against the tile's 64 row
    intervals. ``q_ref`` [8, QB]: rows 0-2 position, 3-5 normal.

    The power sums stay elementwise in three ``[QB, PC]`` accumulators
    (one FMA per pair and colour) and are reduced over the photon axis
    once at the end, instead of a cross-lane reduction per sub-chunk."""
    from jax.experimental import pallas as pl

    from ..photon_map import GAUSS_ALPHA, GAUSS_BETA, GAUSS_EXP_NEG_BETA

    qx, qy, qz = q_ref[0], q_ref[1], q_ref[2]            # [QB]
    if check_normal:
        nx, ny, nz = q_ref[3], q_ref[4], q_ref[5]
    r2 = r2_ref[()]
    # Jensen gaussian as A + B * exp(-k d2) (photon_map.gaussian_kernel_
    # weight, expanded)
    denom = 1.0 - GAUSS_EXP_NEG_BETA
    k_exp = GAUSS_BETA / (2.0 * r2)
    a_w = GAUSS_ALPHA * (1.0 - 1.0 / denom)
    b_w = GAUSS_ALPHA / denom
    lane = jnp.arange(PC, dtype=jnp.int32)

    def slot(s, acc):
        start = starts_ref[s]
        ln = lens_ref[s]
        w = w_ref[s]

        def sub_chunk(k, acc):
            off = start + k * PC
            rows = [p_ref[c, pl.ds(off, PC)] for c in range(9)]   # [PC]
            px, py, pz, pr, pg, pb, dx_, dy_, dz_ = rows
            dx = qx[:, None] - px[None, :]
            dy = qy[:, None] - py[None, :]
            dz = qz[:, None] - pz[None, :]
            d2 = dx * dx + dy * dy + dz * dz                      # [QB,PC]
            ok = ((k * PC + lane) < ln)[None, :] & (d2 <= r2)
            if check_normal:
                ndp = (nx[:, None] * dx_[None, :] + ny[:, None] * dy_[None, :]
                       + nz[:, None] * dz_[None, :])
                ok = ok & (ndp <= 0.0)
            c = jnp.where(ok, a_w + b_w * jnp.exp(-k_exp * d2), 0.0)
            a0, a1, a2 = acc
            return (a0 + c * (w * pr)[None, :], a1 + c * (w * pg)[None, :],
                    a2 + c * (w * pb)[None, :])

        return jax.lax.fori_loop(0, (ln + PC - 1) // PC, sub_chunk, acc)

    zero = jnp.zeros((QB, PC), jnp.float32)
    a0, a1, a2 = jax.lax.fori_loop(0, ROWS, slot, (zero, zero, zero))
    o0_ref[...] = jnp.sum(a0, axis=1)
    o1_ref[...] = jnp.sum(a1, axis=1)
    o2_ref[...] = jnp.sum(a2, axis=1)


def _gather_tiled_impl(grid, position, normal, radius, u_rows,
                       check_normal, interpret, valid):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = position.shape[0]
    if n % TILE:
        raise ValueError(f"{n} queries are not a multiple of {TILE}")
    n_tiles = n // TILE
    starts, lens, weights, visited, total = _tile_tables(
        grid, position, radius, u_rows, valid=valid)
    packed = _pack_photons(grid)
    r2 = jnp.square(jnp.asarray(radius, jnp.float32)).reshape(())
    queries = jnp.concatenate([position.T, normal.T,
                               jnp.zeros((2, n), jnp.float32)], axis=0)

    per_tile = TILE // QB
    table = pl.BlockSpec((None, ROWS), lambda t, j: (t, 0))
    qblock = lambda t, j: t * per_tile + j
    out = pl.BlockSpec((QB,), lambda t, j: (qblock(t, j),))
    acc = pl.pallas_call(
        partial(_gather_kernel, check_normal),
        grid=(n_tiles, per_tile),
        in_specs=[
            table, table, table,
            pl.BlockSpec((), lambda t, j: ()),
            pl.BlockSpec((8, QB), lambda t, j: (0, qblock(t, j))),
            pl.BlockSpec(packed.shape, lambda t, j: (0, 0)),
        ],
        out_specs=[out, out, out],
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="tile_photon_gather",
    )(starts, lens, weights, r2, queries.astype(jnp.float32), packed)
    accum = jnp.stack(acc, axis=-1)

    per_q = lambda a: jnp.repeat(a, TILE, total_repeat_length=n)
    stats = dict(photons_visited=per_q(visited).astype(jnp.int32),
                 photon_subsampled=per_q(
                     jnp.maximum(total - visited, 0)).astype(jnp.int32))
    return accum, stats


@partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _gather_tiled_core(grid, position, normal, radius, u_rows,
                       check_normal: bool, interpret: bool, valid=None):
    return _gather_tiled_impl(grid, position, normal, radius, u_rows,
                              check_normal, interpret, valid)


def _gather_tiled_fwd(grid, position, normal, radius, u_rows,
                      check_normal, interpret, valid=None):
    out = _gather_tiled_core(grid, position, normal, radius, u_rows,
                             check_normal, interpret, valid)
    return out, (grid, position, normal, radius, u_rows, valid)


def _gather_tiled_bwd(check_normal, interpret, res, g):
    grid, position, normal, radius, u_rows, valid = res
    _, vjp = jax.vjp(
        lambda gr, p, q, r: gather_photons_tiled_reference(
            gr, p, q, r, u_rows=u_rows, check_normal=check_normal,
            valid=valid),
        grid, position, normal, radius)
    return (*vjp(g[0]), jnp.zeros_like(u_rows),
            None if valid is None else jnp.zeros_like(valid))


_gather_tiled_core.defvjp(_gather_tiled_fwd, _gather_tiled_bwd)


def gather_photons_tiled(grid, position: Array, normal: Array, radius,
                         *, u_rows: Array, check_normal: bool = True,
                         valid: Array | None = None,
                         interpret: bool = False):
    """Tile-shared photon gather. ``position``/``normal`` are [N,3] with
    N a multiple of TILE in tile order (``tile_block_order``); ``u_rows``
    is [N // TILE, ROWS + 2] uniforms. Returns (accum_power [N,3], stats)
    matching photon_map.gather_photons' contract (same Jensen kernel, an
    unbiased estimate of the same sum; per-query stats are the owning
    tile's counts). Its gradient is the plain reference's (module
    docstring)."""
    return _gather_tiled_core(grid, position, normal, radius, u_rows,
                              check_normal, interpret, valid)


def gather_photons_tiled_reference(grid, position: Array, normal: Array,
                                   radius, *, u_rows: Array,
                                   check_normal: bool = True,
                                   valid: Array | None = None) -> Array:
    """Plain jax.numpy evaluation of the kernel's estimator: the same
    ``_tile_tables`` intervals and weights, each tile's up-to-ROWS*CHUNK
    photons tested densely against its TILE queries in float32. Returns
    accum_power [N,3]; the kernel must agree with it up to summation
    order."""
    from ..photon_map import gaussian_kernel_weight

    n = position.shape[0]
    n_tiles = n // TILE
    starts, lens, weights, _, _ = _tile_tables(grid, position, radius,
                                               u_rows, valid=valid)
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    j = jnp.arange(CHUNK, dtype=jnp.int32)
    p_last = grid.position.shape[0] - 1

    def per_tile(args):
        q, qn, st, ln, w = args            # [TILE,3] x2, [ROWS] x3
        idx = jnp.minimum(st[:, None] + j, p_last).reshape(-1)
        live = (j[None, :] < ln[:, None]).reshape(-1)
        wr = jnp.repeat(w, CHUNK)
        p, pw, pd = (grid.position[idx], grid.power[idx],
                     grid.direction[idx])
        d2 = jnp.sum(jnp.square(q[:, None, :] - p[None]), axis=-1)
        ok = live[None, :] & (d2 <= r2)
        if check_normal:
            ok = ok & (jnp.sum(qn[:, None, :] * pd[None], axis=-1) <= 0.0)
        c = jnp.where(ok, gaussian_kernel_weight(d2, r2), 0.0) * wr[None, :]
        return jnp.einsum("qp,pc->qc", c, pw,
                          precision=jax.lax.Precision.HIGHEST)

    # checkpointed: a VJP keeps each tile's inputs, not its
    # [TILE, ROWS * CHUNK] weights
    acc = jax.lax.map(jax.checkpoint(per_tile),
                      (position.reshape(n_tiles, TILE, 3),
                       normal.reshape(n_tiles, TILE, 3),
                       starts, lens, weights),
                      batch_size=8)      # 8 tiles' [TILE, ROWS*CHUNK] at once
    return acc.reshape(n, 3)
