"""Ray-scene intersection: dense wavefront kernels.

Replaces OptiX ``rtTrace`` + the reference's per-geometry intersection
programs (``geometry_instance/TriangleMesh.cu:35-116``, ``sphere.cu:32-66``,
``parallelogram.cu:49-96`` — parallelograms are pre-split into triangles).

Wavefront design: intersection is *dense math over (ray-chunk x
prim-block) tiles* with masked min-reductions — no per-ray recursion, no
divergence. For small scenes (every Cornell variant) XLA fuses brute force
over all primitives (Moller-Trumbore plus the min-reduction) into one
kernel; large scenes use the BVH leaf-cluster traversal in :mod:`.bvh`.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..core import pytree as struct

from ..core.math import Array, cross, dot, normalize
from ..scene.types import EMITTER, Scene

BIG = 1e30

@struct.dataclass
class Hit:
    """Closest-hit record (the reference's attribute/PRD fields, SoA)."""

    t: Array         # [N] hit distance (BIG on miss)
    prim: Array      # [N] int32 primitive id (tris then spheres), -1 on miss
    hit: Array       # [N] bool
    position: Array  # [N,3]
    ng: Array        # [N,3] geometric normal (as authored, not flipped)
    ns: Array        # [N,3] interpolated shading normal
    uv: Array        # [N,2] texture coords
    mat: Array       # [N] int32 material id (0 on miss; gate on .hit)


# ---------------------------------------------------------------------------
# dense primitive tests
# ---------------------------------------------------------------------------

def _tri_hits(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore for all (ray, tri) pairs.

    o,d: [N,3]; v0,e1,e2: [T,3]; tmin/tmax: [N]. Returns (t, u, v, valid)
    each [N,T].
    """
    pvec = cross(d[:, None, :], e2[None, :, :])             # [N,T,3]
    det = dot(jnp.broadcast_to(e1[None], pvec.shape), pvec)  # [N,T]
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, jnp.broadcast_to(e1[None], tvec.shape))
    v = dot(jnp.broadcast_to(d[:, None, :], qvec.shape), qvec) * inv_det
    t = dot(jnp.broadcast_to(e2[None], qvec.shape), qvec) * inv_det
    valid = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > tmin[:, None]) & (t < tmax[:, None]))
    return t, u, v, valid


def _sphere_hits(o, d, center, radius, tmin, tmax):
    """Analytic sphere (sphere.cu:32-66): nearest root in range. [N,S]."""
    oc = o[:, None, :] - center[None, :, :]
    b = dot(jnp.broadcast_to(d[:, None, :], oc.shape), oc)
    c = dot(oc, oc) - jnp.square(radius)[None, :]
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    in0 = (t0 > tmin[:, None]) & (t0 < tmax[:, None])
    in1 = (t1 > tmin[:, None]) & (t1 < tmax[:, None])
    t = jnp.where(in0, t0, t1)
    valid = (disc > 0.0) & (in0 | in1)
    return t, valid


# ---------------------------------------------------------------------------
# closest hit / occlusion over the whole scene (brute force)
# ---------------------------------------------------------------------------

def _closest_hit_chunk(scene: Scene, o, d, tmin, tmax):
    g = scene.geometry
    t_tri, u, v, ok_tri = _tri_hits(o, d, g.tri_v0, g.tri_e1, g.tri_e2,
                                    tmin, tmax)
    t_tri = jnp.where(ok_tri, t_tri, BIG)
    best_tri = jnp.argmin(t_tri, axis=1)
    ar = jnp.arange(o.shape[0])
    t_best_tri = t_tri[ar, best_tri]
    bu = u[ar, best_tri]
    bv = v[ar, best_tri]
    return _finalize_hit(scene, o, d, tmin, tmax, t_best_tri, best_tri,
                         bu, bv)


def _finalize_hit(scene: Scene, o, d, tmin, tmax, t_best_tri, best_tri,
                  bu, bv):
    """Merge the best triangle hit with analytic spheres and interpolate
    attributes (shared by the brute-force and BVH paths)."""
    g = scene.geometry
    T = g.n_triangles
    ar = jnp.arange(o.shape[0])

    if g.n_spheres > 0:
        t_sph, ok_sph = _sphere_hits(o, d, g.sph_center, g.sph_radius,
                                     tmin, tmax)
        t_sph = jnp.where(ok_sph, t_sph, BIG)
        best_sph = jnp.argmin(t_sph, axis=1)
        t_best_sph = t_sph[ar, best_sph]
    else:
        best_sph = jnp.zeros_like(best_tri)
        t_best_sph = jnp.full_like(t_best_tri, BIG)

    use_sph = t_best_sph < t_best_tri
    t_hit = jnp.minimum(t_best_tri, t_best_sph)
    hit = t_hit < BIG
    prim = jnp.where(use_sph, T + best_sph, best_tri)
    prim = jnp.where(hit, prim, -1).astype(jnp.int32)
    # missed lanes keep a sane position (o + d): garbage ~1e30 positions
    # otherwise leak inf/NaN into masked downstream math and poison
    # gradients (0 * nan = nan in VJPs)
    position = o + jnp.where(hit, t_hit, 1.0)[:, None] * d

    # triangle attributes (barycentric normal/uv interp,
    # TriangleMesh.cu:60-116) — fetched as one fused row per triangle.
    # ng is precomputed per face at trace time (constant-folded [T,3]);
    # uv interp is skipped entirely for texture-free scenes.
    ng_face = normalize(cross(g.tri_e1, g.tri_e2))   # [T,3] (folded)
    with_uv = scene.has_textures
    attr_cols = [g.tri_n0, g.tri_n1, g.tri_n2, ng_face,
                 g.tri_mat[:, None].astype(jnp.float32)]
    if with_uv:
        attr_cols += [g.tri_uv0, g.tri_uv1, g.tri_uv2]
    tri_attr = jnp.concatenate(attr_cols, axis=1)    # [T, 13 or 19]
    a = tri_attr[best_tri]
    w0 = 1.0 - bu - bv
    ns_tri = normalize(w0[:, None] * a[:, 0:3] + bu[:, None] * a[:, 3:6]
                       + bv[:, None] * a[:, 6:9])
    ng_tri = a[:, 9:12]
    mat_tri = jnp.round(a[:, 12]).astype(jnp.int32)
    if with_uv:
        uv_tri = (w0[:, None] * a[:, 13:15] + bu[:, None] * a[:, 15:17]
                  + bv[:, None] * a[:, 17:19])
    else:
        uv_tri = jnp.zeros((o.shape[0], 2), jnp.float32)

    if g.n_spheres > 0:
        sph_attr = jnp.concatenate(
            [g.sph_center, g.sph_mat[:, None].astype(jnp.float32)], axis=1)
        s = sph_attr[best_sph]
        n_sph = normalize(position - s[:, 0:3])
        mat_sph = jnp.round(s[:, 3]).astype(jnp.int32)
        ns = jnp.where(use_sph[:, None], n_sph, ns_tri)
        ng = jnp.where(use_sph[:, None], n_sph, ng_tri)
        mat = jnp.where(use_sph, mat_sph, mat_tri)
        uv = jnp.where(use_sph[:, None], 0.0, uv_tri)
    else:
        ns, ng, mat, uv = ns_tri, ng_tri, mat_tri, uv_tri

    return Hit(t=jnp.where(hit, t_hit, BIG), prim=prim, hit=hit,
               position=position, ng=ng, ns=ns, uv=uv,
               mat=jnp.where(hit, mat, 0).astype(jnp.int32))


def _occluded_chunk(scene: Scene, o, d, tmin, tmax):
    """Any-hit: blocked by everything except emitters
    (gatherAnyHitOnNonEmitter / DiffuseEmitter.cu:63-68 semantics)."""
    g = scene.geometry
    is_emitter = scene.materials.kind == EMITTER
    _, _, _, ok_tri = _tri_hits(o, d, g.tri_v0, g.tri_e1, g.tri_e2,
                                tmin, tmax)
    tri_blocks = ok_tri & ~is_emitter[g.tri_mat][None, :]
    occ = jnp.any(tri_blocks, axis=1)
    if g.n_spheres > 0:
        _, ok_sph = _sphere_hits(o, d, g.sph_center, g.sph_radius,
                                 tmin, tmax)
        sph_blocks = ok_sph & ~is_emitter[g.sph_mat][None, :]
        occ = occ | jnp.any(sph_blocks, axis=1)
    return occ


def _chunked(fn, chunk_size: int, n_out_leaves_hint=None):
    """Apply a [N]-batched function in fixed-size chunks via lax.map to bound
    the [chunk, T] intermediate. N must be a multiple of chunk, or smaller."""
    def run(o, d, tmin, tmax):
        n = o.shape[0]
        if n <= chunk_size:
            return fn(o, d, tmin, tmax)
        if n % chunk_size != 0:
            pad = chunk_size - n % chunk_size
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
            tmin = jnp.concatenate([tmin, jnp.zeros((pad,), tmin.dtype)])
            tmax = jnp.concatenate([tmax, jnp.zeros((pad,), tmax.dtype)])
        shaped = jax.tree_util.tree_map(
            lambda a: a.reshape((-1, chunk_size) + a.shape[1:]),
            (o, d, tmin, tmax))
        out = jax.lax.map(lambda args: fn(*args), shaped)
        out = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:])[:n], out)
        return out
    return run


def _closest_hit_bvh(scene: Scene, o, d, tmin, tmax):
    from .bvh import traverse
    t, idx, bu, bv, found = traverse(scene.bvh, scene.geometry, o, d,
                                     tmin, tmax)
    T = scene.geometry.n_triangles
    best_tri = jnp.clip(idx, 0, T - 1)
    t_best_tri = jnp.where(found, t, BIG)
    return _finalize_hit(scene, o, d, tmin, tmax, t_best_tri, best_tri,
                         bu, bv)


def _occluded_bvh(scene: Scene, o, d, tmin, tmax):
    from .bvh import traverse_any
    g = scene.geometry
    is_emitter = scene.materials.kind == EMITTER
    occluder = ~is_emitter[g.tri_mat]
    occ = traverse_any(scene.bvh, g, occluder, o, d, tmin, tmax)
    if g.n_spheres > 0:
        _, ok_sph = _sphere_hits(o, d, g.sph_center, g.sph_radius,
                                 tmin, tmax)
        occ = occ | jnp.any(ok_sph & ~is_emitter[g.sph_mat][None, :],
                            axis=1)
    return occ


# total [chunk x T] elements the dense path may materialize at once; rays
# go through in chunks of at most 16384, fewer for big T.
CHUNK_ELEMENT_BUDGET = 1 << 25


def _auto_chunk(n_rays: int, n_prims: int) -> int:
    per_ray = max(n_prims, 1)
    return int(min(16384, max(1024, CHUNK_ELEMENT_BUDGET // per_ray)))


def intersect(scene: Scene, o: Array, d: Array, tmin: Array, tmax: Array,
              chunk_size: int | None = None) -> Hit:
    """Closest hit for rays [N,3] against the whole scene. Uses the scene's
    BVH when present (big scenes), else dense brute force."""
    if scene.bvh is not None:
        return _closest_hit_bvh(scene, o, d, tmin, tmax)
    if chunk_size is None:
        chunk_size = _auto_chunk(o.shape[0], scene.geometry.n_triangles)
    return _chunked(partial(_closest_hit_chunk, scene), chunk_size)(
        o, d, tmin, tmax)


def occluded(scene: Scene, o: Array, d: Array, tmin: Array, tmax: Array,
             chunk_size: int | None = None) -> Array:
    """Shadow-ray test [N] -> bool. Emitter surfaces never occlude."""
    if scene.bvh is not None:
        return _occluded_bvh(scene, o, d, tmin, tmax)
    if chunk_size is None:
        chunk_size = _auto_chunk(o.shape[0], scene.geometry.n_triangles)
    return _chunked(partial(_occluded_chunk, scene), chunk_size)(
        o, d, tmin, tmax)
