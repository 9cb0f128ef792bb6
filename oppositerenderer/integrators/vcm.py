"""Full VCM bidirectional path tracing (vertex connection AND merging).

Implements the reference's VCM estimator family exactly — the recursive MIS
quantities dVCM/dVC/dVM per the "Implementing VCM" tech report as coded in
``renderer/vcm/mis.h`` (init :35-105, on-hit :109-123, on-scatter :133-186),
and the four connection techniques in ``renderer/vcm/vcm.h``:

* t=1 light-path -> camera splats (connectCameraT1, :65-161)
* s=0 camera path hits an emitter (connectLightSourceS0, :493-522)
* s=1 next-event estimation with full MIS (connectLightSourceS1, :406-488)
* vertex connection camera-vertex x light-vertex (connectVertices, :315-400)

with the balance heuristic (vcm_shared.h:12-16) and the host-side factors of
OptixRenderer.cpp:675-696 (etaVCM, misVc/VmWeightFactor).

Vertex merging (VM) goes BEYOND the reference: the reference scaffolds VM
(the mis_vm terms, the vmNormalization constant) but disables it
(OptixRenderer.cpp:300-301); here ``cfg.vcm_use_vm`` enables a real merging
pass (:class:`VertexGrid` + :func:`_merge_vertices`, per the tech report /
SmallVCM), validated against PPM in the merge-only limit and against PT in
full-VCM mode (tests/test_vcm_vm.py). Default off, matching the reference's
estimator.

Wavefront re-design vs the reference:
* Light vertices live in a dense [n_paths, max_len-1] tensor with validity
  masks instead of an atomically-appended Light Vertex Cache + index buffer
  (OptixRenderer.cpp:698-773); the one-time LVC size-estimate pass becomes
  unnecessary. 1:1 path pairing (pixel i <-> light path i % count,
  vcm.h:603-607) indexes rows directly.
* Light vertices store material id + frame instead of an embedded VcmBSDF
  byte blob (LightVertex.h:14-30); the BSDF is rebuilt from the material
  table at connection time.
* Camera splats are scatter-adds into the frame (.at[].add), not global
  buffer "+=" races (the reference comments on exactly those races,
  vcm.h:604-606).
* sampleScattering's zero-BSDF rejection leaves the reference's path
  un-advanced and re-traces the same ray (vcm.h:188-204); here rejection
  terminates the path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import pytree as struct

from ..accel.intersect import intersect, occluded
from ..bsdf import BSDF
from ..camera import Camera
from ..config import RenderConfig
from ..core.math import Array, dot, max3
from ..core.profiling import pass_scope
from ..core.rng import LaneSampler, iteration_key
from ..core.sampling import pdf_w_to_a
from ..lights import light_emit, light_illuminate
from ..scene.types import EMITTER, Scene
from .common import bsdf_at_hit, pixel_coords, scene_epsilon

PASS_VCM_LIGHT = 4
PASS_VCM_CAMERA = 5
BIG = 1e30
EPS_COSINE = 1e-6


def _mis(x):
    """vcmMis — balance heuristic (vcm_shared.h:12-16)."""
    return x


@struct.dataclass
class LightVertexStore:
    """Dense light-subpath vertices [n_paths, max_verts]."""

    position: Array     # [P,V,3]
    throughput: Array   # [P,V,3]
    dVCM: Array         # [P,V]
    dVC: Array          # [P,V]
    dVM: Array          # [P,V]
    mat: Array          # [P,V] int32
    ns: Array           # [P,V,3]
    ng: Array           # [P,V,3]
    wo: Array           # [P,V,3] dir back along the incoming ray
    valid: Array        # [P,V] bool
    depth: Array        # [P,V] int32: light path length at the vertex


def _cont_prob(bsdf: BSDF, cfg: RenderConfig):
    """RR continuation prob as used in MIS weights — must match what
    sampleScattering actually uses (incl. the testing override)."""
    if cfg.vcm_force_continuation_prob is not None:
        return jnp.full_like(bsdf.ior, cfg.vcm_force_continuation_prob)
    return bsdf.continuation_prob()


def _rebuild_bsdf(scene: Scene, mat: Array, ns: Array, ng: Array,
                  wo: Array) -> BSDF:
    kd, ks, expn, kr, kt, ior, diel = scene.materials.bsdf_coefficients(mat)
    return BSDF.make(ns, ng, wo, kd, ks, expn, kr, kt, ior, diel)


# ---------------------------------------------------------------------------
# light pass
# ---------------------------------------------------------------------------

def trace_light_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                     key: Array, eps, mis_vc_w: Array, mis_vm_w: Array,
                     lane_ids: Array, n_light_paths_global: int):
    """Light subpaths: store vertices + t=1 camera splats.

    ``lane_ids`` are GLOBAL path indices (this shard traces len(lane_ids)
    paths); ``n_light_paths_global`` is the total across all shards (used in
    the t=1 MIS weight and splat normalization).
    Returns (LightVertexStore, splat_image [H,W,3], stats).
    """
    W, H = cfg.width, cfg.height
    n_paths = lane_ids.shape[0]
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    n_lights = scene.lights.n_lights
    center, radius = scene.bounding_sphere
    max_verts = cfg.vcm_max_path_length - 1

    # --- initLightPayload (VCMLightPass.cu:117-163) ----------------------
    li = jnp.minimum((s.next1() * n_lights).astype(jnp.int32),
                     n_lights - 1)
    rows = scene.lights.row(li)
    light_pick_pdf = 1.0 / n_lights
    radiance, o, d, emission_pdf_w, direct_pdf_w, cos_at_light = light_emit(
        rows, s.next2(), s.next2(), center, radius,
        eps_cosine=cfg.eps_cosine)
    emission_pdf_w = jax.lax.stop_gradient(
        emission_pdf_w * light_pick_pdf)
    direct_pdf_w = jax.lax.stop_gradient(direct_pdf_w * light_pick_pdf)
    throughput = radiance / jnp.maximum(emission_pdf_w, 1e-30)[:, None]
    is_finite_light = rows.is_finite
    is_delta_light = rows.is_delta

    # --- initLightMisTerms (mis.h:35-80) ---------------------------------
    dVCM = _mis(direct_pdf_w / jnp.maximum(emission_pdf_w, 1e-30))
    used_cos = jnp.where(is_finite_light, cos_at_light, 1.0)
    dVC = jnp.where(is_delta_light, 0.0,
                    _mis(used_cos / jnp.maximum(emission_pdf_w, 1e-30)))
    dVM = dVC * mis_vc_w

    alive = jnp.ones((n_paths,), jnp.bool_)
    splat = jnp.zeros((H * W, 3), jnp.float32)
    store = LightVertexStore(
        position=jnp.zeros((n_paths, max_verts, 3)),
        throughput=jnp.zeros((n_paths, max_verts, 3)),
        dVCM=jnp.zeros((n_paths, max_verts)),
        dVC=jnp.zeros((n_paths, max_verts)),
        dVM=jnp.zeros((n_paths, max_verts)),
        mat=jnp.zeros((n_paths, max_verts), jnp.int32),
        ns=jnp.zeros((n_paths, max_verts, 3)),
        ng=jnp.zeros((n_paths, max_verts, 3)),
        wo=jnp.zeros((n_paths, max_verts, 3)),
        valid=jnp.zeros((n_paths, max_verts), jnp.bool_),
        depth=jnp.zeros((n_paths, max_verts), jnp.int32))
    n_stored = jnp.zeros((n_paths,), jnp.int32)

    def light_step(carry, depth1):  # depth1 = depth after ++
        (o, d, throughput, dVCM, dVC, dVM, alive, store, n_stored,
         splat) = carry
        skey = LaneSampler(jax.random.fold_in(key, 3000 + depth1),
                           lane_ids, cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, jnp.full((n_paths,), 1.0) * eps,
                        jnp.where(alive, BIG, 0.0))    # dead: empty ray
        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        live = alive & hit.hit & ~is_emitter  # emitter absorbs
        # (DiffuseEmitter.cu:76-79: light path terminates on emitters)

        n_eff = bsdf.frame.n  # possibly flipped for glass
        cos_in = dot(n_eff, -d)
        live = live & (cos_in >= EPS_COSINE)  # vcm.h:245-250

        # updateMisTermsOnHit (mis.h:109-123)
        dVCM = jnp.where(live, dVCM * _mis(jnp.square(hit.t)) / _mis(cos_in),
                         dVCM)
        dVC = jnp.where(live, dVC / _mis(cos_in), dVC)
        dVM = jnp.where(live, dVM / _mis(cos_in), dVM)

        is_spec = bsdf.is_specular()
        storeable = live & ~is_spec

        # --- store vertex (vcm.h:256-291); OOB slot drops the write ------
        # one-hot masked writes instead of .at[pidx, slot].set over the
        # short slot axis (as accel/bvh._oh_write); this writes 10
        # buffers x max_verts(~9) slots per depth
        slot = jnp.where(storeable, n_stored, max_verts)
        oh = jnp.arange(max_verts)[None, :] == slot[:, None]   # [P,V]

        def put(buf, val):
            m = oh.reshape(oh.shape + (1,) * (buf.ndim - 2))
            return jnp.where(m, val[:, None, ...], buf)

        store = LightVertexStore(
            position=put(store.position, hit.position),
            throughput=put(store.throughput, throughput),
            dVCM=put(store.dVCM, dVCM), dVC=put(store.dVC, dVC),
            dVM=put(store.dVM, dVM), mat=put(store.mat, hit.mat),
            ns=put(store.ns, n_eff), ng=put(store.ng, bsdf.ng),
            wo=put(store.wo, -d),
            valid=put(store.valid, jnp.ones((n_paths,), jnp.bool_)),
            depth=put(store.depth,
                      jnp.full((n_paths,), depth1, jnp.int32)))
        n_stored = n_stored + storeable.astype(jnp.int32)

        # --- t=1: connect to camera (vcm.h:65-161) ------------------------
        if cfg.vcm_connect_camera_t1:
            splat = splat + _connect_camera_t1(
                scene, camera, cfg, bsdf, hit.position, throughput,
                dVCM, dVC, storeable, n_light_paths_global, mis_vm_w, eps)

        # --- terminate if too long (vcm.h:303-307), else scatter ----------
        can_continue = live & (cfg.vcm_max_path_length >= depth1 + 2)
        (o, d, throughput, dVCM, dVC, dVM, alive) = _sample_scattering(
            skey, bsdf, hit.position, throughput, dVCM, dVC, dVM,
            can_continue, mis_vc_w, mis_vm_w, adjoint=True,
            force_cont_prob=cfg.vcm_force_continuation_prob)
        return (o, d, throughput, dVCM, dVC, dVM, alive, store, n_stored,
                splat), None

    carry = (o, d, throughput, dVCM, dVC, dVM, alive, store, n_stored, splat)
    carry, _ = jax.lax.scan(light_step, carry,
                            jnp.arange(1, cfg.vcm_max_path_length))
    (o, d, throughput, dVCM, dVC, dVM, alive, store, n_stored,
     splat) = carry

    stats = dict(light_vertices_stored=jnp.sum(n_stored),
                 avg_light_path_verts=jnp.mean(n_stored.astype(jnp.float32)))
    return store, splat.reshape(H, W, 3), stats


def _exp(mask: Array, extra_dims: int) -> Array:
    for _ in range(extra_dims):
        mask = mask[..., None]
    return mask


def _connect_camera_t1(scene, camera, cfg, bsdf, hitpoint, throughput,
                       dVCM, dVC, active, n_light_paths, mis_vm_w, eps):
    """connectCameraT1 (vcm.h:65-161) -> splat buffer [H*W,3]."""
    W, H = cfg.width, cfg.height
    to_cam = camera.eye - hitpoint
    dist = jnp.linalg.norm(to_cam, axis=-1)
    dir_to_cam = to_cam / jnp.maximum(dist, 1e-20)[:, None]

    px, py, inside, _ = camera.world_to_raster(hitpoint, W, H)
    pix = (jnp.clip(py.astype(jnp.int32), 0, H - 1) * W
           + jnp.clip(px.astype(jnp.int32), 0, W - 1))

    f, cos_to_cam, _dpdf, rev_pdf = bsdf.f(dir_to_cam)
    rev_pdf = rev_pdf * _cont_prob(bsdf, cfg)

    camera_pdf_w, cos_at_cam = camera.pdf_quantities(-dir_to_cam, W, H)
    ok_cam = cos_at_cam > 1e-6
    camera_pdf_a = jax.lax.stop_gradient(jnp.where(
        ok_cam,
        camera_pdf_w * jnp.abs(cos_to_cam)
        / jnp.maximum(jnp.square(dist), 1e-20), 0.0))

    w_light = jnp.maximum(0.0, _mis(camera_pdf_a / n_light_paths) * (
        mis_vm_w + dVCM + dVC * _mis(rev_pdf)))
    mis_weight = jax.lax.stop_gradient(1.0 / (w_light + 1.0))

    contrib = (mis_weight[:, None] * throughput * f
               * (camera_pdf_a / n_light_paths)[:, None])

    ok = active & inside & (max3(f) > 0.0) & ok_cam
    # not-ok lanes trace an empty interval: they exit the BVH loop at the
    # root and the compaction ladder drops them immediately (the t=1 splat
    # is live on a small fraction of lanes at deeper bounces)
    occ = occluded(scene, hitpoint, dir_to_cam,
                   jnp.full_like(dist, 1.0) * eps,
                   jnp.where(ok, jnp.maximum(dist - 2 * eps, eps), 0.0))
    ok = ok & ~occ
    contrib = jnp.where(ok[:, None], contrib, 0.0)
    return jnp.zeros((H * W, 3)).at[jnp.where(ok, pix, 0)].add(contrib)


def _sample_scattering(skey: LaneSampler, bsdf: BSDF, hitpoint, throughput,
                       dVCM, dVC, dVM, can_continue, mis_vc_w, mis_vm_w,
                       adjoint: bool, force_cont_prob: float | None = None):
    """sampleScattering (vcm.h:166-204) + updateMisTermsOnScatter
    (mis.h:133-186), vectorized with masks."""
    if force_cont_prob is not None:
        cont_prob = jnp.full_like(bsdf.ior, force_cont_prob)
    else:
        cont_prob = bsdf.continuation_prob()
    rr = skey.next1() < cont_prob
    live = can_continue & rr

    res = bsdf.sample(skey.next3(), adjoint=adjoint)
    live = live & res.valid & (res.pdf_w > 0.0)

    # reverse pdf: same as direct for specular, else evaluated (vcm.h:184-187)
    _, _, _dp, rev = bsdf.f(res.world_dir)
    rev_pdf = jnp.where(res.is_specular, res.pdf_w, rev)
    dir_pdf = res.pdf_w * cont_prob
    rev_pdf = rev_pdf * cont_prob

    cos_out = res.cos_theta
    # updateMisTermsOnScatter
    safe_dir = jnp.maximum(dir_pdf, 1e-30)
    new_dVC_spec = dVC * _mis(cos_out)
    new_dVM_spec = dVM * _mis(cos_out)
    new_dVCM_spec = jnp.zeros_like(dVCM)
    new_dVC_ns = _mis(cos_out / safe_dir) * (dVC * _mis(rev_pdf) + dVCM
                                             + mis_vm_w)
    new_dVM_ns = _mis(cos_out / safe_dir) * (dVM * _mis(rev_pdf)
                                             + dVCM * mis_vc_w + 1.0)
    new_dVCM_ns = _mis(1.0 / safe_dir)

    sp = res.is_specular
    dVC_n = jnp.where(live, jnp.where(sp, new_dVC_spec, new_dVC_ns), dVC)
    dVM_n = jnp.where(live, jnp.where(sp, new_dVM_spec, new_dVM_ns), dVM)
    dVCM_n = jnp.where(live, jnp.where(sp, new_dVCM_spec, new_dVCM_ns), dVCM)

    w = res.f * (cos_out / jnp.maximum(dir_pdf, 1e-30))[:, None]
    thr = jnp.where(live[:, None], throughput * w, throughput)
    return hitpoint, res.world_dir, thr, dVCM_n, dVC_n, dVM_n, live


# ---------------------------------------------------------------------------
# vertex merging (VM) — the half of VCM the reference scaffolds but never
# finishes (OptixRenderer.cpp:300-301 "vmNormalization ... merging disabled";
# vcm.h computes mis_vm terms that are dead with the factor pinned to 0).
# Implemented per the "Implementing VCM" tech report (SmallVCM VertexCM
# merge): camera vertex x gathers light vertices y with |x-y| <= r and
# accumulates misWeight * f_cam(y.wo) * y.throughput / (pi r^2 nLightPaths).
# The spatial structure is the SAME sorted-uniform-grid machinery as the
# photon map (photon_map.gather_cell_indices).
# ---------------------------------------------------------------------------

@struct.dataclass
class VertexGrid:
    """Sorted uniform grid over the flattened light-vertex store."""

    position: Array    # [M,3]
    wo: Array          # [M,3] world dir back along the vertex's incoming ray
    throughput: Array  # [M,3]
    dVCM: Array        # [M]
    dVM: Array         # [M]
    cont: Array        # [M] RR continuation prob of the vertex's BSDF
    depth: Array       # [M] light path length at the vertex (float32)
    offsets: Array     # [R^3+1] int32
    origin: Array      # [3]
    cell_size: Array   # []
    resolution: int = struct.field(static=True)


def build_vertex_grid(scene: Scene, cfg: RenderConfig,
                      store: LightVertexStore, radius: Array) -> VertexGrid:
    """Flatten the store and sort by grid cell (build_photon_grid pattern,
    OptixRenderer_SpatialHash.cu:209-283 applied to light vertices)."""
    from ..photon_map import min_cell_size_for_window, photon_grid_geometry
    from ..photon_map import PhotonBatch

    flat = jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), store)
    res = cfg.photon_grid_resolution
    mcs = min_cell_size_for_window(radius, 4)
    origin, cell_size = photon_grid_geometry(
        PhotonBatch(position=flat.position, power=flat.throughput,
                    direction=flat.wo, valid=flat.valid), res,
        min_cell_size=mcs)

    # per-vertex reverse continuation prob (SmallVCM: aLightVertex.mBsdf
    # .ContinuationProb() scales the camera->light reverse pdf in the merge
    # MIS weight) — computed once here instead of rebuilding BSDFs per
    # gathered row
    lv_bsdf = _rebuild_bsdf(scene, flat.mat, flat.ns, flat.ng, flat.wo)
    cont = _cont_prob(lv_bsdf, cfg)

    from ..photon_map import cell_coords, cell_index_1d
    n_cells = res ** 3
    cells = cell_index_1d(cell_coords(flat.position, origin, cell_size, res),
                          res)
    cells = jnp.where(flat.valid, cells, n_cells)
    p, w, t = flat.position, flat.wo, flat.throughput
    # argsort + row gather, not a 14-operand co-sort (sort compile time
    # grows with the operand count — see photon_map.build_photon_grid)
    cells_sorted, order = jax.lax.sort(
        (cells, jnp.arange(p.shape[0], dtype=jnp.int32)), num_keys=1)
    cols = jnp.concatenate(
        [p, w, t, flat.dVCM[:, None], flat.dVM[:, None], cont[:, None],
         flat.depth.astype(jnp.float32)[:, None]], axis=1)[order]
    offsets = jnp.searchsorted(cells_sorted,
                               jnp.arange(n_cells + 1, dtype=cells.dtype),
                               method="sort")
    return VertexGrid(
        position=cols[:, 0:3],
        wo=cols[:, 3:6],
        throughput=cols[:, 6:9],
        dVCM=cols[:, 9], dVM=cols[:, 10], cont=cols[:, 11],
        depth=cols[:, 12],
        offsets=offsets.astype(jnp.int32), origin=origin,
        cell_size=cell_size, resolution=res)


def _merge_vertices(scene: Scene, cfg: RenderConfig, cam_bsdf: BSDF,
                    cam_pos, cam_thr, cam_dVCM, cam_dVM, active,
                    vgrid: VertexGrid, radius_sq, mis_vc_w, n_light_paths,
                    u_stride, depth1):
    """One camera vertex x light-vertex-grid merge round.

    MIS weights per SmallVCM's VertexCM::RangeQuery::Process:
      wLight  = lv.dVCM * misVcWeightFactor + lv.dVM * Mis(cameraDirPdfW)
      wCamera = cam.dVCM * misVcWeightFactor + cam.dVM * Mis(cameraRevPdfW)
    with the dir pdf scaled by the camera continuation prob and the rev pdf
    by the light vertex's. Kernel: the repo's Jensen gaussian (consistent
    with the PPM gather; SmallVCM uses the constant kernel — documented
    deviation), normalized by 1/(pi r^2 nLightPaths) like
    OptixRenderer.cpp:300's vmNormalization.
    Returns the merged contribution [n,3] (already multiplied by cam_thr).
    ``u_stride`` [n] drives the unbiased subsampling of over-full boxes.
    """
    from ..photon_map import gather_cell_indices, gaussian_kernel_weight

    radius = jnp.sqrt(radius_sq)
    gidx, gok, stride, _total = gather_cell_indices(
        vgrid.offsets, vgrid.origin, vgrid.cell_size, vgrid.resolution,
        cam_pos, radius, max_cells_per_axis=4,
        budget_total=cfg.vcm_vm_budget, u_stride=u_stride)

    ppos = vgrid.position[gidx]       # [N,B,3]
    pwo = vgrid.wo[gidx]
    pthr = vgrid.throughput[gidx]
    pdvcm = vgrid.dVCM[gidx]          # [N,B]
    pdvm = vgrid.dVM[gidx]
    pcont = vgrid.cont[gidx]
    pdep = vgrid.depth[gidx]

    diff = cam_pos[:, None, :] - ppos
    d2 = dot(diff, diff)
    ok = (gok & (d2 <= radius_sq) & active[:, None]
          & (pdep + depth1 <= cfg.vcm_max_path_length))

    # camera BSDF evaluated at the light vertex's incoming direction,
    # broadcast over the gather axis
    bsdf_b = jax.tree_util.tree_map(lambda a: a[:, None, ...], cam_bsdf)
    f, _cos, dpdf, rpdf = bsdf_b.f(pwo)
    # SmallVCM: the dir pdf (continuing the LIGHT path through x) is scaled
    # by the light vertex's continuation prob; the rev pdf (camera path
    # continuing) by the camera BSDF's
    cam_cont = _cont_prob(cam_bsdf, cfg)
    dpdf = dpdf * pcont
    rpdf = rpdf * cam_cont[:, None]

    w_light = pdvcm * mis_vc_w + pdvm * _mis(dpdf)
    w_camera = (cam_dVCM * mis_vc_w)[:, None] + cam_dVM[:, None] * _mis(rpdf)
    mis_weight = jax.lax.stop_gradient(1.0 / (w_light + 1.0 + w_camera))

    kw = gaussian_kernel_weight(d2, radius_sq)
    acc = jnp.sum(jnp.where(ok[..., None],
                            f * pthr * (mis_weight * kw)[..., None], 0.0),
                  axis=-2)
    acc = acc * stride[:, None].astype(jnp.float32)   # subsample reweight
    norm = 1.0 / (jnp.pi * radius_sq * n_light_paths)
    return cam_thr * acc * norm


# ---------------------------------------------------------------------------
# camera pass
# ---------------------------------------------------------------------------

def trace_camera_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                      key: Array, eps, mis_vc_w: Array, mis_vm_w: Array,
                      store: LightVertexStore, n_light_paths: int,
                      px: Array, py: Array, lane_ids: Array, pair: Array,
                      vgrid: VertexGrid | None = None,
                      radius_sq: Array | None = None):
    """``pair`` indexes rows of ``store`` (1:1 pairing, vcm.h:603-607);
    under sharding it is the device-local pairing, which permutes but
    preserves the estimator. ``n_light_paths`` is the global count.
    ``vgrid``/``radius_sq`` enable the vertex-merging rounds (required when
    cfg.vcm_use_vm)."""
    if cfg.vcm_use_vm and vgrid is None:
        raise ValueError("cfg.vcm_use_vm requires a VertexGrid "
                         "(build_vertex_grid) and radius_sq")
    W, H = cfg.width, cfg.height
    n = px.shape[0]
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    n_lights = scene.lights.n_lights
    center, sradius = scene.bounding_sphere
    light_pick_prob = 1.0 / n_lights
    max_verts = cfg.vcm_max_path_length - 1

    o, d = camera.generate_rays(px, py, s.next2(), W, H,
                                dof_u=s.next2())
    camera_pdf_w, _ = camera.pdf_quantities(d, W, H)

    uniform = cfg.vcm_uniform_vertex_sampling
    if uniform:
        # VCM_UNIFORM_VERTEX_SAMPLING: flatten the dense store and compact
        # valid vertices to the front (valid-first stable sort replaces the
        # reference's atomically-appended LVC, vcm.h:281) so a uniform draw
        # over [0, n_valid) picks any stored vertex with equal probability
        # (vcm.h:583-601).
        flat = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), store)
        compact = jnp.argsort(~flat.valid, stable=True)
        n_valid = jnp.sum(flat.valid).astype(jnp.int32)
        n_conn = max(1, cfg.vcm_uniform_connections)
        # Pick-pdf normalization. The target quantity is the SAME as 1:1
        # pairing: the per-light-path expected sum of vertex connections,
        # i.e. (1/n_paths) sum over ALL stored vertices. With n_conn
        # uniform draws over n_valid vertices, each draw must be scaled by
        #   invPick = n_valid / (n_conn * n_light_paths)
        # (the reference's uniform branch is unfinished — its vertexPickPdf
        # line references variables that don't exist, OptixRenderer.cpp:757
        # with a "TODO scale by pick prob" at vcm.h:586 — so the estimator
        # here is derived, and validated against 1:1 mode by
        # tests/test_vcm.py::test_uniform_vertex_sampling_agrees_with_paired.)
        inv_pick = jax.lax.stop_gradient(
            jnp.maximum(n_valid.astype(jnp.float32), 1.0)
            / (n_conn * n_light_paths))
        store_p = None
    else:
        # hoist the paired light-subpath rows out of the bounce loop:
        # ``pair`` is fixed for the whole camera path, so gather the store
        # ONCE ([n, max_verts, ...]) instead of regathering per (depth x
        # vertex) step
        store_p = jax.tree_util.tree_map(lambda a: a[pair], store)

    # initCameraMisTerms (mis.h:84-105)
    dVCM = jax.lax.stop_gradient(_mis(n_light_paths / camera_pdf_w))
    dVC = jnp.zeros((n,))
    dVM = jnp.zeros((n,))
    throughput = jnp.ones((n, 3))
    color = jnp.zeros((n, 3))
    alive = jnp.ones((n,), jnp.bool_)

    def camera_step(carry, depth1):
        o, d, throughput, dVCM, dVC, dVM, alive, color = carry
        skey = LaneSampler(jax.random.fold_in(key, 4000 + depth1),
                           lane_ids, cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, jnp.full((n,), 1.0) * eps,
                        jnp.where(alive, BIG, 0.0))    # dead: empty ray
        live = alive & hit.hit

        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        n_eff = bsdf.frame.n
        cos_in = dot(n_eff, -d)

        # updateMisTermsOnHit (mis.h:109-123) — BEFORE any technique runs.
        # SmallVCM updates dVCM/dVC/dVM immediately on hit; the s0 weight
        # at depth>=2 must see THIS segment's t^2/cos factor. Found by the
        # analytic polygon-light test (tests/test_analytic.py): the stale
        # dVCM inflated s0's mis weight ~3.7x on that scene -> +5% image
        # energy with every per-technique estimator individually exact.
        upd = live & (cos_in >= EPS_COSINE)
        dVCM = jnp.where(upd, dVCM * _mis(jnp.square(hit.t))
                         / _mis(cos_in), dVCM)
        dVC = jnp.where(upd, dVC / _mis(cos_in), dVC)
        dVM = jnp.where(upd, dVM / _mis(cos_in), dVM)

        # --- s=0: emitter hit (DiffuseEmitter.cu:95-119 + vcm.h:493-522) --
        em = live & is_emitter
        if cfg.vcm_connect_light_s0:
            lemit = scene.materials.emission[hit.mat]
            front = dot(hit.ns, -d) > 0.0
            mrow = scene.materials.light_index[hit.mat]
            inv_area = scene.lights.inverse_area[jnp.maximum(mrow, 0)]
            from ..core.sampling import cos_hemisphere_pdf_w
            direct_pdf_a = inv_area * light_pick_prob
            emission_pdf_w = cos_hemisphere_pdf_w(hit.ng, -d) * inv_area \
                * light_pick_prob
            w_camera = jnp.maximum(0.0, _mis(direct_pdf_a) * dVCM
                                   + _mis(emission_pdf_w) * dVC)
            mis_weight = jax.lax.stop_gradient(
                jnp.where(depth1 == 1, 1.0, 1.0 / (1.0 + w_camera)))
            contrib = throughput * lemit * mis_weight[:, None]
            color = color + jnp.where((em & front)[:, None], contrib, 0.0)
        alive_after_em = live & ~em  # emitter terminates the path

        live2 = alive_after_em & (cos_in >= EPS_COSINE)

        is_spec = bsdf.is_specular()
        connectable = live2 & ~is_spec

        # --- s=1: NEE with full MIS (vcm.h:406-488) -----------------------
        if cfg.vcm_connect_light_s1:
            li = jnp.minimum((skey.next1() * n_lights).astype(jnp.int32),
                             n_lights - 1)
            rows = scene.lights.row(li)
            radiance, dir_l, ldist, direct_pdf_w, emission_pdf_w, \
                cos_at_light = light_illuminate(
                    rows, skey.next2(), hit.position, center, sradius,
                    eps_cosine=cfg.eps_cosine)
            f, cos_to_light, bsdf_dir_pdf, bsdf_rev_pdf = bsdf.f(dir_l)
            cont = _cont_prob(bsdf, cfg)
            bsdf_dir_pdf = jnp.where(rows.is_delta, 0.0,
                                     bsdf_dir_pdf * cont)
            bsdf_rev_pdf = bsdf_rev_pdf * cont
            w_light = jnp.maximum(0.0, _mis(
                bsdf_dir_pdf / jnp.maximum(
                    light_pick_prob * direct_pdf_w, 1e-30)))
            w_camera = jnp.maximum(0.0, _mis(
                emission_pdf_w * jnp.maximum(cos_to_light, 0.0)
                / jnp.maximum(direct_pdf_w * cos_at_light, 1e-30))
                * (mis_vm_w + dVCM + dVC * _mis(bsdf_rev_pdf)))
            mis_weight = jax.lax.stop_gradient(
                1.0 / (w_light + 1.0 + w_camera))
            geom_factor = jax.lax.stop_gradient(
                jnp.maximum(cos_to_light, 0.0)
                / jnp.maximum(light_pick_prob * direct_pdf_w, 1e-30))
            contrib = (mis_weight * geom_factor)[:, None] \
                * radiance * f * throughput
            ok = connectable & (max3(radiance) > 0.0) & (max3(f) > 0.0)
            # not-ok lanes trace an empty interval (instant root miss)
            occ = occluded(scene, hit.position, dir_l,
                           jnp.full((n,), 1.0) * eps,
                           jnp.where(ok, jnp.maximum(ldist - 2 * eps, eps),
                                     0.0))
            color = color + jnp.where((ok & ~occ)[:, None], contrib, 0.0)

        # --- vertex connections (vcm.h:315-400, loop :603-616) ------------
        if cfg.vcm_connect_vertices and uniform:
            # uniform vertex sampling: n_conn uniformly picked vertices
            # from the global store per camera vertex (vcm.h:583-601)
            for _k in range(n_conn):
                u = skey.next1()
                vi = jnp.minimum((u * n_valid.astype(jnp.float32))
                                 .astype(jnp.int32),
                                 jnp.maximum(n_valid - 1, 0))
                src = compact[vi]
                lv = jax.tree_util.tree_map(lambda a: a[src], flat)
                lv_bsdf = _rebuild_bsdf(scene, lv.mat, lv.ns, lv.ng, lv.wo)
                color = color + _connect_vertices(
                    scene, cfg, bsdf, hit.position, throughput, dVCM, dVC,
                    lv_bsdf, lv.position, lv.throughput, lv.dVCM, lv.dVC,
                    connectable & lv.valid & (n_valid > 0), mis_vm_w, eps,
                    inv_vert_pick_pdf=inv_pick)
        elif cfg.vcm_connect_vertices:
            def vc_step(color_acc, lv):
                lv_bsdf = _rebuild_bsdf(scene, lv.mat, lv.ns, lv.ng, lv.wo)
                color_acc = color_acc + _connect_vertices(
                    scene, cfg, bsdf, hit.position, throughput, dVCM, dVC,
                    lv_bsdf, lv.position, lv.throughput, lv.dVCM, lv.dVC,
                    connectable & lv.valid, mis_vm_w, eps)
                return color_acc, None

            # scan over the vertex axis of the pre-gathered store (the
            # per-step slice is contiguous — no gathers in the loop)
            store_scan = jax.tree_util.tree_map(
                lambda a: jnp.moveaxis(a, 1, 0), store_p)
            color, _ = jax.lax.scan(vc_step, color, store_scan)

        # --- vertex merging (tech report sec. 5; SmallVCM merge) ----------
        if cfg.vcm_use_vm:
            color = color + _merge_vertices(
                scene, cfg, bsdf, hit.position, throughput, dVCM, dVM,
                connectable, vgrid, radius_sq, mis_vc_w, n_light_paths,
                skey.next1(), depth1)

        # --- terminate if path too long, else scatter ---------------------
        can_continue = live2 & (depth1 < cfg.vcm_max_path_length)
        (o, d, throughput, dVCM, dVC, dVM, alive) = _sample_scattering(
            skey, bsdf, hit.position, throughput, dVCM, dVC, dVM,
            can_continue, mis_vc_w, mis_vm_w, adjoint=False,
            force_cont_prob=cfg.vcm_force_continuation_prob)
        return (o, d, throughput, dVCM, dVC, dVM, alive, color), None

    carry = (o, d, throughput, dVCM, dVC, dVM, alive, color)
    carry, _ = jax.lax.scan(
        camera_step, carry,
        jnp.arange(1, cfg.vcm_max_path_length + 1))
    return carry[-1]


def _connect_vertices(scene, cfg, cam_bsdf, cam_hit, cam_thr, cam_dVCM,
                      cam_dVC, lv_bsdf, lv_pos, lv_thr, lv_dVCM, lv_dVC,
                      active, mis_vm_w, eps, inv_vert_pick_pdf=1.0):
    """connectVertices (vcm.h:315-400). ``inv_vert_pick_pdf`` is 1 for 1:1
    pairing; under uniform vertex sampling it is 1/vertexPickPdf
    (vcm.h:367-371: scales the contribution and the mis_vm_w terms)."""
    direction = lv_pos - cam_hit
    dist2 = dot(direction, direction)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-30))
    direction = direction / dist[:, None]

    cam_f, cam_cos, cam_dir_pdf, cam_rev_pdf = cam_bsdf.f(direction)
    cam_cont = _cont_prob(cam_bsdf, cfg)
    cam_dir_pdf = cam_dir_pdf * cam_cont
    cam_rev_pdf = cam_rev_pdf * cam_cont

    lv_f, lv_cos, lv_dir_pdf, lv_rev_pdf = lv_bsdf.f(-direction)
    lv_cont = _cont_prob(lv_bsdf, cfg)
    lv_dir_pdf = lv_dir_pdf * lv_cont
    lv_rev_pdf = lv_rev_pdf * lv_cont

    geometry = jax.lax.stop_gradient(
        lv_cos * cam_cos / jnp.maximum(dist2, 1e-30))

    cam_dir_pdf_a = pdf_w_to_a(cam_dir_pdf, dist, lv_cos)
    lv_dir_pdf_a = pdf_w_to_a(lv_dir_pdf, dist, cam_cos)

    w_light = jnp.maximum(0.0, _mis(cam_dir_pdf_a) * (
        mis_vm_w * inv_vert_pick_pdf + lv_dVCM + lv_dVC * _mis(lv_rev_pdf)))
    w_camera = jnp.maximum(0.0, _mis(lv_dir_pdf_a) * (
        mis_vm_w * inv_vert_pick_pdf + cam_dVCM
        + cam_dVC * _mis(cam_rev_pdf)))
    mis_weight = jax.lax.stop_gradient(
        1.0 / (w_light + 1.0 + w_camera))

    contrib = (geometry * mis_weight * inv_vert_pick_pdf)[:, None] \
        * cam_f * lv_f * cam_thr * lv_thr

    ok = (active & (geometry > 0.0) & (max3(cam_f) > 0.0)
          & (max3(lv_f) > 0.0))
    # not-ok lanes trace an empty interval: at deeper bounces most lanes
    # are dead or unconnectable, and this is the hottest loop in VCM
    # (vcm_max_path_length x (max_len-1) occlusion waves per iteration)
    occ = occluded(scene, cam_hit, direction,
                   jnp.full_like(dist, 1.0) * eps,
                   jnp.where(ok, jnp.maximum(dist - 2 * eps, eps), 0.0))
    return jnp.where((ok & ~occ)[:, None], contrib, 0.0)


# ---------------------------------------------------------------------------
# full iteration
# ---------------------------------------------------------------------------

def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration: Array, base_key: Array,
                     radius_sq: Array) -> tuple[Array, dict]:
    eps = scene_epsilon(scene)
    n_light_paths = cfg.width * cfg.height  # light launch = image size

    # host-side MIS factors (OptixRenderer.cpp:675-696):
    # etaVCM = (nVM/nVC) pi r^2 with nVM = n_light_paths and nVC = 1 for
    # 1:1 pairing, n_light_paths for uniform vertex sampling (:679)
    n_vc = n_light_paths if cfg.vcm_uniform_vertex_sampling else 1
    eta_vcm = (float(n_light_paths) / n_vc) * jnp.pi * radius_sq
    mis_vm_w = _mis(eta_vcm) if cfg.vcm_use_vm else jnp.zeros(())
    mis_vc_w = _mis(1.0 / eta_vcm) if cfg.vcm_use_vc else jnp.zeros(())

    lkey = iteration_key(base_key, iteration, PASS_VCM_LIGHT)
    ckey = iteration_key(base_key, iteration, PASS_VCM_CAMERA)

    n = cfg.width * cfg.height
    path_lanes = jnp.arange(n_light_paths, dtype=jnp.int32)
    with pass_scope("vcm_light_pass"):
        store, splat, lstats = trace_light_pass(
            scene, camera, cfg, lkey, eps, mis_vc_w, mis_vm_w, path_lanes,
            n_light_paths)
    vgrid = None
    if cfg.vcm_use_vm:
        with pass_scope("vcm_vertex_grid"):
            vgrid = build_vertex_grid(scene, cfg, store,
                                      jnp.sqrt(radius_sq))
    px, py = pixel_coords(cfg.width, cfg.height)
    pixel_lanes = jnp.arange(n, dtype=jnp.int32)
    pair = pixel_lanes % n_light_paths
    with pass_scope("vcm_camera_pass"):
        color = trace_camera_pass(
            scene, camera, cfg, ckey, eps, mis_vc_w, mis_vm_w, store,
            n_light_paths, px, py, pixel_lanes, pair, vgrid=vgrid,
            radius_sq=radius_sq)
    return color.reshape(cfg.height, cfg.width, 3) + splat, lstats
