"""Progressive photon mapping (wavefront).

Pass schedule per iteration matches OptixRenderer::renderNextIteration for
PPM (``renderer/OptixRenderer.cpp:569-672``):

1. eye pass  — trace radiance rays, walk specular chains, store hitpoints
               (``ppm/RayGeneratorPPM.cu``; material programs fill Hitpoint)
2. photon pass — emit cfg.photons_per_iteration photons, deposit <=
               cfg.max_photon_deposits_per_emitted per path at non-specular
               hits from depth>=1, RR from depth 3
               (``ppm/PhotonGenerator.cu``, ``material/Diffuse.cu:92-131``)
3. grid build — sorted uniform grid (photon_map.build_photon_grid)
4. indirect estimation — kernel-weighted gather at hitpoints
               (``ppm/IndirectRadianceEstimation.cu``)
5. direct estimation — 4 shadow samples at hitpoints; emitter/miss pixels
               pass stored radiance through
               (``ppm/DirectRadianceEstimation.cu``)
6. output — direct + indirect accumulated by the caller's Film
               (``ppm/Output.cu:32-37``)

The Knaus-Zwicker radius comes in per iteration from the host
(renderer.ppm_radius_sq_at_iteration), like the reference computes it on the
host per frame.

Deliberate fixes vs the reference (documented): photon emission from area
lights is cosine-distributed (exact for Lambertian emitters; the reference
uses uniform-hemisphere without reweighting, PhotonGenerator.cu:48-52), the
gather applies the BRDF kd/pi (reference multiplies kd only), and the
emitter display clamp ``min(radiance, 1)`` (DirectRadianceEstimation.cu:38)
is dropped. RenderConfig.reference_faithful restores the clamp and the
albedo-not-f NEE for parity renders.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import pytree as struct

from ..accel.intersect import intersect
from ..camera import Camera
from ..config import PhotonMapStructure, RenderConfig
from ..core.math import Array, dot, max3
from ..core.profiling import pass_scope
from ..core.rng import LaneSampler, iteration_key
from ..core.sampling import (sample_cone, sample_disc, sample_unit_sphere,
                             sample_unit_hemisphere_cos)
from ..lights import AREA, POINT, SPOT
from ..photon_map import (PhotonBatch, build_photon_grid,
                          build_stochastic_hash, gather_photons,
                          gather_stochastic_hash, min_cell_size_for_window)
from ..scene.types import Scene
from .common import bsdf_at_hit, nee_direct, pixel_coords, scene_epsilon

PASS_PPM_EYE = 1
PASS_PPM_PHOTON = 2
PASS_PPM_ESTIMATE = 3
BIG = 1e30


@struct.dataclass
class HitpointBuffer:
    """Per-pixel first-non-specular-hit record (renderer/Hitpoint.h:9-18 +
    enough to rebuild the BSDF for direct/indirect estimation)."""

    position: Array     # [N,3]
    wo: Array           # [N,3] direction back toward the previous vertex
    attenuation: Array  # [N,3] specular-chain throughput
    radiance: Array     # [N,3] emitter radiance picked up on the walk
    mat: Array          # [N] material id at the stored hit
    kd: Array           # [N,3] diffuse reflectance (texture-modulated)
    ns: Array           # [N,3] shading normal
    ng: Array           # [N,3] geometric normal
    found: Array        # [N] bool: stored a non-specular hit
    # flags mirroring RadiancePRD bits
    hit_emitter: Array  # [N]
    specular_chain: Array  # [N] passed through >=1 specular vertex
    # participating-media in-scatter sample (zeros when no medium): ONE
    # weighted-reservoir-picked segment of the WHOLE eye walk (the
    # reference gathers on every in-medium segment,
    # ParticipatingMedium.cu:66-201; a reweighted single sample keeps one
    # volumetric gather per pixel and stays unbiased)
    vol_point: Array    # [N,3] sampled in-medium point
    vol_t: Array        # [N] distance into the medium at the sample
    vol_len: Array      # [N] in-medium overlap length of the segment
    vol_atten: Array    # [N,3] path attenuation up to the segment start
    vol_w: Array        # [N] reservoir weight of the selected segment
    vol_wsum: Array     # [N] total reservoir weight over the walk


# ---------------------------------------------------------------------------
# 1. eye pass
# ---------------------------------------------------------------------------

def trace_eye_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                   key: Array, eps, px: Array, py: Array,
                   lane_ids: Array) -> HitpointBuffer:
    W, H = cfg.width, cfg.height
    n = px.shape[0]
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), W, H,
                                dof_u=s.next2())

    hp = HitpointBuffer(
        position=jnp.zeros((n, 3)), wo=jnp.zeros((n, 3)),
        attenuation=jnp.ones((n, 3)), radiance=jnp.zeros((n, 3)),
        mat=jnp.zeros((n,), jnp.int32), kd=jnp.zeros((n, 3)),
        ns=jnp.zeros((n, 3)),
        ng=jnp.zeros((n, 3)), found=jnp.zeros((n,), jnp.bool_),
        hit_emitter=jnp.zeros((n,), jnp.bool_),
        specular_chain=jnp.zeros((n,), jnp.bool_),
        vol_point=jnp.zeros((n, 3)), vol_t=jnp.zeros((n,)),
        vol_len=jnp.zeros((n,)), vol_atten=jnp.zeros((n, 3)),
        vol_w=jnp.zeros((n,)), vol_wsum=jnp.zeros((n,)))
    walking = jnp.ones((n,), jnp.bool_)
    # per-lane "inside a dielectric" bit: the wavefront form of the reference's
    # medium-aware ray types (RayType.h:16-22) — Glass.cu:146-160 switches
    # refracted rays to *_IN_PARTICIPATING_MEDIUM types so glass interiors
    # skip the global medium; here the bit flips on every refraction
    # (geometric-normal side change) and suppresses the medium while set
    inside = jnp.zeros((n,), jnp.bool_)

    def eye_step(carry, depth):
        hp, o, d, walking, inside = carry
        skey = LaneSampler(jax.random.fold_in(key, 1000 + depth),
                           lane_ids, cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, jnp.full((n,), 1.0) * eps,
                        jnp.where(walking, BIG, 0.0))  # dead: empty ray
        live = walking & hit.hit
        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)
        is_spec = bsdf.is_specular() & ~is_emitter

        if scene.medium is not None:
            # transmittance over the in-medium part of this segment
            # (ParticipatingMedium.cu:66-93) + weighted-reservoir pick of
            # ONE in-scatter sample point across ALL eye segments
            from ..core.math import luminance
            from .media import segment_overlap, transmittance
            t_seg = jnp.where(hit.hit, hit.t, 0.0)
            t_enter, overlap = segment_overlap(scene.medium, o, d, t_seg)
            in_medium = walking & ~inside
            overlap = jnp.where(in_medium, overlap, 0.0)
            tr = transmittance(scene.medium, overlap)
            atten_before = hp.attenuation
            hp = hp.replace(attenuation=jnp.where(
                walking[:, None], hp.attenuation * tr[:, None],
                hp.attenuation))
            # reservoir: segment weight = in-medium length x path
            # attenuation luminance; accept with prob w / wsum so the
            # final pick probability is w_k / W_total (reweighted in
            # render_iteration -> unbiased over every segment)
            w_seg = overlap * jnp.maximum(luminance(atten_before), 0.0)
            wsum_new = hp.vol_wsum + w_seg
            take = in_medium & (w_seg > 0.0) & (
                skey.next1() * wsum_new < w_seg)
            u_v = skey.next1()
            t_v = u_v * overlap
            sel_v = take[:, None]
            hp = hp.replace(
                vol_point=jnp.where(
                    sel_v, o + (t_enter + t_v)[:, None] * d, hp.vol_point),
                vol_t=jnp.where(take, t_v, hp.vol_t),
                vol_len=jnp.where(take, overlap, hp.vol_len),
                vol_atten=jnp.where(sel_v, atten_before, hp.vol_atten),
                vol_w=jnp.where(take, w_seg, hp.vol_w),
                vol_wsum=wsum_new)

        # emitter: pick up radiance, stop (DiffuseEmitter.cu:40-52)
        em = live & is_emitter
        hp = hp.replace(
            radiance=hp.radiance + jnp.where(
                em[:, None], hp.attenuation * emitter_rad, 0.0),
            hit_emitter=hp.hit_emitter | em)

        # non-specular: store hitpoint, stop (Diffuse.cu:71-88)
        store = live & ~is_emitter & ~is_spec
        sel = store[:, None]
        hp = hp.replace(
            position=jnp.where(sel, hit.position, hp.position),
            wo=jnp.where(sel, -d, hp.wo),
            mat=jnp.where(store, hit.mat, hp.mat),
            kd=jnp.where(sel, bsdf.kd, hp.kd),
            ns=jnp.where(sel, bsdf.frame.n, hp.ns),
            ng=jnp.where(sel, bsdf.ng, hp.ng),
            found=hp.found | store)

        # specular: continue the walk (Mirror.cu:52-64, Glass.cu:90-140)
        cont = live & is_spec
        res = bsdf.sample(skey.next3())
        w = res.f * (res.cos_theta / jnp.maximum(res.pdf_w, 1e-20))[:, None]
        hp = hp.replace(
            attenuation=jnp.where(cont[:, None] & res.valid[:, None],
                                  hp.attenuation * w, hp.attenuation),
            specular_chain=hp.specular_chain | cont)
        # refraction flips the dielectric-interior bit (side change
        # against the geometric normal — Glass.cu:146-160 ray-type switch)
        crossed = cont & res.valid & (
            dot(bsdf.ng, res.world_dir) * dot(bsdf.ng, -d) < 0.0)
        inside = inside ^ crossed
        o = jnp.where(cont[:, None], hit.position, o)
        d = jnp.where(cont[:, None], res.world_dir, d)
        walking = cont & res.valid
        return (hp, o, d, walking, inside), None

    carry, _ = jax.lax.scan(
        eye_step, (hp, o, d, walking, inside),
        jnp.arange(0, cfg.max_radiance_trace_depth))
    (hp, o, d, walking, inside) = carry
    return hp


# ---------------------------------------------------------------------------
# 2. photon pass
# ---------------------------------------------------------------------------

def emit_photons(scene: Scene, s: LaneSampler):
    """PhotonGenerator.cu:41-129. Returns (origin, dir, power [N,3])."""
    n_lights = scene.lights.n_lights
    center, radius = scene.bounding_sphere
    li = jnp.minimum((s.next1() * n_lights).astype(jnp.int32),
                     n_lights - 1)
    lt = scene.lights.row(li)
    power = lt.power * n_lights  # light-pick pdf compensation

    u_pos = s.next2()
    u_dir = s.next2()

    # area: uniform position, cosine direction (exact for Lambertian Lemit;
    # deviation from reference's uniform-hemisphere documented above)
    pos_area = lt.position + u_pos[:, 0:1] * lt.v1 + u_pos[:, 1:2] * lt.v2
    dir_area, _, _ = sample_unit_hemisphere_cos(lt.normal, u_dir,
                                                bias_small_cosine=True)

    # point: sphere, or disc toward scene when >1.5x bounding radius with
    # solid-angle power factor (PhotonGenerator.cu:53-71)
    to_light = lt.position - center
    dist_l = jnp.linalg.norm(to_light, axis=-1)
    to_light_n = to_light / jnp.maximum(dist_l, 1e-20)[:, None]
    well_outside = dist_l > 1.5 * radius
    disc_pt = sample_disc(u_pos, jnp.broadcast_to(center, to_light.shape),
                          jnp.broadcast_to(radius, dist_l.shape), -to_light_n)
    dir_disc = disc_pt - lt.position
    dir_disc = dir_disc / jnp.maximum(
        jnp.linalg.norm(dir_disc, axis=-1, keepdims=True), 1e-20)
    solid_factor = (1.0 - dist_l * jax.lax.rsqrt(radius * radius
                                                 + dist_l * dist_l)) / 2.0
    dir_sphere, _ = sample_unit_sphere(u_dir)
    dir_point = jnp.where(well_outside[:, None], dir_disc, dir_sphere)
    factor_point = jnp.where(well_outside, solid_factor, 1.0)

    # spot: cone around axis (PhotonGenerator.cu:73-78)
    dir_spot, _ = sample_cone(u_dir, lt.angle, lt.normal)

    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT
    origin = jnp.where(is_area[:, None], pos_area, lt.position)
    direction = jnp.where(is_area[:, None], dir_area,
                          jnp.where(is_spot[:, None], dir_spot, dir_point))
    power = power * jnp.where(is_area | is_spot, 1.0, factor_point)[:, None]
    return origin, direction, power


def trace_photon_pass(scene: Scene, cfg: RenderConfig, key: Array, eps,
                      lane_ids: Array) -> tuple[PhotonBatch, dict]:
    """``lane_ids`` are GLOBAL photon indices (photons are sharded across
    devices).

    Deposits are emitted as per-bounce scan OUTPUTS (stacked [depth, n]
    slabs, masked by a deposit bit) rather than scattered into a fixed
    n*max_deposits buffer: per-bounce scatters into multi-million-row
    carried buffers are expensive, the stacked-output form is free.
    Capacity is n * max_photon_trace_depth rows; the per-path
    MAX_PHOTONS_DEPOSITS_PER_EMITTED budget (config.h:23-27) is enforced by
    the ``stored`` counter mask exactly as before.
    """
    n = lane_ids.shape[0]
    max_dep = cfg.max_photon_deposits_per_emitted
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    o, d, power = emit_photons(scene, s)

    stored = jnp.zeros((n,), jnp.int32)
    alive = jnp.ones((n,), jnp.bool_)
    path_len = jnp.zeros((n,), jnp.int32)
    vmax = cfg.media_max_deposits_per_photon
    vol_stored = jnp.zeros((n,), jnp.int32)
    has_medium = scene.medium is not None
    # dielectric-interior bit (PHOTON_IN_PARTICIPATING_MEDIUM ray-type
    # analog, RayType.h:16-22): photons inside glass skip the medium
    inside = jnp.zeros((n,), jnp.bool_)

    def photon_step(carry, depth):
        o, d, power, stored, alive, path_len, vol_stored, inside = carry
        skey = LaneSampler(jax.random.fold_in(key, 2000 + depth),
                           lane_ids, cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, jnp.full((n,), 1.0) * eps,
                        jnp.where(alive, BIG, 0.0))    # dead: empty ray
        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        live = alive & hit.hit & ~is_emitter  # emitters absorb
        is_spec = bsdf.is_specular()

        scatter = jnp.zeros((n,), jnp.bool_)
        vol_y = None
        if has_medium:
            # free-flight sampling: scatter inside the medium before the
            # surface (ParticipatingMedium.cu:110-201, analog random walk)
            from .media import sample_scatter_distance, segment_overlap
            t_seg = jnp.where(hit.hit, hit.t, BIG)
            t_enter, overlap = segment_overlap(scene.medium, o, d, t_seg)
            delta, _pdf = sample_scatter_distance(scene.medium, skey.next1())
            scatter = alive & ~inside & (delta < overlap)
            sp = o + (t_enter + delta)[:, None] * d
            # deposit a volumetric photon (power before the albedo multiply)
            vdep = scatter & (vol_stored < vmax)
            vol_y = dict(pos=sp, pow=power, dir=d, valid=vdep)
            vol_stored = vol_stored + vdep.astype(jnp.int32)
            albedo = scene.medium.sigma_s / jnp.maximum(
                scene.medium.sigma_t, 1e-12)
            power = jnp.where(scatter[:, None], power * albedo, power)
            new_dir, _ = sample_unit_sphere(skey.next2())
            live = live & ~scatter   # scattered lanes skip surface logic

        # deposit at non-specular hits from depth>=1 (Diffuse.cu:98-103)
        deposit = live & ~is_spec & (depth >= 1) & (stored < max_dep)
        y = dict(pos=hit.position, pow=power, dir=d, valid=deposit)
        stored = stored + deposit.astype(jnp.int32)

        # full-capacity paths stop (Diffuse.cu:124-127)
        live = live & (stored < max_dep)

        # bounce: adjoint BSDF sample; for diffuse this is power *= Kd
        res = bsdf.sample(skey.next3(), adjoint=True)
        w = res.f * (res.cos_theta / jnp.maximum(res.pdf_w, 1e-20))[:, None]
        power = jnp.where(live[:, None] & res.valid[:, None], power * w,
                          power)
        live = live & res.valid

        # RR from depth 3 (Diffuse.cu:107-117)
        do_rr = depth >= cfg.photon_rr_start_depth
        p_cont = jnp.where(do_rr, bsdf.continuation_prob(), 1.0)
        survive = skey.next1() < p_cont
        power = jnp.where((live & survive)[:, None],
                          power / jnp.maximum(p_cont, 1e-20)[:, None],
                          power)
        live = live & survive

        # refraction through a dielectric flips the interior bit
        crossed = live & (
            jnp.sum(bsdf.ng * res.world_dir, axis=-1)
            * jnp.sum(bsdf.ng * (-d), axis=-1) < 0.0)
        inside = inside ^ crossed

        o = jnp.where(live[:, None], hit.position, o)
        d = jnp.where(live[:, None], res.world_dir, d)
        if has_medium:
            o = jnp.where(scatter[:, None], sp, o)
            d = jnp.where(scatter[:, None], new_dir, d)
        alive = live | scatter
        path_len = path_len + alive.astype(jnp.int32)
        ys = (y, vol_y) if has_medium else (y,)
        return (o, d, power, stored, alive, path_len, vol_stored,
                inside), ys

    carry = (o, d, power, stored, alive, path_len, vol_stored, inside)
    carry, ys = jax.lax.scan(photon_step, carry,
                             jnp.arange(cfg.max_photon_trace_depth))
    (o, d, power, stored, alive, path_len, vol_stored, inside) = carry

    y = ys[0]
    photons = PhotonBatch(position=y["pos"].reshape(-1, 3),
                          power=y["pow"].reshape(-1, 3),
                          direction=y["dir"].reshape(-1, 3),
                          valid=y["valid"].reshape(-1))
    if has_medium:
        vy = ys[1]
        vol_photons = PhotonBatch(position=vy["pos"].reshape(-1, 3),
                                  power=vy["pow"].reshape(-1, 3),
                                  direction=vy["dir"].reshape(-1, 3),
                                  valid=vy["valid"].reshape(-1))
    else:
        vol_photons = PhotonBatch(position=jnp.zeros((1, 3)),
                                  power=jnp.zeros((1, 3)),
                                  direction=jnp.zeros((1, 3)),
                                  valid=jnp.zeros((1,), jnp.bool_))
    stats = dict(photons_stored=jnp.sum(stored),
                 avg_photon_path_length=jnp.mean(path_len.astype(jnp.float32)))
    if has_medium:
        stats["volumetric_photons_stored"] = jnp.sum(vol_stored)
    return photons, vol_photons, stats


# ---------------------------------------------------------------------------
# full iteration
# ---------------------------------------------------------------------------

def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration: Array, base_key: Array,
                     radius_sq: Array) -> tuple[Array, dict]:
    W, H = cfg.width, cfg.height
    n = W * H
    eps = scene_epsilon(scene)
    radius = jnp.sqrt(radius_sq)

    eye_key = iteration_key(base_key, iteration, PASS_PPM_EYE)
    photon_key = iteration_key(base_key, iteration, PASS_PPM_PHOTON)
    est_key = iteration_key(base_key, iteration, PASS_PPM_ESTIMATE)

    # 1. eye pass
    px, py = pixel_coords(W, H)
    pixel_lanes = jnp.arange(n, dtype=jnp.int32)
    with pass_scope("ppm_eye_pass"):
        hp = trace_eye_pass(scene, camera, cfg, eye_key, eps, px, py,
                            pixel_lanes)

    # 2-3. photon pass + map build
    photon_lanes = jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32)
    with pass_scope("ppm_photon_pass"):
        photons, vol_photons, photon_stats = trace_photon_pass(
            scene, cfg, photon_key, eps, photon_lanes)

    # 4. indirect estimation at hitpoints
    # "auto" reaching the integrator directly (no Renderer tiering) means
    # the throughput form; the Renderer resolves auto into tiers
    sort_form = ("argsort" if cfg.photon_grid_sort == "argsort"
                 else "cosort")
    if cfg.photon_map_structure == PhotonMapStructure.SORTED_UNIFORM_GRID:
        with pass_scope("ppm_grid_build"):
            grid = build_photon_grid(
                photons, cfg.photon_grid_resolution,
                min_cell_size=min_cell_size_for_window(radius, 4),
                sort_form=sort_form)
        s_gather = LaneSampler(jax.random.fold_in(est_key, 55), pixel_lanes,
                               cheap=cfg.use_cheap_random)
        from ..accel import pallas_gather as tg
        mode = tg.gather_mode(cfg.use_pallas_gather, W, H)
        with pass_scope("ppm_indirect_gather"):
            if mode != "xla":
                perm, inv = tg.tile_block_order(W, H)
                perm = jnp.asarray(perm)
                u_rows = s_gather.next1().reshape(
                    n // tg.TILE, tg.TILE)[:, :tg.ROWS + 2]
                acc_b, gather_stats = tg.gather_photons_tiled(
                    grid, hp.position[perm], hp.ns[perm], radius,
                    u_rows=u_rows, valid=hp.found[perm],
                    interpret=mode == "interpret")
                inv = jnp.asarray(inv)
                accum_power = acc_b[inv]
                gather_stats = {k: v[inv] for k, v in gather_stats.items()}
            else:
                accum_power, gather_stats = gather_photons(
                    grid, hp.position, hp.ns, radius,
                    max_cells_per_axis=4,
                    budget_total=cfg.gather_photon_budget,
                    u_stride=s_gather.next1())
    elif cfg.photon_map_structure == PhotonMapStructure.KD_TREE_CPU:
        from ..photon_map import build_photon_kdtree, gather_kdtree
        tree = build_photon_kdtree(photons)
        accum_power, gather_stats = gather_kdtree(tree, hp.position, hp.ns,
                                                  radius)
    else:
        h = build_stochastic_hash(photons, radius,
                                  cfg.stochastic_hash_size_log2,
                                  jax.random.fold_in(photon_key, 77))
        accum_power, gather_stats = gather_stochastic_hash(
            h, hp.position, hp.ns, radius)

    brdf = hp.kd / jnp.pi  # reference uses kd (module docstring)
    indirect = (accum_power * brdf * hp.attenuation
                / (jnp.pi * radius_sq * cfg.photons_per_iteration))
    indirect = jnp.where(hp.found[:, None], indirect, 0.0)

    # 5. direct estimation at hitpoints (DirectRadianceEstimation.cu:29-77)
    kd_l, ks_l, exp_l, kr_l, kt_l, ior_l, diel_l = \
        scene.materials.bsdf_coefficients(hp.mat)
    from ..bsdf import BSDF
    hp_bsdf = BSDF.make(hp.ns, hp.ng, hp.wo, hp.kd, ks_l, exp_l, kr_l,
                        kt_l, ior_l, diel_l)
    s_est = LaneSampler(est_key, pixel_lanes, cheap=cfg.use_cheap_random)
    with pass_scope("ppm_direct_estimation"):
        direct = nee_direct(scene, hp_bsdf, hp.position, hp.found, s_est,
                            cfg.ppm_direct_shadow_samples, eps,
                            reference_faithful=cfg.reference_faithful)
    direct = jnp.where(hp.found[:, None], hp.attenuation * direct, 0.0)
    # emitter/specular/miss pixels pass stored radiance through; the
    # reference clamps emitter radiance to <=1 (DirectRadianceEstimation
    # .cu:38) -- reproduced only in reference_faithful mode
    passthrough = (jnp.minimum(hp.radiance, 1.0)
                   if cfg.reference_faithful else hp.radiance)

    # 5b. volumetric in-scatter at the reservoir-picked eye segment (media
    # redesign: distance-sampled point gather, integrators/media.py
    # docstring; the pick covers EVERY in-medium eye segment, reweighted
    # by its inverse pick probability)
    volumetric = jnp.zeros((n, 3))
    if scene.medium is not None:
        from .media import volumetric_radiance_estimate
        vol_radius = radius * 3.0   # volume density needs a larger support
        vgrid = build_photon_grid(
            vol_photons, cfg.photon_grid_resolution,
            min_cell_size=min_cell_size_for_window(vol_radius, 4),
            sort_form=sort_form)
        s_vg = LaneSampler(jax.random.fold_in(est_key, 56), pixel_lanes,
                           cheap=cfg.use_cheap_random)
        vpow, _ = gather_photons(vgrid, hp.vol_point, hp.ns, vol_radius,
                                 max_cells_per_axis=4,
                                 budget_total=cfg.gather_photon_budget,
                                 check_normal=False,
                                 u_stride=s_vg.next1())
        sel_ok = hp.vol_w > 0.0
        inv_pick = jnp.where(
            sel_ok, hp.vol_wsum / jnp.maximum(hp.vol_w, 1e-30), 0.0)
        volumetric = volumetric_radiance_estimate(
            scene.medium, vpow, vol_radius, hp.vol_len, hp.vol_t,
            cfg.photons_per_iteration,
            weight=hp.vol_atten * inv_pick[:, None])
        volumetric = jnp.where(sel_ok[:, None], volumetric, 0.0)

    # 6. output
    radiance = (direct + indirect + passthrough + volumetric
                ).reshape(H, W, 3)
    stats = dict(**photon_stats,
                 **{k: jnp.sum(v) for k, v in gather_stats.items()})
    return radiance, stats
