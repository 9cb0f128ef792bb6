"""Sharded per-iteration render steps (shard_map over the tile axis).

Intra-iteration sharding the reference does NOT have (SURVEY.md section 2.6:
its only multi-GPU axis is whole-iteration sharding over TCP). Design:

* **PT**: pixels (image rows) shard over ``tile``; purely data-parallel.
* **PPM**: eye pass shards pixels; the photon pass shards emitted photons;
  photons then travel to their grid-cell OWNER device via ONE
  ``lax.all_to_all`` (parallel/exchange.py) so each device builds and holds
  only its cell partition — O(P/D) traffic and memory per chip. Queries are
  all_gather'd (20x smaller than photons at reference scale) and partial
  gather sums return via ``psum_scatter``. ``PhotonExchange.ALL_GATHER``
  keeps the replicate-everything fallback.
* **VCM**: light subpaths shard like pixels (global count = n_pixels, so the
  1:1 pairing pixel<->path stays device-local); t=1 camera splats go to
  arbitrary pixels, so local splat images are ``psum``-ed and each device
  keeps its own row band.

Per-lane counter-based RNG (core.rng.LaneSampler) keyed by GLOBAL lane ids
makes every shard draw exactly the stream it would draw unsharded, so the
sharded image equals the single-device image up to float-sum ordering.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import Camera
from ..config import PhotonExchange, RenderConfig, RenderMethod
from ..core.rng import iteration_key
from ..integrators import ppm, pt, vcm
from ..integrators.common import pixel_coords, scene_epsilon
from ..photon_map import (PhotonBatch, build_photon_grid, gather_photons,
                          min_cell_size_for_window)
from ..scene.types import Scene
from .mesh import TILE_AXIS


def _check_divisible(cfg: RenderConfig, n_dev: int):
    n = cfg.n_pixels
    if n % n_dev != 0:
        raise ValueError(f"{n} pixels not divisible by {n_dev} devices")
    if cfg.photons_per_iteration % n_dev != 0:
        raise ValueError("photons_per_iteration must divide by device count")


def make_sharded_render_raw(scene_template: Scene, camera: Camera,
                            cfg: RenderConfig, mesh: Mesh):
    """Un-jitted sharded step taking the scene as a TRACED argument:
    ``fn(scene, iteration, base_key, radius_sq) -> ([H,W,3], stats)``.

    The scene rides into the shard_map replicated (in_spec P()); because it
    is an argument rather than a closure constant, ``jax.grad`` w.r.t.
    scene parameters (material kd/ks/emission, light power) works through
    the collectives — shard_map transposes a replicated input's cotangent
    into the psum over the mesh that the north star's "parameter gradients
    all-reduced" requires (see diff.make_sharded_loss_and_grad).
    """
    n_dev = mesh.devices.size
    _check_divisible(cfg, n_dev)
    W, H = cfg.width, cfg.height
    n = W * H
    n_local = n // n_dev

    px, py = pixel_coords(W, H)
    lanes = jnp.arange(n, dtype=jnp.int32)
    photon_lanes = jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32)

    method = cfg.render_method

    def shard_fn(scene, it, key, radius_sq, px_s, py_s, lanes_s,
                 photon_lanes_s):
        if method == RenderMethod.PATH_TRACING:
            rad = pt.render_lanes(scene, camera, cfg, it, key, px_s, py_s,
                                  lanes_s)
            return rad, {}

        eps = scene_epsilon(scene)
        if method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
            return _ppm_shard(scene, camera, cfg, it, key, radius_sq, eps,
                              px_s, py_s, lanes_s, photon_lanes_s, n_dev)
        # VCM
        return _vcm_shard(scene, camera, cfg, it, key, radius_sq, eps,
                          px_s, py_s, lanes_s, n, n_local)

    spec_l = P(TILE_AXIS)
    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), spec_l, spec_l, spec_l, spec_l),
        out_specs=(P(TILE_AXIS, None), P()),
        check_vma=False)

    def step(scene, iteration, base_key, radius_sq):
        rad_lanes, stats = fn(scene, iteration, base_key, radius_sq,
                              px, py, lanes, photon_lanes)
        return rad_lanes.reshape(H, W, 3), stats

    return step


def make_sharded_render_fn(scene: Scene, camera: Camera, cfg: RenderConfig,
                           mesh: Mesh):
    """Returns jitted ``fn(iteration, base_key, radius_sq) -> ([H,W,3],
    stats)`` sharded over ``mesh``. Scene/camera are closed over
    (replicated)."""
    raw = make_sharded_render_raw(scene, camera, cfg, mesh)

    @jax.jit
    def step(iteration, base_key, radius_sq):
        return raw(scene, iteration, base_key, radius_sq)

    return step


def _ppm_shard(scene, camera, cfg, it, key, radius_sq, eps, px_s, py_s,
               lanes_s, photon_lanes_s, n_dev):
    radius = jnp.sqrt(radius_sq)
    eye_key = iteration_key(key, it, ppm.PASS_PPM_EYE)
    photon_key = iteration_key(key, it, ppm.PASS_PPM_PHOTON)
    est_key = iteration_key(key, it, ppm.PASS_PPM_ESTIMATE)

    hp = ppm.trace_eye_pass(scene, camera, cfg, eye_key, eps, px_s, py_s,
                            lanes_s)
    photons_local, vol_local, pstats = ppm.trace_photon_pass(
        scene, cfg, photon_key, eps, photon_lanes_s)
    from ..core.rng import LaneSampler as _LS
    s_gather = _LS(jax.random.fold_in(est_key, 55), lanes_s,
                   cheap=cfg.use_cheap_random)
    mcs = min_cell_size_for_window(radius, 4)
    if cfg.photon_exchange == PhotonExchange.ALL_TO_ALL:
        # cell-owner exchange: each device keeps only its owned cells
        from .exchange import exchange_photons_by_cell, sharded_gather
        grid, xstats = exchange_photons_by_cell(
            photons_local, cfg.photon_grid_resolution, TILE_AXIS, n_dev,
            min_cell_size=mcs,
            capacity_factor=cfg.photon_exchange_capacity_factor,
            subsample_u=jax.random.uniform(
                jax.random.fold_in(est_key, 57), ()))
        # same tile-gather policy as the unsharded integrator
        # (integrators/ppm.py): the kernel runs against the PARTIAL grid
        # on each device
        from ..accel.pallas_gather import gather_mode
        mode = gather_mode(cfg.use_pallas_gather, cfg.width, cfg.height)
        accum_power, gstats = sharded_gather(
            grid, hp.position, hp.ns, radius, TILE_AXIS,
            budget_total=max(16, cfg.gather_photon_budget // n_dev),
            u_stride=s_gather.next1(),
            tiled_wh=(None if mode == "xla"
                      else (cfg.width, cfg.height, mode == "interpret")),
            q_valid=hp.found)
        gstats = {**gstats, **xstats}
    else:
        # replicate photons to every device; each builds the full map
        gathered = jax.tree_util.tree_map(
            lambda a: jax.lax.all_gather(a, TILE_AXIS, tiled=True),
            photons_local)
        grid = build_photon_grid(gathered, cfg.photon_grid_resolution,
                                 min_cell_size=mcs)
        accum_power, gstats = gather_photons(
            grid, hp.position, hp.ns, radius, max_cells_per_axis=4,
            budget_total=cfg.gather_photon_budget,
            u_stride=s_gather.next1())

    indirect = (accum_power * (hp.kd / jnp.pi) * hp.attenuation
                / (jnp.pi * radius_sq * cfg.photons_per_iteration))
    indirect = jnp.where(hp.found[:, None], indirect, 0.0)

    from ..bsdf import BSDF
    from ..core.rng import LaneSampler
    from ..integrators.common import nee_direct
    kd_l, ks_l, exp_l, kr_l, kt_l, ior_l, diel_l = \
        scene.materials.bsdf_coefficients(hp.mat)
    hp_bsdf = BSDF.make(hp.ns, hp.ng, hp.wo, hp.kd, ks_l, exp_l, kr_l,
                        kt_l, ior_l, diel_l)
    s_est = LaneSampler(est_key, lanes_s, cheap=cfg.use_cheap_random)
    direct = nee_direct(scene, hp_bsdf, hp.position, hp.found, s_est,
                        cfg.ppm_direct_shadow_samples, eps,
                        reference_faithful=cfg.reference_faithful)
    direct = jnp.where(hp.found[:, None], hp.attenuation * direct, 0.0)

    volumetric = jnp.zeros_like(direct)
    if scene.medium is not None:
        from ..integrators.media import volumetric_radiance_estimate
        vol_radius = radius * 3.0
        vol_mcs = min_cell_size_for_window(vol_radius, 4)
        s_vg = _LS(jax.random.fold_in(est_key, 56), lanes_s,
                   cheap=cfg.use_cheap_random)
        if cfg.photon_exchange == PhotonExchange.ALL_TO_ALL:
            from .exchange import exchange_photons_by_cell, sharded_gather
            vgrid, _vx = exchange_photons_by_cell(
                vol_local, cfg.photon_grid_resolution, TILE_AXIS, n_dev,
                min_cell_size=vol_mcs,
                capacity_factor=cfg.photon_exchange_capacity_factor,
                subsample_u=jax.random.uniform(
                    jax.random.fold_in(est_key, 58), ()))
            vpow, _ = sharded_gather(
                vgrid, hp.vol_point, hp.ns, vol_radius, TILE_AXIS,
                budget_total=max(16, cfg.gather_photon_budget // n_dev),
                check_normal=False, u_stride=s_vg.next1())
        else:
            vol_all = jax.tree_util.tree_map(
                lambda a: jax.lax.all_gather(a, TILE_AXIS, tiled=True),
                vol_local)
            vgrid = build_photon_grid(vol_all, cfg.photon_grid_resolution,
                                      min_cell_size=vol_mcs)
            vpow, _ = gather_photons(
                vgrid, hp.vol_point, hp.ns, vol_radius,
                max_cells_per_axis=4,
                budget_total=cfg.gather_photon_budget,
                check_normal=False, u_stride=s_vg.next1())
        # reservoir reweight, mirroring integrators/ppm.render_iteration:
        # the eye walk picks ONE in-medium segment with prob vol_w /
        # vol_wsum and the estimate carries atten * wsum / w
        sel_ok = hp.vol_w > 0.0
        inv_pick = jnp.where(
            sel_ok, hp.vol_wsum / jnp.maximum(hp.vol_w, 1e-30), 0.0)
        volumetric = volumetric_radiance_estimate(
            scene.medium, vpow, vol_radius, hp.vol_len, hp.vol_t,
            cfg.photons_per_iteration,
            weight=hp.vol_atten * inv_pick[:, None])
        volumetric = jnp.where(sel_ok[:, None], volumetric, 0.0)

    rad = direct + indirect + hp.radiance + volumetric
    stats = {k: jax.lax.psum(jnp.sum(v), TILE_AXIS)
             for k, v in {**pstats, **gstats}.items()}
    return rad, stats


def _vcm_shard(scene, camera, cfg, it, key, radius_sq, eps, px_s, py_s,
               lanes_s, n_global, n_local):
    n_light_paths = n_global  # light launch = image size (global)
    # etaVCM = (nVM/nVC) pi r^2 — must match the unsharded factors
    # (vcm.render_iteration / OptixRenderer.cpp:675-696)
    n_vc = n_light_paths if cfg.vcm_uniform_vertex_sampling else 1
    eta_vcm = (float(n_light_paths) / n_vc) * jnp.pi * radius_sq
    mis_vm_w = vcm._mis(eta_vcm) if cfg.vcm_use_vm else jnp.zeros(())
    mis_vc_w = vcm._mis(1.0 / eta_vcm) if cfg.vcm_use_vc else jnp.zeros(())

    lkey = iteration_key(key, it, vcm.PASS_VCM_LIGHT)
    ckey = iteration_key(key, it, vcm.PASS_VCM_CAMERA)

    # light subpaths: this shard traces paths with global ids = lanes_s
    store, splat_local, lstats = vcm.trace_light_pass(
        scene, camera, cfg, lkey, eps, mis_vc_w, mis_vm_w, lanes_s,
        n_light_paths)
    # t=1 splats land on any pixel: reduce over shards, keep own row band
    splat_full = jax.lax.psum(splat_local.reshape(-1, 3), TILE_AXIS)
    my = jax.lax.axis_index(TILE_AXIS)
    splat_mine = jax.lax.dynamic_slice_in_dim(splat_full, my * n_local,
                                              n_local)

    if cfg.vcm_uniform_vertex_sampling or cfg.vcm_use_vm:
        # uniform vertex sampling is BY DEFINITION the global-store regime
        # (vcm.h:583-601): camera vertices draw uniformly over every stored
        # vertex. A device-local store with global normalization loses
        # (D-1)/D of the vertex-connection energy, so all_gather the store —
        # device order = global path order, making the sharded draw stream
        # IDENTICAL to the unsharded one. Vertex MERGING likewise gathers
        # from the global vertex population, so its grid is built over the
        # all-gathered store (identical grid on every device -> sharded
        # merge exactly equals unsharded).
        store = jax.tree_util.tree_map(
            lambda a: jax.lax.all_gather(a, TILE_AXIS, tiled=True), store)
        # surface the O(P x D) cost of the global-store regime: bytes of
        # gathered store PER DEVICE
        gathered_bytes = sum(
            int(np.prod(a.shape)) * a.dtype.itemsize
            for a in jax.tree_util.tree_leaves(store))
    else:
        gathered_bytes = 0

    vgrid = None
    if cfg.vcm_use_vm:
        vgrid = vcm.build_vertex_grid(scene, cfg, store,
                                      jnp.sqrt(radius_sq))

    # camera subpaths pair with this device's local light paths; global
    # pairing is pixel i <-> light path i (vcm.h:603-607) and this device
    # traces exactly the light paths whose global ids equal its camera
    # lanes, so local row j IS global pair lanes_s[j]. When the store was
    # all-gathered (vm), rows are global again and the pair ids are the
    # global lane ids.
    if cfg.vcm_use_vm and not cfg.vcm_uniform_vertex_sampling:
        pair_local = lanes_s
    else:
        pair_local = jnp.arange(n_local, dtype=jnp.int32)
    color = vcm.trace_camera_pass(
        scene, camera, cfg, ckey, eps, mis_vc_w, mis_vm_w, store,
        n_light_paths, px_s, py_s, lanes_s, pair_local, vgrid=vgrid,
        radius_sq=radius_sq)

    stats = {k: jax.lax.psum(jnp.sum(v), TILE_AXIS)
             for k, v in lstats.items()}
    stats["vcm_gathered_store_bytes_per_device"] = jnp.int32(gathered_bytes)
    return color + splat_mine, stats
