"""Debug observability: per-pixel path traces, NaN checking, histograms.

The wavefront analogs of the reference's debug machinery:

* :func:`trace_debug_pixel` — the ``OPTIX_PRINTF[I/ID]`` per-debug-pixel
  tracing (``helpers/helpers.h:27-110``): replay the PT walk of ONE pixel
  with the exact per-lane RNG stream it gets inside the full wavefront, and
  return every bounce's state (position, material, throughput, pdf, NEE
  contribution) as host-readable arrays instead of device printf.
* :func:`check_iteration` — a ``jax.experimental.checkify`` float-error
  pass over one render iteration (SURVEY.md section 5 asks to keep a
  checkify/NaN pass; the reference's closest analog is the per-entry-point
  OptiX exception program, OptixRenderer.cpp:156-181).
* :func:`photon_depth_histogram` — the photon path-length histogram of
  ``OptixRenderer::debugOutputPhotonTracing`` (OptixRenderer.cpp:872-953).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .accel.intersect import intersect
from .camera import Camera
from .config import RenderConfig, RenderMethod
from .core.rng import LaneSampler, iteration_key
from .integrators.common import bsdf_at_hit, nee_direct, scene_epsilon
from .scene.types import Scene


def trace_debug_pixel(scene: Scene, camera: Camera, cfg: RenderConfig,
                      x: int, y: int, iteration: int = 0, seed_key=None):
    """Replay the PT path of pixel (x, y) and return a list of per-bounce
    dicts. The lane id and per-pass keys match integrators.pt exactly, so
    the recorded path is the one the full render computes."""
    from .core.rng import make_root_key
    from .integrators.pt import PASS_PT

    if seed_key is None:
        seed_key = make_root_key(0)
    key = iteration_key(seed_key, jnp.int32(iteration), PASS_PT)
    lane = jnp.asarray([y * cfg.width + x], jnp.int32)
    px = jnp.asarray([x], jnp.float32)
    py = jnp.asarray([y], jnp.float32)
    eps = scene_epsilon(scene)

    s = LaneSampler(key, lane, cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())
    throughput = jnp.ones((1, 3))
    records = []
    for depth in range(cfg.pt_max_segments):
        skey = LaneSampler(jax.random.fold_in(key, depth + 1), lane,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, jnp.full((1,), 1.0) * eps,
                        jnp.full((1,), 1e30))
        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)
        rec = dict(depth=depth,
                   origin=np.asarray(o[0]), direction=np.asarray(d[0]),
                   hit=bool(hit.hit[0]), t=float(hit.t[0]),
                   position=np.asarray(hit.position[0]),
                   material=int(hit.mat[0]),
                   normal=np.asarray(hit.ns[0]),
                   is_emitter=bool(is_emitter[0]),
                   emitter_radiance=np.asarray(emitter_rad[0]),
                   throughput=np.asarray(throughput[0]),
                   is_specular=bool(bsdf.is_specular()[0]))
        if not rec["hit"] or rec["is_emitter"]:
            records.append(rec)
            break
        if cfg.pt_direct_light_sampling and cfg.pt_shadow_samples > 0:
            direct = nee_direct(scene, bsdf, hit.position, hit.hit, skey,
                                cfg.pt_shadow_samples, eps,
                                reference_faithful=cfg.reference_faithful)
            rec["nee_direct"] = np.asarray(
                (throughput * direct)[0])
        res = bsdf.sample(skey.next3())
        rec["sampled_dir"] = np.asarray(res.world_dir[0])
        rec["sample_pdf_w"] = float(res.pdf_w[0])
        rec["sample_valid"] = bool(res.valid[0])
        records.append(rec)
        if not rec["sample_valid"]:
            break
        w = res.f * (res.cos_theta / jnp.maximum(res.pdf_w, 1e-20))[:, None]
        throughput = throughput * w
        o, d = hit.position, res.world_dir
    return records


def check_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                    iteration: int = 0, seed: int = 0,
                    radius_sq: float = 0.002):
    """Run ONE render iteration under checkify float checks (NaN/Inf and
    div-by-zero surfaced with source locations). Returns (error_message or
    None, radiance). Expensive — a debugging tool, not the hot path."""
    from jax.experimental import checkify

    from .core.rng import make_root_key
    from .integrators import ppm, pt, vcm

    key = make_root_key(seed)
    method = cfg.render_method
    if method == RenderMethod.PATH_TRACING:
        def step():
            return pt.render_iteration(scene, camera, cfg,
                                       jnp.int32(iteration), key)
    elif method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
        def step():
            return ppm.render_iteration(scene, camera, cfg,
                                        jnp.int32(iteration), key,
                                        jnp.float32(radius_sq))[0]
    else:
        def step():
            return vcm.render_iteration(scene, camera, cfg,
                                        jnp.int32(iteration), key,
                                        jnp.float32(radius_sq))[0]

    # nan_checks only: the kernels routinely compute masked divisions
    # (e.g. where(|det|>eps, 1/det, 0)) whose discarded lanes would trip
    # div-by-zero checks; what must never happen is a NaN/Inf REACHING an
    # output, which nan_checks catches at the producing op.
    checked = checkify.checkify(jax.jit(step), errors=checkify.nan_checks)
    err, radiance = checked()
    msg = err.get()
    return (msg if msg else None), radiance


def photon_depth_histogram(scene: Scene, cfg: RenderConfig, seed: int = 0,
                           iteration: int = 0):
    """Photon path-length histogram (debugOutputPhotonTracing,
    OptixRenderer.cpp:872-953): counts of photon paths by number of stored
    deposits, plus totals."""
    from .core.rng import make_root_key
    from .integrators import ppm

    key = make_root_key(seed)
    photon_key = iteration_key(key, jnp.int32(iteration),
                               ppm.PASS_PPM_PHOTON)
    eps = scene_epsilon(scene)
    lanes = jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32)
    photons, _vol, stats = ppm.trace_photon_pass(scene, cfg, photon_key,
                                                 eps, lanes)
    # trace_photon_pass stacks deposits DEPTH-MAJOR (scan over depth, then
    # lanes: flat index = depth * n + lane), so the per-path count sums over
    # the leading depth axis — reshape(n, -1) would mix lanes across depths
    per_path = photons.valid.reshape(
        -1, cfg.photons_per_iteration).sum(axis=0)
    hist = jnp.zeros((cfg.max_photon_deposits_per_emitted + 1,),
                     jnp.int32).at[jnp.clip(
                         per_path, 0,
                         cfg.max_photon_deposits_per_emitted)].add(1)
    return dict(deposits_histogram=np.asarray(hist),
                photons_stored=int(stats["photons_stored"]),
                avg_photon_path_length=float(
                    stats["avg_photon_path_length"]))
