"""Unidirectional path tracer (wavefront).

Estimator structure mirrors the reference PT kernel
(``pt/RayGeneratorPT.cu:46-134``): per-pixel jittered camera ray (+ DoF), a
bounded bounce loop with one NEE shadow sample per diffuse bounce, emitters
counted only on primary hits or through specular chains (no MIS), Russian
roulette from depth 3 with continuation prob = max component of throughput.

Wavefront re-design: the per-thread loop + in-material recursion become a
``lax.scan`` over bounce index carrying the full wavefront [N] SoA state;
material dispatch is the dense composite BSDF; randomness is per-lane
counter-based (sharding-invariant — see core.rng.LaneSampler). Deliberate
fixes vs the reference (documented): NEE applies the actual BSDF f (ref
multiplies raw albedo — light.h:29-89 misses the 1/pi), and emitter radiance
adds to the accumulated NEE sum rather than overwriting it
(RayGeneratorPT.cu:79-84).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel.intersect import intersect
from ..camera import Camera
from ..config import RenderConfig
from ..core.math import Array, max3
from ..core.profiling import pass_scope
from ..core.rng import LaneSampler, iteration_key, lane_key_words
from ..scene.types import Scene
from .common import bsdf_at_hit, nee_direct, pixel_coords, scene_epsilon

PASS_PT = 0
BIG = 1e30


def render_lanes(scene: Scene, camera: Camera, cfg: RenderConfig,
                 iteration: Array, base_key: Array, px: Array, py: Array,
                 lane_ids: Array) -> Array:
    """PT radiance for arbitrary pixel lanes [n] (tile-shardable unit).

    ``lane_ids`` are GLOBAL lane indices (sharding-invariant RNG streams).

    ``iteration`` may be a scalar (one iteration) or a [G] vector: then the
    lanes are G equal stacked groups and group g draws the RNG streams of
    ``iteration[g]`` — bit-identical to rendering the groups separately.
    Stacking G independent PT iterations multiplies every traversal
    dispatch's lane count, amortizing the BVH compaction ladder's fixed
    tail rounds (see RenderConfig.iteration_batch).
    """
    n = px.shape[0]
    eps = scene_epsilon(scene)
    its = jnp.reshape(jnp.asarray(iteration), (-1,))
    G = its.shape[0]
    assert n % G == 0, (n, G)
    keys = jax.vmap(lambda it: iteration_key(base_key, it, PASS_PT))(its)
    per_group = n // G

    def sampler_at(depth_tag):
        """LaneSampler whose lane l uses fold_in(keys[l // per_group], tag)
        — for G=1 exactly the stream of the unbatched path."""
        dk = jax.vmap(lambda kk: jax.random.fold_in(kk, depth_tag))(keys)
        return LaneSampler(lane_key_words(dk, per_group), lane_ids,
                           cheap=cfg.use_cheap_random)

    s = LaneSampler(lane_key_words(keys, per_group), lane_ids,
                    cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())

    state = dict(
        o=o, d=d,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        active=jnp.ones((n,), jnp.bool_),
        count_emitter=jnp.ones((n,), jnp.bool_),  # primary hit counts
    )

    def bounce(state, depth):
        skey = sampler_at(depth + 1)
        # dead lanes trace an EMPTY interval: the BVH root test fails
        # immediately instead of a full (lockstep-priced) traversal
        hit = intersect(scene, state["o"], state["d"],
                        jnp.full((n,), 1.0) * eps,
                        jnp.where(state["active"], BIG, 0.0))
        active = state["active"] & hit.hit
        radiance = state["radiance"]

        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, state["d"])

        # --- emitter hit: count if primary/specular chain, then stop ------
        count = active & is_emitter & state["count_emitter"]
        radiance = radiance + jnp.where(
            count[:, None], state["throughput"] * emitter_rad, 0.0)
        active = active & ~is_emitter

        # --- NEE: shadow samples to uniformly picked lights ---------------
        if cfg.pt_direct_light_sampling and cfg.pt_shadow_samples > 0:
            direct = nee_direct(scene, bsdf, hit.position, active, skey,
                                cfg.pt_shadow_samples, eps,
                                reference_faithful=cfg.reference_faithful)
            radiance = radiance + state["throughput"] * direct

        # --- sample continuation direction --------------------------------
        res = bsdf.sample(skey.next3())
        weight = res.f * (res.cos_theta / jnp.maximum(res.pdf_w, 1e-20)
                          )[:, None]
        throughput = state["throughput"] * jnp.where(
            res.valid[:, None], weight, 0.0)
        active = active & res.valid

        # --- Russian roulette (RayGeneratorPT.cu:108-117) ------------------
        do_rr = depth >= cfg.path_rr_start_depth
        p_cont = jax.lax.stop_gradient(
            jnp.where(do_rr, jnp.clip(max3(throughput), 0.0, 1.0), 1.0))
        survive = skey.next1() < p_cont
        throughput = throughput / jnp.maximum(p_cont, 1e-20)[:, None]
        active = active & survive

        return dict(
            o=hit.position, d=res.world_dir, throughput=throughput,
            radiance=radiance, active=active,
            count_emitter=res.is_specular), None

    state, _ = jax.lax.scan(bounce, state,
                            jnp.arange(0, cfg.pt_max_segments))
    return state["radiance"]


def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration: Array, base_key: Array) -> Array:
    """One full-frame PT iteration -> radiance [H, W, 3]."""
    W, H = cfg.width, cfg.height
    px, py = pixel_coords(W, H)
    lane_ids = jnp.arange(W * H, dtype=jnp.int32)
    with pass_scope("pt_raytrace_pass"):
        radiance = render_lanes(scene, camera, cfg, iteration, base_key,
                                px, py, lane_ids)
    return radiance.reshape(H, W, 3)


def render_iteration_batch(scene: Scene, camera: Camera, cfg: RenderConfig,
                           iterations: Array, base_key: Array) -> Array:
    """G full-frame PT iterations in ONE stacked wavefront -> SUMMED
    radiance [H, W, 3] (the film accumulates sums, Output.cu:32-37).

    Bit-identical per iteration to :func:`render_iteration` (same per-lane
    RNG streams); only the dispatch granularity changes — G x W x H lanes
    per traversal instead of W x H, amortizing ladder tails and dispatch
    overheads on BVH scenes (RenderConfig.iteration_batch)."""
    W, H = cfg.width, cfg.height
    G = iterations.shape[0]
    px, py = pixel_coords(W, H)
    px = jnp.tile(px, G)
    py = jnp.tile(py, G)
    lane_ids = jnp.tile(jnp.arange(W * H, dtype=jnp.int32), G)
    with pass_scope("pt_raytrace_pass_batched"):
        radiance = render_lanes(scene, camera, cfg, iterations, base_key,
                                px, py, lane_ids)
    return jnp.sum(radiance.reshape(G, H, W, 3), axis=0)
