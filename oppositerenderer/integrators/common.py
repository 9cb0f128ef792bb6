"""Shared wavefront machinery for all integrators.

The reference dispatches per-material OptiX hit programs; here every lane
builds the same dense composite BSDF from the material table
(scene/types.MaterialTable.bsdf_coefficients) with the glass inside-hit
normal flip + IOR swap of Glass.cu:261-264 applied vectorially.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..bsdf import BSDF
from ..core.math import Array, dot
from ..scene.types import EMITTER, GLASS, Scene
from ..accel.intersect import Hit


def scene_epsilon(scene: Scene) -> Array:
    """Self-intersection offset scaled to the scene (the reference's fixed
    1e-4 works for the 2.5-unit box but is marginal at Cornell's 556 units).
    Traced-safe: returns a scalar Array."""
    diag = jnp.linalg.norm(scene.aabb_max - scene.aabb_min)
    return jnp.maximum(1e-4, 2e-5 * diag)


def bsdf_at_hit(scene: Scene, hit: Hit, incoming_dir: Array,
                ) -> tuple[BSDF, Array, Array]:
    """Build the per-lane BSDF at hit points.

    ``incoming_dir`` is the ray direction (pointing AT the surface).
    Returns (bsdf, is_emitter, emitter_radiance) where emitter_radiance is
    Lemit on front-face emitter hits else 0 (DiffuseEmitter.cu:40-52).
    """
    # one row gather of the material table per bounce (kind/coeffs/
    # emission/texture ids all come from the same [M,*] table)
    m = scene.materials.row(hit.mat)
    kind = m.kind
    kd, ks, exponent, kr, kt, ior, kr_diel = m.coefficients()

    # textured lanes: modulate kd by the diffuse map, perturb the shading
    # normal by the tangent-space normal map (material/Texture.cu)
    ns_in = hit.ns
    from ..scene.types import TEXTURED
    if scene.has_textures:
        from ..scene.texture import apply_normal_map, sample_bilinear
        tex_id = m.texture_id
        textured = (kind == TEXTURED) & (tex_id >= 0)
        tex_rgb = sample_bilinear(scene.textures, tex_id, hit.uv)
        kd = jnp.where(textured[..., None], kd * tex_rgb, kd)
        if scene.normal_maps is not None and scene.normal_maps.shape[0] > 0:
            nm_id = m.normal_map_id
            has_nm = textured & (nm_id >= 0)
            g = scene.geometry
            tri = jnp.clip(hit.prim, 0, g.n_triangles - 1)
            nm_rgb = sample_bilinear(scene.normal_maps, nm_id, hit.uv)
            perturbed = apply_normal_map(hit.ns, g.tri_tangent[tri],
                                         g.tri_bitangent[tri], nm_rgb)
            ns_in = jnp.where(has_nm[..., None], perturbed, hit.ns)

    # glass hit from inside: flip normals, swap IOR pair (Glass.cu:261-264)
    from_outside = dot(hit.ng, incoming_dir) < 0.0
    flip = (kind == GLASS) & ~from_outside
    ns = jnp.where(flip[..., None], -ns_in, ns_in)
    ng = jnp.where(flip[..., None], -hit.ng, hit.ng)
    ior_eff = jnp.where(flip, 1.0 / ior, ior)

    bsdf = BSDF.make(ns, ng, -incoming_dir, kd, ks, exponent, kr, kt,
                     ior_eff, kr_diel)

    is_emitter = kind == EMITTER
    lemit = m.emission
    front = dot(hit.ns, -incoming_dir) > 0.0
    emitter_radiance = jnp.where((is_emitter & front)[..., None], lemit, 0.0)
    return bsdf, is_emitter, emitter_radiance


def pixel_coords(width: int, height: int):
    """Flattened pixel index grids [H*W]."""
    py, px = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                          indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def nee_direct(scene: Scene, bsdf: BSDF, position: Array, active: Array,
               sampler, n_samples: int, eps,
               reference_faithful: bool = False) -> Array:
    """Next-event estimation at surface points: ``n_samples`` shadow rays to
    uniformly picked lights, averaged (pt/RayGeneratorPT.cu:88-100 and
    ppm/DirectRadianceEstimation.cu:49-71 — with the BSDF f applied instead
    of raw albedo; see lights.light_contribution docstring).

    ``reference_faithful`` reproduces the reference's albedo-not-f NEE
    (attenuation *= Kd at the hit, helpers/light.h:29-89 + Diffuse.cu): its
    PT/PPM direct light is brighter by pi than a physically-normalized
    Lambertian BSDF. Exposed so parity-with-reference renders are testable
    alongside the fixed-physics default (RenderConfig.reference_faithful).

    Returns the direct radiance [N,3] (throughput NOT applied).
    """
    from ..core.math import max3
    from ..lights import light_contribution
    from ..accel.intersect import occluded

    n = position.shape[0]
    n_lights = scene.lights.n_lights
    nee_ok = active & ~bsdf.is_specular()
    direct = jnp.zeros((n, 3), jnp.float32)
    if n_samples <= 0:      # e.g. ppm_direct_shadow_samples=0: no NEE,
        return direct       # not a 0/0 NaN frame
    for _ in range(n_samples):
        li = jnp.minimum((sampler.next1() * n_lights).astype(jnp.int32),
                         n_lights - 1)
        rows = scene.lights.row(li)
        contrib, point_on_light, dist = light_contribution(
            rows, position, bsdf.frame.n, sampler.next2())
        dir_l = (point_on_light - position) \
            / jnp.maximum(dist, 1e-20)[:, None]
        f, _, _, _ = bsdf.f(dir_l)
        if reference_faithful:
            f = f * jnp.pi
        worth = nee_ok & (max3(contrib) > 0.0) & (max3(f) > 0.0)
        # not-worth lanes trace an empty interval (instant BVH root miss)
        occ = occluded(scene, position, dir_l, jnp.full((n,), 1.0) * eps,
                       jnp.where(worth,
                                 jnp.maximum(dist - 2 * eps, eps), 0.0))
        vis = worth & ~occ
        direct = direct + jnp.where(vis[:, None], f * contrib * n_lights,
                                    0.0)
    return direct / n_samples
