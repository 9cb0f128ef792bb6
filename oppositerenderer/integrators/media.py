"""Participating-media machinery for the PPM integrator.

The reference (flag-gated default-off, ``config.h:29``) implements a
homogeneous medium with: per-segment transmittance ``exp(-sigma_t d)``
(ParticipatingMedium.cu:66-93), photon scatter events that deposit
*volumetric photons* into a separate 200k buffer (NUM_VOLUMETRIC_PHOTONS,
ParticipatingMedium.cu:110-201), and a beam gather over a second BVH of
photon spheres (VolumetricPhotonSphere.cu, VolumetricPhotonSphereRadiance.cu).

Wavefront redesign (documented deviations):
* the beam query over a photon-sphere BVH becomes a *distance-sampled point
  gather*: each eye segment samples one point inside its in-medium overlap
  (pdf 1/len) and reuses the sorted-grid photon gather there with volume
  normalization 1/(4/3 pi r^3) — same estimator family, no second BVH;
* scattering is isotropic (phase 1/(4 pi)), like the reference's
  "Henyey-like isotropic" comment;
* volumetric deposits are capped per photon path by
  ``media_max_deposits_per_photon`` (fixed slots) instead of a global
  atomic-append buffer.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.math import Array, ray_aabb
from ..scene.types import Medium

INV_4PI = 0.07957747154594767


def segment_overlap(medium: Medium, o: Array, d: Array, t_hit: Array):
    """Length of [0, t_hit] inside the medium box and the entry distance.

    Returns (t_enter, overlap_len), both [N]; zero overlap when missed.
    """
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = ray_aabb(o, inv_d, medium.aabb_min, medium.aabb_max,
                      jnp.zeros_like(t_hit), t_hit)
    overlap = jnp.maximum(t1 - t0, 0.0)
    return t0, overlap


def transmittance(medium: Medium, overlap_len: Array) -> Array:
    """exp(-sigma_t * distance-in-medium) (ParticipatingMedium.cu:75)."""
    return jnp.exp(-medium.sigma_t * overlap_len)


def sample_scatter_distance(medium: Medium, u: Array):
    """Free-flight sampling t ~ Exp(sigma_t). Returns (t, pdf(t))."""
    sigma_t = jnp.maximum(medium.sigma_t, 1e-12)
    t = -jnp.log(jnp.maximum(1.0 - u, 1e-12)) / sigma_t
    pdf = sigma_t * jnp.exp(-sigma_t * t)
    return t, pdf


def volumetric_radiance_estimate(medium: Medium, accum_power: Array,
                                 radius: Array, seg_len: Array,
                                 t_in_medium: Array,
                                 n_emitted: int,
                                 weight: Array | None = None) -> Array:
    """Single sample of the in-scattered radiance along a segment.

    ``accum_power`` is the kernel-weighted photon power gathered at the
    sampled point (photon_map.gather_photons with surface-normal test
    disabled); the estimator is
        L = T(t) * sigma_s * phase * density / pdf(t),
    density = power / (4/3 pi r^3) / n_emitted, pdf(t) = 1/seg_len.

    ``weight`` (optional [N,3]) carries the path attenuation up to the
    segment times the inverse reservoir pick probability when the segment
    was chosen among several (integrators/ppm.trace_eye_pass); omitted it
    is 1, the primary-segment case.

    The 1/sigma_t: deposits happen at free-flight scatter EVENTS, whose
    density per unit volume is sigma_t x fluence (events per unit photon
    path length = sigma_t), so the gathered power over-counts the fluence
    by sigma_t and the in-scatter source sigma_s/(4 pi) x fluence needs
    the division. Found by the analytic slab quadrature test
    (tests/test_media.py::test_slab_single_scatter_matches_quadrature):
    the round-4 estimator was low by exactly sigma_t.
    """
    volume = (4.0 / 3.0) * jnp.pi * radius ** 3
    t_trans = jnp.exp(-medium.sigma_t * t_in_medium)
    fluence = accum_power / (volume * n_emitted
                             * jnp.maximum(medium.sigma_t, 1e-12))
    out = (t_trans * medium.sigma_s * INV_4PI * seg_len)[..., None] \
        * fluence
    if weight is not None:
        out = out * weight
    return out
