"""Sampling library (reference ``renderer/helpers/samplers.h:22-171``).

Every sampler takes uniform samples in ``[0,1)`` with batch shape ``[...]``
(``u`` is ``[...,2]``) and returns directions ``[...,3]`` plus pdfs ``[...]``.
All math is branchless array code.
"""
from __future__ import annotations

import jax.numpy as jnp

from .math import Array, build_onb, normalize, INV_PI, PI, dot


def sample_unit_hemisphere_cos(normal: Array, u: Array,
                               bias_small_cosine: bool = False,
                               eps_cosine: float = 1e-6
                               ) -> tuple[Array, Array, Array]:
    """Cosine-weighted hemisphere around ``normal``.

    Matches samplers.h:22-42 exactly: theta = acos(sqrt(u1)), i.e.
    cos(theta) = sqrt(u1); pdf_w = cos(theta)/pi. Returns (dir, pdf_w, cos).
    """
    cos_theta = jnp.sqrt(u[..., 0])
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - u[..., 0]))
    phi = 2.0 * PI * u[..., 1]
    xs = sin_theta * jnp.cos(phi)
    zs = sin_theta * jnp.sin(phi)
    ys = cos_theta
    if bias_small_cosine:
        ys = jnp.maximum(ys, eps_cosine)
    pdf_w = ys * INV_PI
    U, V = build_onb(normal)
    d = normalize(xs[..., None] * U + ys[..., None] * normal
                  + zs[..., None] * V)
    return d, pdf_w, ys


def cos_hemisphere_pdf_w(normal: Array, direction: Array) -> Array:
    """samplers.h CosHemispherePdfW."""
    return jnp.maximum(0.0, dot(normal, direction)) * INV_PI


def sample_unit_sphere(u: Array) -> tuple[Array, Array]:
    """Uniform sphere; pdf_w = 1/(4 pi). samplers.h:59-72."""
    z = 1.0 - 2.0 * u[..., 0]
    phi = 2.0 * PI * u[..., 1]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    d = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return d, jnp.full(u.shape[:-1], 0.25 * INV_PI)


def sample_unit_disc(u: Array) -> Array:
    """Uniform unit disc -> [...,2]. samplers.h:74-81."""
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_disc(u: Array, center: Array, radius: Array,
                normal: Array) -> Array:
    """Point on an oriented disc in 3D. samplers.h:84-90."""
    U, V = build_onb(normal)
    d2 = sample_unit_disc(u)
    return center + radius[..., None] * (d2[..., 0:1] * U + d2[..., 1:2] * V)


def sample_power_cos_hemisphere(u: Array, power: Array
                                ) -> tuple[Array, Array]:
    """Modified-Phong lobe sample in LOCAL frame (+z axis). Returns
    (local_dir, pdf_w). samplers.h:105-122 (Lafortune)."""
    phi = 2.0 * PI * u[..., 0]
    z = jnp.power(u[..., 1], 1.0 / (power + 1.0))
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    d = jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, z], axis=-1)
    pdf_w = (power + 1.0) * jnp.power(z, power) * (0.5 * INV_PI)
    return d, pdf_w


def power_cos_hemisphere_pdf_w(normal: Array, direction: Array,
                               power: Array) -> Array:
    """samplers.h:98-103."""
    cos_theta = jnp.maximum(0.0, dot(normal, direction))
    return (power + 1.0) * jnp.power(cos_theta, power) * (0.5 * INV_PI)


def sample_cone(u: Array, theta_rad: Array, normal: Array
                ) -> tuple[Array, Array]:
    """Uniform direction in a cone of half-angle theta around ``normal``;
    pdf_w = 1/solid angle. samplers.h:127-152."""
    cos_theta = jnp.cos(theta_rad)
    z = cos_theta + (1.0 - cos_theta) * u[..., 0]
    phi = 2.0 * PI * u[..., 1]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    U, V = build_onb(normal)
    d = normalize(r[..., None] * jnp.cos(phi)[..., None] * U
                  + z[..., None] * normal
                  + r[..., None] * jnp.sin(phi)[..., None] * V)
    pdf_w = 1.0 / (2.0 * PI * (1.0 - cos_theta))
    return d, pdf_w


def cone_pdf_w(theta_rad: Array) -> Array:
    return 1.0 / (2.0 * PI * (1.0 - jnp.cos(theta_rad)))


# pdf measure conversions (samplers.h:160-171). Denominators are floored:
# masked lanes routinely carry dist=0 / cos=0 and a 0/0 NaN — even one that
# is discarded by a later where() — poisons reverse-mode gradients
# (0 * NaN) and trips the checkify NaN pass (debug.check_iteration).
def pdf_w_to_a(pdf_w: Array, dist: Array, cos_there: Array) -> Array:
    return pdf_w * jnp.abs(cos_there) / jnp.maximum(jnp.square(dist), 1e-30)


def pdf_a_to_w(pdf_a: Array, dist: Array, cos_there: Array) -> Array:
    return pdf_a * jnp.square(dist) / jnp.maximum(jnp.abs(cos_there), 1e-20)
