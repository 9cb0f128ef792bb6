"""Vector/geometry math on batched ``[..., 3]`` arrays.

Array replacement for the reference's ``math/Vector3.h``, ``math/AAB.h``,
``math/Sphere.h`` and ``math/DifferentialGeometry.h``: everything is SoA
``jnp`` math over arbitrary batch dimensions instead of per-ray scalar structs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from . import pytree as struct

Array = jax.Array

INV_PI = 0.3183098861837907
PI = 3.141592653589793


def dot(a: Array, b: Array) -> Array:
    """Batched dot product over the last axis; result keeps no vector axis."""
    return jnp.sum(a * b, axis=-1)


def vdot(a: Array, b: Array) -> Array:
    """Batched dot product, keepdims (broadcastable against [...,3])."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def length(a: Array) -> Array:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length_sq(a: Array) -> Array:
    return dot(a, a)


def normalize(a: Array, eps: float = 1e-20) -> Array:
    return a * jax.lax.rsqrt(jnp.maximum(length_sq(a), eps))[..., None]


def reflect(d: Array, n: Array) -> Array:
    """Mirror reflection of incident direction ``d`` about normal ``n``
    (same convention as optix::reflect: d points toward the surface)."""
    return d - 2.0 * vdot(d, n) * n


def refract(d: Array, n: Array, eta: Array) -> tuple[Array, Array]:
    """Refract incident direction ``d`` (toward surface) about unit normal
    ``n`` with relative IOR ``eta = n_i / n_t``.

    Returns ``(refracted_dir, tir_mask)``; direction is unspecified where TIR.
    """
    cos_i = -dot(d, n)
    sin2_t = jnp.square(eta) * jnp.maximum(0.0, 1.0 - jnp.square(cos_i))
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(refr), tir


def luminance(rgb: Array) -> Array:
    """Relative luminance; the reference uses it for VCM BxDF pick
    probabilities (BSDF.h albedo = luminance of reflectance)."""
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def max3(rgb: Array) -> Array:
    return jnp.max(rgb, axis=-1)


def avg3(rgb: Array) -> Array:
    return jnp.mean(rgb, axis=-1)


def is_black(rgb: Array, eps: float = 0.0) -> Array:
    return max3(jnp.abs(rgb)) <= eps


def sqr(x: Array) -> Array:
    return x * x


# ---------------------------------------------------------------------------
# Orthonormal frame (reference math/DifferentialGeometry.h:13-76)
# ---------------------------------------------------------------------------

def build_onb(n: Array) -> tuple[Array, Array]:
    """Branchless orthonormal basis around unit normal ``n`` (Duff et al. 2017).

    Returns tangent/bitangent ``(u, v)`` such that ``(u, v, n)`` is
    right-handed orthonormal. Replaces ``createCoordinateSystem`` /
    ``DifferentialGeometry::SetFromNormal``; branchless so it vectorizes
    with no lane divergence.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    u = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1)
    v = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return u, v


@struct.dataclass
class Frame:
    """Shading frame; local coords have the normal along +z
    (reference DifferentialGeometry with bitangent/tangent/normal)."""

    u: Array  # tangent    [...,3]
    v: Array  # bitangent  [...,3]
    n: Array  # normal     [...,3]

    @classmethod
    def from_normal(cls, n: Array) -> "Frame":
        u, v = build_onb(n)
        return cls(u=u, v=v, n=n)

    def to_local(self, w: Array) -> Array:
        return jnp.stack([dot(w, self.u), dot(w, self.v), dot(w, self.n)],
                         axis=-1)

    def to_world(self, w: Array) -> Array:
        return (w[..., 0:1] * self.u + w[..., 1:2] * self.v
                + w[..., 2:3] * self.n)


# local-frame trig helpers (reference renderer/reflection.h:16-46)
def local_cos_theta(w: Array) -> Array:
    return w[..., 2]


def local_abs_cos_theta(w: Array) -> Array:
    return jnp.abs(w[..., 2])


def local_same_hemisphere(a: Array, b: Array) -> Array:
    return a[..., 2] * b[..., 2] > 0.0


def local_reflect(w: Array) -> Array:
    """Reflect about the local +z normal."""
    return jnp.stack([-w[..., 0], -w[..., 1], w[..., 2]], axis=-1)


# ---------------------------------------------------------------------------
# AABB (reference math/AAB.h)
# ---------------------------------------------------------------------------

@struct.dataclass
class AABB:
    min: Array  # [3]
    max: Array  # [3]

    @classmethod
    def from_points(cls, pts: Array) -> "AABB":
        flat = pts.reshape(-1, 3)
        return cls(min=jnp.min(flat, axis=0), max=jnp.max(flat, axis=0))

    @property
    def extent(self) -> Array:
        return self.max - self.min

    @property
    def center(self) -> Array:
        return 0.5 * (self.min + self.max)

    def add_padding(self, pad: float) -> "AABB":
        return AABB(min=self.min - pad, max=self.max + pad)

    def surface_area(self) -> Array:
        e = self.extent
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def bounding_sphere(self) -> tuple[Array, Array]:
        """(center, radius) — reference AAB::getBoundingSphere."""
        c = self.center
        return c, length(self.max - c)


def ray_aabb(o: Array, inv_d: Array, bmin: Array, bmax: Array,
             tmin: Array, tmax: Array) -> tuple[Array, Array]:
    """Batched slab test. Returns (t_enter, t_exit); hit iff enter<=exit.

    ``o``/``inv_d`` are [...,3]; ``bmin/bmax`` broadcastable to [...,3].
    """
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(tnear, axis=-1), tmin)
    t_exit = jnp.minimum(jnp.min(tfar, axis=-1), tmax)
    return t_enter, t_exit
