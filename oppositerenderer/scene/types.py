"""Scene data model: SoA geometry, material table, scene pytree.

Array re-design of the reference scene layer (``scene/IScene.h``,
``scene/Scene.h``, ``geometry_instance/*``, ``material/*.h``): instead of an
OptiX node graph with per-instance programs, the whole scene is a handful of
dense arrays — triangles (parallelograms become two triangles), analytic
spheres, a material parameter table indexed per primitive, and the light
table. Everything is a jit-traversable pytree; static counts only.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import pytree as struct

from ..core.math import Array, length
from ..lights import LightTable

# material kinds (reference material/ host classes)
DIFFUSE, GLOSSY, MIRROR, GLASS, EMITTER, TEXTURED = 0, 1, 2, 3, 4, 5


@struct.dataclass
class MaterialTable:
    """One row per material. Parameters follow the reference host classes:
    Diffuse(Kd), Glossy(Kd, Ks, exp), Mirror(Kr), Glass(ior, Kr, Kt),
    DiffuseEmitter(power->Lemit, Kd), Texture(Kd map)."""

    kind: Array        # [M] int32
    kd: Array          # [M,3]
    ks: Array          # [M,3]
    exponent: Array    # [M]
    kr: Array          # [M,3]
    kt: Array          # [M,3]
    ior: Array         # [M]
    emission: Array    # [M,3] Lemit (emitters only)
    light_index: Array  # [M] int32 row into LightTable, -1 if not emitter
    texture_id: Array  # [M] int32, -1 = no texture
    normal_map_id: Array  # [M] int32, -1 = none

    def row(self, idx: Array) -> "MaterialTable":
        return jax.tree_util.tree_map(lambda a: a[idx], self)

    def bsdf_coefficients(self, idx: Array):
        """Per-lane BSDF component coefficients for material ids ``idx`` —
        the vectorized analog of each material's VcmBSDF construction
        (Diffuse.cu:174-242, Glossy.cu:188-230, Mirror.cu:134-177,
        Glass.cu:258-356).

        Returns ``(kd, ks, exponent, kr, kt, ior, kr_is_dielectric)``.
        """
        return self.row(idx).coefficients()

    def coefficients(self):
        """BSDF coefficients from already-gathered per-lane rows (call
        ``row(idx)`` ONCE per bounce and reuse)."""
        m = self
        is_glass = m.kind == GLASS
        ones3 = jnp.ones(m.kd.shape[:-1] + (3,), m.kd.dtype)
        kd = jnp.where((m.kind == DIFFUSE)[..., None]
                       | (m.kind == GLOSSY)[..., None]
                       | (m.kind == EMITTER)[..., None]
                       | (m.kind == TEXTURED)[..., None], m.kd, 0.0)
        ks = jnp.where((m.kind == GLOSSY)[..., None], m.ks, 0.0)
        kr = jnp.where((m.kind == MIRROR)[..., None], m.kr,
                       jnp.where(is_glass[..., None], m.kr, 0.0))
        kt = jnp.where(is_glass[..., None], m.kt, 0.0)
        return kd, ks, m.exponent, kr, kt, m.ior, is_glass


@struct.dataclass
class Geometry:
    """Triangle soup + analytic spheres (SoA).

    Triangles store Moller-Trumbore precomputation (v0, edges) plus per-vertex
    shading normals/uvs; the geometric normal is normalize(e1 x e2).
    Spheres match the reference's analytic sphere primitive
    (geometry_instance/sphere.cu:32-66).
    """

    tri_v0: Array   # [T,3]
    tri_e1: Array   # [T,3] v1-v0
    tri_e2: Array   # [T,3] v2-v0
    tri_n0: Array   # [T,3] shading normals at vertices
    tri_n1: Array   # [T,3]
    tri_n2: Array   # [T,3]
    tri_uv0: Array  # [T,2]
    tri_uv1: Array  # [T,2]
    tri_uv2: Array  # [T,2]
    tri_tangent: Array    # [T,3] per-face tangent (normal mapping)
    tri_bitangent: Array  # [T,3]
    tri_mat: Array  # [T] int32
    sph_center: Array  # [S,3]
    sph_radius: Array  # [S]
    sph_mat: Array     # [S] int32

    @property
    def n_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]


@struct.dataclass
class Medium:
    """Homogeneous participating medium over an AABB (the reference's
    ParticipatingMedium material on an AAB instance covering the scene,
    material/ParticipatingMedium.{h,cu}; flag-gated default-off)."""

    sigma_s: Array   # [] scattering coefficient
    sigma_a: Array   # [] absorption coefficient
    aabb_min: Array  # [3]
    aabb_max: Array  # [3]

    @property
    def sigma_t(self) -> Array:
        return self.sigma_s + self.sigma_a


@struct.dataclass
class Scene:
    geometry: Geometry
    materials: MaterialTable
    lights: LightTable
    aabb_min: Array  # [3]
    aabb_max: Array  # [3]
    textures: Array = None       # [n_tex, R, R, 3] diffuse atlas
    normal_maps: Array = None    # [n_nm, R, R, 3] normal-map atlas
    bvh: object = None           # accel.bvh.Bvh when built (big scenes)
    medium: Medium | None = None  # participating medium (None = off)
    name: str = struct.field(static=True, default="scene")

    @property
    def has_textures(self) -> bool:
        return self.textures is not None and self.textures.shape[0] > 0

    @property
    def bounding_sphere(self) -> tuple[Array, Array]:
        """(center, radius) of the scene AABB's bounding sphere
        (used by lightEmit's distant-point-light cone mode)."""
        c = 0.5 * (self.aabb_min + self.aabb_max)
        return c, length(self.aabb_max - c)

    def initial_ppm_radius_estimate(self) -> float:
        """IScene::getSceneInitialPPMRadiusEstimate (IScene.cpp:23-31):
        r = 6 * cbrt(volume)^2 * 3.94e-6."""
        extent = np.asarray(self.aabb_max - self.aabb_min)
        volume = float(np.prod(extent))
        cube = volume ** (1.0 / 3.0)
        return 6.0 * cube * cube * 3.94e-6

    # primitive ids: triangles first, then spheres
    def primitive_material(self, prim_idx: Array) -> Array:
        t = self.geometry.n_triangles
        mats = jnp.concatenate([self.geometry.tri_mat,
                                self.geometry.sph_mat])
        return mats[jnp.clip(prim_idx, 0, t + self.geometry.n_spheres - 1)]
