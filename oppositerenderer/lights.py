"""Light table and light sampling.

SoA re-design of the reference ``renderer/Light.{h,cpp}`` tagged union and the
three device sampling routines in ``renderer/helpers/light.h``:
``getLightContribution`` (:29-89), ``lightEmit`` (:92-145) and
``lightIlluminate`` (:147-216). All functions are batched: ``light_idx`` is a
per-lane int32 selecting a row of the table (gather), so mixed light types in
one wavefront evaluate branchlessly via masks.

Deviations from the reference (documented):
* ``light_contribution`` here returns radiance-domain quantities for use with
  a proper BSDF evaluation; the reference multiplies surface albedo (not
  albedo/pi) by its result, making PT/PPM direct light brighter by pi than
  its own VCM half. We keep all estimators consistent instead.
* The reference spot light is marked "Todo" and returns zero contribution
  (light.h:46-50,141-143); we implement the PBRT cone falloff so SPOT works.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .core import pytree as struct

from .core.math import Array, INV_PI, PI, cross, dot, length, normalize
from .core.sampling import (cone_pdf_w, sample_cone,
                            sample_unit_hemisphere_cos, sample_unit_sphere)

AREA, POINT, SPOT = 0, 1, 2


@struct.dataclass
class LightTable:
    """All scene lights, SoA. [L] rows."""

    kind: Array          # [L] int32: AREA/POINT/SPOT
    power: Array         # [L,3] total emitted power (flux)
    position: Array      # [L,3] anchor (area) / position (point, spot)
    v1: Array            # [L,3] area edge 1
    v2: Array            # [L,3] area edge 2
    normal: Array        # [L,3] area normal / spot direction
    inverse_area: Array  # [L]
    emission: Array      # [L,3] Lemit (area) / intensity (point, spot)
    angle: Array         # [L] spot cone half-angle (radians)
    is_delta: Array      # [L] bool
    is_finite: Array     # [L] bool

    @property
    def n_lights(self) -> int:
        return self.kind.shape[0]

    def row(self, idx: Array) -> "LightTable":
        """Gather per-lane light rows."""
        return jax.tree_util.tree_map(lambda a: a[idx], self)


def make_area_light(power, anchor, v1, v2) -> dict:
    """Light::Light(power, position, v1, v2) — Light.cpp:14-29.

    NumPy on purpose: light construction is host-side scene building; jnp
    here would compile and dispatch tiny device ops per light at scene-load
    time."""
    import numpy as np
    power = np.asarray(power, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    c = np.cross(v1, v2)
    area = np.float32(np.linalg.norm(c))
    return dict(kind=AREA, power=power,
                position=np.asarray(anchor, np.float32), v1=v1, v2=v2,
                normal=(c / max(area, np.float32(1e-20))).astype(np.float32),
                inverse_area=np.float32(1.0 / area),
                emission=(power / (area * PI)).astype(np.float32),
                angle=0.0, is_delta=False, is_finite=True)


def make_point_light(power, position) -> dict:
    """Light::Light(power, position) — Light.cpp:31-40."""
    import numpy as np
    power = np.asarray(power, np.float32)
    z = np.zeros(3, np.float32)
    return dict(kind=POINT, power=power,
                position=np.asarray(position, np.float32),
                v1=z, v2=z, normal=z,
                inverse_area=0.0,
                emission=(power * (0.25 * INV_PI)).astype(np.float32),
                angle=0.0, is_delta=True, is_finite=True)


def make_spot_light(power, position, direction, angle_deg) -> dict:
    """Light::Light(power, position, direction, angle) — Light.cpp:42-51.
    The reference's angleFactor converts degrees with 180/pi (a bug); we use
    the PBRT p.614 form 1/(2pi(1-cos theta))."""
    import numpy as np
    power = np.asarray(power, np.float32)
    angle = np.float32(np.deg2rad(angle_deg))
    solid = np.float32(2.0 * PI * (1.0 - np.cos(angle)))
    d = np.asarray(direction, np.float32)
    z = np.zeros(3, np.float32)
    return dict(kind=SPOT, power=power,
                position=np.asarray(position, np.float32),
                v1=z, v2=z,
                normal=(d / max(np.linalg.norm(d), 1e-20)).astype(
                    np.float32),
                inverse_area=0.0,
                emission=(power / solid).astype(np.float32), angle=angle,
                is_delta=True, is_finite=True)


def build_light_table(light_dicts: list[dict]) -> LightTable:
    import numpy as np
    fields = {}
    for name in ("kind", "power", "position", "v1", "v2", "normal",
                 "inverse_area", "emission", "angle", "is_delta",
                 "is_finite"):
        # stack on host (numpy): one device transfer per field, zero
        # compiles at scene-build time
        vals = np.stack([np.asarray(d[name]) for d in light_dicts]).astype(
            np.int32 if name == "kind"
            else np.bool_ if name.startswith("is_") else np.float32)
        fields[name] = jnp.asarray(vals)
    return LightTable(**fields)


# ---------------------------------------------------------------------------
# Sampling routines. Each takes per-lane rows (via table.row(idx)).
# ---------------------------------------------------------------------------

def light_contribution(lt: LightTable, rec_position: Array,
                       rec_normal: Array, u2: Array):
    """PT/PPM next-event estimation toward one light
    (getLightContribution, light.h:29-89), *excluding* visibility.

    Returns ``(contrib, point_on_light, dist)`` where ``contrib`` is the
    pre-BRDF factor: Le * cos_surf * cos_light * A / d^2 (area),
    intensity * cos_surf / d^2 (point/spot) — multiply by BSDF f and a
    shadow-test to finish. Identical to the reference's power-based formula
    up to its missing 1/pi (module docstring).
    """
    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT
    point_on_light = jnp.where(
        is_area[..., None],
        lt.position + u2[..., 0:1] * lt.v1 + u2[..., 1:2] * lt.v2,
        lt.position)
    towards = point_on_light - rec_position
    dist = length(towards)
    towards = towards / jnp.maximum(dist, 1e-20)[..., None]
    cos_surf = jnp.maximum(0.0, dot(rec_normal, towards))
    # area: Le * cosL * A / d^2 ; point: I / d^2 ; spot adds cone falloff
    cos_light = jnp.maximum(0.0, dot(-towards, lt.normal))
    in_cone = dot(-towards, lt.normal) >= jnp.cos(lt.angle)
    geo = jnp.where(is_area, cos_light / lt.inverse_area,
                    jnp.where(is_spot, in_cone.astype(jnp.float32), 1.0))
    contrib = lt.emission * (cos_surf * geo / jnp.square(
        jnp.maximum(dist, 1e-20)))[..., None]
    return contrib, point_on_light, dist


def light_emit(lt: LightTable, u2_dir: Array, u2_pos: Array,
               scene_center: Array, scene_radius: Array,
               eps_cosine: float = 1e-6):
    """Sample an emission point+direction (lightEmit, light.h:92-145).

    Returns ``(radiance, position, direction, emission_pdf_w, direct_pdf_a,
    cos_theta_light)``. ``emission_pdf_w`` is the product pdf
    p_pos[area] * p_dir[solid angle]; for area lights radiance is
    Lemit * cos_theta (biased away from 0 like the reference).
    """
    is_area = lt.kind == AREA
    is_point = lt.kind == POINT
    is_spot = lt.kind == SPOT

    # --- area ---
    pos_area = lt.position + u2_pos[..., 0:1] * lt.v1 + u2_pos[..., 1:2] * lt.v2
    dir_area, pdf_area, cos_area = sample_unit_hemisphere_cos(
        lt.normal, u2_dir, bias_small_cosine=True, eps_cosine=eps_cosine)
    emission_pdf_area = pdf_area * lt.inverse_area
    rad_area = lt.emission * cos_area[..., None]

    # --- point: cone toward scene when outside bounding sphere ---
    to_center = scene_center - lt.position
    dist_c = length(to_center)
    to_center_n = to_center / jnp.maximum(dist_c, 1e-20)[..., None]
    outside = scene_radius < dist_c
    theta = jnp.arcsin(jnp.clip(scene_radius / jnp.maximum(dist_c, 1e-20),
                                0.0, 1.0))
    dir_cone, pdf_cone = sample_cone(u2_dir, theta, to_center_n)
    dir_sph, pdf_sph = sample_unit_sphere(u2_dir)
    dir_point = jnp.where(outside[..., None], dir_cone, dir_sph)
    pdf_point = jnp.where(outside, pdf_cone, pdf_sph)

    # --- spot: cone around axis ---
    dir_spot, pdf_spot = sample_cone(u2_dir, lt.angle, lt.normal)

    direction = jnp.where(is_area[..., None], dir_area,
                          jnp.where(is_spot[..., None], dir_spot, dir_point))
    emission_pdf = jnp.where(is_area, emission_pdf_area,
                             jnp.where(is_spot, pdf_spot, pdf_point))
    position = jnp.where(is_area[..., None], pos_area,
                         jnp.broadcast_to(lt.position, pos_area.shape))
    direct_pdf_a = jnp.where(is_area, lt.inverse_area, 1.0)
    cos_theta = jnp.where(is_area, cos_area, 1.0)
    radiance = jnp.where(is_area[..., None], rad_area, lt.emission)
    return radiance, position, direction, emission_pdf, direct_pdf_a, cos_theta


def light_illuminate(lt: LightTable, u2: Array, receive_position: Array,
                     scene_center: Array, scene_radius: Array,
                     eps_cosine: float = 1e-6):
    """Sample a point for NEE with VCM pdfs (lightIlluminate, light.h:147-216).

    Returns ``(radiance, dir_to_light, dist, direct_pdf_w, emission_pdf_w,
    cos_theta_light)``. direct_pdf_w for delta lights is d^2 (the reference's
    convention: the 1/d^2 conversion is folded in so contribution =
    radiance/direct_pdf_w works for both kinds).
    """
    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT

    point = jnp.where(
        is_area[..., None],
        lt.position + u2[..., 0:1] * lt.v1 + u2[..., 1:2] * lt.v2,
        lt.position)
    to_light = point - receive_position
    dist = length(to_light)
    dir_to_light = to_light / jnp.maximum(dist, 1e-20)[..., None]
    d2 = jnp.square(dist)

    # area
    cos_light = dot(lt.normal, -dir_to_light)
    ok_area = cos_light >= eps_cosine
    direct_pdf_area = lt.inverse_area * d2 / jnp.maximum(cos_light, 1e-20)
    emission_pdf_area = lt.inverse_area * jnp.maximum(cos_light, 0.0) * INV_PI

    # point/spot
    to_center = scene_center - lt.position
    dist_c = length(to_center)
    outside = scene_radius < dist_c
    theta = jnp.arcsin(jnp.clip(scene_radius / jnp.maximum(dist_c, 1e-20),
                                0.0, 1.0))
    emission_pdf_point = jnp.where(outside, cone_pdf_w(theta), 0.25 * INV_PI)
    emission_pdf_spot = cone_pdf_w(lt.angle)
    in_cone = dot(-dir_to_light, lt.normal) >= jnp.cos(lt.angle)

    radiance = jnp.where(
        is_area[..., None], jnp.where(ok_area[..., None], lt.emission, 0.0),
        jnp.where(is_spot[..., None],
                  jnp.where(in_cone[..., None], lt.emission, 0.0),
                  lt.emission))
    direct_pdf_w = jnp.where(is_area, direct_pdf_area, d2)
    emission_pdf_w = jnp.where(
        is_area, emission_pdf_area,
        jnp.where(is_spot, emission_pdf_spot, emission_pdf_point))
    cos_theta = jnp.where(is_area, cos_light, 1.0)
    return (radiance, dir_to_light, dist, direct_pdf_w, emission_pdf_w,
            cos_theta)
