"""Pinhole + thin-lens camera.

Re-derivation of the reference ``renderer/Camera.{h,cpp}`` (setup semantics at
Camera.cpp:333-345: ``lookdir`` is NOT normalized — its length is the focal
distance; ``camera_u/v`` are scaled to the half extents of the image plane in
world units; ``imagePlaneSize = 2*(ulen, vlen)``), the DoF ray modification
(helpers/camera.h:11-28), and the VCM camera pdf machinery
(VCMCameraPass.cu:108-145).
"""
from __future__ import annotations

import math as pymath

import jax
import jax.numpy as jnp
from .core import pytree as struct

from .core.math import Array, cross, dot, length, normalize
from .core.sampling import sample_unit_disc


@struct.dataclass
class Camera:
    eye: Array        # [3]
    lookdir: Array    # [3], |lookdir| = focal distance
    up: Array         # [3], normalized
    camera_u: Array   # [3], length = half image-plane width (world)
    camera_v: Array   # [3], length = half image-plane height (world)
    aperture: Array   # [] thin-lens aperture radius (0 = pinhole)
    # static python floats (retrievable for orbit/fov ops)
    hfov: float = struct.field(static=True, default=60.0)
    vfov: float = struct.field(static=True, default=60.0)

    @classmethod
    def make(cls, eye, lookat, up=(0.0, 1.0, 0.0), hfov: float = 60.0,
             vfov: float = 60.0, aperture: float = 0.0) -> "Camera":
        """Camera::setup (Camera.cpp:333-345).

        Host-side construction in NumPy on purpose: this runs at
        scene-load / interaction time, where jnp would compile and
        dispatch a dozen tiny device ops per call."""
        import numpy as np
        eye = np.asarray(eye, np.float64)
        lookat = np.asarray(lookat, np.float64)
        up = np.asarray(up, np.float64)
        up = up / max(np.linalg.norm(up), 1e-20)
        lookdir = lookat - eye
        lookdir_len = float(np.linalg.norm(lookdir))
        cu = np.cross(lookdir, up)
        cu /= max(np.linalg.norm(cu), 1e-20)
        cv = np.cross(cu, lookdir)
        cv /= max(np.linalg.norm(cv), 1e-20)
        ulen = lookdir_len * pymath.tan(pymath.radians(hfov * 0.5))
        vlen = lookdir_len * pymath.tan(pymath.radians(vfov * 0.5))
        f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
        return cls(eye=f32(eye), lookdir=f32(lookdir), up=f32(up),
                   camera_u=f32(cu * ulen), camera_v=f32(cv * vlen),
                   aperture=f32(aperture), hfov=hfov, vfov=vfov)

    @property
    def image_plane_size(self) -> Array:
        """2*(ulen, vlen) in world units (Camera.cpp:344)."""
        return 2.0 * jnp.stack([length(self.camera_u), length(self.camera_v)])

    @property
    def lookat(self) -> Array:
        return self.eye + self.lookdir

    # ---------------------------------------------------------------- rays
    def generate_rays(self, px: Array, py: Array, jitter: Array,
                      width: int, height: int,
                      dof_u: Array | None = None
                      ) -> tuple[Array, Array]:
        """Primary rays for integer pixel coords ``px, py`` [N] with
        per-pixel jitter [N,2]. Mapping matches RayGeneratorPT.cu:55-61:
        d = (pixel + jitter)/screen*2 - 1; dir = d.x*u + d.y*v + lookdir.

        With ``aperture > 0`` applies the thin-lens modification of
        helpers/camera.h:11-28 using dof samples [N,2].
        """
        dx = (px.astype(jnp.float32) + jitter[..., 0]) / width * 2.0 - 1.0
        dy = (py.astype(jnp.float32) + jitter[..., 1]) / height * 2.0 - 1.0
        origin = jnp.broadcast_to(self.eye, dx.shape + (3,))
        direction = normalize(dx[..., None] * self.camera_u
                              + dy[..., None] * self.camera_v + self.lookdir)
        if dof_u is None:
            return origin, direction

        def with_dof(o, d):
            look_n = normalize(self.lookdir)
            focal_center = self.eye + self.lookdir
            t_focal = (dot(look_n, focal_center) - dot(look_n, self.eye)) \
                / dot(look_n, d)
            look_at = o + t_focal[..., None] * d
            disc = sample_unit_disc(dof_u)
            o2 = o + (disc[..., 0:1] * self.camera_u
                      + disc[..., 1:2] * self.camera_v) * self.aperture
            return o2, normalize(look_at - o2)

        o2, d2 = with_dof(origin, direction)
        use = self.aperture > 0.0
        return (jnp.where(use, o2, origin), jnp.where(use, d2, direction))

    # ------------------------------------------------- VCM t=1 machinery
    def pdf_quantities(self, direction: Array, width: int, height: int
                       ) -> tuple[Array, Array]:
        """(cameraPdfW, cos_at_camera) for a ray direction.

        VCMCameraPass.cu:131-144: cameraPdfW = (1/pixelArea) *
        imageToSolidAngleFactor, with imageToSolidAngleFactor =
        (distToImagePlane/cos)^2 / cos. (The reference's pixelArea uses
        pixelSizeFactor.x twice — a typo; we use x*y.)
        """
        look_n = normalize(self.lookdir)
        cos_at_camera = dot(look_n, direction)
        dist_image = length(self.lookdir)
        img_to_solid = jnp.square(dist_image / cos_at_camera) / cos_at_camera
        ips = self.image_plane_size
        pixel_area = (ips[0] / width) * (ips[1] / height)
        return img_to_solid / pixel_area, cos_at_camera

    def world_to_raster(self, point: Array, width: int, height: int
                        ) -> tuple[Array, Array, Array, Array]:
        """Project a world point to raster coords for light-tracing splats
        (vcm.h connectCameraT1).

        Returns (px, py, in_frustum, dir_to_point).
        """
        to_p = point - self.eye
        dist = length(to_p)
        d = to_p / jnp.maximum(dist, 1e-20)[..., None]
        look_n = normalize(self.lookdir)
        cos_cam = dot(look_n, d)
        focal = length(self.lookdir)
        behind = cos_cam <= 1e-6
        # intersect ray with image plane at distance focal along lookdir
        t = focal / jnp.maximum(cos_cam, 1e-6)
        on_plane = self.eye + t[..., None] * d
        rel = on_plane - (self.eye + self.lookdir)
        ulen2 = dot(self.camera_u, self.camera_u)
        vlen2 = dot(self.camera_v, self.camera_v)
        ndc_x = dot(rel, self.camera_u) / ulen2   # in [-1,1] inside frustum
        ndc_y = dot(rel, self.camera_v) / vlen2
        px = (ndc_x + 1.0) * 0.5 * width
        py = (ndc_y + 1.0) * 0.5 * height
        inside = ((~behind) & (px >= 0) & (px < width)
                  & (py >= 0) & (py < height))
        return px, py, inside, d

    # ----------------------------------------------------- interactive ops
    def scale_fov(self, scale: float) -> "Camera":
        """Camera::scaleFOV (Camera.cpp:347-360)."""
        clampf = lambda x: min(max(x, 0.0), 120.0)
        h = clampf(pymath.degrees(2 * pymath.atan(
            scale * pymath.tan(pymath.radians(self.hfov * 0.5)))))
        v = clampf(pymath.degrees(2 * pymath.atan(
            scale * pymath.tan(pymath.radians(self.vfov * 0.5)))))
        return Camera.make(self.eye, self.lookat, self.up, h, v,
                           float(self.aperture))

    def translate(self, x: float, y: float) -> "Camera":
        """Camera::translate — pan in the image plane (Camera.cpp:362-368)."""
        trans = self.camera_u * x + self.camera_v * y
        return Camera.make(self.eye + trans, self.lookat + trans, self.up,
                           self.hfov, self.vfov, float(self.aperture))

    def dolly(self, scale: float) -> "Camera":
        """Camera::dolly (Camera.cpp:374-382)."""
        d = self.lookdir * scale
        return Camera.make(self.eye + d, self.lookat, self.up, self.hfov,
                           self.vfov, float(self.aperture))

    def orbit(self, dtheta: float, dphi: float) -> "Camera":
        """Rotate the eye around the lookat point — the Mouse 'rotate'
        interaction (util/Mouse.cpp:316-380). ``dtheta`` spins about the up
        axis, ``dphi`` tilts toward/away from it (radians); the polar angle
        is clamped away from the poles so the frame stays well-defined."""
        import numpy as np
        eye = np.asarray(self.eye, np.float64)
        at = np.asarray(self.lookat, np.float64)
        up = np.asarray(self.up, np.float64)
        rel = eye - at
        r = float(np.linalg.norm(rel))
        # spherical coords about `up`
        y = float(rel @ up)
        planar = rel - y * up
        p = float(np.linalg.norm(planar))
        if p < 1e-9 * max(r, 1e-9):
            e1 = np.array([1.0, 0.0, 0.0])
            e1 -= (e1 @ up) * up
            planar = e1 / np.linalg.norm(e1) * 1e-6
            p = float(np.linalg.norm(planar))
        u_hat = planar / p
        w_hat = np.cross(up, u_hat)
        theta = pymath.atan2(float(rel @ w_hat), p)
        phi = pymath.atan2(y, p)
        theta += dtheta
        phi = min(max(phi + dphi, -1.55), 1.55)
        new_rel = r * (pymath.cos(phi)
                       * (pymath.cos(theta) * u_hat
                          + pymath.sin(theta) * w_hat)
                       + pymath.sin(phi) * up)
        return Camera.make(at + new_rel, at, tuple(up), self.hfov,
                           self.vfov, float(self.aperture))
