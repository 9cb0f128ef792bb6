"""Analytic radiance parity (round-2 verdict missing #3).

The reference's BASELINE asks for radiance parity against its own rendered
images, which cannot run here (Windows/OptiX); the honest substitute is a
CLOSED-FORM ground truth. Two scenes:

* a diffuse floor under a rectangular area light — per-pixel radiance is
  rho/pi * E(x) with E given by the exact polygon-luminaire irradiance
  formula (Lambert's formula: E = L/2 * sum_i gamma_i (c_i . n), see
  Arvo, "The Irradiance Jacobian for Partially Occluded Polyhedral
  Sources", eq. 1.1) — validating emitter radiometry
  (Lemit = power * invArea / pi, DiffuseEmitter.h), NEE geometry terms,
  and MIS totals end-to-end for PT, PPM, and VCM;
* the same floor under a point light — E = Phi cos(theta) / (4 pi d^2),
  validating the delta-light path (Light.cpp:31-40).
"""
import numpy as np
import pytest

from oppositerenderer.camera import Camera
from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.lights import make_area_light, make_point_light
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene.builder import SceneBuilder

RHO = 0.6
W = H = 16


def polygon_irradiance(x, n, corners, L):
    """Exact irradiance at x (normal n) from a polygon with constant
    radiance L (one-sided). Lambert / Arvo formula."""
    E = np.zeros(3)
    k = len(corners)
    r = [c - x for c in corners]
    r = [v / np.linalg.norm(v) for v in r]
    acc = 0.0
    for i in range(k):
        a, b = r[i], r[(i + 1) % k]
        gamma = np.arccos(np.clip(np.dot(a, b), -1.0, 1.0))
        c = np.cross(a, b)
        cn = np.linalg.norm(c)
        if cn > 1e-12:
            acc += gamma * np.dot(c / cn, n)
    return np.abs(acc) * 0.5 * L


def floor_scene(light):
    b = SceneBuilder("analytic")
    floor = b.add_diffuse((RHO, RHO, RHO))
    b.add_parallelogram((-20, 0, -20), (0, 0, 40), (40, 0, 0), floor)
    if light["kind"] == 0:
        anchor = (-0.5, 2.0, -0.5)
        em = b.add_emitter(light["power"], kd=(1, 1, 1), light=light)
        b.add_parallelogram(anchor, (1, 0, 0), (0, 0, 1), em)
    else:
        b.add_light(light)
    scene = b.build(aabb_padding=0.1)
    cam = Camera.make(eye=(0.0, 1.2, -2.5), lookat=(0.0, 0.0, 0.0),
                      hfov=30.0, vfov=30.0)
    return scene, cam


def pixel_floor_points(cam):
    """Intersect pixel-center rays with the y=0 plane (host math)."""
    import jax.numpy as jnp
    from oppositerenderer.integrators.common import pixel_coords
    px, py = pixel_coords(W, H)
    jit = jnp.full((W * H, 2), 0.5)
    o, d = cam.generate_rays(px, py, jit, W, H)
    o = np.asarray(o)
    d = np.asarray(d)
    t = -o[:, 1] / d[:, 1]
    return o + t[:, None] * d


def run(scene, cam, method, iters, seed, **kw):
    cfg = RenderConfig(width=W, height=H, render_method=method, **kw)
    r = Renderer(scene, cam, cfg, seed=seed)
    r.render(iters)
    return np.asarray(r.film.mean_radiance()).reshape(H * W, 3)


def assert_matches(img, truth, med_tol, mean_tol):
    lum = img.mean(axis=1)
    rel = np.abs(lum - truth) / np.maximum(truth, 1e-9)
    assert np.median(rel) < med_tol, (np.median(rel), lum[:4], truth[:4])
    assert abs(lum.mean() - truth.mean()) / truth.mean() < mean_tol, (
        lum.mean(), truth.mean())


@pytest.fixture(scope="module")
def area_setup():
    power = np.array((3.0, 3.0, 3.0), np.float32)
    light = make_area_light(power, (-0.5, 2.0, -0.5), (1, 0, 0), (0, 0, 1))
    scene, cam = floor_scene(light)
    pts = pixel_floor_points(cam)
    L = float(power[0] / (1.0 * np.pi))  # area = 1
    corners = [np.array(c, np.float64) for c in
               [(-0.5, 2, -0.5), (0.5, 2, -0.5), (0.5, 2, 0.5),
                (-0.5, 2, 0.5)]]
    n = np.array([0.0, 1.0, 0.0])
    E = np.array([polygon_irradiance(p, n, corners, L) for p in pts])
    truth = RHO / np.pi * E
    return scene, cam, truth


def test_pt_matches_polygon_formula(area_setup):
    scene, cam, truth = area_setup
    img = run(scene, cam, RenderMethod.PATH_TRACING, 96, seed=7)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)


def test_ppm_matches_polygon_formula(area_setup):
    # the photon map contributes nothing here (no second diffuse bounce
    # exists), so PPM radiance = its NEE direct pass, which must hit the
    # same closed form
    scene, cam, truth = area_setup
    img = run(scene, cam, RenderMethod.PROGRESSIVE_PHOTON_MAPPING, 48,
              seed=8, photons_per_iteration=1 << 10)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)


def test_vcm_matches_polygon_formula(area_setup):
    scene, cam, truth = area_setup
    img = run(scene, cam,
              RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING, 96, seed=9)
    assert_matches(img, truth, med_tol=0.06, mean_tol=0.03)


def test_pt_matches_point_light_formula():
    power = np.array((5.0, 5.0, 5.0), np.float32)
    lpos = np.array((0.3, 1.5, 0.2), np.float64)
    scene, cam = floor_scene(make_point_light(power, tuple(lpos)))
    pts = pixel_floor_points(cam)
    d = lpos[None, :] - pts
    dist2 = (d * d).sum(axis=1)
    cos = d[:, 1] / np.sqrt(dist2)
    E = float(power[0]) * cos / (4.0 * np.pi * dist2)
    truth = RHO / np.pi * E
    img = run(scene, cam, RenderMethod.PATH_TRACING, 64, seed=10)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)
