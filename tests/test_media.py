"""Participating media: transmittance, scatter sampling, full PPM render."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.integrators import media
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene import SceneBuilder, make_cornell_small
from oppositerenderer.scene.types import Medium


def medium_box(ss=0.2, sa=0.05):
    return Medium(sigma_s=jnp.float32(ss), sigma_a=jnp.float32(sa),
                  aabb_min=jnp.zeros(3), aabb_max=jnp.full((3,), 2.5))


def test_segment_overlap():
    m = medium_box()
    o = jnp.asarray([[1.25, 1.25, -2.0], [1.25, 1.25, 1.0],
                     [5.0, 5.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    t_hit = jnp.asarray([10.0, 10.0, 10.0])
    t0, ov = media.segment_overlap(m, o, d, t_hit)
    np.testing.assert_allclose(np.asarray(ov), [2.5, 1.5, 0.0], atol=1e-5)
    assert float(t0[0]) == pytest.approx(2.0)
    # capped by the surface hit
    _, ov2 = media.segment_overlap(m, o, d, jnp.asarray([3.0, 0.5, 1.0]))
    np.testing.assert_allclose(np.asarray(ov2), [1.0, 0.5, 0.0], atol=1e-5)


def test_transmittance_beer_lambert():
    m = medium_box(0.3, 0.2)
    tr = media.transmittance(m, jnp.asarray([0.0, 1.0, 2.0]))
    np.testing.assert_allclose(np.asarray(tr),
                               np.exp(-0.5 * np.asarray([0, 1, 2])),
                               rtol=1e-5)


def test_scatter_distance_distribution():
    m = medium_box(0.5, 0.5)  # sigma_t = 1
    u = jax.random.uniform(jax.random.PRNGKey(0), (1 << 14,))
    t, pdf = media.sample_scatter_distance(m, u)
    # mean free path = 1/sigma_t = 1
    assert float(jnp.mean(t)) == pytest.approx(1.0, rel=0.05)
    np.testing.assert_allclose(np.asarray(pdf),
                               np.exp(-np.asarray(t)), rtol=1e-4)


def cornell_with_medium(ss=0.15, sa=0.02):
    scene, cam = make_cornell_small()
    return scene.replace(medium=Medium(
        sigma_s=jnp.float32(ss), sigma_a=jnp.float32(sa),
        aabb_min=jnp.zeros(3), aabb_max=jnp.full((3,), 2.5))), cam


def ppm_cfg(**kw):
    base = dict(width=32, height=32,
                render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                photons_per_iteration=1 << 13, photon_grid_resolution=16)
    base.update(kw)
    return RenderConfig(**base)


def test_ppm_with_medium_renders():
    scene, cam = cornell_with_medium()
    r = Renderer(scene, cam, ppm_cfg(), seed=3)
    m = r.render_next_iteration()
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all()
    assert img.max() > 0.5
    assert m["volumetric_photons_stored"] > 0


def test_medium_attenuates_and_adds_inscatter():
    """Dense absorbing medium darkens surfaces; scattering adds glow."""
    scene0, cam = make_cornell_small()
    cfg = ppm_cfg()
    r0 = Renderer(scene0, cam, cfg, seed=4)
    r0.render(3)
    base = np.asarray(r0.film.mean_radiance())

    # pure absorber: image must get strictly darker
    sa_scene, _ = cornell_with_medium(ss=0.0, sa=0.4)
    ra = Renderer(sa_scene, cam, cfg, seed=4)
    ra.render(3)
    absorbed = np.asarray(ra.film.mean_radiance())
    mask = base.sum(-1) > 0.05
    assert absorbed[mask].mean() < base[mask].mean() * 0.85

    # scattering medium: some in-scattered radiance appears
    ss_scene, _ = cornell_with_medium(ss=0.3, sa=0.0)
    rs = Renderer(ss_scene, cam, cfg, seed=4)
    rs.render(3)
    scat = np.asarray(rs.film.mean_radiance())
    assert np.isfinite(scat).all()
    # surfaces attenuated but volume glow compensates partially
    assert scat.mean() > absorbed.mean()


def test_medium_energy_sanity():
    """Purely scattering medium should roughly conserve image energy
    (single-scatter estimate recovers part of the attenuation loss)."""
    scene0, cam = make_cornell_small()
    cfg = ppm_cfg()
    r0 = Renderer(scene0, cam, cfg, seed=5)
    r0.render(4)
    base = float(np.asarray(r0.film.mean_radiance()).mean())

    ss_scene, _ = cornell_with_medium(ss=0.1, sa=0.0)
    rs = Renderer(ss_scene, cam, cfg, seed=5)
    rs.render(4)
    scat = float(np.asarray(rs.film.mean_radiance()).mean())
    # within [50%, 110%] of the clear-scene energy
    assert 0.5 * base < scat < 1.1 * base, (scat, base)


# ---------------------------------------------------------------------------
# round 5: glass interiors, all-segment in-scatter, analytic slab validation
# ---------------------------------------------------------------------------

def _glass_slab_scene(sigma_a):
    """Camera at z=-2 -> glass slab z in [0.5, 1.5] -> white wall at z=3,
    medium box covering z in [0, 3]. The straight-through eye path spends
    2.0 units in the medium OUTSIDE the glass and 1.0 INSIDE it."""
    from oppositerenderer.camera import Camera
    from oppositerenderer.lights import make_area_light
    from oppositerenderer.scene import SceneBuilder

    b = SceneBuilder("glass-slab")
    glass = b.add_glass(1.5)
    wall = b.add_diffuse((0.7, 0.7, 0.7))
    em = b.add_emitter((30, 30, 30), light=make_area_light(
        (30, 30, 30), (-4.0, -1.0, 1.0), (0.5, 0, 0), (0, 0.5, 0)))
    S = 4.0
    b.add_parallelogram((-S, -S, 0.5), (2 * S, 0, 0), (0, 2 * S, 0), glass)
    b.add_parallelogram((-S, -S, 1.5), (2 * S, 0, 0), (0, 2 * S, 0), glass)
    b.add_parallelogram((-S, -S, 3.0), (2 * S, 0, 0), (0, 2 * S, 0), wall)
    b.add_parallelogram((-4.0, -1.0, 1.0), (0.5, 0, 0), (0, 0.5, 0), em)
    b.set_medium(0.0, sigma_a, aabb_min=(-S, -S, 0.0), aabb_max=(S, S, 3.0))
    scene = b.build()
    # near-axial rays: oblique pixels lengthen the in-medium path by
    # 1/cos(theta) and would smear the exp(-2 sigma) prediction
    cam = Camera.make(eye=(0, 0, -2), lookat=(0, 0, 3), hfov=2, vfov=2)
    return scene, cam


def test_glass_interior_skips_medium():
    """Dielectric interiors suppress the global medium (the reference's
    *_IN_PARTICIPATING_MEDIUM ray types, RayType.h:16-22 +
    Glass.cu:146-160): the eye-walk attenuation ratio between a sigma_a
    medium and a zero medium must be exp(-sigma_a * OUTSIDE-glass path)
    = exp(-2 sigma_a), NOT exp(-3 sigma_a) (whole path)."""
    import jax
    import jax.numpy as jnp
    from oppositerenderer.integrators.ppm import trace_eye_pass
    from oppositerenderer.integrators.common import (pixel_coords,
                                                         scene_epsilon)

    sigma = 0.4
    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    px, py = pixel_coords(cfg.width, cfg.height)
    lanes = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    key = jax.random.PRNGKey(9)
    attens = {}
    founds = {}
    for s in (0.0, sigma):
        scene, cam = _glass_slab_scene(s)
        hp = trace_eye_pass(scene, cam, cfg, key, scene_epsilon(scene),
                            px, py, lanes)
        attens[s] = np.asarray(hp.attenuation)
        founds[s] = np.asarray(hp.found)
    # identical RNG structure across the two runs -> identical specular
    # chains; compare straight-through lanes (found in both)
    mask = founds[0.0] & founds[sigma]
    assert mask.sum() > 50, mask.sum()
    ratio = attens[sigma][mask].mean(-1) / attens[0.0][mask].mean(-1)
    expected = np.exp(-2.0 * sigma)
    wrong = np.exp(-3.0 * sigma)   # what no-interior-bit would produce
    med = float(np.median(ratio))
    assert med == pytest.approx(expected, rel=0.02), (med, expected)
    assert abs(med - expected) < abs(med - wrong)


def test_inscatter_beyond_primary_segment():
    """In-scatter is picked up on EVERY eye segment (reservoir over the
    walk), not just the camera segment: a mirror-reflected segment
    crossing the medium must carry a volumetric sample (the round-4
    implementation hard-coded depth == 0,
    integrators/ppm.py 'primary = depth == 0')."""
    import jax
    import jax.numpy as jnp
    from oppositerenderer.camera import Camera
    from oppositerenderer.scene import SceneBuilder
    from oppositerenderer.integrators.ppm import trace_eye_pass
    from oppositerenderer.integrators.common import (pixel_coords,
                                                         scene_epsilon)

    # camera at origin -> 45-degree mirror at z=2 deflecting up (+y);
    # medium box only above y=1; diffuse wall at y=4
    from oppositerenderer.lights import make_area_light
    b = SceneBuilder("mirror-medium")
    mirror = b.add_mirror((0.95, 0.95, 0.95))
    wall = b.add_diffuse((0.6, 0.6, 0.6))
    em = b.add_emitter((20, 20, 20), light=make_area_light(
        (20, 20, 20), (-3.0, 0.2, 0.0), (0.4, 0, 0), (0, 0.4, 0)))
    # mirror plane y = z - 2 (normal (0, 1, -1)/sqrt2), spanning the view
    b.add_parallelogram((-2.0, -2.0, 0.0), (4.0, 0, 0), (0, 4.0, 4.0),
                        mirror)
    b.add_parallelogram((-3.0, 4.0, -1.0), (6.0, 0, 0), (0, 0, 6.0), wall)
    b.add_parallelogram((-3.0, 0.2, 0.0), (0.4, 0, 0), (0, 0.4, 0), em)
    b.set_medium(0.2, 0.05, aabb_min=(-3.0, 1.0, -1.0),
                 aabb_max=(3.0, 4.0, 5.0))
    scene = b.build()
    cam = Camera.make(eye=(0, 0, -1), lookat=(0, 0, 2), hfov=25, vfov=25)

    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    px, py = pixel_coords(cfg.width, cfg.height)
    lanes = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    hp = trace_eye_pass(scene, cam, cfg, jax.random.PRNGKey(4),
                        scene_epsilon(scene), px, py, lanes)
    vol_len = np.asarray(hp.vol_len)
    found = np.asarray(hp.found)
    spec = np.asarray(hp.specular_chain)
    # mirror-bounced lanes that reached the wall must have sampled the
    # medium on their SECOND segment (primary segment overlap is zero:
    # camera and mirror both sit below the y=1 medium floor)
    m = found & spec
    assert m.sum() > 50, m.sum()
    assert (vol_len[m] > 0.5).mean() > 0.9, vol_len[m]
    # and the reservoir recorded attenuation + weights for the pick
    assert np.asarray(hp.vol_w)[m].min() > 0.0
    assert np.isclose(np.asarray(hp.vol_atten)[m].max(), 0.95, atol=0.06)


@pytest.mark.slow
def test_slab_single_scatter_matches_quadrature():
    """Converged volumetric estimate vs an independent quadrature of the
    single-scatter integral (VERDICT round-4 item 5c): point light inside
    a homogeneous box, black walls, camera ray crossing the medium.

        L = int T(0,t) sigma_s phase T(t, light) Phi / (4 pi d(t)^2) dt

    Low albedo (sigma_s/sigma_t = 1/6) keeps multiple scattering ~2%."""
    import jax.numpy as jnp
    from oppositerenderer.camera import Camera
    from oppositerenderer.scene import SceneBuilder
    from oppositerenderer.scene.types import Medium

    sigma_s, sigma_a = 0.05, 0.25
    sigma_t = sigma_s + sigma_a
    phi = 50.0
    light_pos = np.array([1.45, 1.0, 1.0])

    from oppositerenderer.lights import make_point_light
    b = SceneBuilder("slab")
    black = b.add_diffuse((0.0, 0.0, 0.0))
    S = 3.0
    b.add_parallelogram((-S, -S, 2.5), (2 * S, 0, 0), (0, 2 * S, 0), black)
    b.add_light(make_point_light((phi, phi, phi), tuple(light_pos)))
    b.set_medium(sigma_s, sigma_a, aabb_min=(-1.0, -1.0, 0.0),
                 aabb_max=(3.0, 3.0, 2.0))
    scene = b.build()
    cam = Camera.make(eye=(1.0, 1.0, -1.0), lookat=(1.0, 1.0, 2.0),
                      hfov=10, vfov=10)

    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=1 << 14,
                       photon_grid_resolution=24,
                       iterations_per_dispatch=4)
    r = Renderer(scene, cam, cfg, seed=6, ppm_initial_radius=0.12)
    r.render(24)
    img = np.asarray(r.film.mean_radiance())
    center = img[6:10, 6:10].mean()

    # quadrature along the center ray o=(1,1,-1), d=+z, medium t in [1,3]
    ts = np.linspace(1.0, 3.0, 4001)
    pts = np.array([1.0, 1.0, -1.0]) + ts[:, None] * np.array([0, 0, 1.0])
    dlight = np.linalg.norm(pts - light_pos, axis=1)
    integrand = (np.exp(-sigma_t * (ts - 1.0)) * sigma_s / (4 * np.pi)
                 * np.exp(-sigma_t * dlight) * phi
                 / (4 * np.pi * np.maximum(dlight, 1e-9) ** 2))
    L_quad = np.trapezoid(integrand, ts)

    assert center == pytest.approx(L_quad, rel=0.15), (center, L_quad)
