import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.core.rng import make_root_key
from oppositerenderer.integrators import vcm
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene import get_scene_by_name, make_cornell_small


def vcm_cfg(**kw):
    base = dict(width=48, height=48,
                render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def cornell():
    return make_cornell_small()


def test_vcm_renders_finite(cornell):
    scene, cam = cornell
    r = Renderer(scene, cam, vcm_cfg(), seed=1)
    m = r.render_next_iteration()
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all()
    assert img.max() > 1.0
    assert m["light_vertices_stored"] > 0


def test_vcm_agrees_with_pt(cornell):
    """VCM total must match PT on the diffuse Cornell box — this exercises
    every MIS weight: wrong weights double-count or lose energy."""
    scene, cam = cornell
    rv = Renderer(scene, cam, vcm_cfg(), seed=2)
    rv.render(24)
    vcm_img = np.asarray(rv.film.mean_radiance())

    rt = Renderer(scene, cam, vcm_cfg(
        render_method=RenderMethod.PATH_TRACING), seed=3)
    rt.render(80)
    pt_img = np.asarray(rt.film.mean_radiance())

    assert vcm_img.mean() == pytest.approx(pt_img.mean(), rel=0.04)
    a = vcm_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    b = pt_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    mask = b > 0.02
    rel = np.abs(a - b)[mask] / b[mask]
    assert np.median(rel) < 0.12, (np.median(rel), rel.max())


def test_vcm_ablations_do_not_exceed_total(cornell):
    """Each single technique (MIS-weighted) must contribute less energy than
    the full estimator; together they reconstruct it. Catches weights > 1."""
    scene, cam = cornell
    full = Renderer(scene, cam, vcm_cfg(), seed=4)
    full.render(6)
    total = float(np.asarray(full.film.mean_radiance()).mean())

    parts = {}
    for name, flags in {
        "vc_only": dict(vcm_connect_camera_t1=False,
                        vcm_connect_light_s0=False,
                        vcm_connect_light_s1=False),
        "s1_only": dict(vcm_connect_camera_t1=False,
                        vcm_connect_light_s0=False,
                        vcm_connect_vertices=False),
        "s0_only": dict(vcm_connect_camera_t1=False,
                        vcm_connect_light_s1=False,
                        vcm_connect_vertices=False),
        "t1_only": dict(vcm_connect_light_s0=False,
                        vcm_connect_light_s1=False,
                        vcm_connect_vertices=False),
    }.items():
        r = Renderer(scene, cam, vcm_cfg(**flags), seed=4)
        r.render(6)
        parts[name] = float(np.asarray(r.film.mean_radiance()).mean())
        assert 0 < parts[name] < total * 1.02, (name, parts[name], total)

    # the techniques partition the estimator: sums reconstruct the total
    assert sum(parts.values()) == pytest.approx(total, rel=0.02), \
        (parts, total)


def test_vcm_specular_scene(cornell):
    scene, cam = get_scene_by_name("CornellSmallLargeSphere")
    r = Renderer(scene, cam, vcm_cfg(), seed=5)
    r.render(3)
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all()
    assert img.max() > 0.5


def test_vcm_point_light_scene():
    """Delta light: s=0 impossible, bsdfDirPdfW zeroed in s=1 MIS."""
    scene, cam = get_scene_by_name("CornellSmallSmallSpheres")
    r = Renderer(scene, cam, vcm_cfg(), seed=6)
    r.render(3)
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_vcm_point_light_agrees_with_pt():
    scene, cam = get_scene_by_name("CornellSmallPointTest")
    rv = Renderer(scene, cam, vcm_cfg(), seed=7)
    rv.render(16)
    vcm_img = np.asarray(rv.film.mean_radiance())
    rt = Renderer(scene, cam, vcm_cfg(
        render_method=RenderMethod.PATH_TRACING), seed=8)
    rt.render(48)
    pt_img = np.asarray(rt.film.mean_radiance())
    assert vcm_img.mean() == pytest.approx(pt_img.mean(), rel=0.08), \
        (vcm_img.mean(), pt_img.mean())


def test_vcm_determinism(cornell):
    scene, cam = cornell
    cfg = vcm_cfg(width=24, height=24)
    key = make_root_key(9)
    a, _ = vcm.render_iteration(scene, cam, cfg, jnp.int32(2), key,
                                jnp.float32(0.001))
    b, _ = vcm.render_iteration(scene, cam, cfg, jnp.int32(2), key,
                                jnp.float32(0.001))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_uniform_vertex_sampling_agrees_with_paired(cornell):
    """VCM_UNIFORM_VERTEX_SAMPLING (OptixRenderer.cpp:308,679-773): the
    uniform-pick connection regime is an unbiased estimator of the same
    integral as 1:1 pairing — mean radiance must agree within MC noise."""
    scene, cam = cornell
    base = RenderConfig(width=32, height=32,
                        render_method=RenderMethod.
                        VCM_BIDIRECTIONAL_PATH_TRACING,
                        vcm_max_path_length=5)
    key = make_root_key(11)
    r2 = jnp.float32(0.002)

    def mean_img(cfg, iters=3):
        acc = 0.0
        for i in range(iters):
            img, _ = vcm.render_iteration(scene, cam, cfg, jnp.int32(i),
                                          key, r2)
            acc = acc + img
        return np.asarray(acc) / iters

    paired = mean_img(base)
    uniform = mean_img(base.replace(vcm_uniform_vertex_sampling=True,
                                    vcm_uniform_connections=3))
    assert np.isfinite(uniform).all()
    assert uniform.mean() == pytest.approx(paired.mean(), rel=0.1), \
        (uniform.mean(), paired.mean())
