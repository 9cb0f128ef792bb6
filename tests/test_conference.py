"""Conference procedural scene (scene/conference.py): build sanity and
estimator cross-agreement. Mirrors the Atrium's coverage for the
reference's second flagship workload class (README.md:15)."""
import numpy as np
import pytest

from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.renderer import Renderer
from oppositerenderer.scene import get_scene_by_name


@pytest.fixture(scope="module")
def conference():
    return get_scene_by_name("Conference:0.15")


def test_build_counts_scale():
    s_lo, _ = get_scene_by_name("Conference:0.15")
    s_hi, _ = get_scene_by_name("Conference:0.5")
    assert s_hi.geometry.n_triangles > 2 * s_lo.geometry.n_triangles
    assert int(s_lo.lights.n_lights) == 3


def test_pt_vcm_agree(conference):
    scene, cam = conference
    imgs = {}
    for m, iters in ((RenderMethod.PATH_TRACING, 20),
                     (RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING, 10)):
        r = Renderer(scene, cam, RenderConfig(width=48, height=48,
                                              render_method=m), seed=3)
        r.render(iters)
        imgs[m] = np.asarray(r.film.mean_radiance())
        assert np.isfinite(imgs[m]).all()
    a = imgs[RenderMethod.PATH_TRACING].mean()
    b = imgs[RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING].mean()
    assert a > 0.05
    assert b == pytest.approx(a, rel=0.12), (a, b)
