"""Debug observability machinery (VERDICT r1 missing #8): per-debug-pixel
path tracing, checkify NaN pass, photon depth histogram."""
import numpy as np
import pytest

from oppositerenderer import debug
from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.scene import make_cornell_small


@pytest.fixture(scope="module")
def cornell():
    return make_cornell_small()


def test_trace_debug_pixel_records_path(cornell):
    scene, cam = cornell
    cfg = RenderConfig(width=32, height=32)
    recs = debug.trace_debug_pixel(scene, cam, cfg, 16, 16)
    assert len(recs) >= 1
    assert recs[0]["hit"]
    # records carry finite positions/throughputs and a sampled direction
    for r in recs:
        assert np.isfinite(r["position"]).all()
        assert np.isfinite(r["throughput"]).all()
    assert "sampled_dir" in recs[0] or recs[0]["is_emitter"]
    # throughput only decreases along a diffuse chain
    if len(recs) >= 2:
        assert recs[1]["throughput"].max() <= recs[0]["throughput"].max() + 1e-6


def test_check_iteration_clean_scene(cornell):
    scene, cam = cornell
    cfg = RenderConfig(width=16, height=16,
                       photons_per_iteration=1024,
                       photon_grid_resolution=8, gather_photon_budget=32,
                       max_photon_trace_depth=3, vcm_max_path_length=4)
    for method in (RenderMethod.PATH_TRACING,
                   RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                   RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING):
        msg, radiance = debug.check_iteration(
            scene, cam, cfg.replace(render_method=method))
        assert np.isfinite(np.asarray(radiance)).all()
        # the estimators guard their divisions; a clean scene must not trip
        # float checks
        assert msg is None, (method, msg)


def test_photon_depth_histogram(cornell):
    scene, cam = cornell
    cfg = RenderConfig(photons_per_iteration=2048,
                       max_photon_trace_depth=4)
    out = debug.photon_depth_histogram(scene, cfg)
    hist = out["deposits_histogram"]
    assert hist.sum() == 2048
    assert out["photons_stored"] > 0
    # stored count must equal the histogram's weighted sum
    weighted = int((np.arange(hist.shape[0]) * hist).sum())
    assert weighted == out["photons_stored"]


def test_photon_depth_histogram_known_geometry():
    """Two huge facing diffuse planes, point light between them, depth cap
    3, RR off. Deposits start at the SECOND diffuse hit (the map is
    indirect-only, Diffuse.cu:98), so nearly every photon deposits exactly
    at depths 1 and 2 -> per-path count ~always 2. A depth-major/lane-major
    reshape mixup smears this spike across {0..3}; the totals in the test
    above survive any permutation, this distribution does not."""
    from oppositerenderer.lights import make_point_light
    from oppositerenderer.scene import SceneBuilder

    b = SceneBuilder()
    mat = b.add_diffuse((0.7, 0.7, 0.7))
    s = 500.0
    # floor (normal +y) and ceiling (normal -y), 1 unit apart
    b.add_triangle((-s, 0, -s), (s, 0, s), (s, 0, -s), mat)
    b.add_triangle((-s, 0, -s), (-s, 0, s), (s, 0, s), mat)
    b.add_triangle((-s, 1, -s), (s, 1, -s), (s, 1, s), mat)
    b.add_triangle((-s, 1, -s), (s, 1, s), (-s, 1, s), mat)
    b.add_light(make_point_light((10.0,) * 3, (0.0, 0.5, 0.0)))
    scene = b.build()

    n = 2048
    cfg = RenderConfig(photons_per_iteration=n, max_photon_trace_depth=3,
                       photon_rr_start_depth=9)
    out = debug.photon_depth_histogram(scene, cfg)
    hist = out["deposits_histogram"]
    assert hist.sum() == n
    weighted = int((np.arange(hist.shape[0]) * hist).sum())
    assert weighted == out["photons_stored"]
    # the spike: >90% of paths deposit exactly twice (tiny edge leakage)
    assert hist[2] > 0.9 * n, hist
