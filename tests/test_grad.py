"""Gradient correctness: jax.grad vs central finite differences.

Fixed RNG streams (common random numbers) make the renders piecewise-smooth
in the parameters, so FD matches the detached-sampling gradient wherever no
discrete decision flips; tests are built so decisions don't depend on the
differentiated parameter (diffuse-only dirs) or tolerate tiny flip noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer import diff
from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.core.rng import make_root_key
from oppositerenderer.integrators import ppm, pt, vcm
from oppositerenderer.scene import make_cornell_small

KEY = make_root_key(12)


@pytest.fixture(scope="module")
def cornell():
    scene, cam = make_cornell_small()
    return scene, cam


def pt_cfg(**kw):
    # no RR dependence on materials: start RR beyond the path length
    base = dict(width=24, height=24,
                render_method=RenderMethod.PATH_TRACING,
                pt_max_segments_nee=3, path_rr_start_depth=9)
    base.update(kw)
    return RenderConfig(**base)


def mean_image_pt(scene, cam, cfg, iters=2):
    acc = 0.0
    for i in range(iters):
        acc = acc + jnp.mean(pt.render_iteration(scene, cam, cfg,
                                                 jnp.int32(i), KEY))
    return acc / iters


def finite_diff(f, x0, h):
    return (f(x0 + h) - f(x0 - h)) / (2 * h)


def test_pt_grad_kd_matches_fd(cornell):
    scene, cam = cornell
    cfg = pt_cfg()

    def loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        return mean_image_pt(s, cam, cfg)

    g = jax.grad(loss)(1.0)
    fd = finite_diff(loss, 1.0, 1e-3)
    assert float(g) == pytest.approx(float(fd), rel=0.02), (g, fd)
    assert float(g) > 0  # brighter walls -> brighter image


def test_pt_grad_emission_matches_fd(cornell):
    scene, cam = cornell
    cfg = pt_cfg()

    def loss(scale):
        return mean_image_pt(diff.scale_emission(scene, scale), cam, cfg)

    g = jax.grad(loss)(1.0)
    fd = finite_diff(loss, 1.0, 1e-3)
    # emission is linear: grad == loss value at scale 1
    assert float(g) == pytest.approx(float(loss(1.0)), rel=1e-4)
    assert float(g) == pytest.approx(float(fd), rel=1e-3)


def test_ppm_grad_kd_matches_fd(cornell):
    scene, cam = cornell
    cfg = RenderConfig(width=24, height=24,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       photon_rr_start_depth=9, max_photon_trace_depth=4)

    def loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        img, _ = ppm.render_iteration(s, cam, cfg, jnp.int32(0), KEY,
                                      jnp.float32(0.003))
        return jnp.mean(img)

    g = jax.grad(loss)(1.0)
    fd = finite_diff(loss, 1.0, 1e-3)
    assert float(g) == pytest.approx(float(fd), rel=0.03), (g, fd)
    assert float(g) > 0


def test_ppm_grad_through_tiled_gather(cornell):
    """jax.grad through a PPM iteration with the Pallas tile gather enabled
    (interpret mode on CPU): the kernel's backward pass is its plain
    reference's VJP, so the kd gradient carries the photon-power term too
    (more kd -> more deposited power) and matches finite differences of
    the same route, as the XLA gather's does."""
    scene, cam = cornell
    cfg = RenderConfig(width=32, height=32,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       photon_rr_start_depth=9, max_photon_trace_depth=4,
                       use_pallas_gather=True)

    def loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        img, _ = ppm.render_iteration(s, cam, cfg, jnp.int32(0), KEY,
                                      jnp.float32(0.003))
        return jnp.mean(img)

    g = jax.grad(loss)(1.0)
    fd = finite_diff(loss, 1.0, 1e-3)
    assert float(g) == pytest.approx(float(fd), rel=0.03), (g, fd)
    assert float(g) > 0


def test_vcm_grad_kd_matches_fd(cornell):
    scene, cam = cornell
    # pin RR continuation to 1 so the FD oracle is well-conditioned (live
    # RR makes FD heavy-tailed: flip prob ~h with magnitude ~1/h)
    cfg = RenderConfig(width=32, height=32,
                       render_method=(
                           RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING),
                       vcm_max_path_length=4,
                       vcm_force_continuation_prob=1.0)
    iters = 2

    def loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        acc = 0.0
        for i in range(iters):
            img, _ = vcm.render_iteration(s, cam, cfg, jnp.int32(i), KEY,
                                          jnp.float32(0.003))
            acc = acc + jnp.mean(img)
        return acc / iters

    g = jax.grad(loss)(1.0)
    fd = finite_diff(loss, 1.0, 1e-3)
    assert float(g) == pytest.approx(float(fd), rel=0.03), (g, fd)
    assert float(g) > 0


def test_vcm_grad_emission_linear(cornell):
    scene, cam = cornell
    cfg = RenderConfig(width=16, height=16,
                       render_method=(
                           RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING),
                       vcm_max_path_length=4)

    def loss(scale):
        img, _ = vcm.render_iteration(diff.scale_emission(scene, scale),
                                      cam, cfg, jnp.int32(0), KEY,
                                      jnp.float32(0.003))
        return jnp.mean(img)

    g = jax.grad(loss)(1.0)
    assert float(g) == pytest.approx(float(loss(1.0)), rel=1e-3)


def test_grad_wrt_glossy_params(cornell):
    """Gradients flow through the Phong lobe (ks, exponent)."""
    from oppositerenderer.scene import get_scene_by_name
    scene, cam = get_scene_by_name("CornellSmallLargeSphere")  # glossy floor
    cfg = pt_cfg(width=16, height=16)
    # glossy material index: find a GLOSSY row
    from oppositerenderer.scene.types import GLOSSY
    gidx = int(np.argmax(np.asarray(scene.materials.kind) == GLOSSY))

    def loss_ks(s_val):
        s = diff.set_material_param(scene, "ks", gidx,
                                    jnp.full((3,), s_val))
        return mean_image_pt(s, cam, cfg, iters=1)

    g = jax.grad(loss_ks)(0.7)
    assert np.isfinite(float(g))
    fd = finite_diff(loss_ks, 0.7, 1e-3)
    assert float(g) == pytest.approx(float(fd), rel=0.15), (g, fd)


def test_render_loss_and_grad_helper(cornell):
    scene, cam = cornell
    cfg = pt_cfg(width=16, height=16)
    loss, grads = diff.render_loss_and_grad(
        lambda s: pt.render_iteration(s, cam, cfg, jnp.int32(0), KEY),
        scene, {("kd", 0): scene.materials.kd[0]})
    assert np.isfinite(float(loss))
    g = np.asarray(grads[("kd", 0)])
    assert g.shape == (3,) and np.isfinite(g).all() and (g > 0).all()
