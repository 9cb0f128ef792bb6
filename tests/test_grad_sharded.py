"""Sharded differentiable rendering (north star: parameter gradients
all-reduced across the mesh, overlapped with the backward pass).

Asserts (a) sharded grad == unsharded grad and (b) sharded grad == central
finite differences, for PT and PPM on the 8-virtual-device mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer import diff
from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.core.rng import make_root_key
from oppositerenderer.integrators import pt
from oppositerenderer.parallel import make_mesh
from oppositerenderer.scene import make_cornell_small

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

KEY = make_root_key(12)


@pytest.fixture(scope="module")
def cornell():
    return make_cornell_small()


def pt_cfg(**kw):
    base = dict(width=24, height=24,
                render_method=RenderMethod.PATH_TRACING,
                pt_max_segments_nee=3, path_rr_start_depth=9)
    base.update(kw)
    return RenderConfig(**base)


def test_sharded_pt_grad_matches_unsharded_and_fd(cornell):
    scene, cam = cornell
    cfg = pt_cfg()
    mesh = make_mesh(8)

    loss_s, grads_s = diff.make_sharded_loss_and_grad(
        scene, cam, cfg, mesh, wrt_kd_scale(scene))(iteration=0, key=KEY)
    g_sharded = float(jnp.sum(grads_s[("kd", 0)]
                              * scene.materials.kd[0]))

    # unsharded reference via plain jax.grad over the single-device render
    def loss_unsharded(scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * scale)
        return jnp.mean(pt.render_iteration(s, cam, cfg, jnp.int32(0), KEY))

    g_ref = float(jax.grad(loss_unsharded)(1.0))
    assert float(loss_s) == pytest.approx(float(loss_unsharded(1.0)),
                                          rel=2e-3)
    assert g_sharded == pytest.approx(g_ref, rel=5e-3), (g_sharded, g_ref)

    fd = float((loss_unsharded(1.001) - loss_unsharded(0.999)) / 0.002)
    assert g_sharded == pytest.approx(fd, rel=0.02), (g_sharded, fd)
    assert g_sharded > 0


def wrt_kd_scale(scene):
    # differentiate w.r.t. the raw kd vector of material 0; chain rule with
    # kd itself recovers d/d(scale) at scale=1
    return {("kd", 0): scene.materials.kd[0]}


def test_sharded_ppm_grad_runs_and_matches_unsharded(cornell):
    """Grad flows through the all-to-all photon exchange + partitioned
    gather (sort/all_to_all/psum_scatter are all linear in photon power)."""
    from oppositerenderer.integrators import ppm
    scene, cam = cornell
    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       max_photon_trace_depth=3,
                       photon_rr_start_depth=9,
                       gather_photon_budget=4096)
    mesh = make_mesh(8)
    r2 = 0.002

    loss_s, grads_s = diff.make_sharded_loss_and_grad(
        scene, cam, cfg, mesh, {("emission_scale", -1): jnp.float32(1.0)})(
        iteration=0, key=KEY, radius_sq=r2)
    g_sharded = float(grads_s[("emission_scale", -1)])

    def loss_unsharded(scale):
        s = diff.scale_emission(scene, scale)
        img, _ = ppm.render_iteration(s, cam, cfg, jnp.int32(0), KEY,
                                      jnp.float32(r2))
        return jnp.mean(img)

    g_ref = float(jax.grad(loss_unsharded)(jnp.float32(1.0)))
    assert np.isfinite(g_sharded)
    assert g_sharded == pytest.approx(g_ref, rel=5e-3), (g_sharded, g_ref)
    # emission is linear in scale: grad == loss at scale 1
    assert g_sharded == pytest.approx(float(loss_s), rel=5e-3)
