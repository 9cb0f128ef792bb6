import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.bsdf import BSDF, fresnel_dielectric
from oppositerenderer.core import math as m

N = 4096


def make_bsdf(n, wo_world, kd=(0, 0, 0), ks=(0, 0, 0), exp=30.0,
              kr=(0, 0, 0), kt=(0, 0, 0), ior=1.5, kr_dielectric=False,
              batch=None):
    b = batch or wo_world.shape[:-1]
    tile = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), b + (3,))
    scal = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), b)
    nrm = jnp.broadcast_to(jnp.asarray(n, jnp.float32), b + (3,))
    return BSDF.make(nrm, nrm, wo_world, tile(kd), tile(ks), scal(exp),
                     tile(kr), tile(kt), scal(ior),
                     jnp.broadcast_to(jnp.asarray(kr_dielectric), b))


def rand_wo(seed, nbatch=N):
    d = jax.random.normal(jax.random.PRNGKey(seed), (nbatch, 3))
    d = d.at[:, 2].set(jnp.abs(d[:, 2]) + 0.05)
    return m.normalize(d)


def u3(seed, nbatch=N):
    return jax.random.uniform(jax.random.PRNGKey(seed), (nbatch, 3))


def test_lambertian_f_value():
    wo = rand_wo(0, 16)
    b = make_bsdf((0, 0, 1), wo, kd=(0.5, 0.25, 0.75))
    wi = rand_wo(1, 16)
    f, cos, dpdf, rpdf = b.f(wi)
    np.testing.assert_allclose(
        np.asarray(f), np.tile([[0.5, 0.25, 0.75]], (16, 1)) / np.pi,
        rtol=1e-5)
    np.testing.assert_allclose(np.asarray(dpdf),
                               np.asarray(wi[:, 2]) / np.pi, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rpdf),
                               np.asarray(wo[:, 2]) / np.pi, rtol=1e-5)


def test_sample_pdf_consistency_diffuse_phong():
    """pdf reported by sample() must equal pdf() evaluated at that dir."""
    wo = rand_wo(2)
    b = make_bsdf((0, 0, 1), wo, kd=(0.4, 0.4, 0.4), ks=(0.4, 0.4, 0.4),
                  exp=25.0)
    res = b.sample(u3(3))
    pdf_eval = b.pdf(res.world_dir)
    mask = np.asarray(res.valid)
    np.testing.assert_allclose(np.asarray(res.pdf_w)[mask],
                               np.asarray(pdf_eval)[mask], rtol=2e-4,
                               atol=1e-6)
    # f from sample matches f()
    f_eval, _, _, _ = b.f(res.world_dir)
    np.testing.assert_allclose(np.asarray(res.f)[mask],
                               np.asarray(f_eval)[mask], rtol=2e-4, atol=1e-6)


def test_energy_conservation_white_furnace():
    """E[f*cos/pdf] <= albedo for each channel (glossy+diffuse mix)."""
    wo = jnp.broadcast_to(jnp.asarray([0.0, 0.4, 0.9165151]), (N, 3))
    b = make_bsdf((0, 0, 1), wo, kd=(0.3, 0.3, 0.3), ks=(0.5, 0.5, 0.5),
                  exp=40.0)
    res = b.sample(u3(4))
    w = jnp.where(res.valid[:, None],
                  res.f * res.cos_theta[:, None]
                  / jnp.maximum(res.pdf_w, 1e-12)[:, None], 0.0)
    mean = np.asarray(jnp.mean(w, axis=0))
    assert np.all(mean < 0.82), mean  # <= kd+ks = 0.8 + MC noise
    assert np.all(mean > 0.6), mean   # and not absurdly lossy


def test_lambertian_reciprocity():
    wo = rand_wo(5, 64)
    wi = rand_wo(6, 64)
    b1 = make_bsdf((0, 0, 1), wo, kd=(0.6, 0.5, 0.4))
    b2 = make_bsdf((0, 0, 1), wi, kd=(0.6, 0.5, 0.4))
    f1, _, d1, r1 = b1.f(wi)
    f2, _, d2, r2 = b2.f(wo)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), rtol=1e-5)
    # reverse pdf of one direction == direct pdf of the swapped evaluation
    np.testing.assert_allclose(np.asarray(r1), np.asarray(d2), rtol=1e-5)


def test_specular_reflection_mirror():
    wo = rand_wo(7, 128)
    b = make_bsdf((0, 0, 1), wo, kr=(0.9, 0.9, 0.9), kr_dielectric=False)
    res = b.sample(u3(8, 128))
    assert bool(jnp.all(res.is_specular))
    assert bool(jnp.all(res.valid))
    # direction is the mirror reflection
    expect = jnp.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], axis=-1)
    np.testing.assert_allclose(np.asarray(res.world_dir), np.asarray(expect),
                               atol=1e-5)
    # throughput weight f*cos/pdf == kr (NoOp fresnel)
    w = res.f * res.cos_theta[:, None] / res.pdf_w[:, None]
    np.testing.assert_allclose(np.asarray(w), 0.9, rtol=1e-4)
    # f() of a specular-only bsdf is 0 (dirac)
    f, _, dpdf, _ = b.f(res.world_dir)
    np.testing.assert_allclose(np.asarray(f), 0.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dpdf), 0.0, atol=1e-7)


def test_glass_fresnel_split_and_snell():
    # normal incidence: R = ((1.5-1)/(1.5+1))^2 = 0.04
    r0 = float(fresnel_dielectric(jnp.asarray(1.0), jnp.asarray(1.0),
                                  jnp.asarray(1.5)))
    assert r0 == pytest.approx(0.04, abs=1e-6)
    # grazing: R -> 1
    rg = float(fresnel_dielectric(jnp.asarray(0.01), jnp.asarray(1.0),
                                  jnp.asarray(1.5)))
    assert rg > 0.9

    wo = jnp.broadcast_to(m.normalize(jnp.asarray([[0.3, 0.0, 0.9]])), (N, 3))
    b = make_bsdf((0, 0, 1), wo, kr=(1, 1, 1), kt=(1, 1, 1), ior=1.5,
                  kr_dielectric=True)
    res = b.sample(u3(9))
    frac_trans = float(jnp.mean((res.world_dir[:, 2] < 0).astype(jnp.float32)))
    cos_i = float(wo[0, 2])
    r = float(fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(1.0),
                                 jnp.asarray(1.5)))
    # pick prob by albedo: T/(R+T)
    assert frac_trans == pytest.approx(1.0 - r, abs=0.02)
    # transmitted dirs obey Snell
    trans = res.world_dir[res.world_dir[:, 2] < 0]
    sin_i = np.sqrt(1 - cos_i**2)
    sin_t = np.linalg.norm(np.asarray(trans[:, :2]), axis=1)
    np.testing.assert_allclose(sin_t, sin_i / 1.5, atol=1e-5)


def test_glass_radiance_eta_scaling_adjoint_flag():
    wo = jnp.broadcast_to(m.normalize(jnp.asarray([[0.0, 0.0, 1.0]])), (8, 3))
    b = make_bsdf((0, 0, 1), wo, kt=(1, 1, 1), ior=1.5, kr=(0, 0, 0),
                  kr_dielectric=True)
    res_cam = b.sample(u3(10, 8), adjoint=False)
    res_lig = b.sample(u3(10, 8), adjoint=True)
    # entering glass from camera side: f scaled by (1/1.5)^2 vs adjoint
    ratio = np.asarray(res_cam.f[:, 0] / res_lig.f[:, 0])
    np.testing.assert_allclose(ratio, (1 / 1.5) ** 2, rtol=1e-5)


def test_below_horizon_rejected():
    # incident direction below the shading horizon -> invalid bsdf samples
    wo = jnp.broadcast_to(m.normalize(jnp.asarray([[0.0, 0.3, -0.95]])),
                          (64, 3))
    b = make_bsdf((0, 0, 1), wo, kd=(0.5, 0.5, 0.5))
    assert not bool(jnp.any(b.is_valid()))
    res = b.sample(u3(11, 64))
    assert not bool(jnp.any(res.valid))
    assert float(jnp.max(jnp.abs(res.f))) == 0.0


def test_grad_flows_through_bsdf():
    wo = rand_wo(12, 16)
    wi = rand_wo(13, 16)

    def loss(kd_scalar):
        b = make_bsdf((0, 0, 1), wo, kd=(0, 0, 0))
        b = b.replace(kd=jnp.full((16, 3), kd_scalar))
        f, _, _, _ = b.f(wi)
        return jnp.sum(f)

    g = jax.grad(loss)(0.5)
    np.testing.assert_allclose(float(g), 16 * 3 / np.pi, rtol=1e-5)
