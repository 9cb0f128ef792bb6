import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.core import sampling as s
from oppositerenderer.core import math as m

N = 1 << 15


def _u2(seed, n=N):
    return jax.random.uniform(jax.random.PRNGKey(seed), (n, 2))


def test_cos_hemisphere_distribution():
    nrm = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    d, pdf, cos = s.sample_unit_hemisphere_cos(nrm, _u2(0))
    assert float(jnp.min(d[:, 2])) >= 0.0
    np.testing.assert_allclose(np.asarray(cos), np.asarray(d[:, 2]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(cos) / np.pi,
                               atol=1e-5)
    # E[cos] for cosine-weighted = 2/3
    assert float(jnp.mean(cos)) == pytest.approx(2.0 / 3.0, abs=0.01)
    # pdf matches analytic form at sampled dirs
    np.testing.assert_allclose(np.asarray(s.cos_hemisphere_pdf_w(nrm, d)),
                               np.asarray(pdf), atol=1e-5)


def test_cos_hemisphere_mc_integral():
    # MC estimate of integral of cos over hemisphere = pi using these samples
    nrm = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    d, pdf, cos = s.sample_unit_hemisphere_cos(nrm, _u2(1))
    est = jnp.mean(cos / pdf)
    assert float(est) == pytest.approx(np.pi, rel=0.01)


def test_unit_sphere_uniform():
    d, pdf = s.sample_unit_sphere(_u2(2))
    np.testing.assert_allclose(np.asarray(m.length(d)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(pdf), 1.0 / (4 * np.pi))
    assert abs(float(jnp.mean(d[:, 2]))) < 0.02
    assert float(jnp.mean(d[:, 2] > 0)) == pytest.approx(0.5, abs=0.02)


def test_unit_disc():
    p = s.sample_unit_disc(_u2(3))
    r = jnp.linalg.norm(p, axis=-1)
    assert float(jnp.max(r)) <= 1.0
    # area within r<0.5 should be 25%
    assert float(jnp.mean(r < 0.5)) == pytest.approx(0.25, abs=0.02)


def test_power_cos_hemisphere():
    power = 20.0
    d, pdf = s.sample_power_cos_hemisphere(_u2(4), power)
    z = jnp.asarray([0.0, 0.0, 1.0])
    pdf2 = s.power_cos_hemisphere_pdf_w(z, d, power)
    np.testing.assert_allclose(np.asarray(pdf2), np.asarray(pdf), rtol=1e-4)
    # E[cos] = (n+1)/(n+2)
    assert float(jnp.mean(d[:, 2])) == pytest.approx(21.0 / 22.0, abs=0.005)
    # normalization: integrate the pdf over the hemisphere with uniform
    # sphere samples restricted to z>0: E[pdf * 2pi] = 1
    du, _ = s.sample_unit_sphere(_u2(6))
    du = du.at[:, 2].set(jnp.abs(du[:, 2]))  # fold to upper hemisphere
    pdf_u = s.power_cos_hemisphere_pdf_w(z, du, power)
    assert float(jnp.mean(pdf_u) * 2 * np.pi) == pytest.approx(1.0, rel=0.05)


def test_cone():
    theta = jnp.float32(0.3)
    nrm = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (N, 1))
    d, pdf = s.sample_cone(_u2(5), theta, nrm)
    cos = m.dot(d, nrm)
    assert float(jnp.min(cos)) >= np.cos(0.3) - 1e-5
    np.testing.assert_allclose(np.asarray(pdf), float(s.cone_pdf_w(theta)),
                               rtol=1e-5)
    # solid-angle MC: E[1/pdf] = cone solid angle
    assert float(jnp.mean(1.0 / pdf)) == pytest.approx(
        2 * np.pi * (1 - np.cos(0.3)), rel=1e-4)


def test_pdf_conversions():
    pdf_w = jnp.asarray(2.0)
    dist = jnp.asarray(3.0)
    cos = jnp.asarray(0.5)
    pdf_a = s.pdf_w_to_a(pdf_w, dist, cos)
    assert float(pdf_a) == pytest.approx(2.0 * 0.5 / 9.0)
    back = s.pdf_a_to_w(pdf_a, dist, cos)
    assert float(back) == pytest.approx(2.0)
