import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.core import math as m


def test_normalize_unit_length(rng_np):
    v = jnp.asarray(rng_np.normal(size=(128, 3)), jnp.float32)
    n = m.normalize(v)
    np.testing.assert_allclose(np.asarray(m.length(n)), 1.0, atol=1e-5)


def test_dot_cross_orthogonal(rng_np):
    a = jnp.asarray(rng_np.normal(size=(64, 3)), jnp.float32)
    b = jnp.asarray(rng_np.normal(size=(64, 3)), jnp.float32)
    c = m.cross(a, b)
    np.testing.assert_allclose(np.asarray(m.dot(a, c)), 0.0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(m.dot(b, c)), 0.0, atol=1e-3)


def test_onb_orthonormal(rng_np):
    n = m.normalize(jnp.asarray(rng_np.normal(size=(256, 3)), jnp.float32))
    u, v = m.build_onb(n)
    np.testing.assert_allclose(np.asarray(m.length(u)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.length(v)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.dot(u, v)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.dot(u, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.dot(v, n)), 0.0, atol=1e-5)
    # right-handed: u x v == n
    np.testing.assert_allclose(np.asarray(m.cross(u, v)), np.asarray(n),
                               atol=1e-5)


def test_frame_roundtrip(rng_np):
    n = m.normalize(jnp.asarray(rng_np.normal(size=(64, 3)), jnp.float32))
    f = m.Frame.from_normal(n)
    w = m.normalize(jnp.asarray(rng_np.normal(size=(64, 3)), jnp.float32))
    wl = f.to_local(w)
    w2 = f.to_world(wl)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)
    # local z == cos to normal
    np.testing.assert_allclose(np.asarray(wl[..., 2]), np.asarray(m.dot(w, n)),
                               atol=1e-5)


def test_reflect():
    d = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2.0)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = m.reflect(d, n)
    np.testing.assert_allclose(np.asarray(r), [[1 / np.sqrt(2), 1 / np.sqrt(2), 0]],
                               atol=1e-6)


def test_refract_straight_through():
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r, tir = m.refract(d, n, jnp.asarray([1.0]))
    np.testing.assert_allclose(np.asarray(r), np.asarray(d), atol=1e-6)
    assert not bool(tir[0])


def test_refract_snell():
    # 45 deg incidence air->glass (eta=1/1.5)
    theta_i = np.pi / 4
    d = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r, tir = m.refract(d, n, jnp.asarray([1.0 / 1.5], jnp.float32))
    assert not bool(tir[0])
    sin_t = np.sin(theta_i) / 1.5
    np.testing.assert_allclose(float(r[0, 0]), sin_t, atol=1e-6)
    np.testing.assert_allclose(float(r[0, 1]), -np.sqrt(1 - sin_t**2), atol=1e-6)


def test_refract_tir():
    # glass->air at steep angle: TIR
    theta_i = np.pi / 3
    d = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    _, tir = m.refract(d, n, jnp.asarray([1.5], jnp.float32))
    assert bool(tir[0])


def test_aabb():
    pts = jnp.asarray([[0, 0, 0], [1, 2, 3], [-1, 1, 0]], jnp.float32)
    box = m.AABB.from_points(pts)
    np.testing.assert_allclose(np.asarray(box.min), [-1, 0, 0])
    np.testing.assert_allclose(np.asarray(box.max), [1, 2, 3])
    c, r = box.bounding_sphere()
    np.testing.assert_allclose(np.asarray(c), [0, 1, 1.5])
    np.testing.assert_allclose(float(r), np.linalg.norm([1, 1, 1.5]), rtol=1e-6)


def test_ray_aabb():
    o = jnp.asarray([[-2.0, 0.5, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = m.ray_aabb(o, inv_d, jnp.zeros(3), jnp.ones(3),
                        jnp.asarray([0.0]), jnp.asarray([1e9]))
    assert float(t0[0]) == pytest.approx(2.0)
    assert float(t1[0]) == pytest.approx(3.0)
    # miss
    o2 = jnp.asarray([[-2.0, 5.0, 0.5]])
    t0, t1 = m.ray_aabb(o2, inv_d, jnp.zeros(3), jnp.ones(3),
                        jnp.asarray([0.0]), jnp.asarray([1e9]))
    assert float(t0[0]) > float(t1[0])
