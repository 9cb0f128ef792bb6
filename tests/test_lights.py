import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer import lights as L

N = 1 << 14


def simple_table():
    return L.build_light_table([
        L.make_area_light(power=(10, 10, 10), anchor=(-1, 2, -1),
                          v1=(2, 0, 0), v2=(0, 0, 2)),
        L.make_point_light(power=(4 * np.pi, 4 * np.pi, 4 * np.pi),
                           position=(0, 3, 0)),
        L.make_spot_light(power=(1, 1, 1), position=(0, 3, 0),
                          direction=(0, -1, 0), angle_deg=30.0),
    ])


def test_area_light_derived_quantities():
    lt = simple_table()
    # area = |v1 x v2| = 4; normal = v1 x v2 normalized = (0,-1,0)
    assert float(lt.inverse_area[0]) == pytest.approx(0.25)
    np.testing.assert_allclose(np.asarray(lt.normal[0]), [0, -1, 0],
                               atol=1e-6)
    # Lemit = P / (A pi)
    np.testing.assert_allclose(np.asarray(lt.emission[0]),
                               10.0 / (4 * np.pi), rtol=1e-6)


def test_point_light_intensity():
    lt = simple_table()
    np.testing.assert_allclose(np.asarray(lt.emission[1]), 1.0, rtol=1e-6)
    assert bool(lt.is_delta[1])


def test_light_contribution_point_analytic():
    lt = simple_table()
    row = lt.row(jnp.asarray([1]))
    # receiver 3 units below the point light, normal up: E = I/d^2 = 1/9
    contrib, _, dist = L.light_contribution(
        row, jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([[0.0, 1.0, 0.0]]),
        jnp.full((1, 2), 0.5))
    assert float(dist[0]) == pytest.approx(3.0)
    np.testing.assert_allclose(np.asarray(contrib[0]), 1.0 / 9.0, rtol=1e-5)


def test_light_contribution_area_analytic():
    lt = simple_table()
    row = lt.row(jnp.asarray([0]))
    # receiver far below the 2x2 light: contribution ~ Le*A*cos^2/d^2
    pos = jnp.asarray([[0.0, -8.0, 0.0]])
    contrib, pol, dist = L.light_contribution(
        row, pos, jnp.asarray([[0.0, 1.0, 0.0]]), jnp.full((1, 2), 0.5))
    d = 10.0
    expect = 10.0 / (4 * np.pi) * 4 * 1.0 * 1.0 / d**2
    np.testing.assert_allclose(np.asarray(contrib[0]), expect, rtol=1e-4)


def test_light_emit_area_energy():
    """MC integral of emitted radiance/pdf recovers total light power."""
    lt = simple_table()
    row = lt.row(jnp.zeros((N,), jnp.int32))
    k = jax.random.PRNGKey(0)
    u_dir = jax.random.uniform(k, (N, 2))
    u_pos = jax.random.uniform(jax.random.fold_in(k, 1), (N, 2))
    rad, pos, d, epdf, dpdfa, cosl = L.light_emit(
        row, u_dir, u_pos, jnp.zeros(3), jnp.asarray(100.0))
    # positions on the light rectangle
    assert float(jnp.max(jnp.abs(pos[:, 1] - 2.0))) < 1e-5
    assert float(jnp.max(jnp.abs(pos[:, 0]))) <= 1.0 + 1e-5
    # emitted direction in lower hemisphere (normal is (0,-1,0))
    assert float(jnp.max(pos[:, 1] + 0)) == pytest.approx(2.0, abs=1e-5)
    assert float(jnp.max(d[:, 1])) <= 1e-5
    # energy: E[rad/epdf] = total power (10) -- rad = Le*cos, epdf = cos/pi/A
    est = jnp.mean(rad[:, 0] / epdf)
    assert float(est) == pytest.approx(10.0, rel=0.01)


def test_light_emit_point_energy():
    lt = simple_table()
    row = lt.row(jnp.ones((N,), jnp.int32))
    k = jax.random.PRNGKey(1)
    rad, pos, d, epdf, dpdfa, cosl = L.light_emit(
        row, jax.random.uniform(k, (N, 2)),
        jax.random.uniform(jax.random.fold_in(k, 1), (N, 2)),
        jnp.zeros(3), jnp.asarray(100.0))  # light inside sphere -> full sphere
    est = jnp.mean(rad[:, 0] / epdf)
    assert float(est) == pytest.approx(4 * np.pi, rel=0.01)


def test_light_emit_point_cone_mode():
    """Point light far outside the scene sphere emits in a cone toward it."""
    lt = L.build_light_table([
        L.make_point_light(power=(1, 1, 1), position=(0, 50, 0))])
    row = lt.row(jnp.zeros((N,), jnp.int32))
    k = jax.random.PRNGKey(2)
    rad, pos, d, epdf, _, _ = L.light_emit(
        row, jax.random.uniform(k, (N, 2)),
        jax.random.uniform(jax.random.fold_in(k, 1), (N, 2)),
        jnp.zeros(3), jnp.asarray(5.0))
    # all dirs within the cone toward origin
    cos_min = np.sqrt(1 - (5.0 / 50.0) ** 2)
    cos = np.asarray(-d[:, 1])
    assert cos.min() >= cos_min - 1e-5


def test_light_illuminate_area_pdf_conversion():
    lt = simple_table()
    row = lt.row(jnp.asarray([0]))
    rec = jnp.asarray([[0.3, -4.0, 0.1]])
    rad, dirl, dist, dpdfw, epdfw, cosl = L.light_illuminate(
        row, jnp.full((1, 2), 0.5), rec, jnp.zeros(3), jnp.asarray(10.0))
    # sampled center of light (0,2,0): dist
    expect_d = np.linalg.norm([0.3 - 0, -4 - 2, 0.1 - 0])
    assert float(dist[0]) == pytest.approx(expect_d, rel=1e-5)
    # directPdfW = invArea * d^2/cosL
    cl = float(cosl[0])
    assert float(dpdfw[0]) == pytest.approx(0.25 * expect_d**2 / cl, rel=1e-4)
    np.testing.assert_allclose(np.asarray(rad[0]), 10 / (4 * np.pi),
                               rtol=1e-5)


def test_light_illuminate_point():
    lt = simple_table()
    row = lt.row(jnp.asarray([1]))
    rec = jnp.asarray([[0.0, 0.0, 0.0]])
    rad, dirl, dist, dpdfw, epdfw, cosl = L.light_illuminate(
        row, jnp.full((1, 2), 0.5), rec, jnp.zeros(3), jnp.asarray(10.0))
    # radiance/directPdfW = I/d^2 = 1/9
    assert float(rad[0, 0] / dpdfw[0]) == pytest.approx(1 / 9.0, rel=1e-5)


def test_mixed_lanes_gather():
    lt = simple_table()
    idx = jnp.asarray([0, 1, 2, 0])
    rows = lt.row(idx)
    assert rows.kind.shape == (4,)
    np.testing.assert_array_equal(np.asarray(rows.kind), [0, 1, 2, 0])
