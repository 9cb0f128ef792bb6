import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.camera import Camera


def make_cam(aperture=0.0):
    return Camera.make(eye=(0, 0, -5), lookat=(0, 0, 0), up=(0, 1, 0),
                       hfov=60.0, vfov=60.0, aperture=aperture)


def test_center_ray_along_lookdir():
    cam = make_cam()
    W = H = 64
    o, d = cam.generate_rays(jnp.asarray([32]), jnp.asarray([32]),
                             jnp.zeros((1, 2)), W, H)
    np.testing.assert_allclose(np.asarray(o[0]), [0, 0, -5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d[0]), [0, 0, 1], atol=1e-6)


def test_focal_distance_and_plane_extent():
    cam = make_cam()
    # |lookdir| = focal distance = 5; half extent = 5*tan(30deg)
    assert float(jnp.linalg.norm(cam.lookdir)) == pytest.approx(5.0)
    ips = np.asarray(cam.image_plane_size)
    np.testing.assert_allclose(ips, 2 * 5 * np.tan(np.radians(30)), rtol=1e-6)


def test_corner_ray():
    cam = make_cam()
    W = H = 64
    # pixel (0,0) with jitter 0 -> d = (-1,-1) corner
    o, d = cam.generate_rays(jnp.asarray([0]), jnp.asarray([0]),
                             jnp.zeros((1, 2)), W, H)
    expect = np.asarray(-cam.camera_u - cam.camera_v + cam.lookdir)
    expect = expect / np.linalg.norm(expect)
    np.testing.assert_allclose(np.asarray(d[0]), expect, atol=1e-6)


def test_world_to_raster_roundtrip():
    cam = make_cam()
    W = H = 128
    px = jnp.asarray([10, 64, 100, 127])
    py = jnp.asarray([5, 64, 30, 0])
    o, d = cam.generate_rays(px, py, jnp.full((4, 2), 0.5), W, H)
    pts = o + 7.3 * d  # arbitrary points along the rays
    rx, ry, inside, _ = cam.world_to_raster(pts, W, H)
    assert bool(jnp.all(inside))
    np.testing.assert_allclose(np.asarray(rx), np.asarray(px) + 0.5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ry), np.asarray(py) + 0.5, atol=1e-3)


def test_point_behind_camera_not_in_frustum():
    cam = make_cam()
    _, _, inside, _ = cam.world_to_raster(jnp.asarray([[0.0, 0.0, -20.0]]),
                                          64, 64)
    assert not bool(inside[0])


def test_camera_pdf_center():
    cam = make_cam()
    W = H = 64
    _, d = cam.generate_rays(jnp.asarray([32]), jnp.asarray([32]),
                             jnp.zeros((1, 2)), W, H)
    pdf_w, cos_cam = cam.pdf_quantities(d, W, H)
    assert float(cos_cam[0]) == pytest.approx(1.0)
    # center: pdfW = focal^2 / pixelArea
    ips = np.asarray(cam.image_plane_size)
    pixel_area = ips[0] / W * ips[1] / H
    assert float(pdf_w[0]) == pytest.approx(25.0 / pixel_area, rel=1e-5)


def test_dof_rays_converge_at_focal_plane():
    cam = make_cam(aperture=0.3)
    W = H = 64
    import jax
    u = jax.random.uniform(jax.random.PRNGKey(0), (256, 2))
    px = jnp.full((256,), 20)
    py = jnp.full((256,), 40)
    o, d = cam.generate_rays(px, py, jnp.full((256, 2), 0.5), W, H,
                             dof_u=u)
    # origins spread on the lens
    assert float(jnp.std(o[:, 0])) > 0.01
    # all rays pass (approximately) through the same focal-plane point
    look_n = np.asarray([0, 0, 1.0])
    t = (0.0 - np.asarray(o[:, 2])) / np.asarray(d[:, 2])  # plane z=0
    pts = np.asarray(o) + t[:, None] * np.asarray(d)
    assert np.std(pts, axis=0).max() < 1e-5


def test_interactive_ops():
    cam = make_cam()
    cam2 = cam.dolly(0.5)
    assert float(jnp.linalg.norm(cam2.lookdir)) == pytest.approx(2.5)
    cam3 = cam.translate(1.0, 0.0)
    np.testing.assert_allclose(np.asarray(cam3.lookat - cam.lookat),
                               np.asarray(cam.camera_u), atol=1e-5)
    cam4 = cam.scale_fov(0.5)
    assert cam4.hfov < cam.hfov
