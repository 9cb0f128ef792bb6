"""BVH build + traversal vs brute force."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.accel import intersect, occluded
from oppositerenderer.accel.bvh import build_scene_bvh, build_bvh_arrays
from oppositerenderer.core import math as m
from oppositerenderer.lights import make_point_light
from oppositerenderer.scene import SceneBuilder, make_cornell_small


def random_soup_scene(n_tris=3000, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.add_diffuse((0.7, 0.7, 0.7))
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    for c in centers:
        v1 = c + rng.normal(0, 0.2, 3)
        v2 = c + rng.normal(0, 0.2, 3)
        b.add_triangle(c, v1, v2, mat)
    b.add_light(make_point_light((10.0,) * 3, (0, 8, 0)))
    return b.build()


def rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32)
    d = m.normalize(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    return o, d


def test_native_builder_available():
    """The C++ builder should compile and run in this environment."""
    from oppositerenderer.native import build_bvh_native
    pmin = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0], [4, 4, 4]],
                      np.float32)
    pmax = pmin + 1.0
    out = build_bvh_native(pmin, pmax, 0.5 * (pmin + pmax), 1)
    assert out is not None, "native builder failed to compile/run"
    nmn, nmx, na, nb, order = out
    assert len(na) >= 4  # at least 4 leaves + inners
    assert sorted(order.tolist()) == [0, 1, 2, 3]
    # root bounds cover everything
    np.testing.assert_allclose(nmn[0], [0, 0, 0])
    np.testing.assert_allclose(nmx[0], [5, 5, 5])


def test_bvh_structure_invariants():
    pmin = np.random.default_rng(3).uniform(0, 10, (500, 3)).astype(
        np.float32)
    pmax = pmin + 0.5
    bvh, order = build_bvh_arrays(pmin, pmax, leaf_size=8)
    na = np.asarray(bvh.nodes_a)
    nb = np.asarray(bvh.nodes_b)
    n_nodes = na.shape[0]
    leaves = na < 0
    # all prims covered exactly once by leaves
    covered = []
    for i in np.where(leaves)[0]:
        first = ~na[i]
        covered += list(range(first, first + nb[i]))
    assert sorted(covered) == list(range(500))
    # children indices in range and acyclic-forward? (children > parent in
    # DFS order)
    for i in np.where(~leaves)[0]:
        assert 0 < na[i] < n_nodes and 0 < nb[i] < n_nodes
        assert na[i] > i and nb[i] > i


@pytest.mark.parametrize("n_tris", [300, 3000])
def test_bvh_matches_bruteforce(n_tris):
    scene = random_soup_scene(n_tris)
    scene_bvh, bvh = build_scene_bvh(scene, leaf_size=16)
    scene_bvh = scene_bvh.replace(bvh=bvh)
    o, d = rays(400)
    tmin = jnp.full((400,), 1e-4)
    tmax = jnp.full((400,), 1e30)
    a = intersect(scene, o, d, tmin, tmax)            # brute force
    b = intersect(scene_bvh, o, d, tmin, tmax)        # BVH
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), rtol=1e-5)
    assert (np.asarray(a.hit) == np.asarray(b.hit)).all()
    h = np.asarray(a.hit)
    # prim ids differ (permutation) but hit positions/normals must agree
    np.testing.assert_allclose(np.asarray(a.position)[h],
                               np.asarray(b.position)[h], atol=1e-4)
    np.testing.assert_allclose(np.abs(np.asarray(a.ng))[h],
                               np.abs(np.asarray(b.ng))[h], atol=1e-4)


def test_bvh_occlusion_matches():
    scene = random_soup_scene(1000, seed=5)
    scene_bvh, bvh = build_scene_bvh(scene, leaf_size=16)
    scene_bvh = scene_bvh.replace(bvh=bvh)
    o, d = rays(300, seed=6)
    tmin = jnp.full((300,), 1e-4)
    tmax = jnp.full((300,), 4.0)
    a = occluded(scene, o, d, tmin, tmax)
    b = occluded(scene_bvh, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bvh_cornell_render_and_grad():
    """Rendering + gradients work through the BVH (custom_vjp zero-grad)."""
    from oppositerenderer import diff
    from oppositerenderer.config import RenderConfig
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import pt
    scene, cam = make_cornell_small()
    scene_b, bvh = build_scene_bvh(scene, leaf_size=4)
    scene_b = scene_b.replace(bvh=bvh)
    cfg = RenderConfig(width=24, height=24, pt_max_segments_nee=3,
                       path_rr_start_depth=9)
    key = make_root_key(2)
    ref = pt.render_iteration(scene, cam, cfg, jnp.int32(0), key)
    got = pt.render_iteration(scene_b, cam, cfg, jnp.int32(0), key)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-3,
                               atol=1e-4)

    def loss(s_val):
        s2 = diff.set_material_param(scene_b, "kd", 0,
                                     scene_b.materials.kd[0] * s_val)
        return jnp.mean(pt.render_iteration(s2, cam, cfg, jnp.int32(0), key))

    g = jax.grad(loss)(1.0)
    assert np.isfinite(float(g)) and float(g) > 0


def test_quantized_loop_bit_identical_to_f32_loop():
    """The int8 quantized inner table (Bvh.q_rows) is a pure encoding/
    scheduling change: conservative child-box quantization only ever ADDS
    node visits, and leaf tests run on the exact f32 rows, so traversal
    results must match the f32 loop EXACTLY (closest and any-hit).

    Guarantee scope: "identical" means up to equal-t TIES — two triangles
    with exactly equal f32 t resolve by visit order, which the two loops
    may differ on (this scene has no such tie at these rays, so exact
    equality is asserted); and the conservativeness of the quantized boxes
    is asserted under THIS backend's contraction semantics (a compiled
    GPU lowering may fuse org + q*scale to an FMA)."""
    from oppositerenderer.accel import bvh as B
    from oppositerenderer.scene import get_scene_by_name
    scene, _cam = get_scene_by_name("Atrium:0.1")
    bvh = scene.bvh
    assert bvh is not None and bvh.q_rows is not None
    rng = np.random.default_rng(5)
    mn, mx = np.asarray(scene.aabb_min), np.asarray(scene.aabb_max)
    n = 4096
    o = jnp.asarray(rng.uniform(mn, mx, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e30).at[::9].set(0.0)   # dead lanes too
    bvh_f = bvh.replace(q_rows=None)
    for any_hit in (False, True):
        rq = B._traverse_impl(bvh, scene.geometry, o, d, tmin, tmax,
                              any_hit)
        rf = B._traverse_impl(bvh_f, scene.geometry, o, d, tmin, tmax,
                              any_hit)
        for a, b, name in zip(rq, rf, ("t", "i", "u", "v", "found")):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"any_hit={any_hit} field={name}")
