import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer import photon_map as pm


def make_photons(n=4000, seed=0, frac_valid=0.9):
    k = jax.random.PRNGKey(seed)
    pos = jax.random.uniform(k, (n, 3), minval=0.0, maxval=2.0)
    power = jax.random.uniform(jax.random.fold_in(k, 1), (n, 3))
    d = jax.random.normal(jax.random.fold_in(k, 2), (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    # all directions downward so a +y normal accepts them
    d = d.at[:, 1].set(-jnp.abs(d[:, 1]) - 0.01)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    valid = jax.random.uniform(jax.random.fold_in(k, 3), (n,)) < frac_valid
    return pm.PhotonBatch(position=pos, power=power, direction=d, valid=valid)


def brute_force_gather(photons, q, normal, radius):
    pos = np.asarray(photons.position)
    pw = np.asarray(photons.power)
    dr = np.asarray(photons.direction)
    vd = np.asarray(photons.valid)
    out = np.zeros((q.shape[0], 3))
    r2 = radius * radius
    for i, p in enumerate(np.asarray(q)):
        diff = p - pos
        d2 = (diff * diff).sum(1)
        okm = vd & (d2 <= r2) & ((-dr * normal).sum(1) >= 0)
        w = np.asarray(pm.gaussian_kernel_weight(jnp.asarray(d2),
                                                 jnp.asarray(r2)))
        out[i] = (pw[okm] * w[okm, None]).sum(0)
    return out


def test_grid_build_offsets_consistent():
    photons = make_photons()
    grid = pm.build_photon_grid(photons, resolution=16)
    offs = np.asarray(grid.offsets)
    assert offs[0] == 0
    assert (np.diff(offs) >= 0).all()
    assert offs[-1] == int(jnp.sum(photons.valid))  # invalid sorted beyond
    # every photon in its cell's interval
    cells = pm.cell_index_1d(
        pm.cell_coords(grid.position, grid.origin, grid.cell_size, 16), 16)
    n_valid = int(grid.n_valid)
    cells = np.asarray(cells)[:n_valid]
    for i in range(0, n_valid, 97):
        c = cells[i]
        assert offs[c] <= i < offs[c + 1]


@pytest.mark.parametrize("radius", [0.08, 0.25])
def test_gather_matches_bruteforce(radius):
    photons = make_photons()
    grid = pm.build_photon_grid(photons, resolution=16)
    k = jax.random.PRNGKey(9)
    q = jax.random.uniform(k, (64, 3), minval=0.2, maxval=1.8)
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (64, 1))
    # cell size = 2/16 = 0.125; radius 0.25 needs 2r/cs + 1 = 5 cells
    got, stats = pm.gather_photons(grid, q, normal, jnp.float32(radius),
                                   max_cells_per_axis=6, budget_total=1024)
    assert int(stats["photon_subsampled"].sum()) == 0
    want = brute_force_gather(photons, q, np.asarray([0.0, 1.0, 0.0]), radius)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_gather_normal_rejection():
    photons = make_photons()
    grid = pm.build_photon_grid(photons, resolution=16)
    q = jnp.asarray([[1.0, 1.0, 1.0]])
    # normal pointing down -> all (downward) photons rejected
    got, _ = pm.gather_photons(grid, q, jnp.asarray([[0.0, -1.0, 0.0]]),
                               jnp.float32(0.3), max_cells_per_axis=6,
                               budget_total=1024)
    np.testing.assert_allclose(np.asarray(got), 0.0, atol=1e-7)


def test_gather_budget_subsample_reported():
    photons = make_photons(n=2000, frac_valid=1.0)
    # cram all photons into a tiny region -> guaranteed overflow
    photons = photons.replace(position=photons.position * 0.01 + 1.0)
    grid = pm.build_photon_grid(photons, resolution=4)
    q = jnp.asarray([[1.01, 1.01, 1.01]])
    _, stats = pm.gather_photons(grid, q, jnp.asarray([[0.0, 1.0, 0.0]]),
                                 jnp.float32(0.05), budget_total=16)
    assert int(stats["photon_subsampled"].sum()) > 0


def test_kernel_weight_bounds():
    r2 = jnp.float32(1.0)
    d2 = jnp.linspace(0.0, 1.0, 64)
    w = pm.gaussian_kernel_weight(d2, r2)
    # Jensen gaussian as implemented in the reference: w(0)=alpha and
    # w(r) ~ 0.497 (the 2r^2 in the exponent means it does NOT vanish at r)
    assert float(w[0]) == pytest.approx(1.818, rel=1e-5)
    assert float(w[-1]) == pytest.approx(0.4974, abs=1e-3)
    assert bool(jnp.all(jnp.diff(w) < 0))


def test_stochastic_hash_gather_approximates():
    photons = make_photons(n=3000, frac_valid=1.0)
    h = pm.build_stochastic_hash(photons, cell_size=jnp.float32(0.12),
                                 table_size_log2=14,
                                 key=jax.random.PRNGKey(0))
    grid = pm.build_photon_grid(photons, resolution=16)
    k = jax.random.PRNGKey(10)
    q = jax.random.uniform(k, (256, 3), minval=0.3, maxval=1.7)
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (256, 1))
    radius = jnp.float32(0.12)  # ~cell size
    exact, _ = pm.gather_photons(grid, q, normal, radius,
                                 max_cells_per_axis=6, budget_total=1024)
    approx, _ = pm.gather_stochastic_hash(h, q, normal, radius)
    # stochastic estimate is unbiased-ish: totals should be within ~30%
    se = float(exact.sum())
    sa = float(approx.sum())
    assert se > 0
    assert abs(sa - se) / se < 0.35


def test_gather_stride_subsampling_unbiased():
    """Strided subsampling with reweighting approximates the full gather
    (unbiased estimator of the box sum; photon_map.gather_photons phase 3)."""
    photons = make_photons(n=4000, frac_valid=1.0)
    grid = pm.build_photon_grid(photons, resolution=8)
    k = jax.random.PRNGKey(3)
    q = jax.random.uniform(k, (128, 3), minval=0.4, maxval=1.6)
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (128, 1))
    radius = jnp.float32(0.4)
    full, _ = pm.gather_photons(grid, q, normal, radius,
                                max_cells_per_axis=6, budget_total=4096)
    # average several jittered subsampled estimates
    est = 0.0
    n_rep = 8
    for i in range(n_rep):
        u = jax.random.uniform(jax.random.PRNGKey(100 + i), (128,))
        sub, stats = pm.gather_photons(grid, q, normal, radius,
                                       max_cells_per_axis=6,
                                       budget_total=64, u_stride=u)
        est = est + sub / n_rep
    assert int(stats["photon_subsampled"].sum()) > 0
    tot_full = float(full.sum())
    tot_est = float(jnp.asarray(est).sum())
    assert abs(tot_est - tot_full) / tot_full < 0.15


def test_kdtree_gather_matches_bruteforce():
    """KD_TREE_CPU variant (OptixRenderer_CPUKdTree.cpp analog): host-built
    tree + fixed-stack device traversal equals the brute-force gather."""
    photons = make_photons(n=600, frac_valid=0.8)
    tree = pm.build_photon_kdtree(photons)
    k = jax.random.PRNGKey(21)
    q = jax.random.uniform(k, (64, 3), minval=0.2, maxval=1.8)
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (64, 1))
    radius = 0.25
    got, stats = pm.gather_kdtree(tree, q, normal, jnp.float32(radius),
                                  max_visits=4096)
    assert int(stats["kd_overrun"]) == 0
    want = brute_force_gather(photons, q, np.asarray([0.0, 1.0, 0.0]),
                              radius)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_kdtree_in_ppm_iteration():
    """Full PPM iteration with the kd-tree structure stays finite and
    close to the grid-structure result."""
    from oppositerenderer.config import (PhotonMapStructure,
                                             RenderConfig, RenderMethod)
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import ppm as ppm_mod
    from oppositerenderer.scene import make_cornell_small
    scene, camera = make_cornell_small()
    base = RenderConfig(width=24, height=24,
                        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                        photons_per_iteration=2048,
                        max_photon_trace_depth=4,
                        photon_grid_resolution=16)
    key = make_root_key(0)
    r2 = jnp.float32(0.01)
    rad_grid, _ = ppm_mod.render_iteration(
        scene, camera, base, jnp.int32(0), key, r2)
    cfg_kd = base.replace(
        photon_map_structure=PhotonMapStructure.KD_TREE_CPU)
    rad_kd, _ = ppm_mod.render_iteration(
        scene, camera, cfg_kd, jnp.int32(0), key, r2)
    assert bool(jnp.isfinite(rad_kd).all())
    # same photons, same estimator -> images match closely (the grid's
    # budget subsampling is the only source of difference)
    diff = float(jnp.abs(rad_kd - rad_grid).mean())
    scale = float(jnp.abs(rad_grid).mean()) + 1e-6
    assert diff / scale < 0.05


def test_large_radius_window_conserves_energy():
    """Radius spanning many more cells than the static 4^3 gather window:
    with min_cell_size_for_window the grid coarsens so the window still
    covers the whole sphere (VERDICT r1: 3x volumetric radius silently
    truncated with the default 100^3 grid)."""
    photons = make_photons(n=200, frac_valid=1.0)
    radius = 0.9  # box extent 2.0, so at res=100 2r spans ~90 cells
    grid = pm.build_photon_grid(
        photons, 100,
        min_cell_size=pm.min_cell_size_for_window(jnp.float32(radius), 4))
    q = jnp.asarray([[1.0, 1.0, 1.0], [0.3, 1.7, 0.9]])
    nrm = jnp.asarray([0.0, 1.0, 0.0])
    got, _ = pm.gather_photons(grid, q, jnp.broadcast_to(nrm, (2, 3)),
                               jnp.float32(radius),
                               max_cells_per_axis=4, budget_total=256)
    want = brute_force_gather(photons, q, nrm, radius)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_large_radius_truncates_without_floor():
    """Sanity: the same query WITHOUT the cell-size floor loses energy —
    documents why min_cell_size_for_window exists."""
    photons = make_photons(n=200, frac_valid=1.0)
    radius = 0.9
    grid = pm.build_photon_grid(photons, 100)
    q = jnp.asarray([[1.0, 1.0, 1.0]])
    nrm = jnp.asarray([0.0, 1.0, 0.0])
    got, _ = pm.gather_photons(grid, q, jnp.broadcast_to(nrm, (1, 3)),
                               jnp.float32(radius),
                               max_cells_per_axis=4, budget_total=256)
    want = brute_force_gather(photons, q, nrm, radius)
    assert np.asarray(got).sum() < 0.5 * want.sum()
