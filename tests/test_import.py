"""Scene file import (Collada + OBJ) and textures."""
import numpy as np
import pytest

from oppositerenderer.scene import get_scene_by_name
from oppositerenderer.scene.collada import load_obj, load_collada
from oppositerenderer.scene.types import (DIFFUSE, EMITTER, GLASS,
                                              GLOSSY, TEXTURED)

DAE = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Y_UP</up_axis></asset>
  <library_effects>
    <effect id="fx-white"><profile_COMMON><technique sid="common">
      <lambert><diffuse><color>0.8 0.7 0.6 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
    <effect id="fx-glass"><profile_COMMON><technique sid="common">
      <phong><diffuse><color>1 1 1 1</color></diffuse>
      <index_of_refraction><float>1.5</float></index_of_refraction></phong>
    </technique></profile_COMMON></effect>
    <effect id="fx-glow"><profile_COMMON><technique sid="common">
      <lambert><emission><color>2 2 2 1</color></emission>
      <diffuse><color>1 1 1 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="white"><instance_effect url="#fx-white"/></material>
    <material id="glassy"><instance_effect url="#fx-glass"/></material>
    <material id="glow"><instance_effect url="#fx-glow"/></material>
  </library_materials>
  <library_geometries>
    <geometry id="quad"><mesh>
      <source id="qp"><float_array id="qpa" count="12">
        0 0 0  1 0 0  1 1 0  0 1 0</float_array>
        <technique_common><accessor source="#qpa" count="4" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="qv"><input semantic="POSITION" source="#qp"/></vertices>
      <triangles material="m0" count="2">
        <input semantic="VERTEX" source="#qv" offset="0"/>
        <p>0 1 2 0 2 3</p>
      </triangles>
    </mesh></geometry>
    <geometry id="tri"><mesh>
      <source id="tp"><float_array id="tpa" count="9">
        2 0 0  3 0 0  2 1 0</float_array>
        <technique_common><accessor source="#tpa" count="3" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="tv"><input semantic="POSITION" source="#tp"/></vertices>
      <triangles material="m1" count="1">
        <input semantic="VERTEX" source="#tv" offset="0"/>
        <p>0 1 2</p>
      </triangles>
    </mesh></geometry>
    <geometry id="lamp"><mesh>
      <source id="lp"><float_array id="lpa" count="12">
        0 2 0  1 2 0  1 2 1  0 2 1</float_array>
        <technique_common><accessor source="#lpa" count="4" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="lv"><input semantic="POSITION" source="#lp"/></vertices>
      <triangles material="m2" count="2">
        <input semantic="VERTEX" source="#lv" offset="0"/>
        <p>0 1 2 0 2 3</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes><visual_scene id="vs">
    <node id="n1"><instance_geometry url="#quad">
      <bind_material><technique_common>
        <instance_material symbol="m0" target="#white"/>
      </technique_common></bind_material></instance_geometry></node>
    <node id="n2"><translate>0 0 1</translate>
      <instance_geometry url="#tri"><bind_material><technique_common>
        <instance_material symbol="m1" target="#glassy"/>
      </technique_common></bind_material></instance_geometry></node>
    <node id="n3"><instance_geometry url="#lamp">
      <bind_material><technique_common>
        <instance_material symbol="m2" target="#glow"/>
      </technique_common></bind_material></instance_geometry></node>
  </visual_scene></library_visual_scenes>
  <scene><instance_visual_scene url="#vs"/></scene>
</COLLADA>
"""

OBJ = """mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 2 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 -1
usemtl matte
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/1/1
usemtl shiny
f 1 2 5
usemtl lamp
f 2 3 5
"""

MTL = """newmtl matte
Kd 0.6 0.5 0.4
newmtl shiny
Kd 0.3 0.3 0.3
Ks 0.5 0.5 0.5
Ns 64
newmtl lamp
Ke 3 3 3
Kd 1 1 1
"""


@pytest.fixture
def dae_file(tmp_path):
    f = tmp_path / "test.dae"
    f.write_text(DAE)
    return f


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    f = tmp_path / "test.obj"
    f.write_text(OBJ)
    return f


def test_collada_import(dae_file):
    scene, cam = load_collada(dae_file)
    g = scene.geometry
    assert g.n_triangles == 5  # 2 quad + 1 tri + 2 lamp
    kinds = set(int(k) for k in np.asarray(scene.materials.kind))
    assert DIFFUSE in kinds and GLASS in kinds and EMITTER in kinds
    # diffuse color carried through
    kd = np.asarray(scene.materials.kd)
    assert any(np.allclose(row, [0.8, 0.7, 0.6]) for row in kd)
    # emitter mesh became an area light
    assert scene.lights.n_lights == 1
    assert not bool(scene.lights.is_delta[0])
    # translate applied to the glass triangle (z=1)
    v = np.asarray(g.tri_v0)
    assert np.isclose(v[:, 2].max(), 1.0)


def test_collada_renders(dae_file):
    import jax.numpy as jnp
    from oppositerenderer.config import RenderConfig
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import pt
    scene, _ = load_collada(dae_file)
    # front side of the quads (+z), where the one-sided faces point
    from oppositerenderer.camera import Camera
    cam = Camera.make((0.5, 1.2, 4.0), (0.5, 0.8, 0.0), hfov=50, vfov=50)
    cfg = RenderConfig(width=16, height=16)
    img = pt.render_iteration(scene, cam, cfg, jnp.int32(0),
                              make_root_key(0))
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.max() > 0


def test_obj_import(obj_file):
    scene, cam = load_obj(obj_file)
    g = scene.geometry
    assert g.n_triangles == 4
    kinds = [int(k) for k in np.asarray(scene.materials.kind)]
    assert DIFFUSE in kinds and GLOSSY in kinds and EMITTER in kinds
    # uv carried
    uv = np.asarray(g.tri_uv1)
    assert np.isclose(uv.max(), 1.0)
    assert scene.lights.n_lights == 1


def test_textured_material_renders(tmp_path):
    """A checkerboard texture modulates kd through the PT path."""
    import jax.numpy as jnp
    from oppositerenderer.config import RenderConfig
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import pt
    from oppositerenderer.scene import SceneBuilder
    from oppositerenderer.lights import make_point_light

    checker = np.indices((8, 8)).sum(axis=0) % 2
    img = np.stack([checker, checker, checker], axis=-1).astype(np.float32)

    b = SceneBuilder()
    tid = b.add_texture_image(img)
    m = b.add_textured((1, 1, 1), tid)
    b.add_parallelogram((-2, 0, -2), (0, 0, 4), (4, 0, 0), m)
    b.add_light(make_point_light((50.0,) * 3, (0, 3, 0)))
    scene = b.build()
    assert scene.has_textures

    from oppositerenderer.camera import Camera
    cam = Camera.make((0, 3, -3.0), (0, 0, 0), hfov=40, vfov=40)
    cfg = RenderConfig(width=32, height=32, pt_max_segments_nee=2)
    out = pt.render_iteration(scene, cam, cfg, jnp.int32(0),
                              make_root_key(1))
    a = np.asarray(out)
    assert np.isfinite(a).all()
    lum = a.sum(-1)
    # checkerboard: a good fraction of pixels dark, a good fraction lit
    lit = (lum > lum.max() * 0.2).mean()
    assert 0.2 < lit < 0.9, lit


def test_factory_falls_through_to_file(tmp_path):
    f = tmp_path / "myscene.obj"
    (tmp_path / "test.mtl").write_text(MTL)
    f.write_text(OBJ)
    scene, cam = get_scene_by_name(str(f))
    assert scene.geometry.n_triangles == 4


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        get_scene_by_name("/nonexistent/scene.dae")
