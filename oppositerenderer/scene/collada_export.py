"""COLLADA (.dae) export of a built Scene.

The inverse of :mod:`.collada`'s importer; exists so a REAL Collada asset
can be produced from any procedural scene (e.g. the Sponza-class Atrium)
and driven through the full file-import path the reference exercises with
downloaded Sponza/Conference .dae files (``scene/Scene.cpp:73-175``) —
transforms, <triangles> prims per material, effect/material libraries,
texture images on disk, point lights. Round-trip tested in
tests/test_collada_roundtrip.py.

Material mapping mirrors the importer's priority rules in reverse:
EMITTER -> emission color, TEXTURED -> diffuse <texture> (+PNG on disk),
GLASS -> index_of_refraction>1, MIRROR -> reflective, GLOSSY -> diffuse+
specular+shininess, DIFFUSE -> diffuse color. (Like the reference's import
rules, Collada has no glossy class — GLOSSY re-imports as DIFFUSE.)
Analytic spheres are not representable in Collada meshes and are skipped.
"""
from __future__ import annotations

from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np

from .types import EMITTER, GLASS, GLOSSY, MIRROR, Scene, TEXTURED


def _fmt(a, nd=6) -> str:
    a = np.asarray(a, np.float32).reshape(-1)
    return " ".join(f"{x:.{nd}g}" for x in a)


def export_collada(scene: Scene, path: str | Path, *,
                   write_normals: bool = True) -> Path:
    """Write ``scene`` to ``path`` (.dae) + PNG textures alongside.

    ``write_normals=False`` omits the NORMAL inputs so the importer's
    smooth-normal generation path (aiProcess_GenSmoothNormals analog) is
    exercised.
    """
    path = Path(path)
    g = scene.geometry
    m = scene.materials
    v0 = np.asarray(g.tri_v0)
    v1 = v0 + np.asarray(g.tri_e1)
    v2 = v0 + np.asarray(g.tri_e2)
    n0, n1, n2 = (np.asarray(x) for x in (g.tri_n0, g.tri_n1, g.tri_n2))
    uv0, uv1, uv2 = (np.asarray(x) for x in (g.tri_uv0, g.tri_uv1,
                                             g.tri_uv2))
    tri_mat = np.asarray(g.tri_mat)
    kinds = np.asarray(m.kind)
    n_mats = kinds.shape[0]

    # --- texture images to disk ---
    images_xml, tex_files = [], {}
    if scene.textures is not None and scene.textures.shape[0] > 0:
        from ..png import encode_png
        for t in range(scene.textures.shape[0]):
            img = np.asarray(scene.textures[t])
            arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            fname = f"{path.stem}_tex{t}.png"
            (path.parent / fname).write_bytes(encode_png(arr))
            tex_files[t] = fname
            images_xml.append(
                f'<image id="img{t}"><init_from>{escape(fname)}'
                f'</init_from></image>')

    # --- effects + materials ---
    effects, materials = [], []
    for i in range(n_mats):
        k = int(kinds[i])
        kd = np.asarray(m.kd[i])
        body = ""
        if k == EMITTER:
            em = np.asarray(m.emission[i])
            body = (f'<emission><color>{_fmt(em)} 1</color></emission>'
                    f'<diffuse><color>{_fmt(kd)} 1</color></diffuse>')
        elif k == TEXTURED and int(m.texture_id[i]) in tex_files:
            t = int(m.texture_id[i])
            body = (
                f'<newparam sid="surf{t}"><surface type="2D">'
                f'<init_from>img{t}</init_from></surface></newparam>'
                f'<newparam sid="samp{t}"><sampler2D>'
                f'<source>surf{t}</source></sampler2D></newparam>')
            diff = (f'<diffuse><texture texture="samp{t}" texcoord="UV"/>'
                    f'</diffuse>')
            body += (f'<technique sid="common"><lambert>{diff}</lambert>'
                     f'</technique>')
            effects.append(f'<effect id="fx{i}"><profile_COMMON>{body}'
                           f'</profile_COMMON></effect>')
            materials.append(
                f'<material id="mat{i}" name="mat{i}">'
                f'<instance_effect url="#fx{i}"/></material>')
            continue
        elif k == GLASS:
            body = (f'<transparent><color>1 1 1 1</color></transparent>'
                    f'<index_of_refraction><float>{float(m.ior[i]):.6g}'
                    f'</float></index_of_refraction>')
        elif k == MIRROR:
            kr = np.asarray(m.kr[i])
            body = f'<reflective><color>{_fmt(kr)} 1</color></reflective>'
        elif k == GLOSSY:
            ks = np.asarray(m.ks[i])
            body = (f'<diffuse><color>{_fmt(kd)} 1</color></diffuse>'
                    f'<specular><color>{_fmt(ks)} 1</color></specular>'
                    f'<shininess><float>{float(m.exponent[i]):.6g}'
                    f'</float></shininess>')
        else:  # DIFFUSE
            body = f'<diffuse><color>{_fmt(kd)} 1</color></diffuse>'
        effects.append(
            f'<effect id="fx{i}"><profile_COMMON><technique sid="common">'
            f'<phong>{body}</phong></technique></profile_COMMON></effect>')
        materials.append(f'<material id="mat{i}" name="mat{i}">'
                         f'<instance_effect url="#fx{i}"/></material>')

    # --- one geometry; one <triangles> prim per material ---
    pos = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)     # [3T,3]
    nrm = np.stack([n0, n1, n2], axis=1).reshape(-1, 3)
    uvs = np.stack([uv0, uv1, uv2], axis=1).reshape(-1, 2)
    T = v0.shape[0]

    prims = []
    for i in range(n_mats):
        faces = np.nonzero(tri_mat == i)[0]
        if faces.size == 0:
            continue
        vidx = (faces[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
        if write_normals:
            p = np.stack([vidx, vidx, vidx], axis=1).reshape(-1)
            inputs = (
                '<input semantic="VERTEX" source="#verts" offset="0"/>'
                '<input semantic="NORMAL" source="#nrm-src" offset="1"/>'
                '<input semantic="TEXCOORD" source="#uv-src" offset="2"/>')
        else:
            p = np.stack([vidx, vidx], axis=1).reshape(-1)
            inputs = (
                '<input semantic="VERTEX" source="#verts" offset="0"/>'
                '<input semantic="TEXCOORD" source="#uv-src" offset="1"/>')
        prims.append(
            f'<triangles material="sym{i}" count="{faces.size}">{inputs}'
            f'<p>{" ".join(map(str, p))}</p></triangles>')

    geometry = f"""<geometry id="geo0"><mesh>
<source id="pos-src"><float_array id="pos-arr" count="{3 * pos.shape[0]}">{_fmt(pos)}</float_array>
<technique_common><accessor source="#pos-arr" count="{pos.shape[0]}" stride="3"/></technique_common></source>
<source id="nrm-src"><float_array id="nrm-arr" count="{3 * nrm.shape[0]}">{_fmt(nrm)}</float_array>
<technique_common><accessor source="#nrm-arr" count="{nrm.shape[0]}" stride="3"/></technique_common></source>
<source id="uv-src"><float_array id="uv-arr" count="{2 * uvs.shape[0]}">{_fmt(uvs)}</float_array>
<technique_common><accessor source="#uv-arr" count="{uvs.shape[0]}" stride="2"/></technique_common></source>
<vertices id="verts"><input semantic="POSITION" source="#pos-src"/></vertices>
{"".join(prims)}
</mesh></geometry>"""

    binds = "".join(
        f'<instance_material symbol="sym{i}" target="#mat{i}"/>'
        for i in range(n_mats))

    # --- point lights (area lights are re-derived from emissive quads) ---
    lights_xml, light_instances = [], []
    lt = scene.lights
    for li in range(lt.n_lights):
        if int(lt.kind[li]) == 1:  # POINT
            lights_xml.append(
                f'<light id="pl{li}"><technique_common><point>'
                f'<color>{_fmt(np.asarray(lt.emission[li]))}</color>'
                f'</point></technique_common></light>')

    doc = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
<asset><up_axis>Y_UP</up_axis></asset>
<library_images>{"".join(images_xml)}</library_images>
<library_effects>{"".join(effects)}</library_effects>
<library_materials>{"".join(materials)}</library_materials>
<library_lights>{"".join(lights_xml)}</library_lights>
<library_geometries>{geometry}</library_geometries>
<library_visual_scenes><visual_scene id="scene0">
<node id="root"><instance_geometry url="#geo0">
<bind_material><technique_common>{binds}</technique_common></bind_material>
</instance_geometry></node>
</visual_scene></library_visual_scenes>
<scene><instance_visual_scene url="#scene0"/></scene>
</COLLADA>
"""
    path.write_text(doc)
    return path
