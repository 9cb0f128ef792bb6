"""Scene file import: Collada (.dae) and Wavefront OBJ.

Replaces the reference's Assimp import path (``scene/Scene.cpp:73-175``:
triangulate + pretransform + smooth normals) with a dependency-free parser
(xml.etree for .dae). Material mapping follows the reference's priority rules
exactly (``Scene.cpp:178-267``): emissive -> DiffuseEmitter, diffuse texture
-> Texture (+ normal map), IOR>1 -> Glass, reflective -> Mirror, else
Diffuse, fallback red. Emissive meshes become quad area lights
(``loadMeshLightSource``, Scene.cpp:287-310); Collada <library_lights> point
lights import directly (Scene.cpp:270-285).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..camera import Camera
from ..lights import make_area_light, make_point_light
from .builder import SceneBuilder
from .texture import load_image
from .types import Scene

_NS = re.compile(r"\{.*\}")


def _tag(el) -> str:
    return _NS.sub("", el.tag)


def _parse_floats(text: str) -> np.ndarray:
    """Float payload parser: C scanner (native/text_scan.cpp, memory-speed)
    with an exact Python fallback (the Python form dominates a flagship
    load)."""
    from ..native import scan_floats
    out = scan_floats(text)
    if out is not None:
        return out
    return np.asarray([float(x) for x in text.replace("\n", " ").split()],
                      np.float32)


def _parse_ints(text: str) -> np.ndarray:
    from ..native import scan_ints
    out = scan_ints(text)
    if out is not None:
        return out
    return np.asarray([int(x) for x in text.replace("\n", " ").split()],
                      np.int64)


_floats = _parse_floats


BVH_AUTO_THRESHOLD = 2048  # tris above which loaders attach a BVH


def generate_smooth_normals(tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for a triangle soup [T,3,3] -> [T,3,3].

    The analog of the reference's aiProcess_GenSmoothNormals import step
    (Scene.cpp:96-108): vertices are matched by (quantized) position across
    the mesh and each one averages the area-weighted face normals of every
    incident triangle. (Assimp additionally cuts at a max smoothing angle;
    this full-smooth variant matches its near-default 175-degree setting.)
    """
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normal (x2)
    pts = tris.reshape(-1, 3)
    scale = max(float(np.abs(pts).max()), 1e-9)
    keys = np.round(pts / scale * 1e6).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    acc = np.zeros((inv.max() + 1, 3), np.float64)
    np.add.at(acc, inv, np.repeat(fn, 3, axis=0))
    n = acc[inv].reshape(-1, 3, 3)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    flat = np.repeat(fn, 3, axis=0).reshape(-1, 3, 3)
    flat /= np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-20)
    return np.where(ln > 1e-12, n / np.maximum(ln, 1e-20), flat).astype(
        np.float32)


# per-phase wall time of the most recent load_scene_file call (parse =
# XML/OBJ -> host Scene incl. device upload of the arrays; bvh = native
# SAH build + wide collapse). Read by scripts/milestone4.py to budget
# scene loading.
LAST_LOAD_PHASES: dict[str, float] = {}


def load_scene_file(path: str | Path) -> tuple[Scene, Camera]:
    import time as _time
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"scene file not found: {path}")
    t0 = _time.perf_counter()
    if path.suffix.lower() in (".dae", ".xml"):
        scene, cam = load_collada(path)
    elif path.suffix.lower() == ".obj":
        scene, cam = load_obj(path)
    else:
        raise ValueError(f"unsupported scene format: {path.suffix}")
    LAST_LOAD_PHASES.clear()
    LAST_LOAD_PHASES["parse_build"] = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    if scene.geometry.n_triangles > BVH_AUTO_THRESHOLD:
        from ..accel.bvh import build_scene_bvh
        scene, bvh = build_scene_bvh(scene)
        scene = scene.replace(bvh=bvh)
    LAST_LOAD_PHASES["bvh_build"] = _time.perf_counter() - t0
    return scene, cam


# ---------------------------------------------------------------------------
# Collada
# ---------------------------------------------------------------------------

def load_collada(path: str | Path) -> tuple[Scene, Camera]:
    import xml.etree.ElementTree as ET
    path = Path(path)
    root = ET.parse(str(path)).getroot()

    def find_all(el, name):
        return [c for c in el.iter() if _tag(c) == name]

    def child(el, name):
        for c in el:
            if _tag(c) == name:
                return c
        return None

    # up axis
    z_up = False
    for a in find_all(root, "up_axis"):
        z_up = (a.text or "").strip().upper() == "Z_UP"

    # images: id -> file path
    images = {}
    for img in find_all(root, "image"):
        init = child(img, "init_from")
        if init is not None and init.text:
            images[img.get("id")] = init.text.strip()

    # effects: id -> property dict
    effects = {}
    for eff in find_all(root, "effect"):
        props = dict(diffuse=None, diffuse_tex=None, specular=None,
                     shininess=0.0, reflective=None, ior=1.0,
                     emission=None, normal_tex=None)
        samplers = {}   # sampler sid -> surface sid
        surfaces = {}   # surface sid -> image id
        for np_ in find_all(eff, "newparam"):
            sid = np_.get("sid")
            surf = child(np_, "surface")
            if surf is not None:
                init = child(surf, "init_from")
                if init is not None:
                    surfaces[sid] = (init.text or "").strip()
            samp = child(np_, "sampler2D")
            if samp is not None:
                src = child(samp, "source")
                if src is not None:
                    samplers[sid] = (src.text or "").strip()

        def resolve_texture(tex_el):
            sid = tex_el.get("texture")
            surf = samplers.get(sid, sid)
            img_id = surfaces.get(surf, surf)
            return images.get(img_id)

        for key in ("diffuse", "specular", "reflective", "emission"):
            for el in find_all(eff, key):
                col = child(el, "color")
                tex = child(el, "texture")
                if tex is not None and key == "diffuse":
                    props["diffuse_tex"] = resolve_texture(tex)
                if col is not None and col.text:
                    props[key] = _parse_floats(col.text)[:3]
        for el in find_all(eff, "shininess"):
            f = child(el, "float")
            if f is not None and f.text:
                props["shininess"] = float(f.text)
        for el in find_all(eff, "index_of_refraction"):
            f = child(el, "float")
            if f is not None and f.text:
                props["ior"] = float(f.text)
        # bump/normal maps (extra/technique profile used by some exporters)
        for el in find_all(eff, "bump"):
            tex = child(el, "texture")
            if tex is not None:
                props["normal_tex"] = resolve_texture(tex)
        effects[eff.get("id")] = props

    # materials: id -> effect props
    materials = {}
    for mat in find_all(root, "material"):
        ie = child(mat, "instance_effect")
        if ie is not None:
            url = (ie.get("url") or "").lstrip("#")
            materials[mat.get("id")] = effects.get(url, {})

    b = SceneBuilder(path.stem)
    mat_index: dict[str, int] = {}
    tex_index: dict[str, int] = {}
    fallback_red = None
    emitter_quads: list[tuple] = []   # (mat_props, quad pts) for lights

    def get_texture(rel):
        if rel is None:
            return -1
        if rel not in tex_index:
            f = (path.parent / rel)
            if not f.exists():
                return -1
            tex_index[rel] = b.add_texture_image(load_image(f))
        return tex_index[rel]

    def get_material(mat_id: str, mesh_tris):
        """Reference priority rules (Scene.cpp:178-267)."""
        nonlocal fallback_red
        key = mat_id
        if key in mat_index:
            return mat_index[key]
        p = materials.get(mat_id)
        if p is None:
            if fallback_red is None:
                fallback_red = b.add_diffuse((1.0, 0.0, 0.0))
            return fallback_red
        emission = p.get("emission")
        if emission is not None and np.any(np.asarray(emission) > 0):
            kd = p.get("diffuse")
            kd = (1, 1, 1) if kd is None else tuple(kd)
            # emitter: quad light from the mesh (loadMeshLightSource)
            pts = mesh_tris.reshape(-1, 3)
            anchor = pts[0]
            v1 = pts[1] - pts[0]
            v2 = pts[2] - pts[0]
            area = np.linalg.norm(np.cross(v1, v2))
            power = tuple(np.asarray(emission) * max(area, 1e-6) * np.pi)
            midx = b.add_emitter(power, kd=kd, light=make_area_light(
                power, tuple(anchor), tuple(v1), tuple(v2)))
        elif p.get("diffuse_tex") is not None:
            tid = get_texture(p["diffuse_tex"])
            nid = -1
            if p.get("normal_tex") is not None:
                f = path.parent / p["normal_tex"]
                if f.exists():
                    nid = b.add_normal_map_image(load_image(f))
            if tid >= 0:
                midx = b.add_textured((1, 1, 1), tid, nid)
            else:
                midx = b.add_diffuse(tuple(p["diffuse"])
                                     if p.get("diffuse") is not None
                                     else (0.7, 0.7, 0.7))
        elif p.get("ior", 1.0) > 1.0:
            midx = b.add_glass(p["ior"])
        elif p.get("reflective") is not None and \
                np.any(np.asarray(p["reflective"]) > 0):
            midx = b.add_mirror(tuple(p["reflective"]))
        elif p.get("diffuse") is not None:
            midx = b.add_diffuse(tuple(p["diffuse"]))
        else:
            if fallback_red is None:
                fallback_red = b.add_diffuse((1.0, 0.0, 0.0))
            midx = fallback_red
        mat_index[key] = midx
        return midx

    # geometries: id -> list of (material_symbol, verts, normals, uvs, faces)
    geometries = {}
    for geo in find_all(root, "geometry"):
        mesh = child(geo, "mesh")
        if mesh is None:
            continue
        sources = {}
        for src in find_all(mesh, "source"):
            arr = child(src, "float_array")
            if arr is not None and arr.text:
                acc = find_all(src, "accessor")
                stride = int(acc[0].get("stride", 3)) if acc else 3
                sources[src.get("id")] = _parse_floats(arr.text).reshape(
                    -1, stride)
        vertices_map = {}
        for v in find_all(mesh, "vertices"):
            inp = child(v, "input")
            if inp is not None:
                vertices_map[v.get("id")] = (inp.get("source") or
                                             "").lstrip("#")
        prims = []
        for tri_el in list(mesh):
            tname = _tag(tri_el)
            if tname not in ("triangles", "polylist"):
                continue
            inputs = {}
            max_off = 0
            for inp in tri_el:
                if _tag(inp) != "input":
                    continue
                off = int(inp.get("offset", 0))
                max_off = max(max_off, off)
                sem = inp.get("semantic")
                src = (inp.get("source") or "").lstrip("#")
                if sem == "VERTEX":
                    src = vertices_map.get(src, src)
                inputs[sem] = (off, src)
            p_el = child(tri_el, "p")
            if p_el is None or not p_el.text:
                continue
            idx = _parse_ints(p_el.text).reshape(-1, max_off + 1)
            if tname == "polylist":
                vc = _parse_ints(child(tri_el, "vcount").text)
                # triangulate fans
                tri_rows = []
                cursor = 0
                for c in vc:
                    for k in range(1, c - 1):
                        tri_rows += [cursor, cursor + k, cursor + k + 1]
                    cursor += c
                idx = idx[tri_rows]
            prims.append((tri_el.get("material"), inputs, idx))
        geometries[geo.get("id")] = (sources, prims)

    # visual scene: nodes with transforms + instance_geometry
    def node_matrix(node):
        m = np.eye(4, dtype=np.float32)
        for c in node:
            t = _tag(c)
            if t == "matrix" and c.text:
                m = m @ _parse_floats(c.text).reshape(4, 4)
            elif t == "translate" and c.text:
                tr = np.eye(4, dtype=np.float32)
                tr[:3, 3] = _parse_floats(c.text)[:3]
                m = m @ tr
            elif t == "scale" and c.text:
                sc = np.diag(list(_parse_floats(c.text)[:3]) + [1.0]
                             ).astype(np.float32)
                m = m @ sc
            elif t == "rotate" and c.text:
                x, y, z, ang = _parse_floats(c.text)[:4]
                a = np.radians(ang)
                axis = np.asarray([x, y, z], np.float32)
                axis /= max(np.linalg.norm(axis), 1e-12)
                K = np.asarray([[0, -axis[2], axis[1]],
                                [axis[2], 0, -axis[0]],
                                [-axis[1], axis[0], 0]], np.float32)
                R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
                r4 = np.eye(4, dtype=np.float32)
                r4[:3, :3] = R
                m = m @ r4
        return m

    def walk(node, parent_m):
        m = parent_m @ node_matrix(node)
        for c in node:
            t = _tag(c)
            if t == "instance_geometry":
                url = (c.get("url") or "").lstrip("#")
                if url in geometries:
                    _emit_geometry(url, m, c)
            elif t == "node":
                walk(c, m)

    def _emit_geometry(geo_id, m, inst_el):
        sources, prims = geometries[geo_id]
        # material binding symbol -> material id
        binds = {}
        for im in find_all(inst_el, "instance_material"):
            binds[im.get("symbol")] = (im.get("target") or "").lstrip("#")
        R = m[:3, :3]
        for mat_sym, inputs, idx in prims:
            voff, vsrc = inputs.get("VERTEX", (0, None))
            if vsrc is None or vsrc not in sources:
                continue
            verts = sources[vsrc][:, :3]
            pos = (verts[idx[:, voff]] @ R.T) + m[:3, 3]
            if z_up:
                pos = pos[:, [0, 2, 1]] * np.asarray([1, 1, -1], np.float32)
            nrm = None
            if "NORMAL" in inputs:
                noff, nsrc = inputs["NORMAL"]
                if nsrc in sources:
                    nrm = sources[nsrc][:, :3][idx[:, noff]] @ R.T
                    if z_up:
                        nrm = nrm[:, [0, 2, 1]] * np.asarray(
                            [1, 1, -1], np.float32)
            uv = None
            if "TEXCOORD" in inputs:
                toff, tsrc = inputs["TEXCOORD"]
                if tsrc in sources:
                    uv = sources[tsrc][:, :2][idx[:, toff]]

            mat_id = binds.get(mat_sym, mat_sym)
            tris = pos.reshape(-1, 3, 3)
            midx = get_material(mat_id, tris)
            if nrm is None:
                # smooth-normal generation when the file authors none
                # (reference: aiProcess_GenSmoothNormals, Scene.cpp:96-108)
                nrm = generate_smooth_normals(tris).reshape(-1, 3)
            b.add_triangle_soup(tris, midx, normals=nrm.reshape(-1, 3, 3),
                                uvs=(uv.reshape(-1, 3, 2)
                                     if uv is not None else None))

    for vs in find_all(root, "visual_scene"):
        for node in vs:
            if _tag(node) == "node":
                walk(node, np.eye(4, dtype=np.float32))

    # library point lights (Scene.cpp:270-285)
    for light in find_all(root, "light"):
        for pt in find_all(light, "point"):
            col = child(pt, "color")
            color = _parse_floats(col.text)[:3] if col is not None else \
                np.ones(3, np.float32)
            b.add_light(make_point_light(tuple(color), (0.0, 0.0, 0.0)))

    if not b._lights:
        # headlight fallback so imported scenes without lights still render
        b.add_light(make_point_light((100.0,) * 3, tuple(
            b._aabb_max + 0.1 * (b._aabb_max - b._aabb_min))))

    scene = b.build(aabb_padding=0.01 * float(
        np.linalg.norm(b._aabb_max - b._aabb_min)))
    camera = default_camera_for(scene)
    return scene, camera


def default_camera_for(scene: Scene) -> Camera:
    """Frame the scene AABB like a viewer default."""
    import numpy as np
    mn = np.asarray(scene.aabb_min)
    mx = np.asarray(scene.aabb_max)
    center = 0.5 * (mn + mx)
    diag = float(np.linalg.norm(mx - mn))
    eye = center + np.asarray([0.0, 0.25 * diag, -1.2 * diag])
    return Camera.make(tuple(eye), tuple(center), hfov=60, vfov=60)


# ---------------------------------------------------------------------------
# Wavefront OBJ (+ MTL)
# ---------------------------------------------------------------------------

def load_obj(path: str | Path) -> tuple[Scene, Camera]:
    path = Path(path)
    b = SceneBuilder(path.stem)
    verts: list = []
    norms: list = []
    uvs: list = []
    mtl_props: dict[str, dict] = {}
    mat_cache: dict[str, int] = {}
    tex_cache: dict[str, int] = {}
    current = None

    def parse_mtl(mtl_path: Path):
        cur = None
        if not mtl_path.exists():
            return
        for line in mtl_path.read_text().splitlines():
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                cur = t[1]
                mtl_props[cur] = {}
            elif cur is not None:
                if t[0] in ("Kd", "Ks", "Ke"):
                    mtl_props[cur][t[0]] = tuple(float(x) for x in t[1:4])
                elif t[0] in ("Ns", "Ni", "d"):
                    mtl_props[cur][t[0]] = float(t[1])
                elif t[0] in ("map_Kd", "map_bump", "bump"):
                    mtl_props[cur][t[0]] = t[-1]

    def get_material(name, tri_pts=None):
        """Same priority rules as the Collada/Assimp path."""
        if name in mat_cache:
            return mat_cache[name]
        p = mtl_props.get(name, {})
        ke = np.asarray(p.get("Ke", (0, 0, 0)))
        if ke.max() > 0 and tri_pts is not None:
            anchor, v1, v2 = (tri_pts[0], tri_pts[1] - tri_pts[0],
                              tri_pts[2] - tri_pts[0])
            area = np.linalg.norm(np.cross(v1, v2))
            power = tuple(ke * max(area, 1e-6) * np.pi)
            m = b.add_emitter(power, kd=p.get("Kd", (1, 1, 1)),
                              light=make_area_light(power, tuple(anchor),
                                                    tuple(v1), tuple(v2)))
        elif "map_Kd" in p:
            rel = p["map_Kd"]
            if rel not in tex_cache:
                f = path.parent / rel
                tex_cache[rel] = (b.add_texture_image(load_image(f))
                                  if f.exists() else -1)
            tid = tex_cache[rel]
            m = (b.add_textured(p.get("Kd", (1, 1, 1)), tid) if tid >= 0
                 else b.add_diffuse(p.get("Kd", (0.7,) * 3)))
        elif p.get("Ni", 1.0) > 1.0 and p.get("d", 1.0) < 1.0:
            m = b.add_glass(p["Ni"])
        elif "Ks" in p and max(p["Ks"]) > 0 and p.get("Ns", 0) > 0:
            m = b.add_glossy(p.get("Kd", (0.5,) * 3), p["Ks"],
                             min(p.get("Ns", 30.0), 1000.0))
        elif "Kd" in p:
            m = b.add_diffuse(p["Kd"])
        else:
            m = b.add_diffuse((1.0, 0.0, 0.0))
        mat_cache[name] = m
        return m

    default_mat = None
    for line in path.read_text().splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            verts.append([float(x) for x in t[1:4]])
        elif t[0] == "vn":
            norms.append([float(x) for x in t[1:4]])
        elif t[0] == "vt":
            uvs.append([float(x) for x in t[1:3]])
        elif t[0] == "mtllib":
            parse_mtl(path.parent / t[1])
        elif t[0] == "usemtl":
            current = t[1]
        elif t[0] == "f":
            corners = []
            for w in t[1:]:
                parts = (w.split("/") + ["", ""])[:3]
                vi = int(parts[0]) - 1 if parts[0] else 0
                ti = int(parts[1]) - 1 if parts[1] else -1
                ni = int(parts[2]) - 1 if parts[2] else -1
                corners.append((vi, ti, ni))
            for k in range(1, len(corners) - 1):
                tri = [corners[0], corners[k], corners[k + 1]]
                pts = np.asarray([verts[c[0]] for c in tri], np.float32)
                if current is not None:
                    m = get_material(current, pts)
                else:
                    if default_mat is None:
                        default_mat = b.add_diffuse((0.7, 0.7, 0.7))
                    m = default_mat
                kw = {}
                if all(c[2] >= 0 for c in tri) and norms:
                    kw = dict(n0=norms[tri[0][2]], n1=norms[tri[1][2]],
                              n2=norms[tri[2][2]])
                if all(c[1] >= 0 for c in tri) and uvs:
                    kw.update(uv0=uvs[tri[0][1]], uv1=uvs[tri[1][1]],
                              uv2=uvs[tri[2][1]])
                b.add_triangle(pts[0], pts[1], pts[2], m, **kw)

    if not b._lights:
        mx = b._aabb_max
        mn = b._aabb_min
        b.add_light(make_point_light((100.0,) * 3,
                                     tuple(mx + 0.1 * (mx - mn))))
    scene = b.build(aabb_padding=0.01 * float(
        np.linalg.norm(b._aabb_max - b._aabb_min)))
    return scene, default_camera_for(scene)
