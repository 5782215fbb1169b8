"""Collada (.dae) scene ingestion — the Yulio FPR pipeline entry point.

The torch package's counterpart of `yulio_raytracer_tpu/io/collada.py`,
element for element, on the port's own materials, textures, meshes,
images and cameras.  It follows `devices/device/loaders/
ColladaLoader.cpp` (which wraps Assimp 3.2):

* material translation (:205-401): diffuse texture/color -> Uber
  (roughness = 1 - shininess_strength; reflectivity inverted, the Rhino
  quirk :257-259); transparency/transparent -> ThinDielectric (eta 1.4,
  thickness 1); the double-sided flag decides back-face culling
  (:333-335);
* camera extraction (:406-498): cameras named `YULIO_FPR_VIEW_*` (all
  cameras when none are tagged), 12 StereoCube cameras per viewpoint,
  `sceneScale` from the camera world matrix's scale (:440-447);
* mesh flattening (:512-641): node-hierarchy world transforms baked into
  vertices, per-mesh cull mode (default/forcesingle/forcedouble
  :601-615), `YULIO_CAMERA_ALIGNED_*` meshes flagged as camera-facing
  billboards (:629-632).

The COLLADA XML itself is parsed here (sources and accessors,
triangles/polylist with input offsets, the up-axis conversion, smooth
normals where none are authored), standing in for Assimp's
post-processing.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from ..geometry import mesh as gmesh
from ..shading import materials as gmat
from ..shading import textures as gtex
from . import image as gimage

FPR_VIEW_CAMERA_PREFIX = "YULIO_FPR_VIEW_"
CAMERA_ALIGNED_NODE_PREFIX = "YULIO_CAMERA_ALIGNED_"

_NS = "{http://www.collada.org/2005/11/COLLADASchema}"


def _tag(el):
    return el.tag.split('}')[-1]


def _find(el, name):
    r = el.find(_NS + name)
    if r is None:
        r = el.find(name)
    return r


def _findall(el, name):
    r = el.findall(_NS + name)
    return r if r else el.findall(name)


def _numbers(text, dtype=np.float64):
    """The whitespace-separated numbers of an element's text."""
    return np.array((text or '').split(), dtype)


def _floats(text):
    return _numbers(text)


@dataclass
class DaeCamera:
    name: str
    position: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    scene_scale: float


@dataclass
class DaeResult:
    cameras: list = field(default_factory=list)   # list[DaeCamera]
    scene_scale: float = 1.0
    mesh_ids: list = field(default_factory=list)


def _up_axis_transform(root) -> np.ndarray:
    """Root conversion to Y-up (Assimp bakes this into the root node)."""
    up = 'Y_UP'
    asset = _find(root, 'asset')
    if asset is not None:
        ua = _find(asset, 'up_axis')
        if ua is not None and ua.text:
            up = ua.text.strip()
    if up == 'Z_UP':
        return np.asarray([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                           [0, 0, 0, 1]], np.float64)
    if up == 'X_UP':
        return np.asarray([[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]], np.float64)
    return np.eye(4)


def _node_transform(node) -> np.ndarray:
    """Compose a node's matrix/translate/rotate/scale children (column-
    vector 4x4 convention, applied in document order)."""
    m = np.eye(4)
    for c in node:
        t = _tag(c)
        if t == 'matrix':
            m = m @ _floats(c.text).reshape(4, 4)
        elif t == 'translate':
            v = _floats(c.text)
            t4 = np.eye(4)
            t4[:3, 3] = v[:3]
            m = m @ t4
        elif t == 'rotate':
            v = _floats(c.text)
            axis = v[:3]
            ang = np.deg2rad(v[3])
            n = np.linalg.norm(axis)
            if n > 0:
                axis = axis / n
                x, y, z = axis
                cth, sth = np.cos(ang), np.sin(ang)
                r = np.eye(4)
                r[:3, :3] = np.asarray([
                    [cth + x * x * (1 - cth), x * y * (1 - cth) - z * sth,
                     x * z * (1 - cth) + y * sth],
                    [y * x * (1 - cth) + z * sth, cth + y * y * (1 - cth),
                     y * z * (1 - cth) - x * sth],
                    [z * x * (1 - cth) - y * sth, z * y * (1 - cth) + x * sth,
                     cth + z * z * (1 - cth)]])
                m = m @ r
        elif t == 'scale':
            v = _floats(c.text)
            s4 = np.diag([v[0], v[1], v[2], 1.0])
            m = m @ s4
    return m


class _Library:
    """Indexes the library_* sections by id."""

    def __init__(self, root, base_path):
        self.base = base_path
        self.images = {}
        for lib in _findall(root, 'library_images'):
            for img in _findall(lib, 'image'):
                init = _find(img, 'init_from')
                if init is not None and init.text:
                    self.images[img.get('id')] = init.text.strip()
        self.effects = {e.get('id'): e
                        for lib in _findall(root, 'library_effects')
                        for e in _findall(lib, 'effect')}
        self.materials = {}
        for lib in _findall(root, 'library_materials'):
            for m in _findall(lib, 'material'):
                ie = _find(m, 'instance_effect')
                self.materials[m.get('id')] = (
                    ie.get('url').lstrip('#') if ie is not None else None)
        self.geometries = {g.get('id'): g
                           for lib in _findall(root, 'library_geometries')
                           for g in _findall(lib, 'geometry')}
        self.cameras = {c.get('id'): c
                        for lib in _findall(root, 'library_cameras')
                        for c in _findall(lib, 'camera')}

    # ---------------- effect translation (ColladaLoader.cpp:205-401) -----
    def material_info(self, material_id, sb):
        """Returns (material index in sb, cull_backfaces, render)."""
        eff_id = self.materials.get(material_id)
        eff = self.effects.get(eff_id)
        diffuse_color = (0.5, 0.5, 0.5)
        diffuse_alpha = 1.0
        tex_file = None
        shininess_strength = 0.0
        reflectivity = 0.0
        transparency = 1.0
        transparent_alpha = 1.0
        double_sided = False
        mtype = 'Matte'

        if eff is not None:
            # resolve sampler->surface->image chains
            sampler_img = {}
            surface_img = {}
            for np_el in eff.iter():
                if _tag(np_el) == 'newparam':
                    sid = np_el.get('sid')
                    surf = _find(np_el, 'surface')
                    if surf is not None:
                        init = _find(surf, 'init_from')
                        if init is not None:
                            surface_img[sid] = init.text.strip()
                    samp = _find(np_el, 'sampler2D')
                    if samp is not None:
                        src = _find(samp, 'source')
                        if src is not None:
                            sampler_img[sid] = src.text.strip()

            def resolve_texture(tex_el):
                t = tex_el.get('texture')
                s = sampler_img.get(t, t)
                img_id = surface_img.get(s, s)
                return self.images.get(img_id, img_id)

            for shader in eff.iter():
                if _tag(shader) not in ('phong', 'lambert', 'blinn',
                                        'constant'):
                    continue
                dif = _find(shader, 'diffuse')
                if dif is not None:
                    tex = _find(dif, 'texture')
                    col = _find(dif, 'color')
                    if tex is not None:
                        tex_file = resolve_texture(tex)
                        mtype = 'Uber'
                    elif col is not None:
                        v = _floats(col.text)
                        diffuse_color = tuple(v[:3])
                        diffuse_alpha = float(v[3]) if len(v) > 3 else 1.0
                        mtype = 'Uber'
                shin = _find(shader, 'shininess')
                if shin is not None:
                    f = _find(shin, 'float')
                    if f is not None:
                        # Assimp maps shininess-strength separately; common
                        # exporters put a [0,1] strength here for Yulio
                        shininess_strength = float(np.clip(
                            _floats(f.text)[0], 0.0, 1.0))
                refl = _find(shader, 'reflectivity')
                if refl is not None:
                    f = _find(refl, 'float')
                    if f is not None:
                        # Rhino quirk (:257-259): value arrives inverted
                        reflectivity = 1.0 - float(np.clip(
                            _floats(f.text)[0], 0.0, 1.0))
                trans = _find(shader, 'transparency')
                if trans is not None:
                    f = _find(trans, 'float')
                    if f is not None:
                        transparency = float(_floats(f.text)[0])
                        if transparency < 1.0:
                            mtype = 'ThinDielectric'
                transp = _find(shader, 'transparent')
                if transp is not None:
                    col = _find(transp, 'color')
                    if col is not None:
                        v = _floats(col.text)
                        transparent_alpha = float(v[3]) if len(v) > 3 else 1.0
                        if transparent_alpha < 1.0:
                            mtype = 'ThinDielectric'
                break
            for extra in eff.iter():
                if _tag(extra) == 'double_sided':
                    double_sided = (extra.text or '0').strip() in ('1',
                                                                   'true')

        cull = not double_sided

        tex_id = -1
        if tex_file:
            full = tex_file if os.path.isabs(tex_file) else os.path.join(
                self.base, tex_file)
            if os.path.exists(full):
                try:
                    tex_id = sb.textures.add(gimage.load(full),
                                             gtex.FILTER_BILINEAR,
                                             key=os.path.abspath(full))
                except OSError:
                    tex_id = -1

        if mtype == 'Uber':
            spec = gmat.make_material('uber', {
                'diffuse': diffuse_color,
                'roughness': 1.0 - shininess_strength,
                'reflectivity': reflectivity,
            }, tex_id=tex_id)
        elif mtype == 'ThinDielectric':
            spec = gmat.make_material('thindielectric', {
                'transmission': diffuse_color,
                'eta': 1.4, 'thickness': 1.0,
                'transparency': transparency,
            }, tex_id=tex_id)
        else:
            spec = gmat.make_material('matte',
                                      {'reflectance': diffuse_color})
        return sb.add_material(spec), cull, True


def _read_source_arrays(mesh_el):
    """id -> (N, stride) float array from <source> elements."""
    out = {}
    for src in _findall(mesh_el, 'source'):
        arr_el = _find(src, 'float_array')
        if arr_el is None:
            continue
        data = _floats(arr_el.text)
        stride = 3
        tc = _find(src, 'technique_common')
        if tc is not None:
            acc = _find(tc, 'accessor')
            if acc is not None:
                stride = int(acc.get('stride', 3))
        out[src.get('id')] = data.reshape(-1, stride)
    vert_el = _find(mesh_el, 'vertices')
    vert_id = None
    if vert_el is not None:
        vert_id = vert_el.get('id')
        for inp in _findall(vert_el, 'input'):
            if inp.get('semantic') == 'POSITION':
                out[vert_id] = out.get(inp.get('source').lstrip('#'),
                                       np.zeros((0, 3)))
    return out, vert_id


def _smooth_normals(pos, tris):
    n = np.zeros_like(pos)
    p0, p1, p2 = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def _parse_primitives(mesh_el, sources, vert_id):
    """Yield (material_symbol, positions, normals, uvs, triangles)."""
    for prim in mesh_el:
        t = _tag(prim)
        if t not in ('triangles', 'polylist', 'polygons'):
            continue
        inputs = []
        max_off = 0
        for inp in _findall(prim, 'input'):
            off = int(inp.get('offset', 0))
            inputs.append((inp.get('semantic'), off,
                           inp.get('source').lstrip('#')))
            max_off = max(max_off, off)
        stride = max_off + 1
        p_el = _find(prim, 'p')
        if p_el is None:
            continue
        idx = _numbers(p_el.text, np.int64)

        if t == 'polylist':
            vcount = _numbers(_find(prim, 'vcount').text, np.int64)
        elif t == 'triangles':
            vcount = np.full(int(prim.get('count', 0)), 3, np.int64)
        else:       # polygons: each <p> one polygon — handled per p above
            vcount = np.asarray([idx.size // stride], np.int64)

        corners = idx.reshape(-1, stride)
        # fan-triangulate
        tri_corner_rows = []
        c = 0
        for vc in vcount:
            for k in range(1, vc - 1):
                tri_corner_rows.extend([c, c + k, c + k + 1])
            c += vc
        corners = corners[tri_corner_rows]   # (3T, stride)

        pos_src = nrm_src = uv_src = None
        pos_off = nrm_off = uv_off = 0
        for sem, off, src in inputs:
            if sem == 'VERTEX':
                pos_src, pos_off = sources.get(src), off
            elif sem == 'NORMAL':
                nrm_src, nrm_off = sources.get(src), off
            elif sem == 'TEXCOORD' and uv_src is None:
                uv_src, uv_off = sources.get(src), off
        if pos_src is None or not len(pos_src):
            continue

        # re-index: each unique (v, n, t) corner becomes a vertex
        keys = np.stack([
            corners[:, pos_off],
            corners[:, nrm_off] if nrm_src is not None else
            np.zeros(len(corners), np.int64),
            corners[:, uv_off] if uv_src is not None else
            np.zeros(len(corners), np.int64)], axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        pos = pos_src[uniq[:, 0]][:, :3].astype(np.float32)
        nrm = (nrm_src[uniq[:, 1]][:, :3].astype(np.float32)
               if nrm_src is not None else None)
        uv = (uv_src[uniq[:, 2]][:, :2].astype(np.float32)
              if uv_src is not None else None)
        tris = inv.reshape(-1, 3).astype(np.int32)
        yield prim.get('material'), pos, nrm, uv, tris


def load_dae(path: str, settings, sb, face_culling_mode: str | None = None,
             toe_in: bool = False) -> DaeResult:
    """Load a Collada file into the SceneBuilder; returns extracted FPR
    cameras and sceneScale (ColladaLoader.cpp:643-648)."""
    mode = face_culling_mode or getattr(settings, 'face_culling_mode',
                                        'default')
    root = ET.parse(path).getroot()
    base = os.path.dirname(path)
    lib = _Library(root, base)
    up = _up_axis_transform(root)
    result = DaeResult()

    mat_cache: dict = {}

    def get_material(mat_id):
        if mat_id not in mat_cache:
            mat_cache[mat_id] = lib.material_info(mat_id, sb)
        return mat_cache[mat_id]

    # visual scene traversal
    scenes = [vs for libv in _findall(root, 'library_visual_scenes')
              for vs in _findall(libv, 'visual_scene')]

    def walk(node, parent_m):
        m = parent_m @ _node_transform(node)
        node_name = node.get('name') or node.get('id') or ''

        for ig in _findall(node, 'instance_geometry'):
            geo = lib.geometries.get(ig.get('url', '').lstrip('#'))
            if geo is None:
                continue
            # bind_material: symbol -> material id
            binds = {}
            for im in ig.iter():
                if _tag(im) == 'instance_material':
                    binds[im.get('symbol')] = im.get('target',
                                                     '').lstrip('#')
            mesh_el = _find(geo, 'mesh')
            if mesh_el is None:
                continue
            sources, vert_id = _read_source_arrays(mesh_el)
            geo_name = geo.get('name') or geo.get('id') or ''
            for sym, pos, nrm, uvc, tris in _parse_primitives(
                    mesh_el, sources, vert_id):
                mat_idx, mat_cull, render = get_material(binds.get(sym, sym))
                if not render:
                    continue
                if nrm is None:
                    nrm = _smooth_normals(pos, tris)   # Assimp GenNormals
                # cull resolution (ColladaLoader.cpp:601-615)
                if mode == 'forcesingle':
                    cull = gmesh.CULL_BACK
                elif mode == 'forcedouble':
                    cull = gmesh.CULL_NONE
                else:
                    cull = gmesh.CULL_BACK if mat_cull else gmesh.CULL_NONE
                face_camera = (node_name.startswith(
                    CAMERA_ALIGNED_NODE_PREFIX)
                    or geo_name.startswith(CAMERA_ALIGNED_NODE_PREFIX))
                world = m
                row_affine = np.concatenate(
                    [world[:3, :3].T, world[:3, 3][None]],
                    axis=0).astype(np.float32)
                if face_camera:
                    # billboards stay in local space; re-oriented per view
                    # (singleray_device.cpp:354-398)
                    hm = gmesh.HostMesh(pos, tris, nrm, uvc,
                                        material=mat_idx, cull=cull,
                                        face_camera=True,
                                        orig_transform=row_affine)
                else:
                    hm = gmesh.HostMesh(pos, tris, nrm, uvc,
                                        material=mat_idx,
                                        cull=cull).transformed(row_affine)
                result.mesh_ids.append(sb.add_mesh(hm))

        for ic in _findall(node, 'instance_camera'):
            cam = lib.cameras.get(ic.get('url', '').lstrip('#'))
            cam_name = (cam.get('name') if cam is not None else None) \
                or node_name
            # scale decomposition for sceneScale (:440-447)
            scale = float(np.linalg.norm(m[:3, 0]))
            pos = (m @ np.asarray([0, 0, 0, 1.0]))[:3]
            look = (m @ np.asarray([0, 0, -1, 1.0]))[:3]
            upv = (m[:3, :3] @ np.asarray([0, 1, 0.0]))
            result.cameras.append(DaeCamera(cam_name, pos.astype(np.float32),
                                            look.astype(np.float32),
                                            upv.astype(np.float32), scale))

        for child in _findall(node, 'node'):
            walk(child, m)

    for vs in scenes:
        for node in _findall(vs, 'node'):
            walk(node, up)

    # FPR filter (:406-436): prefix-tagged cameras win; else all
    tagged = [c for c in result.cameras
              if c.name.startswith(FPR_VIEW_CAMERA_PREFIX)]
    if tagged:
        for c in tagged:
            c.name = c.name[len(FPR_VIEW_CAMERA_PREFIX):]
        result.cameras = tagged
    if result.cameras:
        result.scene_scale = result.cameras[0].scene_scale
        if hasattr(settings, 'scene_scale'):
            settings.scene_scale = result.scene_scale
    return result


def make_stereo_cameras(result: DaeResult, toe_in: bool = False):
    """12 StereoCube cameras per FPR viewpoint (:480-498).
    Returns list of (camera_name, [12 cameras])."""
    from ..cameras import cameras as cam
    rigs = []
    for c in result.cameras:
        l2w = cam.look_at(c.position, c.look_at, c.up)
        rigs.append((c.name, cam.make_stereo_rig(
            l2w, origin=None, up=tuple(np.asarray(c.up, np.float64)),
            scene_scale=c.scene_scale, toe_in=toe_in)))
    return rigs
