"""Embree XML scene-graph loader.

The torch package's counterpart of `yulio_raytracer_tpu/io/xml_scene.py`,
tag for tag.  Reproduces `devices/device/loaders/xml_loader.cpp`:
Transform/Group stacks (:509-537), material cache + <assign>/<ref> named
materials (:631-645, :417-444), TriangleMesh/Sphere/Disk shapes
(:446-507), the eight light tags (:276-395) and `.bin` sidecar binary
arrays (:193-268).  Camera-aligned billboards (the faceCamera flag,
:455) are not ported yet: a mesh flagged faceCamera raises
NotImplementedError.

AffineSpace nodes accept translate/scale/rotate_x/y/z/rotate+axis
attributes or a 12-float row-major 3x4 body (:157-191).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..geometry.mesh import HostMesh
from ..geometry import primitives
from ..shading import materials as gmat
from ..shading import textures as gtex
from ..lights import lights as glights
from . import image as gimage
from . import obj as gobj


def _body_floats(el) -> list:
    return [float(x) for x in (el.text or '').split()]


def _identity():
    return np.concatenate([np.eye(3, dtype=np.float64),
                           np.zeros((1, 3))], axis=0)


def _compose(a, b):
    """(a*b)(x) = a(b(x)) in the row-vector [vx;vy;vz;p] layout."""
    l = b[:3] @ a[:3]
    p = b[3] @ a[:3] + a[3]
    return np.concatenate([l, p[None]], axis=0)


def _rot_axis(axis, deg):
    axis = np.asarray(axis, np.float64)
    u = axis / max(np.linalg.norm(axis), 1e-20)
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    x, y, z = u
    l = np.asarray([
        [c + x * x * (1 - c), x * y * (1 - c) + z * s, x * z * (1 - c) - y * s],
        [y * x * (1 - c) - z * s, c + y * y * (1 - c), y * z * (1 - c) + x * s],
        [z * x * (1 - c) + y * s, z * y * (1 - c) - x * s, c + z * z * (1 - c)],
    ])
    return np.concatenate([l, np.zeros((1, 3))], axis=0)


def _load_affine(el) -> np.ndarray:
    if el is None:
        return _identity()
    a = el.attrib
    if 'translate' in a:
        t = np.fromstring(a['translate'], sep=' ')
        return np.concatenate([np.eye(3), t[None]], axis=0)
    if 'scale' in a:
        s = np.fromstring(a['scale'], sep=' ')
        return np.concatenate([np.diag(s), np.zeros((1, 3))], axis=0)
    for key, axis in (('rotate_x', (1, 0, 0)), ('rotate_y', (0, 1, 0)),
                      ('rotate_z', (0, 0, 1))):
        if key in a:
            return _rot_axis(axis, float(a[key]))
    if 'rotate' in a and 'axis' in a:
        return _rot_axis(np.fromstring(a['axis'], sep=' '),
                         float(a['rotate']))
    body = _body_floats(el)
    if len(body) != 12:
        raise ValueError("wrong AffineSpace body")
    m = np.asarray(body).reshape(3, 4)     # row-major [R | t]
    # columns of R become the vx/vy/vz rows of our layout
    return np.concatenate([m[:, :3].T, m[:, 3][None]], axis=0)


def _xfm_point(a, p):
    return np.asarray(p) @ a[:3] + a[3]


class XMLSceneLoader:
    def __init__(self, path: str, sb, transforms=None, depth: int = 0):
        if depth > 16:
            raise ValueError("XML include recursion too deep")
        self.sb = sb
        self.depth = depth
        self.path = os.path.dirname(path)
        self.bin_path = os.path.splitext(path)[0] + '.bin'
        self.bin = open(self.bin_path, 'rb') if os.path.exists(self.bin_path) \
            else None
        # nested includes inherit the including file's transform stack top
        # (xml_loader.cpp:558-561 wraps included prims in
        # rtTransformPrimitive(transforms.top()))
        self.transforms = list(transforms) if transforms else [_identity()]
        self.material_map: dict = {}      # <assign id=...>
        self.material_cache: dict = {}    # parameters-element identity cache
        self.scene_map: dict = {}         # <assign type="scene"> / <ref>
        root = ET.parse(path).getroot()
        if root.tag != 'scene':
            raise ValueError("invalid scene tag")
        try:
            for child in root:
                self._load_node(child)
        finally:
            if self.bin:
                self.bin.close()

    # ---------------- arrays ----------------
    def _array(self, el, comps: int, dtype) -> np.ndarray:
        if el is None:
            return np.zeros((0, comps), dtype)
        if el.get('ofs'):
            if not self.bin:
                raise FileNotFoundError(self.bin_path)
            ofs = int(el.get('ofs'))
            size = int(el.get('size'))
            self.bin.seek(ofs)
            raw = np.frombuffer(self.bin.read(size * comps * 4),
                                np.float32 if dtype == np.float32
                                else np.int32)
            return raw.reshape(size, comps).astype(dtype)
        body = _body_floats(el)
        arr = np.asarray(body, dtype)
        if arr.size % comps:
            raise ValueError("wrong array body")
        return arr.reshape(-1, comps)

    # ---------------- materials ----------------
    def _load_material(self, el) -> int:
        if el is None:
            return self.sb.add_material(gmat.make_material('matte', {}))
        if el.get('id') and el.tag == 'material' and len(el) == 0:
            return self.material_map[el.get('id')]
        if el.get('id') and len(el) == 0:
            return self.material_map[el.get('id')]
        parms_el = el.find('parameters')
        cache_key = id(parms_el)
        if cache_key in self.material_cache:
            return self.material_cache[cache_key]
        code_el = el.find('code')
        code = (code_el.text or '').strip().strip('"')
        parms: dict = {}
        tex_id = -1
        tex_ids: dict = {}
        if parms_el is not None:
            for entry in parms_el:
                name = entry.get('name')
                if entry.tag in ('float', 'int'):
                    parms[name] = float(_body_floats(entry)[0])
                elif entry.tag in ('float2', 'float3', 'float4', 'int2',
                                   'int3', 'int4'):
                    parms[name] = tuple(_body_floats(entry))
                elif entry.tag == 'texture':
                    fn = (entry.text or '').strip().strip('"')
                    full = os.path.join(self.path, fn)
                    try:
                        img = gimage.load(full)
                        tid = self.sb.textures.add(
                            img, gtex.FILTER_BILINEAR,
                            key=os.path.abspath(full))
                    except OSError:
                        tid = -1
                    tex_ids[name] = tid
                    if name == 'Kd':
                        tex_id = tid
        mid = self.sb.add_material(
            gmat.make_material(code, parms, tex_id=tex_id, tex_ids=tex_ids))
        self.material_cache[cache_key] = mid
        if el.get('id'):
            self.material_map[el.get('id')] = mid
        return mid

    # ---------------- scene nodes ----------------
    def _load_node(self, el):
        tag = el.tag
        top = self.transforms[-1]

        if tag == 'assign':
            if el.get('type') == 'material':
                self.material_map[el.get('id')] = self._load_material(el[0])
            elif el.get('type') == 'scene':
                # named scene-graph node, re-instanced by <ref>
                # (xml_loader.cpp:551-553, 573-577)
                self.scene_map[el.get('id')] = el[0]
            else:
                raise ValueError(f"unknown assign type {el.get('type')}")
            return
        if tag == 'ref':
            self._load_node(self.scene_map[el.get('id')])
            return
        if tag in ('Group',):
            for c in el:
                self._load_node(c)
            return
        if tag == 'Transform':
            self.transforms.append(_compose(top, _load_affine(el[0])))
            for c in list(el)[1:]:
                self._load_node(c)
            self.transforms.pop()
            return
        if tag == 'obj':
            ids = gobj.load_obj(os.path.join(self.path, el.get('src')),
                                self.sb)
            for i in ids:
                self.sb.meshes[i] = self.sb.meshes[i].transformed(
                    top.astype(np.float32))
            return
        if tag in ('xml', 'extern'):
            # include another scene file under the current transform
            # (xml_loader.cpp:558-572; 'extern' dispatches by extension
            # through rtLoadScene)
            src = os.path.join(self.path, el.get('src'))
            ext = os.path.splitext(src)[1].lower()
            if ext == '.xml':
                XMLSceneLoader(src, self.sb, transforms=[top],
                               depth=self.depth + 1)
            elif ext == '.obj':
                ids = gobj.load_obj(src, self.sb)
                for i in ids:
                    self.sb.meshes[i] = self.sb.meshes[i].transformed(
                        top.astype(np.float32))
            else:
                raise ValueError(f"unsupported include {src}")
            return

        if tag == 'TriangleMesh':
            fc = el.find('faceCamera')
            if fc is not None and any(_body_floats(fc)):
                raise NotImplementedError(
                    "faceCamera: camera-aligned billboards are not ported "
                    "to the torch package yet")
            mat = self._load_material(el.find('material'))
            pos = self._array(el.find('positions'), 3, np.float32)
            nrm = self._array(el.find('normals'), 3, np.float32)
            uv = self._array(el.find('texcoords'), 2, np.float32)
            tris = self._array(el.find('triangles'), 3, np.int32)
            mot = self._array(el.find('motions'), 3, np.float32)
            tgx = self._array(el.find('tangent_x'), 3, np.float32)
            tgy = self._array(el.find('tangent_y'), 3, np.float32)
            m = HostMesh(pos, tris.astype(np.int32),
                         nrm if len(nrm) else None,
                         uv if len(uv) else None, material=mat,
                         motions=mot if len(mot) else None,
                         tangent_x=tgx if len(tgx) else None,
                         tangent_y=tgy if len(tgy) else None)
            self.sb.add_mesh(m.transformed(top.astype(np.float32)))
            return
        if tag == 'Sphere':
            mat = self._load_material(el.find('material'))
            p = _body_floats(el.find('position'))
            r = _body_floats(el.find('radius'))[0]
            nt = int(_body_floats(el.find('numTheta'))[0])
            nph = int(_body_floats(el.find('numPhi'))[0])
            m = primitives.tessellate_sphere(p, r, nt, nph, material=mat)
            mo = el.find('motion')
            if mo is not None:
                # constant per-vertex motion dPdt (shapes/sphere.h dPdt)
                dpdt = np.asarray(_body_floats(mo), np.float32)
                m.motions = np.tile(dpdt[None, :], (len(m.positions), 1))
            self.sb.add_mesh(m.transformed(top.astype(np.float32)))
            return
        if tag == 'Disk':
            mat = self._load_material(el.find('material'))
            p = _body_floats(el.find('position'))
            r = _body_floats(el.find('radius'))[0]
            ntri = int(_body_floats(el.find('numTriangles'))[0])
            m = primitives.tessellate_disk(p, (0, 1, 0), r, ntri,
                                           material=mat)
            self.sb.add_mesh(m.transformed(top.astype(np.float32)))
            return

        # ---- lights (all transformed by the stack top) ----
        if tag == 'PointLight':
            space = _load_affine(el.find('AffineSpace'))
            i = _body_floats(el.find('I'))
            self.sb.add_light(glights.point(_xfm_point(top, space[3]), i))
            return
        if tag == 'SpotLight':
            space = _load_affine(el.find('AffineSpace'))
            i = _body_floats(el.find('I'))
            amin = _body_floats(el.find('angleMin'))[0]
            amax = _body_floats(el.find('angleMax'))[0]
            d = space[2] @ top[:3]
            self.sb.add_light(glights.spot(_xfm_point(top, space[3]), d, i,
                                           amin, amax))
            return
        if tag == 'DirectionalLight':
            space = _load_affine(el.find('AffineSpace'))
            e = _body_floats(el.find('E'))
            self.sb.add_light(glights.directional(space[2] @ top[:3], e))
            return
        if tag == 'DistantLight':
            space = _load_affine(el.find('AffineSpace'))
            l = _body_floats(el.find('L'))
            ha = _body_floats(el.find('halfAngle'))[0]
            self.sb.add_light(glights.distant(space[2] @ top[:3], l, ha))
            return
        if tag == 'AmbientLight':
            self.sb.add_light(glights.ambient(_body_floats(el.find('L'))))
            return
        if tag == 'TriangleLight':
            space = _load_affine(el.find('AffineSpace'))
            l = _body_floats(el.find('L'))
            v0 = _xfm_point(top, _xfm_point(space, (1, 0, 0)))
            v1 = _xfm_point(top, _xfm_point(space, (0, 1, 0)))
            v2 = _xfm_point(top, _xfm_point(space, (0, 0, 0)))
            self.sb.add_light(glights.triangle(v0, v1, v2, l))
            return
        if tag == 'QuadLight':
            space = _load_affine(el.find('AffineSpace'))
            l = _body_floats(el.find('L'))
            v0 = _xfm_point(top, _xfm_point(space, (0, 0, 0)))
            v1 = _xfm_point(top, _xfm_point(space, (0, 1, 0)))
            v2 = _xfm_point(top, _xfm_point(space, (1, 1, 0)))
            v3 = _xfm_point(top, _xfm_point(space, (1, 0, 0)))
            self.sb.add_light(glights.triangle(v1, v3, v0, l))
            self.sb.add_light(glights.triangle(v2, v3, v1, l))
            return
        if tag == 'HDRILight':
            space = _load_affine(el.find('AffineSpace'))
            l = _body_floats(el.find('L'))
            img_el = el.find('image')
            fn = (img_el.text or '').strip().strip('"')
            img = gimage.load(os.path.join(self.path, fn))
            l2w = _compose(top, space)
            self.sb.add_light(glights.hdri(img, l, l2w.astype(np.float32)))
            return

        raise ValueError(f"unknown XML scene tag: {tag}")


def load_xml(path: str, sb):
    XMLSceneLoader(path, sb)
