"""Wavefront OBJ + MTL loader.

The torch package's copy of `yulio_raytracer_tpu/io/obj.py`.  Mirrors
`devices/device/loaders/obj_loader.cpp`: MTL materials become the "Obj"
preset (d/Kd/Ks/Ns + maps, obj_loader.cpp:247-276), faces are
fan-triangulated, indices may be negative (relative), the default material
is matte 0.5 (obj_loader.cpp:143-147), and each (group x material) run
flushes to one mesh.
"""
from __future__ import annotations

import os

import numpy as np

from ..geometry.mesh import HostMesh
from ..shading import materials as gmat
from ..shading import textures as gtex
from . import image as gimage


def _fix(idx: int, n: int) -> int:
    """OBJ 1-based/negative-relative index -> 0-based."""
    if idx > 0:
        return idx - 1
    if idx < 0:
        return n + idx
    return -1


def _parse_vertex_token(tok: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' -> (v, vt, vn) raw ints (0=absent)."""
    parts = tok.split('/')
    v = int(parts[0]) if parts[0] else 0
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, vt, vn


def load_mtl(path: str, sb, tex_filter=gtex.FILTER_BILINEAR) -> dict:
    """Parse an MTL library into material name -> material id in sb."""
    mats = {}
    cur_name = None
    cur: dict = {}
    tex_ids: dict = {}
    base = os.path.dirname(path)

    def flush():
        if cur_name is None:
            return
        spec = gmat.make_material('obj', cur,
                                  tex_id=tex_ids.get('map_Kd', -1),
                                  tex_ids=dict(tex_ids))
        mats[cur_name] = sb.add_material(spec)

    def load_tex(name: str) -> int:
        p = os.path.join(base, name)
        try:
            img = gimage.load(p)
        except Exception:
            return -1
        return sb.textures.add(img, tex_filter, key=os.path.abspath(p))

    try:
        lines = open(path, 'r', errors='replace').read().splitlines()
    except OSError:
        return mats
    for line in lines:
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        tok = line.split()
        key = tok[0]
        if key == 'newmtl':
            flush()
            cur_name = ' '.join(tok[1:])
            cur = {}
            tex_ids = {}
        elif key in ('Ka', 'Kd', 'Ks', 'Tf'):
            cur[key] = tuple(float(x) for x in tok[1:4])
        elif key in ('d', 'Ns', 'Ni'):
            cur[key] = float(tok[1])
        elif key.startswith('map_'):
            tid = load_tex(' '.join(tok[1:]))
            if tid >= 0:
                tex_ids[key] = tid
    flush()
    return mats


def load_obj(path: str, sb, cull: int = 0) -> list[int]:
    """Load an OBJ into the SceneBuilder; returns the added mesh ids."""
    base = os.path.dirname(path)
    v: list = []
    vt: list = []
    vn: list = []
    faces: list = []            # current group: list of [(v,vt,vn), ...]
    mats: dict = {}
    default_mat = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.5, 0.5, 0.5)}))
    cur_mat = default_mat
    added = []

    def flush():
        nonlocal faces
        if not faces:
            return
        # compact the vertex set used by this group (obj_loader getVertex)
        vmap: dict = {}
        pos, nrm, uv, tris = [], [], [], []
        any_n = any(c[2] >= 0 for f in faces for c in f)
        any_t = any(c[1] >= 0 for f in faces for c in f)
        for f in faces:
            idx = []
            for (vi, ti, ni) in f:
                key = (vi, ti, ni)
                if key not in vmap:
                    vmap[key] = len(pos)
                    pos.append(v[vi])
                    nrm.append(vn[ni] if ni >= 0 and ni < len(vn)
                               else (0.0, 0.0, 0.0))
                    uv.append(vt[ti] if ti >= 0 and ti < len(vt)
                              else (0.0, 0.0))
                idx.append(vmap[key])
            for k in range(1, len(idx) - 1):   # fan triangulation
                tris.append([idx[0], idx[k], idx[k + 1]])
        m = HostMesh(np.asarray(pos, np.float32),
                     np.asarray(tris, np.int32),
                     np.asarray(nrm, np.float32) if any_n else None,
                     np.asarray(uv, np.float32) if any_t else None,
                     material=cur_mat, cull=cull)
        added.append(sb.add_mesh(m))
        faces = []

    for raw in open(path, 'r', errors='replace').read().splitlines():
        line = raw.strip()
        if not line or line.startswith('#'):
            continue
        tok = line.split()
        key = tok[0]
        if key == 'v':
            v.append(tuple(float(x) for x in tok[1:4]))
        elif key == 'vt':
            vals = [float(x) for x in tok[1:3]]
            vt.append(tuple(vals + [0.0] * (2 - len(vals))))
        elif key == 'vn':
            vn.append(tuple(float(x) for x in tok[1:4]))
        elif key == 'f':
            corners = []
            for t in tok[1:]:
                vi, ti, ni = _parse_vertex_token(t)
                corners.append((_fix(vi, len(v)), _fix(ti, len(vt)),
                                _fix(ni, len(vn))))
            if len(corners) >= 3:
                faces.append(corners)
        elif key == 'usemtl':
            flush()
            name = ' '.join(tok[1:])
            cur_mat = mats.get(name, default_mat)
        elif key == 'mtllib':
            mats.update(load_mtl(os.path.join(base, ' '.join(tok[1:])), sb))
        elif key in ('g', 'o'):
            flush()
    flush()
    return added
