"""The reference's own tables, worked out from a plain scene description
(portbench/scenes): triangles with their shading attributes, the light
triangles and their emitting shapes, the materials as lobe slots, the
texture images, the dome (an ambient light) where there is one, and
clusters of consecutive triangles with boxes that the brute-force
intersection culls by.
"""
from __future__ import annotations

import numpy as np
import torch

# material kinds
LAMBERT = 0          # matte: a Lambertian lobe of its reflectance
LAMBERT_TEX = 1      # mattetextured: Lambertian of the texel's rgb
PLASTIC = 2          # the pigment's Lambertian under a dielectric layer
                     # (eta 1.4) and a microfacet dielectric of roughness
                     # 0.01 (exponent 100)
PLASTIC_ETA = 1.4
PLASTIC_ROUGHNESS = 0.01
# triangles a cluster holds at most
CLUSTER = 64


def _light_triangles(q):
    """A quad light's two triangle lights, the renderer's winding:
    (p+u+v, p+u, p) and (p+u+v, p, p+v), in f32."""
    p, u, v = q['p'], q['dx'], q['dy']
    return [tuple(np.asarray(x, np.float32) for x in t)
            for t in ((p + u + v, p + u, p), (p + u + v, p, p + v))]


def _mesh_rows(m):
    pos = np.asarray(m['positions'], np.float32)
    tri = np.asarray(m['triangles'], np.int64)
    p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    if m['normals'] is not None:
        n = np.asarray(m['normals'], np.float32)
        vn = np.stack([n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]]], axis=1)
    else:
        ng = np.cross(p1 - p0, p2 - p0)
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        vn = np.repeat(ng[:, None, :], 3, axis=1)
    if m['texcoords'] is not None:
        t = np.asarray(m['texcoords'], np.float32)
        uv = np.stack([t[tri[:, 0]], t[tri[:, 1]], t[tri[:, 2]]], axis=1)
    else:
        uv = np.zeros((len(tri), 3, 2), np.float32)
    return p0, p1, p2, vn, uv


def prepare(desc: dict, device, dtype=torch.float32) -> dict:
    """The reference's tables for `desc` on `device`, floats in
    `dtype`."""
    meshes = list(desc['meshes'])
    mats = [dict(m) for m in desc['materials']]
    lights = []
    for q in desc['quad_lights']:
        for v0, v1, v2 in _light_triangles(q):
            lid = len(lights)
            lights.append({'kind': 'triangle', 'v0': v0, 'v1': v1, 'v2': v2,
                           'L': np.asarray(q['L'], np.float32),
                           'Ng': np.cross(v0 - v1, v2 - v0).astype(
                               np.float32)})
            # the emitting shape faces where the light shines: its
            # vertices in the order (v0, v2, v1), white and matte
            mats.append({'type': 'matte', 'reflectance': (1.0, 1.0, 1.0)})
            meshes.append({'positions': np.stack([v0, v2, v1]),
                           'triangles': np.asarray([[0, 1, 2]], np.int32),
                           'normals': None, 'texcoords': None,
                           'material': len(mats) - 1, 'light': lid})
    if desc.get('ambient') is not None:
        # the dome: no shape; it is sampled after the triangle lights
        lights.append({'kind': 'ambient',
                       'L': np.asarray(desc['ambient'], np.float32)})
    rows = [_mesh_rows(m) for m in meshes]
    p0, p1, p2, vn, uv = (np.concatenate(x) for x in zip(*rows))
    counts = [len(r[0]) for r in rows]
    e1, e2 = p1 - p0, p2 - p0
    ngv = np.cross(e1, e2)
    nglen = np.linalg.norm(ngv, axis=-1, keepdims=True)
    ng = ngv / np.maximum(nglen, 1e-30)
    mat_id = np.repeat([m['material'] for m in meshes], counts)
    light_id = np.repeat([m.get('light', -1) for m in meshes], counts)

    kind = np.zeros(len(mats), np.int64)
    color = np.ones((len(mats), 3), np.float32)
    tex = np.full(len(mats), -1, np.int64)
    for i, m in enumerate(mats):
        if m['type'] == 'matte':
            color[i] = m['reflectance']
        elif m['type'] == 'mattetextured':
            kind[i], tex[i] = LAMBERT_TEX, m['texture']
        elif m['type'] == 'plastic':
            kind[i], color[i] = PLASTIC, m['pigmentColor']
        else:
            raise ValueError(f"the reference has no material {m['type']!r}")

    # clusters: runs of up to CLUSTER consecutive triangles of one mesh
    starts = np.cumsum([0] + counts[:-1])
    first = np.concatenate([np.arange(s, s + c, CLUSTER)
                            for s, c in zip(starts, counts)])
    last = np.concatenate([np.minimum(np.arange(s, s + c, CLUSTER)
                                      + CLUSTER, s + c)
                           for s, c in zip(starts, counts)])
    members = first[:, None] + np.arange(CLUSTER)[None, :]
    members = np.where(members < last[:, None], members, -1)
    verts = np.stack([p0, p1, p2], axis=1).astype(np.float64)
    safe = np.where(members >= 0, members, first[:, None])
    cv = verts[safe].reshape(len(first), -1, 3)
    lo, hi = cv.min(axis=1), cv.max(axis=1)
    pad = 1e-4 * (hi - lo).max(axis=1, keepdims=True) + 1e-5 * (
        1.0 + np.abs(np.concatenate([lo, hi], axis=1)).max(axis=1,
                                                           keepdims=True))

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(
            dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    atlas = [np.concatenate([np.asarray(t, np.float32),
                             np.ones(np.shape(t)[:2] + (1,), np.float32)],
                            axis=-1) for t in desc['textures']]
    return {
        'dtype': dtype, 'device': device,
        'v0': f(p0), 'e1': f(e1), 'e2': f(e2), 'ng': f(ng), 'vn': f(vn),
        'uv': f(uv), 'valid': torch.as_tensor(nglen[:, 0] > 0.0,
                                              device=device),
        'mat_id': i(mat_id), 'light_id': i(light_id),
        'mat_kind': i(kind), 'mat_color': f(color), 'mat_tex': i(tex),
        'tex_data': f(np.concatenate([t.reshape(-1, 4) for t in atlas])
                      if atlas else np.ones((1, 4))),
        'tex_off': i(np.cumsum([0] + [t.shape[0] * t.shape[1]
                                      for t in atlas])[:max(len(atlas), 1)]),
        'tex_w': i([t.shape[1] for t in atlas] or [1]),
        'tex_h': i([t.shape[0] for t in atlas] or [1]),
        'lights': [{k: v if k == 'kind' else f(v) for k, v in l.items()}
                   for l in lights],
        'cluster_tris': i(members), 'cluster_lo': f(lo - pad),
        'cluster_hi': f(hi + pad),
        'num_triangles': int(len(p0)),
    }
