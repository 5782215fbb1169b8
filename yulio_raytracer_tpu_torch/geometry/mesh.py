"""SoA triangle geometry, host side (numpy only).

The part of `yulio_raytracer_tpu/geometry/mesh.py` that the port's commit
and loaders run, for static and moving meshes with or without authored
tangents (no camera-aligned billboards): `HostMesh.transformed`,
`pack_meshes`, `woop_matrices` and `add_shade_table` produce the same
arrays, so a scene committed by either package holds identical tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# cull modes (per primitive, from the Collada loader's per-mesh face culling
# modes default/forcesingle/forcedouble — ColladaLoader.cpp:601-615)
CULL_NONE = 0      # double-sided
CULL_BACK = 1      # hide back-facing hits (single-sided)


@dataclass
class HostMesh:
    """One logical shape before packing (host-side, numpy)."""
    positions: np.ndarray            # (V, 3) f32
    triangles: np.ndarray            # (T, 3) i32
    normals: Optional[np.ndarray] = None    # (V, 3) f32 or None
    texcoords: Optional[np.ndarray] = None  # (V, 2) f32 or None
    motions: Optional[np.ndarray] = None    # (V, 3) f32 dP/dt (motion blur)
    # per-vertex shading tangents (trianglemesh_full.cpp:39-47, for the
    # anisotropic BRDF and bump mapping); without them a triangle's frame
    # comes from its uv parameterization
    tangent_x: Optional[np.ndarray] = None   # (V, 3) f32
    tangent_y: Optional[np.ndarray] = None   # (V, 3) f32
    material: int = 0
    light: int = -1                  # area-light id or -1
    cull: int = CULL_NONE
    illum_mask: int = -1
    shadow_mask: int = -1

    def transformed(self, xfm: np.ndarray) -> "HostMesh":
        """Bake an affine transform ((4, 3) rows [vx; vy; vz; p]) into the
        vertices, as TriangleMesh::transform (trianglemesh_normals.cpp:
        43-57): normals by the inverse transpose, renormalized."""
        l, p = xfm[:3], xfm[3]
        pos = self.positions @ l + p
        nrm = None
        if self.normals is not None:
            nrm = self.normals @ np.linalg.inv(l)
            nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = (nrm / np.maximum(nlen, 1e-20)).astype(np.float32,
                                                          copy=False)

        def vec(t):
            return np.asarray(t @ l, np.float32) if t is not None else None

        return HostMesh(pos.astype(np.float32, copy=False), self.triangles,
                        nrm, self.texcoords, vec(self.motions),
                        vec(self.tangent_x), vec(self.tangent_y),
                        self.material, self.light, self.cull,
                        self.illum_mask, self.shadow_mask)


@dataclass
class PackedGeometry:
    """All scene triangles, flattened (host numpy; moved to the device at
    commit).  This is the analog of the committed Embree scene."""
    v0: np.ndarray          # (T, 3) f32
    e1: np.ndarray          # (T, 3) f32  v1 - v0
    e2: np.ndarray          # (T, 3) f32  v2 - v0
    ng: np.ndarray          # (T, 3) f32  normalized geometric normal
    vn: np.ndarray          # (T, 3, 3) f32 per-corner shading normals
    uv: np.ndarray          # (T, 3, 2) f32 per-corner texcoords
    mat_id: np.ndarray      # (T,) i32
    light_id: np.ndarray    # (T,) i32
    cull: np.ndarray        # (T,) i32
    illum_mask: np.ndarray  # (T,) i32
    shadow_mask: np.ndarray # (T,) i32
    valid: np.ndarray       # (T,) bool — padding/degenerate mask
    bbox_lo: np.ndarray     # (3,) f32 scene bounds
    bbox_hi: np.ndarray     # (3,) f32
    # motion blur (None when no mesh moves): positions(t) = v0 + t*mv0 ...
    mv0: Optional[np.ndarray] = None   # (T, 3)
    me1: Optional[np.ndarray] = None
    me2: Optional[np.ndarray] = None
    # authored per-triangle tangent frames: the face mean of the
    # per-vertex tangents, NaN rows where a mesh has none (None when no
    # mesh authored them)
    ptx: Optional[np.ndarray] = None   # (T, 3)
    pty: Optional[np.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return int(self.v0.shape[0])


def woop_matrices(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Per-triangle world->unit-triangle affine transforms for the Woop
    intersection test (ops/intersect.py).

    For triangle (v0, e1, e2) with n = cross(e1, e2), the inverse of the
    column matrix A = [e1 e2 n] maps world points into (u, v, w) where the
    triangle is {u,v >= 0, u+v <= 1, w = 0}.  Packed as one (4, 3T) f32
    matrix: [o | 1] @ W -> o',  [d | 0] @ W -> d'.  Degenerate triangles
    get zero matrices (they never report hits because d'_z == 0 there).
    """
    t = len(v0)
    e1d = e1.astype(np.float64)
    e2d = e2.astype(np.float64)
    n = np.cross(e1d, e2d)
    # det(A) = n . (e1 x e2) = |n|^2; the inverse is the adjugate, rows
    # (e2 x n, n x e1, n) / det
    det = np.einsum('ij,ij->i', n, n)
    scale = np.zeros(t, np.float64)
    good = (det > 1e-18) & valid
    np.divide(1.0, det, out=scale, where=good)
    r1 = np.cross(e2d, n) * scale[:, None]
    r2 = np.cross(n, e1d) * scale[:, None]
    r3 = n * scale[:, None]
    # row-vector (x @ M) form: M columns are the inverse's rows
    v0d = v0.astype(np.float64)
    out = np.empty((4, t, 3), np.float32)
    out[0, :, 0] = r1[:, 0]; out[0, :, 1] = r2[:, 0]; out[0, :, 2] = r3[:, 0]
    out[1, :, 0] = r1[:, 1]; out[1, :, 1] = r2[:, 1]; out[1, :, 2] = r3[:, 1]
    out[2, :, 0] = r1[:, 2]; out[2, :, 1] = r2[:, 2]; out[2, :, 2] = r3[:, 2]
    # trans_k = -(v0 . M[:, k]) = -(v0 . r_k)
    out[3, :, 0] = -np.einsum('ij,ij->i', v0d, r1)
    out[3, :, 1] = -np.einsum('ij,ij->i', v0d, r2)
    out[3, :, 2] = -np.einsum('ij,ij->i', v0d, r3)
    return out.reshape(4, 3 * t)


def tangent_frames(e1: np.ndarray, e2: np.ndarray, uv: np.ndarray,
                   ng: np.ndarray) -> tuple:
    """Per-triangle tangent/bitangent from the uv parameterization; an
    ng-aligned frame for degenerate uvs."""
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    tx = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r
    ty = (e2 * du1[:, None] - e1 * du2[:, None]) * r
    # fallback frame
    a = np.abs(ng)
    helper = np.eye(3)[np.argmin(a, axis=1)]
    fx = np.cross(helper, ng)
    fx /= np.maximum(np.linalg.norm(fx, axis=1, keepdims=True), 1e-20)
    fy = np.cross(ng, fx)
    tx = np.where(ok[:, None], tx, fx)
    ty = np.where(ok[:, None], ty, fy)
    ntx = np.linalg.norm(tx, axis=1, keepdims=True)
    nty = np.linalg.norm(ty, axis=1, keepdims=True)
    return ((tx / np.maximum(ntx, 1e-20)).astype(np.float32, copy=False),
            (ty / np.maximum(nty, 1e-20)).astype(np.float32, copy=False))


def add_shade_table(geom: dict) -> dict:
    """Pack the per-triangle shading attributes into one (T, 28) f32 table
    (post_intersect gathers one row per hit):
    [ng(3) | vn(9) | uv(6) | mat | light | illum | shadow | tx(3) | ty(3)].
    Authored tangents ('ptx'/'pty', popped) replace the uv-derived frame
    on the rows that have them."""
    t = geom['ng'].shape[0]
    geom = {k: np.asarray(v) for k, v in geom.items()}
    tx, ty = tangent_frames(geom['e1'], geom['e2'],
                            geom['uv'], geom['ng'])
    if 'ptx' in geom:
        # NaN rows mark triangles without authored tangents
        ptx = geom.pop('ptx')
        pty = geom.pop('pty')
        has = np.isfinite(ptx).all(axis=1, keepdims=True)
        tx = np.where(has, np.nan_to_num(ptx), tx).astype(np.float32,
                                                          copy=False)
        ty = np.where(has & np.isfinite(pty).all(axis=1, keepdims=True),
                      np.nan_to_num(pty), ty).astype(np.float32, copy=False)
    geom['shade_tab'] = np.concatenate([
        geom['ng'].astype(np.float32, copy=False),
        geom['vn'].reshape(t, 9).astype(np.float32, copy=False),
        geom['uv'].reshape(t, 6).astype(np.float32, copy=False),
        geom['mat_id'].astype(np.float32, copy=False)[:, None],
        geom['light_id'].astype(np.float32, copy=False)[:, None],
        geom['illum_mask'].astype(np.float32, copy=False)[:, None],
        geom['shadow_mask'].astype(np.float32, copy=False)[:, None],
        tx,
        ty,
    ], axis=1)
    return geom


def pack_meshes(meshes: list[HostMesh], pad_multiple: int = 128) -> PackedGeometry:
    """Flatten shapes into one SoA table, padded to a multiple of
    `pad_multiple` triangles (the reference's padding, so both packages'
    tables are equal)."""
    v0s, e1s, e2s, vns, uvs = [], [], [], [], []
    mats, lights, culls, ims, sms = [], [], [], [], []
    movs, ptxs, ptys = [], [], []
    any_motion = any(m.motions is not None and len(m.motions)
                     for m in meshes)
    any_tangent = any(m.tangent_x is not None or m.tangent_y is not None
                      for m in meshes)
    for m in meshes:
        pos = np.asarray(m.positions, np.float32)
        tri = np.asarray(m.triangles, np.int64)
        if tri.size == 0:
            continue
        p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        v0s.append(p0)
        e1s.append(p1 - p0)
        e2s.append(p2 - p0)
        if any_motion:
            if m.motions is not None and len(m.motions):
                mo = np.asarray(m.motions, np.float32)
                m0, m1, m2 = mo[tri[:, 0]], mo[tri[:, 1]], mo[tri[:, 2]]
            else:
                m0 = m1 = m2 = np.zeros((len(tri), 3), np.float32)
            movs.append((m0, m1 - m0, m2 - m0))
        if m.normals is not None and len(m.normals):
            n = np.asarray(m.normals, np.float32)
            vns.append(np.stack([n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]]], axis=1))
        else:
            ng = np.cross(p1 - p0, p2 - p0)
            ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            vns.append(np.repeat(ng[:, None, :], 3, axis=1))
        if any_tangent:
            ptx_, pty_ = _face_tangents(m, tri)
            ptxs.append(ptx_)
            ptys.append(pty_)
        if m.texcoords is not None and len(m.texcoords):
            t = np.asarray(m.texcoords, np.float32)
            uvs.append(np.stack([t[tri[:, 0]], t[tri[:, 1]], t[tri[:, 2]]], axis=1))
        else:
            uvs.append(np.zeros((len(tri), 3, 2), np.float32))
        nt = len(tri)
        mats.append(np.full(nt, m.material, np.int32))
        lights.append(np.full(nt, m.light, np.int32))
        culls.append(np.full(nt, m.cull, np.int32))
        ims.append(np.full(nt, m.illum_mask, np.int32))
        sms.append(np.full(nt, m.shadow_mask, np.int32))

    if not v0s:  # empty scene: one degenerate triangle
        v0s = [np.zeros((1, 3), np.float32)]
        e1s = [np.zeros((1, 3), np.float32)]
        e2s = [np.zeros((1, 3), np.float32)]
        vns = [np.zeros((1, 3, 3), np.float32)]
        uvs = [np.zeros((1, 3, 2), np.float32)]
        mats, lights = [np.zeros(1, np.int32)], [np.full(1, -1, np.int32)]
        culls = [np.zeros(1, np.int32)]
        ims, sms = [np.full(1, -1, np.int32)], [np.full(1, -1, np.int32)]

    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    t = len(v0)
    pad = -(-max(t, 1) // pad_multiple) * pad_multiple - t

    def _pad(a, fill=0.0):
        w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, w, constant_values=fill)

    ngv = np.cross(e1, e2)
    nglen = np.linalg.norm(ngv, axis=-1, keepdims=True)
    valid = (nglen[:, 0] > 0.0)
    ng = ngv / np.maximum(nglen, 1e-30)

    verts = np.concatenate([v0, v0 + e1, v0 + e2])
    finite = np.isfinite(verts).all(axis=1)
    bb_lo, bb_hi = (verts[finite].min(axis=0), verts[finite].max(axis=0)) \
        if finite.any() else (np.zeros(3), np.zeros(3))
    mv0, me1, me2 = (
        _pad(np.concatenate(x).astype(np.float32, copy=False))
        for x in zip(*movs)) if movs else (None, None, None)

    return PackedGeometry(
        v0=_pad(v0.astype(np.float32, copy=False)),
        e1=_pad(e1.astype(np.float32, copy=False)),
        e2=_pad(e2.astype(np.float32, copy=False)),
        ng=_pad(ng.astype(np.float32, copy=False)),
        vn=_pad(np.concatenate(vns).astype(np.float32, copy=False)),
        uv=_pad(np.concatenate(uvs).astype(np.float32, copy=False)),
        mat_id=_pad(np.concatenate(mats)),
        light_id=_pad(np.concatenate(lights), fill=-1),
        cull=_pad(np.concatenate(culls)),
        illum_mask=_pad(np.concatenate(ims), fill=-1),
        shadow_mask=_pad(np.concatenate(sms), fill=-1),
        valid=_pad(valid, fill=False),
        bbox_lo=bb_lo.astype(np.float32, copy=False),
        bbox_hi=bb_hi.astype(np.float32, copy=False),
        mv0=mv0, me1=me1, me2=me2,
        ptx=_pad(np.concatenate(ptxs), fill=np.nan) if ptxs else None,
        pty=_pad(np.concatenate(ptys), fill=np.nan) if ptys else None,
    )


def _face_tangents(m: HostMesh, tri: np.ndarray) -> tuple:
    """A mesh's per-triangle (tx, ty): the normalized mean of its three
    vertices' tangents, NaN rows for a tangent the mesh lacks (ty is NaN
    wherever tx is)."""
    def face_mean(t):
        t = np.asarray(t, np.float32)
        v = (t[tri[:, 0]] + t[tri[:, 1]] + t[tri[:, 2]]) / 3.0
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return (v / np.maximum(n, 1e-20)).astype(np.float32, copy=False)

    missing = np.full((len(tri), 3), np.nan, np.float32)
    if m.tangent_x is None or not len(m.tangent_x):
        return missing, missing
    return face_mean(m.tangent_x), (
        face_mean(m.tangent_y)
        if m.tangent_y is not None and len(m.tangent_y) else missing)
