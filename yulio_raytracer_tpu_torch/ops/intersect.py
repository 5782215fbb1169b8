"""Ray-triangle intersection: the plain Woop and Moller-Trumbore tests
and shading geometry.

Counterpart of `yulio_raytracer_tpu/ops/intersect.py`.  Triangles are
packed rows of 16 floats [woop (12) | ng (3) | cull] (`ops/wide.py`
`pack_tris`, the layout the reference's kernels read); the vectorized
Woop test over them is the plain version behind the dense kernels
(`ops/dense.py`) and, through `woop_rows`, the reference's CPU path
`intersect_woop` / `occluded_woop`.  `intersect_brute` /
`occluded_brute` test every triangle of a vertex-edge table, at each
ray's time in a motion scene: the reference's plain path, which traces
motion scenes of at most 2048 triangles.

Conventions (the kernels' contract): barycentrics accepted inclusively
by 32 f32-ulps-at-1.0 (BARY_EPS); hits strictly inside (tnear, tfar); a
triangle with cull flag 1 rejects hits with dot(ng, dir) >= 0; closest
hit ties keep the lowest triangle index.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = float('inf')
BARY_EPS = float(32 * np.finfo(np.float32).eps)  # 3.8e-6
# elements of one (rays x triangles) temporary in the plain test
_CHUNK_ELEMS = 1 << 20


class Hit(NamedTuple):
    """Closest-hit record for a ray batch (all (R,) tensors)."""
    t: torch.Tensor       # f32, inf on miss
    tri: torch.Tensor     # int32 triangle index, -1 on miss
    u: torch.Tensor       # f32 barycentric of the e1 vertex
    v: torch.Tensor       # f32 barycentric of the e2 vertex

    @property
    def valid(self):
        return self.tri >= 0


def woop_test(s, org, dirn, tnear, tfar):
    """The Woop + cull test in the reference kernels' operation order.

    s: the 16 row fields, s[k] broadcastable against org[..., k]; org,
    dirn: (..., 3); tnear, tfar broadcastable likewise.  Returns (th,
    uh, vh, ok)."""
    ox, oy, oz = org[..., 0], org[..., 1], org[..., 2]
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    oup = ox * s[0] + oy * s[3] + oz * s[6] + s[9]
    ovp = ox * s[1] + oy * s[4] + oz * s[7] + s[10]
    owp = ox * s[2] + oy * s[5] + oz * s[8] + s[11]
    dup = dx * s[0] + dy * s[3] + dz * s[6]
    dvp = dx * s[1] + dy * s[4] + dz * s[7]
    dwp = dx * s[2] + dy * s[5] + dz * s[8]
    nz = torch.abs(dwp) > 1e-12
    inv_dw = torch.where(nz, 1.0 / dwp, 0.0)
    th = -owp * inv_dw
    uh = oup + th * dup
    vh = ovp + th * dvp
    ngd = dx * s[12] + dy * s[13] + dz * s[14]
    cull_ok = (s[15] != 1.0) | (ngd < 0.0)
    ok = (nz & (uh >= -BARY_EPS) & (vh >= -BARY_EPS)
          & (uh + vh <= 1.0 + BARY_EPS)
          & (th > tnear) & (th < tfar) & cull_ok)
    return th, uh, vh, ok


def _woop_block(rows, org, dirn, tnear, tfar):
    """Rays (Rc,) against packed rows (Tc, 16) -> (Rc, Tc) results."""
    return woop_test(rows.T, org[:, None, :], dirn[:, None, :],
                     tnear[:, None], tfar[:, None])


def _chunks(n_rays, n_tris):
    tc = max(1, min(n_tris, _CHUNK_ELEMS // 64))
    rc = max(1, _CHUNK_ELEMS // tc)
    return rc, tc


def _blocks(n_rays, n_tris, test):
    """(ray slice, first triangle, test(ray slice, triangle slice)) over
    the (rays x triangles) blocks of one plain sweep."""
    rc, tc = _chunks(n_rays, n_tris)
    for r0 in range(0, n_rays, rc):
        sl = slice(r0, r0 + rc)
        for t0 in range(0, n_tris, tc):
            yield sl, t0, test(sl, slice(t0, t0 + tc))


def _closest(blocks, org) -> Hit:
    """Closest hit of each ray over _blocks of (th, uh, vh, ok)."""
    r, dev = org.shape[0], org.device
    t_b = torch.full((r,), INF, dtype=torch.float32, device=dev)
    tri_b = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    for sl, t0, (th, uh, vh, ok) in blocks:
        th = torch.where(ok, th, INF)
        tmin, j = torch.min(th, dim=1)               # first index on ties
        better = tmin < t_b[sl]
        t_b[sl] = torch.where(better, tmin, t_b[sl])
        tri_b[sl] = torch.where(better, (j + t0).to(torch.int32), tri_b[sl])
        u_b[sl] = torch.where(better, uh.gather(1, j[:, None])[:, 0], u_b[sl])
        v_b[sl] = torch.where(better, vh.gather(1, j[:, None])[:, 0], v_b[sl])
    return Hit(t_b, tri_b, u_b, v_b)


def _any(blocks, org):
    """(R,) bool: does any triangle of the _blocks occlude the ray."""
    occ = torch.zeros((org.shape[0],), dtype=torch.bool, device=org.device)
    for sl, _, res in blocks:
        occ[sl] |= torch.any(res[3], dim=1)
    return occ


def _row_blocks(rows, org, dirn, tnear, tfar):
    return _blocks(org.shape[0], rows.shape[0], lambda s, ts: _woop_block(
        rows[ts], org[s], dirn[s], tnear[s], tfar[s]))


def closest_rows(rows, org, dirn, tnear, tfar) -> Hit:
    """Closest hit of every ray against every packed row (T, 16)."""
    return _closest(_row_blocks(rows, org, dirn, tnear, tfar), org)


def any_rows(rows, org, dirn, tnear, tfar):
    """(R,) bool: does any packed row occlude the ray segment."""
    return _any(_row_blocks(rows, org, dirn, tnear, tfar), org)


def woop_rows(geom) -> torch.Tensor:
    """Packed (T, 16) rows from a reference-style geometry dict holding
    'woop' (4, 3T), 'ng' (T, 3) and 'cull' (T,)."""
    w = geom['woop']
    t = w.shape[1] // 3
    w = w.reshape(4, t, 3).permute(1, 0, 2).reshape(t, 12)
    return torch.cat([w, geom['ng'].to(torch.float32),
                      geom['cull'].to(torch.float32)[:, None]], dim=1)


def intersect_woop(geom, org, dirn, tnear, tfar) -> Hit:
    """Closest hit against all of geom's triangles (plain reference)."""
    return closest_rows(woop_rows(geom), org, dirn, tnear, tfar)


def occluded_woop(geom, org, dirn, tnear, tfar):
    """Any-hit against all of geom's triangles (plain reference)."""
    return any_rows(woop_rows(geom), org, dirn, tnear, tfar)


def _mt_block(v0, e1, e2, cull, valid, org, dirn, tnear, tfar,
              motion=None, time=None):
    """Moller-Trumbore of rays (Rc,) against a triangle block (Tc,), as
    the reference's `_mt_block`: (t, u, v, ok), each (Rc, Tc).  With
    motion = (mv0, me1, me2) and time (Rc,), vertices move linearly:
    v(t) = v + t * m."""
    o, d = org[:, None, :], dirn[:, None, :]
    v0b, e1b, e2b = v0[None], e1[None], e2[None]
    if motion is not None:
        tb = time[:, None, None]
        v0b = v0b + tb * motion[0][None]
        e1b = e1b + tb * motion[1][None]
        e2b = e2b + tb * motion[2][None]
    pvec = torch.linalg.cross(d, e2b)
    det = torch.sum(e1b * pvec, dim=-1)
    ng_dot_d = torch.sum(torch.linalg.cross(e1b, e2b) * d, dim=-1)
    cull_ok = torch.where(cull[None, :] == 1, ng_dot_d < 0.0, True)
    nz = torch.abs(det) > 1e-12
    inv_det = torch.where(nz, 1.0 / det, 0.0)
    tvec = o - v0b
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1b)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2b * qvec, dim=-1) * inv_det
    ok = (nz & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
          & (t > tnear[:, None]) & (t < tfar[:, None])
          & cull_ok & valid[None, :])
    return t, u, v, ok


def _brute_blocks(geom, org, dirn, tnear, tfar, time):
    """_blocks of _mt_block over a geom dict holding v0, e1, e2, cull,
    valid and, for a motion scene traced at `time`, mv0, me1, me2."""
    keys = ('mv0', 'me1', 'me2') if time is not None else ()

    def test(s, ts):
        return _mt_block(
            geom['v0'][ts], geom['e1'][ts], geom['e2'][ts],
            geom['cull'][ts], geom['valid'][ts],
            org[s], dirn[s], tnear[s], tfar[s],
            tuple(geom[k][ts] for k in keys) or None,
            None if time is None else time[s])
    return _blocks(org.shape[0], geom['v0'].shape[0], test)


def intersect_brute(geom, org, dirn, tnear, tfar, time=None) -> Hit:
    """Closest hit of each ray against all of geom's triangles (plain
    Moller-Trumbore; with `time`, the triangles at each ray's time)."""
    return _closest(_brute_blocks(geom, org, dirn, tnear, tfar, time), org)


def occluded_brute(geom, org, dirn, tnear, tfar, time=None):
    """(R,) bool any-hit against all of geom's triangles (see
    intersect_brute)."""
    return _any(_brute_blocks(geom, org, dirn, tnear, tfar, time), org)


def post_intersect(geom, org, dirn, hit: Hit):
    """Shading geometry at the hits (postIntersect): P, Ng, interpolated
    Ns, st, the epsilon scale 'error', material/light ids and masks, from
    one row gather of geom['shade_tab'] (T, 28).  Contents are undefined
    for misses except the masked ids."""
    valid = hit.valid
    idx = torch.clamp(hit.tri, min=0).to(torch.int64)
    p = org + hit.t[..., None] * dirn
    p = torch.where(valid[..., None], p, 0.0)
    tab = geom['shade_tab'][idx]                     # (R, 28)
    ng = tab[:, 0:3]
    vn = tab[:, 3:12].reshape(-1, 3, 3)
    uvs = tab[:, 12:18].reshape(-1, 3, 2)
    mat_id = torch.round(tab[:, 18]).to(torch.int64)
    light_id = torch.round(tab[:, 19]).to(torch.int64)
    illum = torch.round(tab[:, 20]).to(torch.int64)
    shadow = torch.round(tab[:, 21]).to(torch.int64)

    w = 1.0 - hit.u - hit.v
    ns = (w[..., None] * vn[:, 0] + hit.u[..., None] * vn[:, 1]
          + hit.v[..., None] * vn[:, 2])
    nlen = torch.sqrt(torch.clamp(torch.sum(ns * ns, dim=-1, keepdim=True),
                                  min=1e-20))
    ns = ns / nlen
    st = (w[..., None] * uvs[:, 0] + hit.u[..., None] * uvs[:, 1]
          + hit.v[..., None] * uvs[:, 2])
    # error estimate scaling the intersection epsilon: max(|P|, t)
    err = torch.maximum(torch.amax(torch.abs(p), dim=-1), torch.abs(hit.t))
    return {
        'P': p,
        'Ng': ng,
        'Ns': ns,
        'st': st,
        'error': torch.where(valid, err, 0.0),
        'mat_id': torch.where(valid, mat_id, 0),
        'light_id': torch.where(valid, light_id, -1),
        'illum_mask': torch.where(valid, illum, -1),
        'shadow_mask': torch.where(valid, shadow, -1),
        'Tx': tab[:, 22:25],
        'Ty': tab[:, 25:28],
    }
