"""Ray-triangle intersection: the plain Woop test and shading geometry.

Counterpart of `yulio_raytracer_tpu/ops/intersect.py`.  Triangles are
packed rows of 16 floats [woop (12) | ng (3) | cull] (`ops/wide.py`
`pack_tris`, the layout the reference's kernels read); the vectorized
Woop test over them is the plain version behind the dense kernels
(`ops/dense.py`) and, through `woop_rows`, the reference's CPU path
`intersect_woop` / `occluded_woop`.

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


def closest_rows(rows, org, dirn, tnear, tfar) -> Hit:
    """Closest hit of every ray against every packed row (T, 16)."""
    r, n = org.shape[0], rows.shape[0]
    rc, tc = _chunks(r, n)
    t_b = torch.full((r,), INF, dtype=torch.float32, device=org.device)
    tri_b = torch.full((r,), -1, dtype=torch.int32, device=org.device)
    u_b = torch.zeros((r,), dtype=torch.float32, device=org.device)
    v_b = torch.zeros((r,), dtype=torch.float32, device=org.device)
    for r0 in range(0, r, rc):
        sl = slice(r0, r0 + rc)
        for t0 in range(0, n, tc):
            th, uh, vh, ok = _woop_block(rows[t0:t0 + tc], org[sl], dirn[sl],
                                         tnear[sl], tfar[sl])
            th = torch.where(ok, th, INF)
            tmin, j = torch.min(th, dim=1)           # first index on ties
            better = tmin < t_b[sl]
            t_b[sl] = torch.where(better, tmin, t_b[sl])
            tri_b[sl] = torch.where(better, (j + t0).to(torch.int32),
                                    tri_b[sl])
            u_b[sl] = torch.where(better, uh.gather(1, j[:, None])[:, 0],
                                  u_b[sl])
            v_b[sl] = torch.where(better, vh.gather(1, j[:, None])[:, 0],
                                  v_b[sl])
    return Hit(t_b, tri_b, u_b, v_b)


def any_rows(rows, org, dirn, tnear, tfar):
    """(R,) bool: does any packed row occlude the ray segment."""
    r, n = org.shape[0], rows.shape[0]
    rc, tc = _chunks(r, n)
    occ = torch.zeros((r,), dtype=torch.bool, device=org.device)
    for r0 in range(0, r, rc):
        sl = slice(r0, r0 + rc)
        for t0 in range(0, n, tc):
            ok = _woop_block(rows[t0:t0 + tc], org[sl], dirn[sl], tnear[sl],
                             tfar[sl])[3]
            occ[sl] |= torch.any(ok, dim=1)
    return occ


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
