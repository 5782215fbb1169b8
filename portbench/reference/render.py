"""The plain reference path tracer: plain torch over the reference's own
tables (reference/scene.py), one path per (pixel, sample, seed), in any
float dtype.

Semantics, as the renderer under test defines them: stratified box-
filtered camera samples; the pinhole and StereoCube cameras; closest
hits by Moller-Trumbore over every triangle (barycentrics accepted to
32 ulps at 1.0, t strictly inside (tnear, tfar), ties to the lowest
triangle), culled by cluster boxes; shading normals interpolated and
faced forward; Lambertian, textured Lambertian (bilinear, wrapped) and
plastic lobes, one picked by luminance over pdf; next-event estimation
to every light, one shadow ray each: a triangle light at a point on
it, the dome (an ambient light) along a cosine-weighted direction;
under a shadow cap every shadow ray's length is the cap, jittered by
+-15% and lengthened by up to 100 caps below the horizon; emission of
a light seen, and the dome's radiance along an escaped ray, unless the
last bounce sampled a diffuse lobe; Russian roulette from bounce
rr_depth - 1; paths below the minimum contribution stop.  Random numbers per (seed, pixel,
sample, dimension) with the renderer's dimension layout.  No object of
the program is read.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .scene import LAMBERT_TEX, PLASTIC, PLASTIC_ETA, PLASTIC_ROUGHNESS

ULP = 1.1920929e-7
EPSILON = 32.0 * ULP
BARY_EPS = float(32 * np.finfo(np.float32).eps)
MIN_CONTRIBUTION = 0.02
RR_DEPTH = 5
UP = (0.0, 1.0, 0.0)
SHADOW_JITTER = 0.15
ONE_OVER_PI = float(1.0 / np.pi)
TWO_PI = float(2.0 * np.pi)
ONE_OVER_TWO_PI = float(1.0 / (2.0 * np.pi))
# lobe slots and type bits
SLOTS = 4
NONE, LAMB, LAYER, MICROFACET = 0, 1, 4, 12
DIFFUSE_REFLECTION, GLOSSY_REFLECTION = 0x1, 0x10
EYE_SEPARATION = 6.35 * 0.393701
FALLOFF_ANGLE = 30.0


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps=1e-20):
    return a / torch.clamp(length(a), min=eps)[..., None]


def clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# ------------------------------------------------------------------ cameras

def _np_normalize(v):
    return v / max(float(np.linalg.norm(v)), 1e-20)


def look_at(eye, point, up):
    """(4, 3) float64 rows [vx; vy; vz; eye]."""
    eye = np.asarray(eye, np.float64)
    z = _np_normalize(np.asarray(point, np.float64) - eye)
    u = _np_normalize(np.cross(np.asarray(up, np.float64), z))
    v = _np_normalize(np.cross(z, u))
    return np.stack([u, v, z, eye])


def pixel_to_world(l2w, angle_deg, aspect):
    w = (-0.5 * aspect * l2w[0] - 0.5 * l2w[1]
         + 0.5 / np.tan(np.deg2rad(0.5 * angle_deg)) * l2w[2])
    return np.stack([aspect * l2w[0], l2w[1], w, l2w[3]])


def _compose(a, b):
    """a after b, for (4, 3) row affines."""
    return np.concatenate([b[:3] @ a[:3], (b[3] @ a[:3] + a[3])[None]])


def _rotate(center, axis, angle):
    x, y, z = _np_normalize(np.asarray(axis, np.float64))
    c, s = np.cos(angle), np.sin(angle)
    lin = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) + z * s, x * z * (1 - c) - y * s],
        [y * x * (1 - c) - z * s, c + y * y * (1 - c), y * z * (1 - c) + x * s],
        [z * x * (1 - c) + y * s, z * y * (1 - c) - x * s, c + z * z * (1 - c)]])

    def move(t):
        return np.concatenate([np.eye(3), np.asarray(t, np.float64)[None]])
    rot = np.concatenate([lin, np.zeros((1, 3))])
    return _compose(_compose(move(center), rot), move(-np.asarray(center)))


def _sign(x):
    return torch.where(x < 0.0, -1.0, 1.0).to(x.dtype)


def _rotate_about(v, u, angle):
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    ub = u.expand(v.shape)
    return v * c + cross(ub, v) * s + ub * (dot(ub, v) * (1.0 - c[..., 0]))[
        ..., None]


def camera_rays(spec, uv, width, height):
    """(org, dir) of the camera rays through film points uv (R, 2) in
    [0, 1)^2, in uv's dtype: a pinhole, or a side face (0-3) of a
    StereoCube rig, its eye offset falling off above 30 degrees."""
    dt, dev = uv.dtype, uv.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dt)

    l2w = look_at(spec['eye'], spec['look'], spec['up'])
    px, ypix = uv[:, 0], 1.0 - uv[:, 1]
    if spec['kind'] == 'pinhole':
        p2w = t(pixel_to_world(l2w, spec['fov'], width / height))
        d = px[:, None] * p2w[0] + ypix[:, None] * p2w[1] + p2w[2]
        return p2w[3].expand(d.shape), normalize(d)
    if spec['kind'] != 'stereo_cube':
        raise ValueError(f"unknown camera kind {spec['kind']!r}")
    index = int(spec['face'])
    face = index % 6
    origin, up = l2w[3], np.asarray(UP, np.float64)
    front = pixel_to_world(l2w, 90.0, 1.0)

    def rot(axis, deg, m):
        return _compose(_rotate(origin, axis, np.deg2rad(deg)), m)
    if face >= 4:
        raise ValueError("the reference has the four side faces only")
    p2w = front if face == 0 else rot(up, (90.0, 180.0, -90.0)[face - 1],
                                      front)
    p2w, fr = t(p2w), t(front)
    straight = normalize(0.5 * fr[0] + 0.5 * fr[1] + fr[2])
    xdir = normalize(px[:, None] * fr[0] + 0.5 * fr[1] + fr[2])
    theta = torch.arccos(torch.clamp(dot(xdir, straight), -1.0, 1.0)) \
        * _sign(px - 0.5)
    ydir = normalize(0.5 * fr[0] + ypix[:, None] * fr[1] + fr[2])
    vert = torch.abs(torch.rad2deg(torch.arccos(torch.clamp(
        dot(ydir, straight), -1.0, 1.0))) * _sign(ypix - 0.5))
    scale = spec['scene_scale']
    off = EYE_SEPARATION * scale * (-0.5 if index < 6 else 0.5)
    fall = 1.0 - smoothstep(0.0, 1.0, smoothstep(FALLOFF_ANGLE, 90.0, vert))
    off = torch.where(vert > FALLOFF_ANGLE, off * fall,
                      torch.full_like(vert, off))
    p_eye = p2w[3] + off[:, None] * p2w[0]
    org = t(origin) + _rotate_about(p_eye - t(origin), t(_np_normalize(up)),
                                    theta)
    d = px[:, None] * p2w[0] + ypix[:, None] * p2w[1] + p2w[2]
    return org, normalize(d)


def grid_dims(spp: int):
    a = int(np.floor(np.sqrt(spp)))
    while a > 1 and spp % a != 0:
        a -= 1
    return a, spp // a


def film_points(seed, pid, sid, spp, width, height, dtype):
    """Each sample's point on the film: sample j of a pixel in stratum j
    of an a x b grid under a per-pixel scramble, jittered; the box
    filter."""
    a, b = grid_dims(spp)
    n = a * b
    scramble = rng.key(pid, 0, seed, 0x9E3779B9)
    s = ((sid + scramble) & rng.MASK) % n
    jit = rng.uniform2(seed, pid, sid, 0, dtype)
    u = ((s % a).to(dtype) + jit[:, 0]) * float(np.float32(1.0 / a))
    v = ((s // a).to(dtype) + jit[:, 1]) * float(np.float32(1.0 / b))
    px = (pid % width).to(dtype)
    py = (pid // width).to(dtype)
    return torch.stack([(px + u) / width, (py + v) / height], dim=-1)


# ----------------------------------------------------------- intersection

def _budget(device):
    return 1 << (24 if torch.device(device).type == 'cuda' else 18)


def _cluster_pairs(sc, org, dirn, tnear, tfar):
    """(ray, cluster) index pairs whose cluster box the ray segment
    meets (a slab test; the boxes are padded, so it never misses)."""
    lo, hi = sc['cluster_lo'], sc['cluster_hi']
    k = lo.shape[0]
    big = torch.full_like(dirn, 1e30)
    inv = torch.where(dirn == 0.0, torch.copysign(big, dirn), 1.0 / dirn)
    rc = max(1, _budget(org.device) // (4 * k))
    rays, clusters = [], []
    for r0 in range(0, org.shape[0], rc):
        o, iv = org[r0:r0 + rc, None, :], inv[r0:r0 + rc, None, :]
        t0 = (lo[None] - o) * iv
        t1 = (hi[None] - o) * iv
        near = torch.amax(torch.minimum(t0, t1), dim=-1)
        far = torch.amin(torch.maximum(t0, t1), dim=-1)
        near = torch.maximum(near, tnear[r0:r0 + rc, None])
        far = torch.minimum(far, tfar[r0:r0 + rc, None])
        r, c = torch.nonzero(near <= far, as_tuple=True)
        rays.append(r + r0)
        clusters.append(c)
    return torch.cat(rays), torch.cat(clusters)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of paired rays and triangles, all (N, 3):
    (t, u, v, det_ok)."""
    pv = cross(d, e2)
    det = dot(e1, pv)
    nz = torch.abs(det) > 1e-12
    inv = torch.where(nz, 1.0 / det, torch.zeros_like(det))
    tv = o - v0
    u = dot(tv, pv) * inv
    qv = cross(tv, e1)
    v = dot(d, qv) * inv
    t = dot(e2, qv) * inv
    return t, u, v, nz


def _tests(sc, org, dirn, tnear, tfar, rays, clusters):
    """Every (ray, triangle) test of the pairs, in chunks: yields (ray
    index, triangle index, t, ok)."""
    width = sc['cluster_tris'].shape[1]
    pc = max(1, _budget(org.device) // width)
    for p0 in range(0, rays.shape[0], pc):
        tri = sc['cluster_tris'][clusters[p0:p0 + pc]].reshape(-1)
        ray = rays[p0:p0 + pc, None].expand(-1, width).reshape(-1)
        keep = tri >= 0
        tri, ray = tri[keep], ray[keep]
        t, u, v, nz = _mt(org[ray], dirn[ray], sc['v0'][tri], sc['e1'][tri],
                          sc['e2'][tri])
        ok = (nz & (u >= -BARY_EPS) & (v >= -BARY_EPS)
              & (u + v <= 1.0 + BARY_EPS) & (t > tnear[ray])
              & (t < tfar[ray]) & sc['valid'][tri])
        yield ray, tri, t, ok


def closest(sc, org, dirn, tnear, tfar):
    """(t, tri, u, v) of each ray's nearest hit (tri -1 on a miss), the
    lowest triangle among equal t."""
    r, dev = org.shape[0], org.device
    best = torch.full((r,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=dev)
    rays, clusters = _cluster_pairs(sc, org, dirn, tnear, tfar)
    for ray, tri, t, ok in _tests(sc, org, dirn, tnear, tfar, rays,
                                  clusters):
        # t > tnear >= 0, so a positive float's bits order as the float
        bits = t.to(torch.float32).view(torch.int32).to(torch.int64)
        k = torch.where(ok, (bits << 32) | tri, best.new_tensor(
            torch.iinfo(torch.int64).max))
        best.scatter_reduce_(0, ray, k, reduce='amin')
    hit = best != torch.iinfo(torch.int64).max
    tri = torch.where(hit, best & 0xFFFFFFFF, -1)
    safe = torch.clamp(tri, min=0)
    t, u, v, _ = _mt(org, dirn, sc['v0'][safe], sc['e1'][safe],
                     sc['e2'][safe])
    return t, tri, u, v


def occluded(sc, org, dirn, tnear, tfar):
    """(R,) bool: does any triangle meet the ray segment."""
    occ = torch.zeros((org.shape[0],), dtype=torch.bool, device=org.device)
    rays, clusters = _cluster_pairs(sc, org, dirn, tnear, tfar)
    for ray, _, _, ok in _tests(sc, org, dirn, tnear, tfar, rays, clusters):
        occ[ray[ok]] = True
    return occ


# ------------------------------------------------------------------ shading

def fresnel(cosi, eta):
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    cost = torch.sqrt(torch.clamp(k, min=0.0))
    rper = (eta * cosi - cost) / torch.clamp(eta * cosi + cost, min=1e-20)
    rpar = (cosi - eta * cost) / torch.clamp(cosi + eta * cost, min=1e-20)
    f = 0.5 * (rpar * rpar + rper * rper)
    return (torch.where(tir, torch.ones_like(f), f),
            torch.where(tir, torch.zeros_like(cost), cost))


def refract(v, n, eta, cos_i):
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    cos_t = torch.sqrt(torch.clamp(k, min=0.0))
    d = eta[..., None] * (cos_i[..., None] * n - v) - cos_t[..., None] * n
    return torch.where(ok[..., None], d, torch.zeros_like(d)), ok, cos_t


def to_world(n, local):
    """local (x, y, z) in the frame around unit n whose helper axis is
    n's smallest component (the first of equals)."""
    helper = torch.eye(3, dtype=n.dtype, device=n.device)[
        torch.argmin(torch.abs(n), dim=-1)]
    dx = normalize(cross(helper, n))
    dy = cross(n, dx)
    return local[..., 0:1] * dx + local[..., 1:2] * dy + local[..., 2:3] * n


def _hemisphere(phi, cos_t, sin_t, n):
    return to_world(n, torch.stack([torch.cos(phi) * sin_t,
                                    torch.sin(phi) * sin_t, cos_t], -1))


def texel(sc, tex, st):
    """Bilinear, wrapped lookup of texture ids tex (R,) at st (R, 2):
    (R, 3) rgb."""
    off, w, h = sc['tex_off'][tex], sc['tex_w'][tex], sc['tex_h'][tex]
    dt = st.dtype
    s = st[:, 0] - torch.floor(st[:, 0])
    t = st[:, 1] - torch.floor(st[:, 1])
    u = s * w.to(dt) - 0.5
    v = t * h.to(dt) - 0.5
    x0 = torch.minimum(torch.clamp(torch.floor(u).long(), min=0),
                       torch.clamp(w - 2, min=0))
    y0 = torch.minimum(torch.clamp(torch.floor(v).long(), min=0),
                       torch.clamp(h - 2, min=0))
    ur = (u - x0.to(dt))[:, None]
    vr = (v - y0.to(dt))[:, None]
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)

    def at(x, y):
        return sc['tex_data'][off + y * w + x]
    c = ((at(x0, y0) * (1 - ur) + at(x1, y0) * ur) * (1 - vr)
         + (at(x0, y1) * (1 - ur) + at(x1, y1) * ur) * vr)
    return c[:, :3]


def lobes(sc, mat, st):
    """Each hit's lobe slots: type (R, 4), color (R, 4, 3), eta, exp."""
    r, dev, dt = mat.shape[0], mat.device, sc['mat_color'].dtype
    kind = sc['mat_kind'][mat]
    color = sc['mat_color'][mat]
    tex = sc['mat_tex'][mat]
    textured = kind == LAMBERT_TEX
    if bool(textured.any()):
        rgb = texel(sc, torch.clamp(tex, min=0), st)
        color = torch.where(textured[:, None], color * rgb, color)
    plastic = kind == PLASTIC
    types = torch.zeros((r, SLOTS), dtype=torch.int64, device=dev)
    types[:, 0] = torch.where(plastic, LAYER, LAMB)
    types[:, 1] = torch.where(plastic, MICROFACET, NONE)
    colors = torch.zeros((r, SLOTS, 3), dtype=dt, device=dev)
    colors[:, 0] = color
    colors[:, 1] = torch.where(plastic[:, None], 1.0, 0.0).to(dt)
    eta = torch.where(plastic[:, None] & (types > 0),
                      float(np.float32(1.0 / PLASTIC_ETA)), 1.0).to(dt)
    exp = torch.where(types == MICROFACET,
                      float(np.float32(1.0 / PLASTIC_ROUGHNESS)), 0.0).to(dt)
    return types, colors, eta, exp


def eval_diffuse(types, colors, eta, ns, wo, wi):
    """The diffuse lobes' eval summed, (R, 3): Lambertian and the
    layered Lambertian (one slot each)."""
    cos_i = dot(wi, ns)[:, None].expand(types.shape)
    cos_o = dot(wo, ns)[:, None].expand(types.shape)
    f_lam = ONE_OVER_PI * clamp01(cos_i)
    fo, _ = fresnel(clamp01(cos_o), eta)
    fi, cos_i1 = fresnel(clamp01(cos_i), eta)
    f_layer = (1.0 - fo) * (1.0 - fi) * ONE_OVER_PI * cos_i1
    f_layer = torch.where((cos_i > 0.0) & (cos_o > 0.0), f_layer,
                          torch.zeros_like(f_layer))
    f = torch.where(types == LAMB, f_lam, torch.where(
        types == LAYER, f_layer, torch.zeros_like(f_lam)))
    return torch.sum(colors * f[..., None], dim=-2)


def sample_lobe(types, colors, eta, exp, ns, ng, wo, s2, s1):
    """Every slot sampled with s2, one picked with s1 by luminance over
    pdf: (wi, pdf, weight (R, 3), diffuse-sampled, valid)."""
    shape = types.shape
    nsb = ns[:, None, :].expand(shape + (3,))
    wob = wo[:, None, :].expand(shape + (3,))
    u = s2[:, None, 0].expand(shape)
    v = s2[:, None, 1].expand(shape)
    cos_o = dot(wob, nsb)
    cos_o_c = clamp01(cos_o)
    # cosine family: the Lambertian, and the layer's refracted sample
    cos_t = torch.sqrt(torch.clamp(v, min=0.0))
    wi_cos = _hemisphere(TWO_PI * u, cos_t,
                         torch.sqrt(torch.clamp(1.0 - v, min=0.0)), nsb)
    pdf_cos = cos_t * ONE_OVER_PI
    f_lam = ONE_OVER_PI * clamp01(dot(wi_cos, nsb))
    fo, _ = fresnel(cos_o_c, eta)
    cos_i1 = dot(wi_cos, nsb)
    wi_out, ok_out, cos_out = refract(
        wi_cos, -nsb, 1.0 / torch.clamp(eta, min=1e-6), clamp01(cos_i1))
    fi, _ = fresnel(clamp01(cos_out), eta)
    f_layer = (1.0 - fo) * (1.0 - fi) * ONE_OVER_PI * clamp01(cos_i1)
    f_layer = torch.where(ok_out & (cos_o > 0.0), f_layer,
                          torch.zeros_like(f_layer))
    # microfacet dielectric: a power-cosine half vector, reflected
    ch = torch.pow(torch.clamp(v, min=1e-30), 1.0 / (exp + 1.0))
    wh = _hemisphere(TWO_PI * u, ch,
                     torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0)), nsb)
    pdf_h = (exp + 1.0) * torch.pow(ch, exp) * ONE_OVER_TWO_PI
    cos_owh = dot(wob, wh)
    wi_mf = 2.0 * cos_owh[..., None] * wh - wob
    pdf_mf = pdf_h / torch.clamp(4.0 * torch.abs(cos_owh), min=1e-12)
    cos_i_mf = dot(wi_mf, nsb)
    cos_h = dot(wh, nsb)
    d_mf = (exp + 2.0) * ONE_OVER_TWO_PI * torch.pow(
        torch.clamp(torch.abs(cos_h), min=1e-20), exp)
    g_mf = torch.clamp(torch.minimum(
        2.0 * cos_h * cos_o_c / torch.clamp(cos_owh, min=1e-12),
        2.0 * cos_h * clamp01(cos_i_mf) / torch.clamp(cos_owh, min=1e-12)),
        max=1.0)
    fr, _ = fresnel(clamp01(cos_owh), eta)
    w_mf = fr[..., None] * (d_mf * g_mf / torch.clamp(
        4.0 * cos_o_c, min=1e-12))[..., None]
    mf_ok = ((cos_i_mf > 0.0) & (cos_o > 0.0)
             & (dot(wi_mf, ng[:, None, :].expand(shape + (3,))) > 0.0))
    w_mf = torch.where(mf_ok[..., None], w_mf, torch.zeros_like(w_mf))

    is_lam, is_layer = types == LAMB, types == LAYER
    is_mf = types == MICROFACET
    wi = torch.where(is_layer[..., None], wi_out,
                     torch.where(is_mf[..., None], wi_mf, wi_cos))
    pdf = torch.where(is_lam | is_layer, pdf_cos,
                      torch.where(is_mf, pdf_mf, torch.zeros_like(pdf_mf)))
    c = torch.where(is_lam[..., None], colors * f_lam[..., None],
                    torch.where(is_layer[..., None],
                                colors * f_layer[..., None],
                                torch.where(is_mf[..., None], colors * w_mf,
                                            torch.zeros_like(w_mf))))
    lum = torch.sum(c, dim=-1)
    good = (types != NONE) & (lum > 0.0) & (pdf > 0.0)
    f_w = torch.where(good, lum / torch.clamp(pdf, min=1e-20),
                      torch.zeros_like(lum))
    total = torch.sum(f_w, dim=-1, keepdim=True)
    probs = f_w / torch.clamp(total, min=1e-30)
    cdf = probs[:, 0]
    pick = (cdf < s1).to(torch.int64)
    for k in range(1, SLOTS):
        cdf = cdf + probs[:, k]
        pick = pick + (cdf < s1)
    pick = torch.clamp(pick, max=SLOTS - 1)[:, None]
    bits = torch.where(is_lam | is_layer, DIFFUSE_REFLECTION,
                       torch.where(is_mf, GLOSSY_REFLECTION, 0))
    return (torch.gather(wi, 1, pick[..., None].expand(-1, 1, 3))[:, 0],
            torch.gather(pdf, 1, pick)[:, 0] * torch.gather(probs, 1,
                                                            pick)[:, 0],
            torch.gather(c, 1, pick[..., None].expand(-1, 1, 3))[:, 0],
            (torch.gather(bits, 1, pick)[:, 0] & DIFFUSE_REFLECTION) != 0,
            (total[:, 0] > 0.0) & torch.gather(good, 1, pick)[:, 0])


def _sample_light(light, p, ns, u2):
    """(le, wi, pdf, tmax) of one sample u2 (R, 2) of a light seen from
    points p with shading normals ns."""
    if light['kind'] == 'ambient':
        cos_t = torch.sqrt(torch.clamp(u2[:, 1], min=0.0))
        sin_t = torch.sqrt(torch.clamp(1.0 - u2[:, 1], min=0.0))
        wi = _hemisphere(TWO_PI * u2[:, 0], cos_t, sin_t, ns)
        # the dome's own tmax (the scene's bounding sphere) is not
        # reproduced: trace() takes the dome under a shadow cap only
        return (light['L'].expand(p.shape), wi, cos_t * ONE_OVER_PI,
                torch.full_like(cos_t, float('inf')))
    a, b, c = light['v0'], light['v1'], light['v2']
    su = torch.sqrt(torch.clamp(u2[:, 0], min=0.0))[:, None]
    q = c + (1.0 - su) * (a - c) + (u2[:, 1:2] * su) * (b - c)
    d = q - p
    tmax = length(d)
    d_ng = dot(d, light['Ng'])
    wi = d / torch.clamp(tmax, min=1e-20)[:, None]
    pdf = 2.0 * tmax ** 3 / torch.clamp(torch.abs(d_ng), min=1e-20)
    le = torch.where((d_ng < 0.0)[:, None], light['L'].expand(d.shape),
                     torch.zeros_like(d))
    return le, wi, pdf, tmax


def _shadow_cap(cap, u, wi):
    """The shadow ray's length under the cap: jittered by u, lengthened
    by up to 100 caps where wi points at or below the horizon."""
    tmax = cap + (2.0 * cap * SHADOW_JITTER * u - cap * SHADOW_JITTER)
    dot_up = dot(wi, torch.tensor(UP, dtype=wi.dtype, device=wi.device))
    return tmax + torch.where(
        dot_up <= 0.0, cap * 100.0 * smoothstep(0.0, 1.0, torch.abs(dot_up)),
        torch.zeros_like(tmax))


# --------------------------------------------------------------------- paths

def _dims(n_lights: int):
    """(first light dimension, dimensions a bounce) of the layout."""
    if n_lights <= 5:
        return 8, 16
    return 3 + n_lights, 3 + 2 * n_lights


def trace(sc, traffic: dict, cam: dict, seed, pid, sid):
    """Radiance (R, 3) float32 of the paths of samples sid (R,) of pixels
    pid (R,) under render seeds seed (R,), all int64."""
    dt, dev = sc['dtype'], sc['device']
    width, height = traffic['width'], traffic['height']
    max_depth = traffic['max_depth']
    if traffic.get('pixel_filter', 'box') != 'box':
        raise ValueError("the reference samples the box filter only")
    cap = traffic.get('t_max_shadow_ray')
    n = pid.shape[0]
    uv = film_points(seed, pid, sid, traffic['spp'], width, height, dt)
    org, dirn = camera_rays(cam, uv, width, height)
    lights = sc['lights']
    dome = [l['L'] for l in lights if l['kind'] == 'ambient']
    if dome and cap is None:
        raise ValueError("the reference takes the dome under a shadow cap "
                         "only")
    dim_light, stride = _dims(len(lights))
    out = torch.zeros((n, 3), dtype=dt, device=dev)
    lane = {'org': org, 'dir': dirn, 'thr': torch.ones_like(org),
            'L': torch.zeros_like(org),
            'ignore': torch.zeros((n,), dtype=torch.bool, device=dev),
            'rid': torch.arange(n, device=dev),
            'seed': seed, 'pid': pid, 'sid': sid}
    for depth in range(max_depth):
        live = torch.amax(lane['thr'], dim=-1) >= MIN_CONTRIBUTION
        lane = {k: v[live] for k, v in lane.items()}
        m = lane['rid'].shape[0]
        if m == 0:
            break
        s, p_id, s_id = lane['seed'], lane['pid'], lane['sid']
        base = (stride + stride * depth) & rng.MASK
        org, dirn, thr, L = lane['org'], lane['dir'], lane['thr'], lane['L']
        t, tri, bu, bv = closest(sc, org, dirn,
                                 torch.zeros((m,), dtype=dt, device=dev),
                                 torch.full((m,), float('inf'), dtype=dt,
                                            device=dev))
        hit = tri >= 0
        if dome:
            # escaped rays see the dome unless a diffuse lobe sent them
            seen = ~hit & ~lane['ignore']
            out.index_copy_(0, lane['rid'][~hit], (L + torch.where(
                seen[:, None], thr * sum(dome), torch.zeros_like(thr)))[~hit])
        lane = {k: v[hit] for k, v in lane.items()}
        t, tri, bu, bv = t[hit], tri[hit], bu[hit], bv[hit]
        s, p_id, s_id = s[hit], p_id[hit], s_id[hit]
        org, dirn, thr, L = org[hit], dirn[hit], thr[hit], L[hit]
        m = tri.shape[0]
        if m == 0:
            break
        p = org + t[:, None] * dirn
        ng = sc['ng'][tri]
        vn = sc['vn'][tri]
        w = (1.0 - bu - bv)[:, None]
        ns = w * vn[:, 0] + bu[:, None] * vn[:, 1] + bv[:, None] * vn[:, 2]
        ns = ns / torch.sqrt(torch.clamp(torch.sum(ns * ns, -1, keepdim=True),
                                         min=1e-20))
        uvt = sc['uv'][tri]
        st = w * uvt[:, 0] + bu[:, None] * uvt[:, 1] + bv[:, None] * uvt[:, 2]
        err = torch.maximum(torch.amax(torch.abs(p), dim=-1), torch.abs(t))
        back = dot(ng, dirn) > 0.0
        ng = torch.where(back[:, None], -ng, ng)
        ns = torch.where(back[:, None], -ns, ns)
        wo = -dirn
        types, colors, eta, exp = lobes(sc, sc['mat_id'][tri], st)

        # emission of a light seen from its front, unless the last bounce
        # sampled a diffuse lobe
        lid = sc['light_id'][tri]
        for li, light in enumerate(lights):
            if light['kind'] != 'triangle':
                continue
            seen = (lid == li) & ~back & ~lane['ignore']
            L = L + torch.where(seen[:, None], thr * light['L'],
                                torch.zeros_like(thr))

        # next-event estimation: one shadow ray to every light
        err_eps = err * EPSILON
        cands, contribs, wis, tfars = [], [], [], []
        for li, light in enumerate(lights):
            u2 = rng.uniform2(s, p_id, s_id, (base + dim_light + li)
                              & rng.MASK, dt)
            le, wi, pdf, tmax = _sample_light(light, p, ns, u2)
            if cap is not None:
                tmax = _shadow_cap(cap, rng.uniform1(
                    s, p_id, s_id, (base + 3 + li) & rng.MASK, dt), wi)
            brdf = eval_diffuse(types, colors, eta, ns, wo, wi)
            cand = ((pdf > 0.0) & torch.any(le > 0.0, dim=-1)
                    & torch.any(brdf > 0.0, dim=-1))
            cands.append(cand)
            contribs.append(thr * le * brdf
                            / torch.clamp(pdf, min=1e-20)[:, None])
            wis.append(wi)
            tfars.append(tmax - err_eps)
        if lights:
            cand = torch.stack(cands)
            ci = torch.nonzero(cand.reshape(-1), as_tuple=True)[0]
            occ = torch.zeros_like(cand.reshape(-1))
            rows = ci % m
            occ[ci] = occluded(sc, p[rows], torch.cat(wis)[ci], err_eps[rows],
                               torch.cat(tfars)[ci])
            lit = cand & ~occ.reshape(cand.shape)
            L = L + torch.sum(torch.where(lit[..., None], torch.stack(contribs),
                                          torch.zeros_like(contribs[0])),
                              dim=0)
        out.index_copy_(0, lane['rid'], L)

        # continue: depth, roulette, one sampled lobe
        cont = torch.full((m,), depth < max_depth - 1, device=dev)
        if depth >= RR_DEPTH - 1:
            q = torch.clamp(torch.amax(thr, dim=-1), max=0.95)
            rr_u = rng.uniform1(s, p_id, s_id, (base + 2) & rng.MASK, dt)
            cont = cont & ~(rr_u >= q)
            rr_scale = 1.0 / torch.clamp(q, min=1e-3)
        else:
            rr_scale = torch.ones((m,), dtype=dt, device=dev)
        s2 = rng.uniform2(s, p_id, s_id, base & rng.MASK, dt)
        s1 = rng.uniform1(s, p_id, s_id, (base + 1) & rng.MASK, dt)
        wi, pdf, weight, diffuse, ok = sample_lobe(types, colors, eta, exp,
                                                   ns, ng, wo, s2, s1)
        cont = cont & ok & (pdf > 0.0) & torch.any(weight > 0.0, dim=-1)
        lane['thr'] = thr * (weight / torch.clamp(pdf, min=1e-20)[:, None]) \
            * rr_scale[:, None]
        lane['org'] = p + wi * err_eps[:, None]
        lane['dir'] = wi
        lane['L'] = L
        lane['ignore'] = diffuse
        lane = {k: v[cont] for k, v in lane.items()}
    return out.to(torch.float32)
