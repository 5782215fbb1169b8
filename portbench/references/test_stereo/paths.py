"""The stereo field's paths: plain torch over tables.py's tables, one
path per (pixel, sample, seed), in any float dtype.

Semantics, as the renderer under test defines them, where they go
beyond portbench/reference/render.py's:
  film points  the b-spline filter as the stateless sampler draws it:
               the stratified point (dimension 0) plus three uniform
               pairs at dimensions 0 ^ 0x5F375A86, 0 ^ 0x2545F491 and
               0 ^ 0x9E3779B9, minus 2 and offset by half a pixel (the
               cubic B-spline as four unit boxes convolved); a sample
               may land up to 1.5 pixels past its pixel and keeps unit
               weight in its own pixel
  lobes        each slot's colour from the texel at ds * st + s0 by its
               mode (tables.py); every slot sampled with one 2D number
               and one picked by luminance over pdf: the cosine family
               (Lambertian, layer), the delta dielectric reflection
               (Fresnel weight, pdf 1), the straight transmission (its
               colour, pdf 1) and the microfacet dielectric; only the
               diffuse ones are evaluated for the light samples, and a
               diffuse pick hides the environment from the next bounce
  lights       in the description's order, light k on RNG dimensions
               base + 8 + k (its sample) and base + 3 + k (its shadow
               jitter): the HDRI by its 2D distribution (the bucket of u
               among the cdf's entries <= u, linear inside it; the texel
               under the sample, times L; pdf the distribution's over
               2 pi^2 sin(theta)), the dome by a cosine-weighted
               direction; every shadow ray capped
  escaped rays the HDRI's bilinear lat-long lookup (wrapped in x) times
               L, plus the dome's radiance
Departures from the published renderer, shared with the port: the
shadow cap replaces every light's ray length, the HDRI's too; the
HDRI's NEE reads the texel under the sample (no filter) while its
escaped rays read it bilinearly, as hdrilight.cpp does.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import render as plain
from portbench.reference import rng

from .tables import (CONST_TRANSMIT, DIEL_REFLECT, DIFFUSE_REFLECTION,
                     GLOSSY_REFLECTION, LAMB, LAYER, MICROFACET, NONE,
                     SPECULAR_REFLECTION, SPECULAR_TRANSMISSION,
                     TEX_MUL_RGB, TEX_UBER_ALPHA, TEX_UBER_DIFFUSE,
                     TEX_UBER_OPACITY)

PI = float(np.pi)
TWO_PI = float(2.0 * np.pi)
ONE_OVER_PI = float(1.0 / np.pi)
ONE_OVER_TWO_PI = float(1.0 / (2.0 * np.pi))
RR_DEPTH = 5
# the b-spline's extra draws, as XORs of the camera's dimension 0
BSPLINE_SALTS = (0x5F375A86, 0x2545F491, 0x9E3779B9)
dot, normalize, clamp01 = plain.dot, plain.normalize, plain.clamp01


# ------------------------------------------------------------------ camera

def film_points(seed, pid, sid, spp, width, height, dtype,
                pixel_filter='bspline'):
    """Each sample's point on the film: the box filter's as
    reference/render.py draws it, or the b-spline's."""
    if pixel_filter == 'box':
        return plain.film_points(seed, pid, sid, spp, width, height, dtype)
    if pixel_filter != 'bspline':
        raise ValueError(f"unknown pixel filter {pixel_filter!r}")
    a, b = plain.grid_dims(spp)
    scramble = rng.key(pid, 0, seed, 0x9E3779B9)
    s = ((sid + scramble) & rng.MASK) % (a * b)
    jit = rng.uniform2(seed, pid, sid, 0, dtype)
    u = ((s % a).to(dtype) + jit[:, 0]) * float(np.float32(1.0 / a))
    v = ((s // a).to(dtype) + jit[:, 1]) * float(np.float32(1.0 / b))
    box = torch.stack([u, v], dim=-1)
    e1, e2, e3 = (rng.uniform2(seed, pid, sid, salt, dtype)
                  for salt in BSPLINE_SALTS)
    juv = 0.5 + (box + e1 + e2 + e3) - 2.0
    px = (pid % width).to(dtype)
    py = (pid // width).to(dtype)
    return torch.stack([(px + juv[:, 0]) / width, (py + juv[:, 1]) / height],
                       dim=-1)


def camera_rays(spec, uv, width, height):
    """reference/render.py's StereoCube side faces, whose eye separation
    is the rig's default and which turn no eye in: the configuration's
    camera must be such a face."""
    if spec['kind'] == 'stereo_cube' and (
            spec.get('toe_in', False)
            or spec.get('eye_separation', plain.EYE_SEPARATION)
            != plain.EYE_SEPARATION
            or tuple(spec['up']) != plain.UP):
        raise ValueError("the reference's stereo faces have the default "
                         "eye separation, no toe-in and up (0, 1, 0)")
    return plain.camera_rays(spec, uv, width, height)


# ------------------------------------------------------------------ shading

def texel4(sc, tex, st):
    """Bilinear, wrapped lookup of texture ids tex (R,) at st (R, 2):
    (R, 4) rgba (reference/render.py's texel, with alpha)."""
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
    return ((at(x0, y0) * (1 - ur) + at(x1, y0) * ur) * (1 - vr)
            + (at(x0, y1) * (1 - ur) + at(x1, y1) * ur) * vr)


def lobes(sc, mat, st):
    """Each hit's lobe slots: type (R, 4), colour (R, 4, 3), eta, exp."""
    types = sc['lobe_type'][mat]
    base = sc['lobe_color'][mat]
    tex = sc['lobe_tex'][mat]
    mode = sc['lobe_mode'][mat]
    uv = sc['mat_ds'][mat] * st + sc['mat_s0'][mat]
    colors = []
    for k in range(types.shape[1]):
        c = base[:, k]
        if bool((mode[:, k] != 0).any()):
            has = (tex[:, k] >= 0)[:, None]
            rgba = torch.where(has, texel4(sc, torch.clamp(tex[:, k], min=0),
                                           uv), torch.ones_like(c[:, :1]))
            rgb, a = rgba[:, :3], rgba[:, 3:4]
            for m, val in ((TEX_MUL_RGB, c * rgb), (TEX_UBER_ALPHA, c * a),
                           (TEX_UBER_OPACITY, 1.0 - a),
                           (TEX_UBER_DIFFUSE, torch.where(has, rgb, c) * a)):
                c = torch.where((mode[:, k] == m)[:, None], val, c)
        colors.append(c)
    return (types, torch.stack(colors, dim=1), sc['lobe_eta'][mat],
            sc['lobe_exp'][mat])


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
    # the cosine family: the Lambertian, and the layer's refracted sample
    cos_t = torch.sqrt(torch.clamp(v, min=0.0))
    wi_cos = plain._hemisphere(TWO_PI * u, cos_t,
                               torch.sqrt(torch.clamp(1.0 - v, min=0.0)),
                               nsb)
    pdf_cos = cos_t * ONE_OVER_PI
    f_lam = ONE_OVER_PI * clamp01(dot(wi_cos, nsb))
    fo, _ = plain.fresnel(cos_o_c, eta)
    cos_i1 = dot(wi_cos, nsb)
    wi_out, ok_out, cos_out = plain.refract(
        wi_cos, -nsb, 1.0 / torch.clamp(eta, min=1e-6), clamp01(cos_i1))
    fi, _ = plain.fresnel(clamp01(cos_out), eta)
    f_layer = (1.0 - fo) * (1.0 - fi) * ONE_OVER_PI * clamp01(cos_i1)
    f_layer = torch.where(ok_out & (cos_o > 0.0), f_layer,
                          torch.zeros_like(f_layer))
    # the delta dielectric reflection: wo mirrored about ns, the Fresnel
    # reflectance, pdf 1
    wi_refl = 2.0 * cos_o_c[..., None] * nsb - wob
    f_refl, _ = plain.fresnel(cos_o_c, eta)
    # the straight transmission: on through the surface, pdf 1
    wi_str = -wob
    # the microfacet dielectric: a power-cosine half vector, reflected
    ch = torch.pow(torch.clamp(v, min=1e-30), 1.0 / (exp + 1.0))
    wh = plain._hemisphere(TWO_PI * u, ch,
                           torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0)),
                           nsb)
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
    fr, _ = plain.fresnel(clamp01(cos_owh), eta)
    w_mf = fr[..., None] * (d_mf * g_mf / torch.clamp(
        4.0 * cos_o_c, min=1e-12))[..., None]
    mf_ok = ((cos_i_mf > 0.0) & (cos_o > 0.0)
             & (dot(wi_mf, ng[:, None, :].expand(shape + (3,))) > 0.0))
    w_mf = torch.where(mf_ok[..., None], w_mf, torch.zeros_like(w_mf))

    is_lam, is_layer = types == LAMB, types == LAYER
    is_refl, is_str = types == DIEL_REFLECT, types == CONST_TRANSMIT
    is_mf = types == MICROFACET
    zero3 = torch.zeros_like(w_mf)

    def pick3(lam, layer, refl, strt, mf):
        return torch.where(is_lam[..., None], lam, torch.where(
            is_layer[..., None], layer, torch.where(
                is_refl[..., None], refl, torch.where(
                    is_str[..., None], strt, torch.where(
                        is_mf[..., None], mf, zero3)))))
    wi = pick3(wi_cos, wi_out, wi_refl, wi_str, wi_mf)
    pdf = torch.where(is_lam | is_layer, pdf_cos, torch.where(
        is_refl | is_str, torch.ones_like(pdf_cos),
        torch.where(is_mf, pdf_mf, torch.zeros_like(pdf_mf))))
    c = pick3(colors * f_lam[..., None], colors * f_layer[..., None],
              colors * f_refl[..., None], colors * 1.0, colors * w_mf)
    lum = torch.sum(c, dim=-1)
    good = (types != NONE) & (lum > 0.0) & (pdf > 0.0)
    f_w = torch.where(good, lum / torch.clamp(pdf, min=1e-20),
                      torch.zeros_like(lum))
    total = torch.sum(f_w, dim=-1, keepdim=True)
    probs = f_w / torch.clamp(total, min=1e-30)
    cdf = probs[:, 0]
    pick = (cdf < s1).to(torch.int64)
    for k in range(1, shape[1]):
        cdf = cdf + probs[:, k]
        pick = pick + (cdf < s1)
    pick = torch.clamp(pick, max=shape[1] - 1)[:, None]
    bits = torch.where(is_lam | is_layer, DIFFUSE_REFLECTION, torch.where(
        is_refl, SPECULAR_REFLECTION, torch.where(
            is_str, SPECULAR_TRANSMISSION, torch.where(
                is_mf, GLOSSY_REFLECTION, 0))))

    def take(x):
        return torch.gather(x, 1, pick)[:, 0]

    def take3(x):
        return torch.gather(x, 1, pick[..., None].expand(-1, 1, 3))[:, 0]
    return (take3(wi), take(pdf) * take(probs), take3(c),
            (take(bits) & DIFFUSE_REFLECTION) != 0,
            (total[:, 0] > 0.0) & take(good))


# ------------------------------------------------------------------ lights

def _bucket(cdf, u):
    """The bucket of u: the count of cdf's entries <= u, less one, in
    [0, N - 1]; cdf (N + 1,) or (R, N + 1) row by row."""
    if cdf.dim() == 1:
        idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    else:
        idx = torch.searchsorted(cdf, u[:, None].contiguous(),
                                 right=True)[:, 0]
    return torch.clamp(idx - 1, 0, cdf.shape[-1] - 2)


def _step(c0, c1, u):
    return torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-30),
                       torch.zeros_like(u))


def sample_hdri(light, u2):
    """(le, wi, pdf) of the HDRI at samples u2 (R, 2)."""
    w, h = light['width'], light['height']
    ux, uy = u2[:, 0], u2[:, 1]
    mc = light['marg_cdf']
    yi = _bucket(mc, uy)
    y = yi.to(u2.dtype) + _step(mc[yi], mc[yi + 1], uy)
    rows = light['cond_cdf'][yi]
    xi = _bucket(rows, ux)
    c0 = torch.gather(rows, 1, xi[:, None])[:, 0]
    c1 = torch.gather(rows, 1, xi[:, None] + 1)[:, 0]
    x = xi.to(u2.dtype) + _step(c0, c1, ux)
    pdf2 = light['cond_pdf'][yi, xi] * light['marg_pdf'][yi]
    theta = PI * y / h
    phi = TWO_PI * (1.0 - x / w)
    sin_t = torch.sin(theta)
    wl = torch.stack([-sin_t * torch.cos(phi), torch.cos(theta),
                      -sin_t * torch.sin(phi)], dim=-1)
    a = light['local2world']
    wi = (wl[:, 0:1] * a[0] + wl[:, 1:2] * a[1]) + wl[:, 2:3] * a[2]
    pdf = pdf2 / torch.clamp(TWO_PI * PI * sin_t, min=1e-20)
    xn = torch.clamp(x.to(torch.int64), 0, w - 1)
    yn = torch.clamp(y.to(torch.int64), 0, h - 1)
    return light['L'] * light['image'][yn, xn], wi, pdf


def le_hdri(light, d):
    """The HDRI's radiance along ray directions d (R, 3): a bilinear
    lat-long lookup, wrapped in x, times L."""
    a = light['world2local']
    wi = (d[:, 0:1] * a[0] + d[:, 1:2] * a[1]) + d[:, 2:3] * a[2]
    theta = torch.arccos(torch.clamp(wi[:, 1], -1.0, 1.0))
    phi = torch.atan2(-wi[:, 2], -wi[:, 0])
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    u = 1.0 - phi / TWO_PI
    v = theta / PI
    w, h = light['width'], light['height']
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    x_next = torch.where(x + 1 == w, 0, x + 1)
    alpha = (u * w - x)[:, None]
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    y_next = torch.clamp(y + 1, max=h - 1)
    beta = (v * h - y)[:, None]
    img = light['image']
    t0 = beta * img[y_next, x] + (1 - beta) * img[y, x]
    t1 = beta * img[y_next, x_next] + (1 - beta) * img[y, x_next]
    return light['L'] * (alpha * t1 + (1 - alpha) * t0)


def sample_light(light, p, ns, u2):
    """(le, wi, pdf) of one sample u2 (R, 2) of an environment light
    seen from points p with shading normals ns."""
    if light['kind'] == 'hdri':
        return sample_hdri(light, u2)
    cos_t = torch.sqrt(torch.clamp(u2[:, 1], min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - u2[:, 1], min=0.0))
    wi = plain._hemisphere(TWO_PI * u2[:, 0], cos_t, sin_t, ns)
    return light['L'].expand(p.shape), wi, cos_t * ONE_OVER_PI


def shadow_cap(cap, jitter, u, wi):
    """The shadow ray's length under the cap: jittered by +-jitter on u,
    lengthened by up to 100 caps where wi points at or below the
    horizon."""
    tmax = cap + (2.0 * cap * jitter * u - cap * jitter)
    dot_up = dot(wi, torch.tensor(plain.UP, dtype=wi.dtype,
                                  device=wi.device))
    return tmax + torch.where(
        dot_up <= 0.0,
        cap * 100.0 * plain.smoothstep(0.0, 1.0, torch.abs(dot_up)),
        torch.zeros_like(tmax))


def escaped(lights, d):
    """The environment's radiance along escaped rays' directions d: the
    lights' summed in their order."""
    env = 0
    for light in lights:
        env = env + (le_hdri(light, d) if light['kind'] == 'hdri'
                     else light['L'].expand(d.shape))
    return env


# --------------------------------------------------------------------- paths

def trace(sc, traffic: dict, cam: dict, seed, pid, sid):
    """Radiance (R, 3) float32 of the paths of samples sid (R,) of pixels
    pid (R,) under render seeds seed (R,), all int64."""
    dt, dev = sc['dtype'], sc['device']
    cfg = traffic['config']
    width, height = traffic['width'], traffic['height']
    max_depth = traffic['max_depth']
    cap = traffic['t_max_shadow_ray']
    if cap is None:
        raise ValueError("the stereo field's reference takes its lights "
                         "under a shadow cap only")
    jitter, min_contribution = (cfg['t_max_shadow_jitter'],
                                cfg['min_contribution'])
    n = pid.shape[0]
    uv = film_points(seed, pid, sid, traffic['spp'], width, height, dt,
                     traffic.get('pixel_filter', 'box'))
    org, dirn = camera_rays(cam, uv, width, height)
    lights = sc['lights']
    if any(l['kind'] not in ('hdri', 'ambient') for l in lights):
        raise ValueError("the stereo field's reference has environment "
                         "lights only")
    dim_light, stride = plain._dims(len(lights))
    out = torch.zeros((n, 3), dtype=dt, device=dev)
    lane = {'org': org, 'dir': dirn, 'thr': torch.ones_like(org),
            'L': torch.zeros_like(org),
            'ignore': torch.zeros((n,), dtype=torch.bool, device=dev),
            'rid': torch.arange(n, device=dev),
            'seed': seed, 'pid': pid, 'sid': sid}
    for depth in range(max_depth):
        live = torch.amax(lane['thr'], dim=-1) >= min_contribution
        lane = {k: v[live] for k, v in lane.items()}
        m = lane['rid'].shape[0]
        if m == 0:
            break
        base = (stride + stride * depth) & rng.MASK
        org, dirn = lane['org'], lane['dir']
        t, tri, bu, bv = plain.closest(
            sc, org, dirn, torch.zeros((m,), dtype=dt, device=dev),
            torch.full((m,), float('inf'), dtype=dt, device=dev))
        hit = tri >= 0
        # escaped rays see the environment unless a diffuse lobe sent
        # them
        miss = ~hit
        if bool(miss.any()):
            seen = ~lane['ignore'][miss]
            thr, L = lane['thr'][miss], lane['L'][miss]
            out.index_copy_(0, lane['rid'][miss], L + torch.where(
                seen[:, None], thr * escaped(lights, dirn[miss]),
                torch.zeros_like(thr)))
        lane = {k: v[hit] for k, v in lane.items()}
        t, tri, bu, bv = t[hit], tri[hit], bu[hit], bv[hit]
        m = tri.shape[0]
        if m == 0:
            break
        s, p_id, s_id = lane['seed'], lane['pid'], lane['sid']
        org, dirn, thr, L = lane['org'], lane['dir'], lane['thr'], lane['L']
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
        # the light samples only where a diffuse lobe can take them
        use_dl = torch.any((types == LAMB) | (types == LAYER), dim=-1)

        # next-event estimation: one shadow ray to every light
        err_eps = err * plain.EPSILON
        cands, contribs, wis, tfars = [], [], [], []
        for li, light in enumerate(lights):
            u2 = rng.uniform2(s, p_id, s_id, (base + dim_light + li)
                              & rng.MASK, dt)
            le, wi, pdf = sample_light(light, p, ns, u2)
            tmax = shadow_cap(cap, jitter, rng.uniform1(
                s, p_id, s_id, (base + 3 + li) & rng.MASK, dt), wi)
            brdf = plain.eval_diffuse(types, colors, eta, ns, wo, wi)
            cands.append(use_dl & (pdf > 0.0) & torch.any(le > 0.0, dim=-1)
                         & torch.any(brdf > 0.0, dim=-1))
            contribs.append(thr * le * brdf
                            / torch.clamp(pdf, min=1e-20)[:, None])
            wis.append(wi)
            tfars.append(tmax - err_eps)
        cand = torch.stack(cands)
        ci = torch.nonzero(cand.reshape(-1), as_tuple=True)[0]
        occ = torch.zeros_like(cand.reshape(-1))
        rows = ci % m
        occ[ci] = plain.occluded(sc, p[rows], torch.cat(wis)[ci],
                                 err_eps[rows], torch.cat(tfars)[ci])
        lit = cand & ~occ.reshape(cand.shape)
        L = L + torch.sum(torch.where(lit[..., None], torch.stack(contribs),
                                      torch.zeros_like(contribs[0])), dim=0)
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
