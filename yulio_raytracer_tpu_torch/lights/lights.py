"""Light models, vectorized over ray batches.

Counterpart of `yulio_raytracer_tpu/lights/lights.py`: the ambient dome
(the Yulio model), point, spot, directional, distant, HDRI environment
and triangle area lights.  A light is a dict {'kind': str, ...params};
builders stay host-side numpy (the HDRI's distribution tables are CPU
tensors) and commit moves the arrays to the device.

`sample` broadcasts over leading dims, so a group of same-kind lights
stacked to (nk, 1, ...) parameters samples (nk, R) shade points in one
call (the reference's vmap over a kind group).  An HDRI light is sampled
alone, unstacked, with samples of shape (1, R, 2).  `le_area` is the
triangle light's only, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vm
from ..sampling import distribution as dist
from ..sampling import shapesampler as ss

TWO_PI = float(2 * np.pi)
PI = float(np.pi)


# --------------------------------------------------------------- builders

def _np3(x):
    return np.asarray(x, np.float32)


def _npnorm(x):
    v = np.asarray(x, np.float32)
    return v / max(float(np.linalg.norm(v)), 1e-20)


def ambient(L, illum_mask=-1, shadow_mask=-1):
    """AmbientLight (ambientlight.h): a uniform environment, the dome
    model; commit sets its bounding sphere (set_scene_bounds)."""
    return {'kind': 'ambient', 'L': _np3(L),
            'bsphere_center': np.zeros(3, np.float32),
            'bsphere_radius': np.float32(0),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def point(P, I, illum_mask=-1, shadow_mask=-1):
    return {'kind': 'point', 'P': _np3(P), 'I': _np3(I),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def spot(P, D, I, angle_min_deg, angle_max_deg, illum_mask=-1,
         shadow_mask=-1):
    """spotlight.h:42-45: the stored axis is -normalize(D) (against the
    surface-to-light direction) and the cone bounds are the cosines of
    half the given angles."""
    return {'kind': 'spot', 'P': _np3(P),
            'D': -_npnorm(D), 'I': _np3(I),
            'cos_min': np.float32(np.cos(0.5 * np.deg2rad(angle_min_deg))),
            'cos_max': np.float32(np.cos(0.5 * np.deg2rad(angle_max_deg))),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def directional(D, E, illum_mask=-1, shadow_mask=-1):
    return {'kind': 'directional', 'wo': -_npnorm(D), 'E': _np3(E),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def distant(D, L, half_angle_deg, illum_mask=-1, shadow_mask=-1):
    ha = float(np.deg2rad(half_angle_deg))
    return {'kind': 'distant', 'wo': -_npnorm(D), 'L': _np3(L),
            'half_angle': np.float32(ha),
            'cos_half': np.float32(np.cos(ha)),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def triangle(v0, v1, v2, L, illum_mask=-1, shadow_mask=-1):
    v0, v1, v2 = _np3(v0), _np3(v1), _np3(v2)
    return {'kind': 'triangle', 'v0': v0, 'v1': v1, 'v2': v2,
            'L': _np3(L),
            # unnormalized Ng = cross(e1, e2) with e1 = v0 - v1, e2 = v2 - v0
            # (trianglelight.h:39); |Ng| = 2*area feeds the pdf
            'Ng': np.cross(v0 - v1, v2 - v0).astype(np.float32),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def hdri(image, L=(1, 1, 1), local2world=None, illum_mask=-1,
         shadow_mask=-1):
    """HDRILight (hdrilight.cpp): a lat-long environment map with a
    sin(theta)-weighted 2D importance distribution; local2world is a
    (4, 3) numpy affine (identity if None)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    h, w = img.shape[:2]
    ys = (np.arange(h) + 0.5) / h
    importance = np.sin(np.pi * ys)[:, None] * img.sum(axis=-1)
    l2w = (np.asarray(local2world, np.float32) if local2world is not None
           else np.concatenate([np.eye(3, dtype=np.float32),
                                np.zeros((1, 3), np.float32)]))
    linv = np.linalg.inv(l2w[:3, :]).astype(np.float32)
    w2l = np.concatenate([linv, (-l2w[3, :] @ linv)[None, :]]) \
        .astype(np.float32)
    return {'kind': 'hdri', 'image': img,
            'L': _np3(L),
            'width': w, 'height': h, 'dist': dist.build_2d(importance),
            'local2world': l2w, 'world2local': w2l,
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def is_env(light) -> bool:
    return light['kind'] in ('ambient', 'hdri')


def set_scene_bounds(light, bbox_lo, bbox_hi):
    """AmbientLight::createShape (ambientlight.h:43-47): the bounding
    sphere of the scene's bbox, radius x 1.5, limits the dome's shadow
    rays; other kinds are returned as they are."""
    if light['kind'] != 'ambient':
        return light
    center, radius = vm.bsphere_of_bbox(bbox_lo, bbox_hi)
    out = dict(light)
    out['bsphere_center'] = np.asarray(center, np.float32)
    out['bsphere_radius'] = np.float32(max(radius * 1.5,
                                           np.finfo(np.float32).eps))
    return out


# --------------------------------------------------------------- sampling

def _inf(shape, like):
    return torch.full(shape, float('inf'), device=like.device)


def sample(light, P, Ns, u2):
    """Sample incoming illumination at shade points P (R, 3) with normals
    Ns and samples u2 (..., R, 2).  Returns (Le (..., R, 3), wi (..., R, 3),
    pdf (..., R), tmax (..., R)); zero radiance or pdf marks an invalid
    sample (pathtraceintegrator.cpp:137).  pdf conventions are the
    reference's (pointlight.h, spotlight.h, distantlight.h,
    trianglelight.h, ambientlight.h, hdrilight.cpp)."""
    k = light['kind']
    shape = u2.shape[:-1]
    v3 = shape + (3,)

    if k == 'ambient':
        # ambientlight.h:67-80: a cosine hemisphere; tmax is the far hit
        # of the scene's bounding sphere
        wi, pdf = ss.cosine_sample_hemisphere(u2[..., 0], u2[..., 1], Ns)
        hit, tfar = vm.ray_sphere_tfar(P, wi, light['bsphere_center'],
                                       light['bsphere_radius'])
        has_sphere = light['bsphere_radius'] > 0
        tmax = torch.where(has_sphere & hit, tfar, float('inf'))
        return light['L'].expand(v3), wi, pdf, tmax

    if k in ('point', 'spot'):
        # pointlight.h: pdf = distance^2
        d = light['P'] - P
        distn = vm.length(d)
        wi = d / torch.clamp(distn, min=1e-20)[..., None]
        if k == 'point':
            return light['I'].expand(v3), wi, distn * distn, distn
        cos_a = vm.dot(wi, light['D'])
        denom = light['cos_min'] - light['cos_max']
        fall = torch.where(
            denom != 0,
            torch.clamp((cos_a - light['cos_max'])
                        / torch.where(denom != 0, denom, 1.0), 0, 1),
            (cos_a > light['cos_min']).to(torch.float32))
        return light['I'] * fall[..., None], wi, distn * distn, distn

    if k == 'directional':
        return (light['E'].expand(v3), light['wo'].expand(v3),
                torch.ones(shape, device=u2.device), _inf(shape, u2))

    if k == 'distant':
        local, pdf = ss.uniform_sample_cone(u2[..., 0], u2[..., 1],
                                            light['half_angle'])
        dx, dy, dz = vm.frame(light['wo'].expand(v3))
        wi = (local[..., 0:1] * dx + local[..., 1:2] * dy
              + local[..., 2:3] * dz)
        return light['L'].expand(v3), wi, pdf, _inf(shape, u2)

    if k == 'triangle':
        # trianglelight.h: pdf = 2 t^3 / |d . Ng| (solid angle, |Ng| = 2A);
        # zero radiance from the back side
        p = ss.uniform_sample_triangle(u2[..., 0], u2[..., 1], light['v0'],
                                       light['v1'], light['v2'])
        d = p - P
        tmax = vm.length(d)
        d_dot_ng = vm.dot(d, light['Ng'])
        wi = d / torch.clamp(tmax, min=1e-20)[..., None]
        pdf = 2.0 * tmax ** 3 / torch.clamp(torch.abs(d_dot_ng), min=1e-20)
        le = torch.where((d_dot_ng < 0.0)[..., None],
                         light['L'].expand(d.shape), 0.0)
        return le, wi, pdf, tmax

    if k == 'hdri':
        # hdrilight.cpp:93-104
        xy, pdf2 = dist.sample_2d(light['dist'], u2)
        w, h = light['width'], light['height']
        theta = PI * xy[..., 1] / h
        phi = TWO_PI * (1.0 - xy[..., 0] / w)
        sin_t = torch.sin(theta)
        wi_local = torch.stack([-sin_t * torch.cos(phi), torch.cos(theta),
                                -sin_t * torch.sin(phi)], dim=-1)
        wi = vm.xfm_vector(light['local2world'], wi_local)
        pdf = pdf2 / torch.clamp(TWO_PI * PI * sin_t, min=1e-20)
        xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
        return light['L'] * light['image'][yi, xi], wi, pdf, _inf(shape, u2)

    raise ValueError(f"unknown light kind {k}")


def le_env(light, wo):
    """Radiance of an environment light along escaped rays, Le(wo) with
    wo = -ray.dir (pathtraceintegrator.cpp:86-89)."""
    k = light['kind']
    if k == 'ambient':
        return light['L'].expand(wo.shape)
    if k == 'hdri':
        # hdrilight.cpp:59-86: a lat-long lookup, bilinear, wrapping in x
        wi = vm.xfm_vector(light['world2local'], -wo)
        theta = torch.arccos(torch.clamp(wi[..., 1], -1.0, 1.0))
        phi = torch.arctan2(-wi[..., 2], -wi[..., 0])
        phi = torch.where(phi < 0, phi + TWO_PI, phi)
        u = 1.0 - phi / TWO_PI
        v = theta / PI
        w, h = light['width'], light['height']
        x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        x_next = torch.where(x + 1 == w, 0, x + 1)
        alpha = (u * w - x)[..., None]
        y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        y_next = torch.clamp(y + 1, max=h - 1)
        beta = (v * h - y)[..., None]
        img = light['image']
        t0 = beta * img[y_next, x] + (1 - beta) * img[y, x]
        t1 = beta * img[y_next, x_next] + (1 - beta) * img[y, x_next]
        return light['L'] * (alpha * t1 + (1 - alpha) * t0)
    raise ValueError(f"{k} is not an environment light")


def le_area(light, backfacing):
    """Emission of a hit triangle light; zero where the hit is
    backfacing (pathtraceintegrator.cpp:114).  Other kinds have no
    surface: NotImplementedError, as the reference's bounce never asks."""
    if light['kind'] != 'triangle':
        raise NotImplementedError(
            f"le_area of a {light['kind']!r} light: only triangle lights "
            "have an emitting surface")
    return torch.where(backfacing[..., None], 0.0, light['L'])
