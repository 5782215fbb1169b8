"""Vector math over batched (..., 3) tensors.

Counterpart of `yulio_raytracer_tpu/core/math.py`, limited to what the
ported path calls: the vec3 helpers, reflect and refract, the frame, the
affine transforms and rotations the cameras build, smoothstep, and the
ambient dome's bounding sphere and far hit.  Affine spaces keep the
(4, 3) row layout [vx; vy; vz; p] of the reference.
"""
from __future__ import annotations

import numpy as np
import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps=1e-20):
    return a / torch.clamp(length(a), min=eps)[..., None]


def reflect(v, n, cos_i=None):
    """Reflect v about n (optics.h:30-39): v points away from the surface
    and so does the result, r = 2 dot(v, n) n - v."""
    if cos_i is None:
        cos_i = dot(v, n)
    return 2.0 * cos_i[..., None] * n - v


def refract(v, n, eta, cos_i):
    """Refract v about n with relative IOR eta (optics.h:80-87); v and n
    point to the same side.  Returns (direction, valid, cos_t); on total
    internal reflection valid is False and the direction zeros."""
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    valid = k >= 0.0
    cos_t = torch.sqrt(torch.clamp(k, min=0.0))
    d = eta[..., None] * (cos_i[..., None] * n - v) - cos_t[..., None] * n
    return torch.where(valid[..., None], d, 0.0), valid, cos_t


def frame(n):
    """Orthonormal frame around unit normal n, helper axis = the smallest
    |component| (first one on ties, as jnp.argmin).  Returns (dx, dy, n)."""
    smallest = torch.argmin(torch.abs(n), dim=-1)
    helper = torch.eye(3, dtype=n.dtype, device=n.device)[smallest]
    dx = normalize(cross(helper, n))
    dy = cross(n, dx)
    return dx, dy, n


def xfm_vector(a, x):
    """Transform direction x (..., 3) by the linear part of affine a (4, 3)."""
    return (x[..., 0:1] * a[0] + x[..., 1:2] * a[1]) + x[..., 2:3] * a[2]


def xfm_point(a, x):
    """Transform points x (..., 3) by affine a (4, 3)."""
    return xfm_vector(a, x) + a[3]


def affine_compose(a, b):
    """(a * b)(x) = a(b(x)), as AffineSpace3f's operator*."""
    la, pa = a[:3], a[3]
    return torch.cat([b[:3] @ la, (b[3] @ la + pa)[None]])


def _affine_translate(t):
    return torch.cat([torch.eye(3, dtype=torch.float32, device=t.device),
                      t[None]])


def affine_rotate(center, axis, angle):
    """Rotation by angle (radians, a 0-d tensor) about the axis through
    center (AffineSpace3f::rotate); Rodrigues in the row-vector layout."""
    u = axis / torch.clamp(torch.linalg.norm(axis), min=1e-20)
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = u[0], u[1], u[2]
    lin = torch.stack([
        torch.stack([c + x * x * (1 - c), x * y * (1 - c) + z * s,
                     x * z * (1 - c) - y * s]),
        torch.stack([y * x * (1 - c) - z * s, c + y * y * (1 - c),
                     y * z * (1 - c) + x * s]),
        torch.stack([z * x * (1 - c) + y * s, z * y * (1 - c) - x * s,
                     c + z * z * (1 - c)])])
    rot = torch.cat([lin, torch.zeros((1, 3), device=lin.device)])
    # translate(-center), rotate, translate(center)
    return affine_compose(affine_compose(_affine_translate(center), rot),
                          _affine_translate(-center))


def rotate_about_axis(v, u, angle):
    """Rodrigues rotation of v (..., 3) about the unit axis u (3,) by angle
    (...,): v cos + (u x v) sin + u (u.v)(1 - cos), affine_rotate's
    handedness."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    ub = u.expand(v.shape)
    return (v * c + cross(ub, v) * s
            + ub * (dot(ub, v) * (1.0 - c[..., 0]))[..., None])


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def bsphere_of_bbox(lower, upper):
    """Bounding sphere (center, radius) of a bbox, on the host (the
    reference's getBSphere; the ambient light scales the radius by
    1.5)."""
    center = 0.5 * (np.asarray(lower) + np.asarray(upper))
    radius = float(np.linalg.norm(np.asarray(upper) - center))
    return center.astype(np.float32), np.float32(radius)


def ray_sphere_tfar(org, direction, center, radius):
    """Far intersection of rays with a sphere, for the ambient dome's
    shadow tmax; org may lie inside the sphere.  Returns (hit, t_far)."""
    oc = org - center
    b = dot(direction, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    t_far = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    return (disc >= 0.0) & (t_far > 0.0), t_far
