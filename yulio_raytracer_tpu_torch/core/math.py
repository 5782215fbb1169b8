"""Vector math over batched (..., 3) tensors.

Counterpart of `yulio_raytracer_tpu/core/math.py`, limited to what the
ported path calls.  Affine spaces keep the (4, 3) row layout
[vx; vy; vz; p] of the reference.
"""
from __future__ import annotations

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
