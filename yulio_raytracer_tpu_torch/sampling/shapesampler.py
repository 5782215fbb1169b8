"""Shape sampling over batched sample tensors.

Counterpart of `yulio_raytracer_tpu/sampling/shapesampler.py`, limited
to what the ported path calls: the cosine and power-cosine hemispheres
(the lobes), the area-uniform triangle point (triangle lights) and the
disk (the depth-of-field lens).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vm

TWO_PI = float(2.0 * np.pi)
ONE_OVER_PI = float(1.0 / np.pi)
ONE_OVER_TWO_PI = float(1.0 / (2.0 * np.pi))


def _local_to_world(n, local):
    dx, dy, dz = vm.frame(n)
    return local[..., 0:1] * dx + local[..., 1:2] * dy + local[..., 2:3] * dz


def cosine_sample_hemisphere(u, v, n=None):
    """Returns (dir, pdf); up = n (or +z)."""
    phi = TWO_PI * u
    cos_t = torch.sqrt(torch.clamp(v, min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - v, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         cos_t], dim=-1)
    pdf = cos_t * ONE_OVER_PI
    if n is None:
        return local, pdf
    return _local_to_world(n, local), pdf


def cosine_hemisphere_pdf(wi, n):
    """shapesampler.h:113-115."""
    c = vm.dot(wi, n)
    return torch.where(c < 0.0, 0.0, c * ONE_OVER_PI)


def power_cosine_sample_hemisphere(u, v, exp, n=None):
    """shapesampler.h:119-136.  Returns (dir, pdf); up = n (or +z)."""
    phi = TWO_PI * u
    cos_t = torch.pow(torch.clamp(v, min=1e-30), 1.0 / (exp + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         cos_t], dim=-1)
    pdf = (exp + 1.0) * torch.pow(cos_t, exp) * ONE_OVER_TWO_PI
    if n is None:
        return local, pdf
    return _local_to_world(n, local), pdf


def power_cosine_hemisphere_pdf(wi, n, exp):
    """shapesampler.h:139-141."""
    c = vm.dot(wi, n)
    return torch.where(c < 0.0, 0.0,
                       (exp + 1.0) * torch.pow(torch.clamp(c, min=0.0), exp)
                       * ONE_OVER_TWO_PI)


def uniform_sample_triangle(u, v, a, b, c):
    """Area-uniform point on triangle ABC."""
    su = torch.sqrt(torch.clamp(u, min=0.0))[..., None]
    return c + (1.0 - su) * (a - c) + (v[..., None] * su) * (b - c)


def uniform_sample_disk(sample, radius):
    """Point on a disk of the given radius, (..., 2)."""
    r = torch.sqrt(torch.clamp(sample[..., 0], min=0.0))
    theta = TWO_PI * sample[..., 1]
    return torch.stack([radius * r * torch.cos(theta),
                        radius * r * torch.sin(theta)], dim=-1)
