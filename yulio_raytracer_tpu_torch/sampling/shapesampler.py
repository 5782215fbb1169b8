"""Shape sampling over batched sample tensors.

Counterpart of `yulio_raytracer_tpu/sampling/shapesampler.py`, limited
to what the ported path calls: the cosine hemisphere (Lambertian lobes),
the area-uniform triangle point (triangle lights) and the disk (the
depth-of-field lens).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vm

TWO_PI = float(2.0 * np.pi)
ONE_OVER_PI = float(1.0 / np.pi)


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
