"""Stratified sample patterns as pure functions of (seed, pixel, sample).

Counterpart of `yulio_raytracer_tpu/sampling/patterns.py`: sample j of
pixel p lands in stratum j of an a x b grid (a per-pixel XOR scramble
decorrelates the stratum order), jittered by the stateless RNG, so both
packages draw the same camera samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng


def grid_dims(spp: int) -> tuple[int, int]:
    """Factor spp into the most square a x b grid with a*b >= spp."""
    a = int(np.floor(np.sqrt(spp)))
    while a > 1 and spp % a != 0:
        a -= 1
    return a, spp // a


def grid_scalars(spp: int):
    """The stratification grid of `spp` as (a, n, 1/a, 1/b), with the
    reciprocals rounded to f32 on the host as the reference does."""
    a, b = grid_dims(spp)
    return (int(a), int(a * b),
            float(np.float32(1.0 / a)), float(np.float32(1.0 / b)))


def pixel_sample(seed, pixel_id, sample_id, spp, dim: int = 0):
    """Jittered-stratified 2D sample in [0,1)^2 for the pixel position.

    pixel_id/sample_id: int64 tensors holding u32 values.  spp: an int
    or a grid_scalars() tuple."""
    a, n, inv_a, inv_b = spp if isinstance(spp, tuple) else grid_scalars(spp)
    scramble = rng.hash_u32(pixel_id, dim, seed, 0x9E3779B9)
    s = ((rng._u32(sample_id) + scramble) & rng._MASK) % n
    sx = (s % a).to(torch.float32)
    sy = (s // a).to(torch.float32)
    jitter = rng.uniform2(seed, pixel_id, sample_id, dim)
    u = (sx + jitter[..., 0]) * inv_a
    v = (sy + jitter[..., 1]) * inv_b
    return torch.stack([u, v], dim=-1)


def pixel_sample_bspline(seed, pixel_id, sample_id, spp, dim: int = 0):
    """Cubic B-spline pixel-filter importance sampling, the reference's
    default filter: the stratified sample plus three more uniform pairs,
    minus 2 (the 4-fold convolution of unit boxes, support [-2, 2] about
    the pixel's centre), so samples keep unit weight."""
    s0 = pixel_sample(seed, pixel_id, sample_id, spp, dim)
    # the extra draws' dims as the reference's u32 XORs, in one call
    u1, u2, u3 = rng.uniform2(seed, pixel_id, sample_id,
                              [(dim ^ salt) & rng._MASK
                               for salt in (0x5F375A86, 0x2545F491,
                                            0x9E3779B9)])
    return 0.5 + (s0 + u1 + u2 + u3) - 2.0


def sample_2d(seed, pixel_id, sample_id, dim):
    return rng.uniform2(seed, pixel_id, sample_id, dim)


def sample_1d(seed, pixel_id, sample_id, dim):
    return rng.uniform1(seed, pixel_id, sample_id, dim)
