"""Accumulation film: per-pixel RGB sum and weight.

Counterpart of `yulio_raytracer_tpu/film/accum.py` (the AccuBuffer of
framebuffer.h:229-327): `resolve` divides the sum by the weight.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Film(NamedTuple):
    rgb_sum: torch.Tensor   # (H, W, 3) f32
    weight: torch.Tensor    # (H, W)    f32

    @property
    def height(self):
        return self.rgb_sum.shape[0]

    @property
    def width(self):
        return self.rgb_sum.shape[1]


def resolve(film: Film):
    """Normalized color = sum / weight."""
    return film.rgb_sum / torch.clamp(film.weight, min=1e-12)[..., None]
