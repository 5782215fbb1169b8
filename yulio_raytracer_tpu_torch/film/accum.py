"""Accumulation film: per-pixel RGB sum and weight.

Counterpart of `yulio_raytracer_tpu/film/accum.py` (the AccuBuffer of
framebuffer.h:229-327): `accumulate` adds one iteration's sums (or
overwrites them, accumulate=0), `resolve` divides the sum by the weight,
and a film round-trips through numpy arrays for checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def create(height: int, width: int, device=None) -> Film:
    """An empty film on `device` (None: torch's default device)."""
    return Film(torch.zeros((height, width, 3), device=device),
                torch.zeros((height, width), device=device))


def accumulate(film: Film, rgb, weight, reset: bool = False) -> Film:
    """Add one iteration's weighted sums; rgb (H, W, 3), weight (H, W) on
    the film's device.  reset=True overwrites (AccuBuffer::update with
    accumulate=0)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32,
                          device=film.rgb_sum.device)
    weight = torch.as_tensor(weight, dtype=torch.float32,
                             device=film.weight.device)
    if reset:
        return Film(rgb, weight)
    return Film(film.rgb_sum + rgb, film.weight + weight)


def resolve(film: Film):
    """Normalized color = sum / weight."""
    return film.rgb_sum / torch.clamp(film.weight, min=1e-12)[..., None]


def to_numpy_checkpoint(film: Film) -> dict:
    return {"rgb_sum": film.rgb_sum.cpu().numpy(),
            "weight": film.weight.cpu().numpy()}


def from_numpy_checkpoint(d: dict, device=None) -> Film:
    """The film of a checkpoint, on `device` (None: torch's default)."""
    return Film(torch.as_tensor(np.array(d["rgb_sum"]), device=device),
                torch.as_tensor(np.array(d["weight"]), device=device))
