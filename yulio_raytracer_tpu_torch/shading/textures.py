"""Texture table: every scene image packed into one flat RGBA buffer.

Counterpart of `yulio_raytracer_tpu/shading/textures.py`.  This slice
ports the empty atlas only (the 1x1 white fallback the reference builds
for a textureless scene); adding an image raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FILTER_NEAREST = 0
FILTER_BILINEAR = 1


@dataclass
class TextureTableBuilder:
    """Host-side accumulator; `build()` returns the numpy table dict."""

    def add(self, image, filter: int = FILTER_BILINEAR, invert: bool = False,
            key=None) -> int:
        raise NotImplementedError(
            "textures are not ported to the torch package yet")

    def build(self) -> dict:
        return {
            'data': np.ones((1, 4), np.float32),
            'off': np.zeros((1,), np.int32),
            'w': np.ones((1,), np.int32),
            'h': np.ones((1,), np.int32),
            'filter': np.full((1,), FILTER_BILINEAR, np.int32),
            'invert': np.zeros((1,), np.int32),
        }
