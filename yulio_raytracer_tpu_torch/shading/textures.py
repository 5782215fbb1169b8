"""Texture table: every scene image packed into one flat RGBA buffer.

Counterpart of `yulio_raytracer_tpu/shading/textures.py`.  The images
become ONE flat (P, 4) float buffer plus per-texture (offset, width,
height, filter, invert) rows, so a whole wavefront's fetches are a few
gathers however many images the scene holds.  The filters keep the
reference's semantics:
* wrap: fractional repeat `p - floor(p)` on both filters;
* bilinear (Bilinear.h:23-36): u = s*W - .5 with x clamped to [0, W-2]
  (the rightmost texel column is reached only as the +1 neighbour);
* nearest (nearestneighbor.h): floor(s*W) clamped to [0, W-1];
* then `invert`, and a texture id < 0 reads opaque white.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import profiling

FILTER_NEAREST = 0
FILTER_BILINEAR = 1


@dataclass
class TextureTableBuilder:
    """Host-side accumulator; `build()` returns the numpy table dict
    (commit moves it to the device)."""
    datas: list = field(default_factory=list)
    offs: list = field(default_factory=list)
    widths: list = field(default_factory=list)
    heights: list = field(default_factory=list)
    filters: list = field(default_factory=list)
    inverts: list = field(default_factory=list)
    _cursor: int = 0
    _cache: dict = field(default_factory=dict)

    def add(self, image: np.ndarray, filter: int = FILTER_BILINEAR,
            invert: bool = False, key=None) -> int:
        """image: (H, W), (H, W, 3) or (H, W, 4), float or uint8 (/255);
        grey becomes RGB and RGB gets alpha 1.  An image added again under
        the same (key, filter, invert) keeps its first id.  Returns the
        texture id."""
        if key is not None and (key, filter, invert) in self._cache:
            return self._cache[(key, filter, invert)]
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        h, w = img.shape[:2]
        tid = len(self.offs)
        self.datas.append(img.reshape(-1, 4))
        self.offs.append(self._cursor)
        self.widths.append(w)
        self.heights.append(h)
        self.filters.append(filter)
        self.inverts.append(invert)
        self._cursor += h * w
        if key is not None:
            self._cache[(key, filter, invert)] = tid
        return tid

    def build(self) -> dict:
        if not self.datas:
            # a 1x1 white fallback, so gathers always have a target
            self.add(np.ones((1, 1, 4), np.float32))
        return {
            'data': np.concatenate(self.datas, axis=0),
            'off': np.asarray(self.offs, np.int32),
            'w': np.asarray(self.widths, np.int32),
            'h': np.asarray(self.heights, np.int32),
            'filter': np.asarray(self.filters, np.int32),
            'invert': np.asarray(self.inverts, np.int32),
        }


# the span of every fetch, as readers of a trace name it
SPAN_FETCH = profiling.FETCH


def fetch(table: dict, tid, uv):
    """Gathered texel fetch.  tid: (...,) int texture ids (< 0: white);
    uv: (..., 2).  Returns (..., 4) RGBA."""
    with profiling.span(SPAN_FETCH):
        return _fetch(table, tid, uv)


def _fetch(table, tid, uv):
    safe_tid = torch.clamp(tid, min=0).long()
    off = table['off'][safe_tid].long()
    w = table['w'][safe_tid].long()
    h = table['h'][safe_tid].long()
    filt = table['filter'][safe_tid]
    inv = table['invert'][safe_tid]

    s = uv[..., 0] - torch.floor(uv[..., 0])
    t = uv[..., 1] - torch.floor(uv[..., 1])
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)

    # bilinear (Bilinear.h)
    u = s * wf - 0.5
    v = t * hf - 0.5
    x0 = torch.minimum(torch.clamp(torch.floor(u).long(), min=0),
                       torch.clamp(w - 2, min=0))
    y0 = torch.minimum(torch.clamp(torch.floor(v).long(), min=0),
                       torch.clamp(h - 2, min=0))
    ur = (u - x0.to(torch.float32))[..., None]
    vr = (v - y0.to(torch.float32))[..., None]
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)

    def texel(x, y):
        return table['data'][off + y * w + x]

    c_bi = ((texel(x0, y0) * (1 - ur) + texel(x1, y0) * ur) * (1 - vr)
            + (texel(x0, y1) * (1 - ur) + texel(x1, y1) * ur) * vr)

    # nearest (nearestneighbor.h): a truncating cast, as the reference's
    xn = torch.minimum(torch.clamp((s * wf).to(torch.int32).long(), min=0),
                       w - 1)
    yn = torch.minimum(torch.clamp((t * hf).to(torch.int32).long(), min=0),
                       h - 1)
    c_nn = texel(xn, yn)

    c = torch.where((filt == FILTER_BILINEAR)[..., None], c_bi, c_nn)
    c = torch.where((inv != 0)[..., None], 1.0 - c, c)
    return torch.where((tid < 0)[..., None], 1.0, c)
