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

On a CUDA tensor `fetch` launches the kernel of csrc/texture.cu, one
thread a slot, which reads only the texels its slot's own filter needs
(none where the id is < 0); on a CPU tensor it runs `_fetch`, the plain
version, whose arithmetic the kernel repeats op for op (bit-equal).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cuda_build as cb
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


_V, _L = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {'yrt_texture_fetch': [_V] * 8 + [_L] * 6 + [_V]}


def fetch(table: dict, tid, uv):
    """Gathered texel fetch.  tid: (...,) int texture ids (< 0: white);
    uv: (..., 2), broadcast over tid's shape.  Returns (..., 4) RGBA.
    Under profiling.tracing() the span counts the slots fetched
    (`slots`) and those with an id >= 0 (`texel_slots`)."""
    with profiling.span(SPAN_FETCH) as rec:
        if profiling.tracer_on():
            rec.set(slots=tid.numel(), texel_slots=torch.sum(tid >= 0))
        if tid.device.type == 'cpu':
            return _fetch(table, tid, uv)
        return _fetch_kernel(table, tid, uv)


def _fetch_kernel(table, tid, uv):
    """The fetch on the card: csrc/texture.cu over tid's slots, uv read
    through its strides (an expanded view is not copied).  Every id must
    be < the number of textures: the kernel traps on one past the table,
    as the plain version's gather fails on it."""
    dev, shape = tid.device, tid.shape
    out = torch.empty(shape + (4,), dtype=torch.float32, device=dev)
    n = tid.numel()
    if n == 0:
        return out
    if uv.dtype != torch.float32 or uv.device != dev:
        raise ValueError(f"uv: expected float32 on {dev}, got {uv.dtype} "
                         f"on {uv.device}")
    k = shape[-1] if shape else 1
    uv = uv.expand(shape + (2,)).reshape(-1, k, 2)
    rows = [cb.table_arg('data', table['data'], 4, dev)]
    for name in ('off', 'w', 'h', 'filter', 'invert'):
        x = table[name]
        if (x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous()
                or x.device != dev):
            raise ValueError(f"{name}: expected a contiguous int32 (T,) "
                             f"tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        rows.append(x)
    _op(*rows, tid.to(torch.int64).contiguous(), uv, out)
    return out


def launch(lib, entry, data, off, w, h, filt, inv, tid, uv, out):
    """F1 (yrt_texture_fetch) of lib over tid's slots, uv (R, k, 2) read
    through its strides."""
    cb.launch(getattr(lib, entry), entry, out.device, data, off, w, h, filt,
              inv, tid, uv, off.numel(), tid.numel(), uv.shape[1],
              *uv.stride(), out)


def _lib():
    return cb.library('texture', _SIGNATURES)


_op = cb.operator(
    'texture_fetch', '(Tensor data, Tensor off, Tensor w, Tensor h, '
    'Tensor filter, Tensor invert, Tensor tid, Tensor uv, Tensor(a!) out) '
    '-> ()', launch, _lib, fetch)


def _fetch(table, tid, uv):
    """The plain fetch: torch ops over every slot, both filters' taps."""
    if tid.is_cuda:
        _fetch.cuda_calls += 1
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


# launch counts: the fetch kernel launched, and the plain fetch run on CUDA
# tensors
fetch.launches = 0
_fetch.cuda_calls = 0
