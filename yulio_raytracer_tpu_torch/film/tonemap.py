"""Default tonemapper: gamma correction + optional cosine^3 vignetting.

Counterpart of `yulio_raytracer_tpu/film/tonemap.py`
(defaulttonemapper.h:25-52) as one elementwise pass over the frame.
"""
from __future__ import annotations

import torch


def tonemap(rgb, gamma: float = 1.0, vignetting: bool = False):
    """rgb: (H, W, 3) linear -> display-referred (float, unclamped)."""
    out = rgb
    if gamma != 1.0:
        out = torch.pow(torch.clamp(out, min=0.0), 1.0 / gamma)
    if vignetting:
        h, w = rgb.shape[0], rgb.shape[1]
        y = (torch.arange(h, dtype=torch.float32, device=rgb.device)
             - 0.5 * h)[:, None]
        x = (torch.arange(w, dtype=torch.float32, device=rgb.device)
             - 0.5 * w)[None, :]
        # distance scaled by half the width (defaulttonemapper.h:46-48)
        d = torch.sqrt(x * x + y * y) / (0.5 * w)
        out = out * torch.pow(torch.cos(d * 0.5), 3.0)[..., None]
    return out


def to_srgb_u8(rgb):
    """Clamp and quantize to u8 (framebuffer RGB8 store semantics)."""
    return torch.clamp(rgb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
