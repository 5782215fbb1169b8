"""1D and 2D discrete importance-sampling distributions (CDF inversion).

Counterpart of `yulio_raytracer_tpu/sampling/distribution.py` (the
reference's distribution1d.cpp / distribution2d.cpp, used by the HDRI
light).  The tables are built once on the host in float64 and kept as
float32 tensors; sampling inverts them over a batch of samples.

The reference's `sample_2d` finds each sample's column by gathering its
whole row CDF, (R, W+1), and counting the entries <= u.  Here a binary
search over the row takes ceil(log2(W+2)) gathers of one entry each and
gives the same index, the count of entries <= u, also over the runs of
equal entries that zero-weight texels leave.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Distribution1D(NamedTuple):
    """cdf has N+1 entries, cdf[0] = 0, cdf[N] = 1; pdf[i] = f[i] N / sum."""
    cdf: torch.Tensor   # (N+1,)
    pdf: torch.Tensor   # (N,) density over positions in [0, 1)

    @property
    def size(self) -> int:
        return self.pdf.shape[-1]


def _tables_1d(f):
    """(cdf, pdf) of weights f (..., N) in float64."""
    n = f.shape[-1]
    total = f.sum(axis=-1, keepdims=True)
    total = np.where(total <= 0, 1.0, total)
    pdf = f / total * n
    cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,)),
                          np.cumsum(f / total, axis=-1)], axis=-1)
    cdf[..., -1] = 1.0
    return cdf, pdf


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def build_1d(f) -> Distribution1D:
    cdf, pdf = _tables_1d(np.asarray(f, np.float64))
    return Distribution1D(_f32(cdf), _f32(pdf))


def _step(cdf, idx, u):
    """The fraction of u between cdf[idx] and cdf[idx + 1] (0 on a flat
    step)."""
    c0, c1 = cdf[idx], cdf[idx + 1]
    return torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-30),
                       0.0)


def _bucket(cdf, u):
    """The bucket of u: searchsorted(cdf, u, 'right') - 1 in [0, N-1]."""
    idx = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, cdf.shape[0] - 2)


def sample_1d(dist: Distribution1D, u):
    """A continuous position x in [0, N) with its pdf (in units of one
    bucket, as distribution1d.cpp).  Returns (x, pdf, index)."""
    idx = _bucket(dist.cdf, u)
    x = idx.to(torch.float32) + _step(dist.cdf, idx, u)
    return x, dist.pdf[idx], idx


def pdf_1d(dist: Distribution1D, p):
    """Density at a normalized position p in [0, 1) (distribution1d.cpp:
    77-79, which takes normalized positions where sample returns bucket
    ones)."""
    idx = torch.clamp((p * dist.size).to(torch.int64), 0, dist.size - 1)
    return dist.pdf[idx]


class Distribution2D(NamedTuple):
    """Row-conditional CDFs and the marginal over rows of (H, W) weights."""
    cond_cdf: torch.Tensor   # (H, W+1)
    cond_pdf: torch.Tensor   # (H, W)
    marg_cdf: torch.Tensor   # (H+1,)
    marg_pdf: torch.Tensor   # (H,)

    @property
    def shape(self):
        return tuple(self.cond_pdf.shape)


def build_2d(f) -> Distribution2D:
    f = np.asarray(f, np.float64)
    w = f.shape[1]
    row_sum = f.sum(axis=1)
    marg_cdf, marg_pdf = _tables_1d(row_sum)
    safe = np.where(row_sum[:, None] <= 0, 1.0, row_sum[:, None])
    cond_pdf = f / safe * w
    cond_cdf = np.concatenate([np.zeros((f.shape[0], 1)),
                               np.cumsum(f / safe, axis=1)], axis=1)
    cond_cdf[:, -1] = 1.0
    return Distribution2D(_f32(cond_cdf), _f32(cond_pdf), _f32(marg_cdf),
                          _f32(marg_pdf))


def row_search(cond_cdf, yi, u):
    """For each sample, the count of entries <= u in row yi of cond_cdf
    (H, W+1), whose rows do not decrease: a binary search, one gathered
    entry a step."""
    w1 = cond_cdf.shape[1]
    flat = cond_cdf.reshape(-1)
    base = yi * w1
    lo = torch.zeros_like(yi)
    hi = torch.full_like(yi, w1)
    # invariant: row[:lo] <= u < row[hi:]
    for _ in range(int(np.ceil(np.log2(w1 + 1)))):
        mid = (lo + hi) // 2
        open_ = lo < hi
        right = flat[base + torch.clamp(mid, max=w1 - 1)] <= u
        lo = torch.where(open_ & right, mid + 1, lo)
        hi = torch.where(open_ & ~right, mid, hi)
    return lo


def sample_2d(dist: Distribution2D, uv):
    """uv (..., 2) in [0, 1)^2 -> ((..., 2) continuous (x, y) in bucket
    coordinates [0, W) x [0, H), joint pdf), the pdf as distribution2d.cpp:
    59-68 (the product of both axes' step densities)."""
    w = dist.shape[1]
    ux, uy = uv[..., 0], uv[..., 1]
    yi = _bucket(dist.marg_cdf, uy)
    yfrac = _step(dist.marg_cdf, yi, uy)
    py = dist.marg_pdf[yi]
    xi = torch.clamp(row_search(dist.cond_cdf, yi, ux) - 1, 0, w - 1)
    xfrac = _step(dist.cond_cdf.reshape(-1), yi * (w + 1) + xi, ux)
    px = dist.cond_pdf[yi, xi]
    x = xi.to(torch.float32) + xfrac
    y = yi.to(torch.float32) + yfrac
    return torch.stack([x, y], dim=-1), px * py


def pdf_2d(dist: Distribution2D, p):
    """Joint density at a normalized position p in [0, 1)^2
    (distribution2d.cpp:70-73)."""
    h, w = dist.shape
    xi = torch.clamp((p[..., 0] * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((p[..., 1] * h).to(torch.int64), 0, h - 1)
    return dist.cond_pdf[yi, xi] * dist.marg_pdf[yi]
