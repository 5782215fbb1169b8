"""Light models, vectorized over ray batches.

Counterpart of `yulio_raytracer_tpu/lights/lights.py`.  A light is a dict
{'kind': str, ...params}; builders stay host-side numpy and commit moves
the arrays to the device.  This slice ports the triangle area light;
sampling or evaluating any other kind raises NotImplementedError.

`sample` and `le_area` broadcast over leading dims, so a group of
same-kind lights stacked to (nk, 1, ...) parameters samples (nk, R) shade
points in one call (the reference's vmap over a kind group).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as vm
from ..sampling import shapesampler as ss


def _np3(x):
    return np.asarray(x, np.float32)


def _not_ported(kind):
    return NotImplementedError(
        f"{kind!r} lights are not ported to the torch package yet "
        "('triangle' only)")


def triangle(v0, v1, v2, L, illum_mask=-1, shadow_mask=-1):
    v0, v1, v2 = _np3(v0), _np3(v1), _np3(v2)
    return {'kind': 'triangle', 'v0': v0, 'v1': v1, 'v2': v2,
            'L': _np3(L),
            # unnormalized Ng = cross(e1, e2) with e1 = v0 - v1, e2 = v2 - v0
            # (trianglelight.h:39); |Ng| = 2*area feeds the pdf
            'Ng': np.cross(v0 - v1, v2 - v0).astype(np.float32),
            'illum_mask': illum_mask, 'shadow_mask': shadow_mask}


def set_scene_bounds(light, bbox_lo, bbox_hi):
    """Only the ambient dome reads the scene bounds."""
    if light['kind'] == 'ambient':
        raise _not_ported('ambient')
    return light


def sample(light, P, Ns, u2):
    """Sample incoming illumination at shade points P (..., 3) with u2
    (..., 2).  Returns (Le (..., 3), wi (..., 3), pdf (...), tmax (...));
    zero radiance or pdf marks an invalid sample."""
    if light['kind'] != 'triangle':
        raise _not_ported(light['kind'])
    # trianglelight.h: pdf = 2 t^3 / |d . Ng| (solid angle, |Ng| = 2A);
    # zero radiance from the back side
    p = ss.uniform_sample_triangle(u2[..., 0], u2[..., 1], light['v0'],
                                   light['v1'], light['v2'])
    d = p - P
    tmax = vm.length(d)
    d_dot_ng = vm.dot(d, light['Ng'])
    wi = d / torch.clamp(tmax, min=1e-20)[..., None]
    pdf = 2.0 * tmax ** 3 / torch.clamp(torch.abs(d_dot_ng), min=1e-20)
    le = torch.where((d_dot_ng < 0.0)[..., None], light['L'].expand(d.shape),
                     0.0)
    return le, wi, pdf, tmax


def le_area(light, backfacing):
    """Emission of a hit area light; zero when the hit is backfacing."""
    if light['kind'] != 'triangle':
        raise _not_ported(light['kind'])
    return torch.where(backfacing[..., None], 0.0, light['L'])
