"""The numbers that decide `correct`: what the timed path produced at
the checked pixels against the plain reference's, each number held to
its limit from the cell's file.

Frames (the film of every checked frame at the checked pixels, the sum
of each pixel's samples):
  rel_median  the median over pixels of sum|p - r| / sum|r| (pixels
              the reference lights); ulps where the two agree
  off_share   the share of pixels whose relative error passes 5%: the
              paths that part at an edge by rounding, and any fault
  rel_l1      sum|p - r| / sum|r| over every checked value
Refinements (the host's 8-bit image after every refinement of the
window at the checked pixels, and the film after the last):
  u8_off_share  the share of 8-bit values that differ by more than 1
  film_rel_median, film_rel_l1  as rel_median and rel_l1, on the last
              film's sums
"""
from __future__ import annotations

import numpy as np
import torch

OFF = 0.05


def _film_numbers(p, r, prefix=''):
    p = np.asarray(p, np.float64).reshape(-1, 3)
    r = np.asarray(r, np.float64).reshape(-1, 3)
    d = np.abs(p - r).sum(axis=1)
    m = np.abs(r).sum(axis=1)
    e = np.where(m > 0, d / np.maximum(m, 1e-30), np.where(d > 0, 1.0, 0.0))
    lit = m > 0
    out = {prefix + 'rel_median': float(np.median(e[lit] if lit.any()
                                                  else e)),
           prefix + 'rel_l1': float(d.sum() / max(m.sum(), 1e-30))}
    if not prefix:
        out['off_share'] = float(np.mean(e > OFF))
    return out


def frames(program, reference) -> dict:
    """program, reference: (frames, pixels, 3) pixel sums."""
    return _film_numbers(program, reference)


def present_u8(film_sum, k: int, gamma: float):
    """The viewer's 8-bit value of a film sum after k refinements of one
    sample: sum / k, to the power 1 / gamma, quantized (x * 255 + 0.5,
    clamped, truncated)."""
    x = film_sum / float(k)
    if gamma != 1.0:
        x = torch.pow(torch.clamp(x, min=0.0), 1.0 / gamma)
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def refinements(images, film_sum, samples, gamma: float) -> dict:
    """images: (refinements, pixels, 3) uint8 the host held after each
    refinement; film_sum: (pixels, 3) the last film's sums; samples:
    (pixels, refinements, 3) float32, the reference's radiance of each
    refinement's sample."""
    sums = torch.cumsum(samples, dim=1)                 # (P, N, 3)
    n = sums.shape[1]
    ref = torch.stack([present_u8(sums[:, k], k + 1, gamma)
                       for k in range(n)])              # (N, P, 3)
    diff = np.abs(np.asarray(images, np.int16)
                  - ref.cpu().numpy().astype(np.int16))
    out = {'u8_off_share': float(np.mean(diff > 1))}
    out.update(_film_numbers(film_sum, sums[:, -1].cpu().numpy(), 'film_'))
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {'value', 'limit'}}): every number at or under
    its limit; a number without a limit, or not finite, fails."""
    shown, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        shown[k] = {'value': v, 'limit': lim}
        ok = ok and lim is not None and np.isfinite(v) and v <= lim
    return ok and bool(numbers), shown
