"""Camera ray generation.

Counterpart of `yulio_raytracer_tpu/cameras/cameras.py`: `look_at` and
the pinhole camera, with the reference's conventions (Z = normalize(point
- eye), U = normalize(cross(up, Z)), V = normalize(cross(Z, U));
dir = normalize(px * vx + (1 - py) * vy + vz)).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import math as vm


def look_at(eye, point, up):
    """-> (4, 3) f32 affine [vx; vy; vz; p] on the CPU."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    z = vm.normalize(torch.as_tensor(point, dtype=torch.float32) - eye)
    u = vm.normalize(vm.cross(torch.as_tensor(up, dtype=torch.float32), z))
    v = vm.normalize(vm.cross(z, u))
    return torch.stack([u, v, z, eye])


def _pixel2world(l2w, angle_deg, aspect):
    w = vm.xfm_vector(l2w, torch.tensor(
        [-0.5 * aspect, -0.5, 0.5 / np.tan(np.deg2rad(0.5 * angle_deg))],
        dtype=torch.float32, device=l2w.device))
    return torch.stack([aspect * l2w[0], l2w[1], w, l2w[3]])


@dataclass(frozen=True)
class Pinhole:
    local2world: torch.Tensor
    angle: float = 64.0
    aspect: float = 1.0

    def ray(self, pixel, sample):
        """pixel: (R, 2) in [0,1]^2; sample unused -> (org, dir) (R, 3)
        on pixel's device."""
        p2w = _pixel2world(self.local2world.to(pixel.device), self.angle,
                           self.aspect)
        d = (pixel[:, 0:1] * p2w[0] + (1.0 - pixel[:, 1:2]) * p2w[1]
             + p2w[2])
        org = p2w[3].expand(d.shape)
        return org, vm.normalize(d)
