"""Camera ray generation.

Counterpart of `yulio_raytracer_tpu/cameras/cameras.py`: `look_at`, the
pinhole, depth-of-field and stereo cube-map cameras and
`make_stereo_rig`, with the reference's conventions (Z = normalize(point
- eye), U = normalize(cross(up, Z)), V = normalize(cross(Z, U));
dir = normalize(px * vx + (1 - py) * vy + vz)).  The stereo cube keeps
the GearVR up/down flips, the eye offset sign (faces 0-5 the left eye),
the vertical stereo falloff, the head rotation about normalize(up)
through the origin and the optional toe-in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import math as vm
from ..sampling import shapesampler as ss

EYE_SEPARATION = 6.35 * 0.393701          # StereoCubeCamera.h:7
ZERO_PARALLAX = EYE_SEPARATION * 30.0     # StereoCubeCamera.h:8


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


@dataclass(frozen=True)
class DepthOfField:
    local2world: torch.Tensor
    angle: float = 64.0
    aspect: float = 1.0
    lens_radius: float = 0.0
    focal_distance: float = 1.0

    def ray(self, pixel, sample):
        """pixel: (R, 2) in [0,1]^2; sample: (R, 2) lens sample -> (org,
        dir) (R, 3) on pixel's device.  The focal plane lies at
        focal_distance along the central ray."""
        l2w = self.local2world.to(pixel.device)
        p2w = _pixel2world(l2w, self.angle, self.aspect)
        fd = self.focal_distance / torch.linalg.norm(
            0.5 * p2w[0] + 0.5 * p2w[1] + p2w[2])
        lens = ss.uniform_sample_disk(sample, self.lens_radius)
        begin = vm.xfm_point(l2w, torch.cat(
            [lens, torch.zeros_like(lens[..., :1])], dim=-1))
        end = p2w[3] + fd * (pixel[:, 0:1] * p2w[0]
                             + (1.0 - pixel[:, 1:2]) * p2w[1] + p2w[2])
        return begin, vm.normalize(end - begin)


def _sign(x):
    return torch.where(x < 0.0, -1.0, 1.0)


def _arccos_deg(x):
    return torch.rad2deg(torch.arccos(torch.clamp(x, -1.0, 1.0)))


@dataclass(frozen=True)
class StereoCube:
    """One of a viewpoint's 12 cameras (6 faces x 2 eyes).

    cube_face_index: 0..11; face = index % 6 in the order front, right,
    back, left, up, down; an index below 6 is the left eye (-0.5 eye
    offsets), the others the right eye."""
    local2world: torch.Tensor
    cube_face_index: int = 0
    origin: Optional[torch.Tensor] = None
    up: tuple = (0.0, 1.0, 0.0)
    scene_scale: float = 1.0
    eye_separation: float = EYE_SEPARATION
    zero_parallax: float = ZERO_PARALLAX
    toe_in: bool = False
    falloff_angle: float = 30.0

    def _face(self):
        """(this face's pixel-to-world affine, the front face's, origin,
        up) on the CPU: the side faces turn the front about up through
        the origin; the up and down faces turn it about the right axis
        by -90 and 90 degrees, then half a turn about up (the GearVR
        flips)."""
        l2w = torch.as_tensor(self.local2world, dtype=torch.float32).cpu()
        origin = (l2w[3] if self.origin is None else
                  torch.as_tensor(self.origin, dtype=torch.float32).cpu())
        up = torch.tensor(self.up, dtype=torch.float32)
        front = _pixel2world(l2w, 90.0, 1.0)

        def rot(axis, deg, m):
            return vm.affine_compose(vm.affine_rotate(
                origin, axis, torch.tensor(np.deg2rad(deg),
                                           dtype=torch.float32)), m)

        face = self.cube_face_index % 6
        if face < 4:
            p2w = front if face == 0 else rot(up, (90.0, 180.0, -90.0)[
                face - 1], front)
        else:
            # right = cross(normalize(up), normalize(lookAt - origin))
            # (StereoCubeCamera.h:28); the forward axis is local2world's vz
            rightv = vm.cross(vm.normalize(up), vm.normalize(l2w[2]))
            p2w = rot(up, 180.0, rot(rightv, -90.0 if face == 4 else 90.0,
                                     front))
        return p2w, front, origin, up

    def ray(self, pixel, sample):
        """StereoCubeCamera::ray (StereoCubeCamera.h:68-161): pixel (R, 2)
        in [0,1]^2, sample unused -> (org, dir) (R, 3) on pixel's
        device."""
        dev = pixel.device
        p2w, front, origin, up = (x.to(dev) for x in self._face())
        face = self.cube_face_index % 6
        px = pixel[:, 0]
        ypix = 1.0 - pixel[:, 1]
        fvx, fvy, fvz = front[0], front[1], front[2]
        xyz_straight = vm.normalize(0.5 * fvx + 0.5 * fvy + fvz)
        if face < 4:
            # side faces: horizontal and vertical angles off the centre
            xdir = vm.normalize(px[:, None] * fvx + 0.5 * fvy + fvz)
            theta = torch.arccos(torch.clamp(
                vm.dot(xdir, xyz_straight), -1.0, 1.0)) * _sign(px - 0.5)
            ydir = vm.normalize(0.5 * fvx + ypix[:, None] * fvy + fvz)
            abs_vert = torch.abs(_arccos_deg(vm.dot(ydir, xyz_straight))
                                 * _sign(ypix - 0.5))
        else:
            # up and down faces: the head turns by the in-face 2D angle
            # (the exact centre, xy = 0, normalizes to 0 as the reference)
            xy = torch.stack([px - 0.5, ypix - 0.5, torch.zeros_like(px)],
                             dim=-1)
            xy_up = torch.tensor([0.0, -1.0 if face == 4 else 1.0, 0.0],
                                 device=dev)
            theta = torch.arccos(torch.clamp(
                vm.dot(vm.normalize(xy), xy_up), -1.0, 1.0)) \
                * _sign(px - 0.5)
            xyzdir = vm.normalize(px[:, None] * fvx + ypix[:, None] * fvy
                                  + fvz)
            abs_vert = 90.0 - torch.abs(_arccos_deg(
                vm.dot(xyzdir, xyz_straight)))

        # the eye offset with the vertical stereo falloff (:127-144)
        eye_sep = self.eye_separation * self.scene_scale
        zero_par = self.zero_parallax * self.scene_scale
        eye_off = torch.tensor(eye_sep, dtype=torch.float32, device=dev) * (
            -0.5 if self.cube_face_index < 6 else 0.5)
        fall = 1.0 - vm.smoothstep(0.0, 1.0, vm.smoothstep(
            self.falloff_angle, 90.0, abs_vert))
        eye_off = torch.where(abs_vert > self.falloff_angle, eye_off * fall,
                              eye_off)

        # translate by the eye offset (p2w * translate((eyeOff, 0, 0))
        # moves p by eyeOff * vx), then turn the eye about the head axis
        p_eye = p2w[3] + eye_off[:, None] * p2w[0]
        u = vm.normalize(up)
        ray_origin = origin + vm.rotate_about_axis(p_eye - origin, u, theta)

        vx, vy, vz = p2w[0], p2w[1], p2w[2]
        if self.toe_in and zero_par != 0.0:
            # toe-in (:152-156): the view turns about up through the eye
            # by -atan(eyeOff / zeroParallax)
            corr = -torch.arctan(eye_off / zero_par)
            vx, vy, vz = (vm.rotate_about_axis(v.expand(ray_origin.shape),
                                               u, corr)
                          for v in (vx, vy, vz))
        d = px[:, None] * vx + ypix[:, None] * vy + vz
        return ray_origin, vm.normalize(d)


def make_stereo_rig(local2world, origin=None, up=(0, 1, 0), scene_scale=1.0,
                    eye_separation=EYE_SEPARATION, zero_parallax=ZERO_PARALLAX,
                    toe_in=False, falloff_angle=30.0):
    """The 12 StereoCube cameras of one viewpoint (ColladaLoader.cpp:
    480-498)."""
    return [StereoCube(local2world, i, origin, tuple(up), scene_scale,
                       eye_separation, zero_parallax, toe_in, falloff_angle)
            for i in range(12)]
