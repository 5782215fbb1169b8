"""Debug renderer: white-on-escape diffuse-bounce visualization.

Counterpart of `yulio_raytracer_tpu/integrator/debugrenderer.py`
(:20-59, the reference's `renderers/debugrenderer.cpp:28-130`): up to
max_depth cosine-weighted diffuse bounces about the face-forward
geometric normal, no shading, white where the path escapes.  It traces
through the path tracer's closest-hit path (`pathtracer._intersect`: the
dense kernels, or the scene's BVH kernels), so it measures how fast the
walks run without the bounce's shading: a scene and BVH sanity view and
a ray-throughput probe.  Bounce d draws its direction from
`rng.uniform2(seed, pixel_id, 0, 8 + d)` and re-originates at 0.999 t,
as the reference.  Lanes whose path has ended are traced with tfar = -1
(the kernels reject them at once) where the reference retraces them;
their results were never read.  A motion scene is traced at time 0.

`render` drives a frame: `spp` rays through each pixel's centre, each
with its own RNG key (`DebugParams.spp`; the reference's `trace` takes
the keys from its caller).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..core import math as vm
from ..core import rng
from ..sampling import shapesampler as ss
from .pathtracer import _intersect


@dataclass(frozen=True)
class DebugParams:
    max_depth: int = 1
    spp: int = 1


def trace(scene, params: DebugParams, org, dirn, seed, pixel_id):
    """org/dirn (R, 3) f32, pixel_id (R,) int64 holding u32 RNG keys.
    Returns ((R, 3) colour: white on escape, black on a path still
    alive after max_depth bounces; the traced-ray count, a scalar
    tensor)."""
    r, dev = org.shape[0], org.device
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    escaped = torch.zeros((r,), dtype=torch.bool, device=dev)
    nrays = torch.zeros((), device=dev)
    tnear = torch.zeros((r,), device=dev)
    t0 = None if scene.motion is None else tnear
    for depth in range(params.max_depth):
        hit = _intersect(scene, org, dirn, tnear,
                         torch.where(alive, float('inf'), -1.0), t0)
        nrays = nrays + torch.sum(alive)
        escaped = escaped | (alive & ~hit.valid)
        alive = alive & hit.valid
        # diffuse bounce (debugrenderer.cpp:113-119)
        idx = torch.clamp(hit.tri, min=0).to(torch.int64)
        ng = vm.normalize(scene.geom['shade_tab'][idx, 0:3])
        nf = torch.where((vm.dot(-dirn, ng) < 0)[:, None], -ng, ng)
        u2 = rng.uniform2(seed, pixel_id, 0, 8 + depth)
        new_dir, _ = ss.cosine_sample_hemisphere(u2[..., 0], u2[..., 1], nf)
        new_org = org + 0.999 * hit.t[:, None] * dirn
        org = torch.where(alive[:, None], new_org, org)
        dirn = torch.where(alive[:, None], new_dir, dirn)
    color = torch.where(escaped, 1.0, 0.0)[:, None].expand(r, 3)
    return color.contiguous(), nrays


def render(scene, camera, params: DebugParams, width: int, height: int,
           seed: int = 0):
    """A width x height frame on the scene's device: params.spp rays
    through each pixel's centre (ray k of pixel p keyed k * W * H + p),
    in 32 x 32 pixel tiles, in passes of at most the renderer's
    MAX_RAYS_PER_PASS rays.
    Returns ((H, W, 3) mean colour, renderer.FrameStats), the seconds
    ending with the device finished."""
    from .. import renderer
    dev = scene.device
    npix = width * height
    t0 = time.perf_counter()
    order = torch.as_tensor(renderer._tile_order(width, height), device=dev)
    ray_ids = (order[None, :] + npix * torch.arange(
        params.spp, device=dev)[:, None]).reshape(-1)
    rgb = torch.zeros((npix, 3), device=dev)
    nrays = torch.zeros((), device=dev)
    per_pass = renderer.MAX_RAYS_PER_PASS
    for lo in range(0, ray_ids.shape[0], per_pass):
        ids = ray_ids[lo:lo + per_pass]
        pix = ids % npix
        uv = torch.stack([((pix % width).to(torch.float32) + 0.5) / width,
                          ((pix // width).to(torch.float32) + 0.5) / height],
                         dim=-1)
        org, dirn = camera.ray(uv, torch.full_like(uv, 0.5))
        color, n = trace(scene, params, org, dirn, seed, ids)
        rgb.index_add_(0, pix, color)
        nrays = nrays + n
    img = (rgb / params.spp).reshape(height, width, 3)
    num_rays = float(nrays)               # waits for the device
    return img, renderer.FrameStats(num_rays, time.perf_counter() - t0)
