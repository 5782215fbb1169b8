"""The ray sets the kernels are held and timed on: camera rays, the
bounce's hemisphere rays from their hits, the NEE shadow rays to every
light, rays scattered through a scene's box, and the pair kernels' own
calls in a frame.  `chip_smoke.py`, `wide_turns` and `pairs_turns` make
them with these functions.
"""
from __future__ import annotations

import contextlib

import torch

from . import renderer
from .integrator import pathtracer as pt
from .ops import intersect as ops_i
from .ops import pairs
from .sampling import patterns
from .sampling import shapesampler as ss


def camera_rays(scene, cam, width, height, dev, seed):
    """One camera sample per pixel in tile order (sample 0): (org, dir,
    time), time None unless the scene moves."""
    order = torch.as_tensor(renderer._tile_order(width, height), device=dev)
    sid = torch.zeros_like(order)
    return renderer._gen_rays(scene, cam, width, height,
                              patterns.grid_scalars(1), order, sid, seed)


def scattered_rays(scene, n, gen, dev):
    """n rays from uniform points of the scene's box in uniform
    directions, at uniform times."""
    lo = torch.tensor(scene.bbox_lo, device=dev)
    hi = torch.tensor(scene.bbox_hi, device=dev)
    org = lo + (hi - lo) * torch.rand(n, 3, generator=gen, device=dev)
    d = torch.randn(n, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    return (org, d, torch.zeros(n, device=dev),
            torch.full((n,), float('inf'), device=dev),
            torch.rand(n, generator=gen, device=dev))


def hemisphere_rays(scene, org, dirn, hit, gen, dev):
    """Cosine-distributed rays leaving every hit point on the side facing
    the incoming ray (the bounce's scattering geometry); missed rays
    become dead lanes (tfar = -1).  Also returns the hit points' records."""
    dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
    back = (dg['Ng'] * dirn).sum(-1) > 0
    n = torch.where(back[:, None], -dg['Ng'], dg['Ng'])
    u = torch.rand(org.shape[0], 2, generator=gen, device=dev)
    wi, _ = ss.cosine_sample_hemisphere(u[:, 0], u[:, 1], n)
    eps = dg['error'] * 32.0 * 1.1920929e-7
    o = dg['P'] + wi * eps[:, None]
    tf = torch.where(hit.valid, float('inf'), -1.0)
    return o, wi, torch.zeros_like(tf), tf, dg, eps


def shadow_rays(scene, dg, eps, valid, gen, dev):
    """Rays from every hit point to a random point on every light, as the
    NEE batch lays them out (light-major); missed rays are dead lanes."""
    os_, ds, tns, tfs = [], [], [], []
    for l in scene.lights:
        u = torch.rand(dg['P'].shape[0], 2, generator=gen, device=dev)
        p = ss.uniform_sample_triangle(u[:, 0], u[:, 1], l['v0'], l['v1'],
                                       l['v2'])
        d = p - dg['P']
        dist = d.norm(dim=-1)
        os_.append(dg['P'])
        ds.append(d / dist.clamp(min=1e-20)[:, None])
        tns.append(eps)
        tfs.append(torch.where(valid, dist - eps, -1.0))
    return (torch.cat(os_), torch.cat(ds), torch.cat(tns), torch.cat(tfs))


@contextlib.contextmanager
def recorded_pair_calls():
    """Record every call of the pair kernels' wrappers (ops/pairs.py
    intersect_pairs_raw, K8, and occluded_pairs, K9) made inside the
    block, in order: a list of dicts {'kernel': the wrapper's name,
    'args': (rows, org, dirn, tnear, tfar, gs, ge), 'out': its result}.
    The wrappers run as they would; the list holds their tensors.  A
    wrapper counts its launches on the module's attribute of its name,
    the recorder while it stands in: the count carries over both ways."""
    calls = []
    wrapped = {name: getattr(pairs, name)
               for name in ('intersect_pairs_raw', 'occluded_pairs')}

    def recorder(name, fn):
        def call(rows, org, dirn, tnear, tfar, gs=None, ge=None):
            out = fn(rows, org, dirn, tnear, tfar, gs, ge)
            calls.append({'kernel': name,
                          'args': (rows, org, dirn, tnear, tfar, gs, ge),
                          'out': out})
            return out
        call.launches = fn.launches
        return call
    for name, fn in wrapped.items():
        setattr(pairs, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            fn.launches = getattr(pairs, name).launches
            setattr(pairs, name, fn)


def frame_pair_calls(scene, camera, binning, width, height, spp=1, seed=42):
    """The K8/K9 calls of one bounce-1 trace: a frame of max_depth 2
    rendered with ray_binning `binning` ('grid' or 'dense'), whose
    bounce 0 runs the BVH4 kernels and whose bounce 1 the binning's
    rounds over a pass of width * height * spp rays (up to the renderer's
    MAX_RAYS_PER_PASS).  Returns recorded_pair_calls' list."""
    with recorded_pair_calls() as calls:
        renderer.render_frame(scene, camera, pt.PTParams(
            max_depth=2, ray_binning=binning), width, height, spp=spp,
            seed=seed)
    return calls
