"""The ray sets the kernels are held and timed on: camera rays, the
bounce's hemisphere rays from their hits, the NEE shadow rays to every
light, rays scattered through a scene's box, rays started at treelet
roots, the dense kernels' entry sets, the sweep prototype's rows and
rays on a scene, and the dense, pair, binary and motion kernels', the
texture fetch's, the lobes' and the RNG's own calls in a frame; and a
committed scene's tree as 8-wide rows.
`chip_smoke.py`, `turns` and `wide_ab` make them with these functions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from types import SimpleNamespace

import numpy as np
import torch

from . import renderer
from .core import rng
from .integrator import pathtracer as pt
from .lights import lights as glights
from .ops import intersect as ops_i
from .ops import dense, pairs, traverse, treelets, wide
from .sampling import patterns
from .sampling import shapesampler as ss
from .shading import lobes, textures


def camera_rays(scene, cam, width, height, dev, seed):
    """One camera sample per pixel in tile order (sample 0): (org, dir,
    time), time None unless the scene moves."""
    order = torch.as_tensor(renderer._tile_order(width, height), device=dev)
    sid = torch.zeros_like(order)
    return renderer._gen_rays(scene, cam, width, height,
                              patterns.grid_scalars(1), order, sid, seed)[:3]


def nodes8(scene):
    """The committed scene's tree as 8-wide rows (ops/wide.py
    pack_nodes8) on its device, read back from its binary rows
    (ops/traverse.py pack_nodes): their boxes and leaf ranges, and for
    each interior node the skip of its left child, its right child, which
    is all of the tree that pack_nodes8 reads."""
    rows = scene.nodes.cpu().numpy()
    a, tag = rows[:, 6].astype(np.int64), rows[:, 7].astype(np.int64)
    leaf = tag > 0
    skip = np.zeros(rows.shape[0], np.int64)
    inner = np.nonzero(~leaf)[0]
    skip[inner + 1] = a[inner]
    tree = SimpleNamespace(lo=rows[:, 0:3], hi=rows[:, 3:6],
                           start=np.where(leaf, a, 0),
                           count=np.where(leaf, tag, 0), skip=skip)
    return torch.as_tensor(wide.pack_nodes8(tree), device=scene.device)


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


def shadow_rays(scene, dg, eps, valid, gen, dev, ns=None):
    """Rays from every hit point to a random point on every light, as the
    NEE batch lays them out (light-major); missed rays are dead lanes.
    A light of another kind than 'triangle' is sampled as the bounce
    samples it (lights.sample, about the shading normals ns: the dome's
    rays end at its bounding sphere, a directional light's never)."""
    os_, ds, tns, tfs = [], [], [], []
    for l in scene.lights:
        u = torch.rand(dg['P'].shape[0], 2, generator=gen, device=dev)
        if l['kind'] == 'triangle':
            p = ss.uniform_sample_triangle(u[:, 0], u[:, 1], l['v0'],
                                           l['v1'], l['v2'])
            d = p - dg['P']
            dist = d.norm(dim=-1)
            d = d / dist.clamp(min=1e-20)[:, None]
        else:
            _, d, _, dist = glights.sample(l, dg['P'], ns, u)
        os_.append(dg['P'])
        ds.append(d)
        tns.append(eps)
        tfs.append(torch.where(valid, dist - eps, -1.0))
    return (torch.cat(os_), torch.cat(ds), torch.cat(tns), torch.cat(tfs))


def dense_entry_rays(scene, camera, size, dev, gen, seed):
    """The dense kernels' entry sets on a scene traced densely: its
    size^2 camera rays (sample 0) followed by the hemisphere rays from
    their closest hits (the plain version's), one closest-hit batch; and
    the shadow rays from those hits to every light.  Returns (closest,
    shadow), each (org, dirn, tnear, tfar)."""
    org, dirn, _ = camera_rays(scene, camera, size, size, dev, seed)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    hit = dense.intersect_dense_plain(scene.tris, org, dirn, zeros, inf)
    ho, hd, htn, htf, dg, eps = hemisphere_rays(scene, org, dirn, hit, gen,
                                                dev)
    closest = (torch.cat([org, ho]), torch.cat([dirn, hd]),
               torch.cat([zeros, htn]), torch.cat([inf, htf]))
    return closest, shadow_rays(scene, dg, eps, hit.valid, gen, dev)


def from_treelet_roots(scene, org, dirn, tnear, tfar):
    """The rays as the 'treelet' binning's first round gives them to
    K5/K6: each started at the root of its nearest treelet ((R,) int32),
    a ray whose segment enters no treelet dead (tfar -1).  Returns
    (org, dirn, tnear, tfar, roots)."""
    tl = scene.treelets
    sel, has = treelets.treelet_assign(
        tl['treelet_boxes'], org, dirn, tnear, tfar,
        treelets.no_treelets_visited(org.shape[0],
                                     tl['treelet_boxes'].shape[0],
                                     org.device))
    return (org, dirn, tnear, torch.where(has, tfar, -1.0),
            tl['treelet_roots'][torch.clamp(sel, min=0).long()])


def sweep_sets(scene, hit, cam, hemi, n_rows=512, every=4):
    """The sweep prototype K12's sets on a scene: its n_rows packed rows
    that hold the most closest hits `hit` of its camera rays, in table
    order; every `every`-th of those rays cam (org, dirn, ...), and of
    the hemisphere rays hemi from their hits (a missed ray's dead lane is
    tested as any other: K12 has no tfar).  Returns (rows, hits in
    them, (org, dirn), (org, dirn))."""
    per_row = torch.bincount(hit.tri[hit.tri >= 0].long() // 8,
                             minlength=scene.tris.shape[0])
    top = torch.argsort(-per_row, stable=True)[:n_rows].sort().values
    return (scene.tris[top], int(per_row[top].sum()),
            *((x[0][::every].contiguous(), x[1][::every].contiguous())
              for x in (cam, hemi)))


@contextlib.contextmanager
def _recorded(module, names, arity=None):
    """Record every call of the wrappers `names` of `module` made inside
    the block, in order: a list of dicts {'kernel': the wrapper's name,
    'args': its arity positional arguments, omitted ones None (arity
    None: a dict of all its arguments by name, defaults filled in), 'out':
    its result}.  The wrappers run as they would; the list holds their
    tensors.  A wrapper that counts its launches counts them on the
    module's attribute of its name, the recorder while it stands in: the
    count carries over both ways."""
    calls = []
    wrapped = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        sig = inspect.signature(fn) if arity is None else None

        def call(*args, **kw):
            if arity is None:
                out = fn(*args, **kw)
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                args = dict(bound.arguments)
            else:
                args = args + (None,) * (arity - len(args))
                out = fn(*args)
            calls.append({'kernel': name, 'args': args, 'out': out})
            return out
        if hasattr(fn, 'launches'):
            call.launches = fn.launches
        return call
    for name, fn in wrapped.items():
        setattr(module, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            if hasattr(fn, 'launches'):
                fn.launches = getattr(module, name).launches
            setattr(module, name, fn)


def recorded_pair_calls():
    """Record every call of the pair kernels' wrappers (ops/pairs.py
    intersect_pairs_raw, K8, and occluded_pairs, K9) made inside the
    block, as _recorded does; 'args' is (rows, org, dirn, tnear, tfar,
    gs, ge)."""
    return _recorded(pairs, ('intersect_pairs_raw', 'occluded_pairs'), 7)


def recorded_binary_calls():
    """Record every call of the binary kernels' wrappers (ops/traverse.py
    intersect_packet, K5, and occluded_packet, K6) made inside the block,
    as _recorded does; 'args' is (nodes, tris, org, dirn, tnear, tfar,
    roots), roots None for a whole-tree call."""
    return _recorded(traverse, ('intersect_packet', 'occluded_packet'), 7)


def recorded_motion_calls():
    """Record every call of the motion kernel's wrappers (ops/traverse.py
    intersect_packet_mb, K7's closest form, and occluded_packet_mb, its
    any-hit form) made inside the block, as _recorded does; 'args' is
    (nodes, tris_mb, org, dirn, tnear, tfar, time)."""
    return _recorded(traverse, ('intersect_packet_mb', 'occluded_packet_mb'),
                     7)


def recorded_dense_calls():
    """Record every call of the dense kernels' wrappers (ops/dense.py
    intersect_dense, K1, and occluded_dense, K2) made inside the block, as
    _recorded does; 'args' is (tris, org, dirn, tnear, tfar)."""
    return _recorded(dense, ('intersect_dense', 'occluded_dense'), 5)


def recorded_fetch_calls():
    """Record every call of the texture fetch (shading/textures.py
    fetch, the fetch kernel on the card) made inside the block, as
    _recorded does; 'args' is (table, tid, uv)."""
    return _recorded(textures, ('fetch',), 3)


def recorded_lobe_calls():
    """Record every call of the lobes' eval and sample (shading/lobes.py
    eval_lobes and sample_lobes, the lobe kernels on the card) made
    inside the block, as _recorded does; 'args' is the call's arguments
    by name."""
    return _recorded(lobes, ('eval_lobes', 'sample_lobes'))


def recorded_rng_calls():
    """Record every draw of the RNG (core/rng.py _draw, under uniform1/2/3
    and hash_u32: the kernel F3 on the card) made inside the block, as
    _recorded does; 'args' is (n, a, b, c, d): the kind of draw (0 the key
    itself, n its floats) and the key's four streams."""
    return _recorded(rng, ('_draw',), 5)


def _bounce_one(scene, camera, binning, width, height, spp, seed):
    """Render a frame of max_depth 2 with ray_binning `binning`: bounce 0
    and bounce 1 over a pass of width * height * spp rays (up to the
    renderer's MAX_RAYS_PER_PASS)."""
    renderer.render_frame(scene, camera, pt.PTParams(
        max_depth=2, ray_binning=binning), width, height, spp=spp,
        seed=seed)


def frame_pair_calls(scene, camera, binning, width, height, spp=1, seed=42):
    """The K8/K9 calls of one bounce-1 trace: a frame of max_depth 2
    rendered with ray_binning `binning` ('grid' or 'dense'), whose
    bounce 0 runs the BVH4 kernels and whose bounce 1 the binning's
    rounds.  Returns recorded_pair_calls' list."""
    with recorded_pair_calls() as calls:
        _bounce_one(scene, camera, binning, width, height, spp, seed)
    return calls


def frame_binary_calls(scene, camera, accel_or_binning, width, height,
                       spp=1, seed=42):
    """The K5/K6 calls of one bounce-1 trace, as frame_pair_calls: with
    'bvh2' the scene's binary tables trace both bounces (the scene as
    committed with accel='bvh2', whatever its own accel), with 'grid',
    'dense' or 'treelet' bounce 1 runs that binning's rounds and the
    K5/K6 fallback ('treelet': two rounds from treelet roots, then the
    fallback).  Returns recorded_binary_calls' list."""
    binning = accel_or_binning
    if accel_or_binning == 'bvh2':
        if scene.nodes is None:
            raise ValueError("the scene has no binary BVH tables")
        scene, binning = dataclasses.replace(scene, accel='bvh2'), 'morton'
    elif binning not in ('grid', 'dense', 'treelet'):
        raise ValueError(f"unknown accel_or_binning {accel_or_binning!r}: "
                         "expected 'bvh2', 'grid', 'dense' or 'treelet'")
    with recorded_binary_calls() as calls:
        _bounce_one(scene, camera, binning, width, height, spp, seed)
    return calls


def frame_motion_calls(scene, camera, width, height, spp=1, seed=42):
    """The K7 calls of one bounce-1 trace of a motion scene committed with
    its tree (accel 'bvh4mb'), as frame_pair_calls: each bounce's closest
    call and the shadow call of its NEE.  Returns recorded_motion_calls'
    list."""
    return _frame_calls(scene, 'bvh4mb', recorded_motion_calls, camera,
                        width, height, spp, seed)


def frame_dense_calls(scene, camera, width, height, spp=1, seed=42):
    """The K1/K2 calls of one bounce-1 trace of a scene traced densely
    (accel 'dense'), as frame_motion_calls.  Returns recorded_dense_calls'
    list."""
    return _frame_calls(scene, 'dense', recorded_dense_calls, camera, width,
                        height, spp, seed)


def frame_fetch_calls(scene, camera, width, height, spp=1, seed=42):
    """The texture fetch's calls in bounces 0 and 1 of a textured scene
    (ray_binning 'morton'), one a bounce and one more where a material
    binds a bump map: tid (R, 4), the lobe slots' texture ids of the
    bounce's R hits, with uv their (R, 2) coordinates expanded over the
    slots (a bump map's call: tid and uv of R).  Returns
    recorded_fetch_calls' list."""
    with recorded_fetch_calls() as calls:
        _bounce_one(scene, camera, 'morton', width, height, spp, seed)
    return calls


def frame_lobe_calls(scene, camera, width, height, spp=1, max_depth=2,
                     seed=42, **kw):
    """The lobes' eval and sample calls of a frame of max_depth bounces
    (ray_binning 'morton'; kw to render_frame): each bounce's eval over
    every light group of its NEE, then its sample in the scatter.
    Returns recorded_lobe_calls' list."""
    with recorded_lobe_calls() as calls:
        renderer.render_frame(scene, camera, pt.PTParams(max_depth=max_depth),
                              width, height, spp=spp, seed=seed, **kw)
    return calls


def frame_rng_calls(scene, camera, width, height, spp=1, max_depth=2,
                    seed=42, **kw):
    """The RNG's draws of a frame of max_depth bounces (ray_binning
    'morton'; kw to render_frame): each pass's camera samples, then each
    bounce's light samples (with the shadow cap's jitter where there is
    a cap) over every light group of its NEE, its roulette past the
    roulette start, and its scatter's two samples.  Returns
    recorded_rng_calls' list."""
    with recorded_rng_calls() as calls:
        renderer.render_frame(scene, camera, pt.PTParams(max_depth=max_depth),
                              width, height, spp=spp, seed=seed, **kw)
    return calls


def _frame_calls(scene, accel, recorder, camera, width, height, spp, seed):
    if scene.accel != accel:
        raise ValueError(f"the scene's accel is {scene.accel!r}, not "
                         f"{accel!r}")
    with recorder() as calls:
        _bounce_one(scene, camera, 'morton', width, height, spp, seed)
    return calls
