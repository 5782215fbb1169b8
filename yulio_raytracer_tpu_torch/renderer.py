"""Frame rendering: the frame as passes of camera-sample ray batches.

Counterpart of `yulio_raytracer_tpu/renderer.py` (`render_frame` on one
device, with `_gen_rays` and `_tile_order`).  Rays run in 32 x 32 pixel
tile order; every (pixel, sample) ray is keyed by its absolute ids, so
a render is deterministic and independent of how the frame is cut into
passes.  Under `sampler='precomputed'` the camera samples, and the
bounce's scatter, roulette and light samples, come instead from the
reference's precomputed sample sets (sampling/precomputed.py), gathered
by each pixel's tile-seeded set and each sample's index.  Passes are
sized by device memory alone: a pass holds at most
`MAX_RAYS_PER_PASS` rays, folding several samples of every pixel into
one batch when the frame is small enough (the reference's sample-major
batching), and any ray count is accepted.  Where the frame's paths run
past the Russian-roulette start on a BVH scene, each pass runs
`pathtracer.trace_compacted`, which drops dead rays between bounces
(`compaction`, as the reference's render_frame).  A frame adds to a
film: progressive frames salt their sample ids with the iteration, as
the reference's, and `render_progressive` checkpoints the film after
each iteration so a stopped run resumes to the same film.  `pick` traces
one ray through a point of the image (the viewer's re-centring).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .film import accum
from .integrator import pathtracer
from .sampling import patterns
from .sampling import precomputed
from .utils import profiling as prof

# RNG dims reserved for the camera
DIM_PIXEL = 0
DIM_LENS = 1
DIM_TIME = 2   # motion-blur time sample
# rays per pass: ~2 KB of device memory per ray at the pass's peak
# (wavefront state, shadow batches and the compaction's copies), so a
# pass of 2^24 rays peaks near 35 GB, under half an 80 GB H100.  Fewer,
# wider passes cut the frame's bounces, and with them its host-paced
# launches and syncs, with no more device time per ray (a 64 spp
# 800^2 stereo face on an H100: 11 passes, ~115k launches and 2.5 s at
# 2^22; 3 passes, ~38k launches and 1.7 s at 2^24)
MAX_RAYS_PER_PASS = 1 << 24


def _gen_rays(scene, camera, width, height, spp, pixel_ids, sample_ids,
              seed, pixel_filter: str = 'box', samples=None):
    """Camera samples -> (org, dir, time, uv); time (R,) in [0, 1) for a
    motion scene, else None; uv (R, 2) each ray's position on the film
    ([0, 1)^2 under the box filter; the b-spline's reaches 1.5 pixels
    past it).  pixel_ids/sample_ids: (R,) int64; spp:
    patterns.grid_scalars(spp); pixel_filter: 'box' or 'bspline'.
    samples: a pass's precomputed sample sets (_pass_samples), whose
    pixel (filter applied), lens and time tables replace the stateless
    draws, gathered at each ray's set and index."""
    if pixel_filter not in ('box', 'bspline'):
        raise ValueError(f"pixel_filter must be 'box' or 'bspline', got "
                         f"{pixel_filter!r}")
    px = (pixel_ids % width).to(torch.float32)
    py = (pixel_ids // width).to(torch.float32)
    if samples is not None:
        pick = samples['set'], samples['sidx']
        juv, lens = samples['pixel'][pick], samples['lens'][pick]
    else:
        sampler = (patterns.pixel_sample_bspline if pixel_filter == 'bspline'
                   else patterns.pixel_sample)
        juv = sampler(seed, pixel_ids, sample_ids, spp, DIM_PIXEL)
        lens = patterns.sample_2d(seed, pixel_ids, sample_ids, DIM_LENS)
    uv = torch.stack([(px + juv[:, 0]) / width,
                      (py + juv[:, 1]) / height], dim=-1)
    org, dirn = camera.ray(uv, lens)
    time = None
    if scene.motion is not None:
        time = (samples['time'][pick] if samples is not None else
                patterns.sample_1d(seed, pixel_ids, sample_ids, DIM_TIME))
    return org, dirn, time, uv


def sample_tables(spp: int, iteration: int, max_depth: int,
                  pixel_filter: str, width: int, height: int, device):
    """A frame's precomputed sample sets on `device` (the reference's
    render_frame, renderer.py:345-355): build_tables' arrays for (spp,
    iteration, num_1d = max_depth, num_2d = 1 + max_depth, the filter),
    the pixels' set picks 'set_ids' (tile_set_ids) and the frame's first
    sample id 'base' (iteration * spp)."""
    tabs = precomputed.build_tables(spp, iteration, num_1d=max_depth,
                                    num_2d=1 + max_depth,
                                    pixel_filter=pixel_filter)
    tables = {k: torch.as_tensor(v, device=device) for k, v in tabs.items()}
    tables['set_ids'] = torch.as_tensor(
        precomputed.tile_set_ids(width, height), device=device).long()
    tables['base'] = iteration * spp
    return tables


def _pass_samples(tables, pixel_ids, sample_ids):
    """The frame's tables with each ray's set ('set', its pixel's pick)
    and index ('sidx', its sample id less the frame's base); None under
    the stateless sampler."""
    if tables is None:
        return None
    return dict(tables, set=tables['set_ids'][pixel_ids],
                sidx=sample_ids - tables['base'])


@lru_cache(maxsize=8)
def _tile_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Ray-order permutation: consecutive rays cover tile x tile pixel
    blocks (coherent warps for the traversal kernels)."""
    yy, xx = np.mgrid[0:height, 0:width]
    yy, xx = yy.ravel(), xx.ravel()
    tiles_x = (width + tile - 1) // tile
    tile_id = (yy // tile) * tiles_x + (xx // tile)
    order = np.lexsort((xx % tile, yy % tile, tile_id))
    return order.astype(np.int64)


COMPACTIONS = ('auto', 'on', 'off')


def compacts(scene, params, compaction: str) -> bool:
    """Whether a frame's passes run trace_compacted: 'auto' where paths
    run past the Russian-roulette start (max_depth > rr_depth), 'on' at
    any max_depth > 1, 'off' never; only on a BVH scene (the dense
    kernels' scenes keep trace).  Raises ValueError for another
    compaction."""
    if compaction not in COMPACTIONS:
        raise ValueError(f"compaction must be 'auto', 'on' or 'off', got "
                         f"{compaction!r}")
    return (scene.accel != 'dense' and params.max_depth > 1
            and (compaction == 'on' or (compaction == 'auto' and
                                        params.max_depth > params.rr_depth)))


@dataclass
class FrameStats:
    num_rays: float = 0.0
    seconds: float = 0.0

    @property
    def mrps(self):
        return self.num_rays / max(self.seconds, 1e-9) / 1e6


def _render_pass(scene, camera, params, width, height, spp_grid, pix,
                 sample0, k, seed, pixel_filter='box', tables=None,
                 backplate=None, compacted=False, bounce_stats=None):
    """One pass on the scene's device: samples sample0 .. sample0 + k - 1
    of each pixel id in pix (n,) int64 (on that device), traced by
    trace_compacted or trace.  Every ray depends on its own ids alone, so
    a pixel's sum does not depend on the pixels beside it in the pass.
    Returns ((n, 3) the pixels' radiance summed over the k samples in
    sample order, the ray count as a scalar tensor)."""
    with prof.span(prof.PASS, rays=pix.shape[0] * k):
        with prof.span(prof.RAYGEN):
            dev = pix.device
            pixel_ids = pix.repeat(k)
            sample_ids = (sample0 + torch.arange(k, device=dev)
                          ).repeat_interleave(pix.shape[0])
            samples = _pass_samples(tables, pixel_ids, sample_ids)
            org, dirn, ray_time, uv = _gen_rays(
                scene, camera, width, height, spp_grid, pixel_ids,
                sample_ids, seed, pixel_filter, samples)
        if compacted:
            rgb, nrays = pathtracer.trace_compacted(
                scene, params, org, dirn, seed, pixel_ids, sample_ids,
                ray_time, bounce_stats, uv, backplate, samples)
        else:
            rgb, nrays = pathtracer.trace(scene, params, org, dirn, seed,
                                          pixel_ids, sample_ids, ray_time,
                                          uv, backplate, samples)
        return rgb.reshape(k, -1, 3).sum(dim=0), nrays


def render_frame(scene, camera, params, width: int, height: int, spp: int,
                 seed: int = 0, device=None, compaction: str = 'auto',
                 bounce_stats=None, backplate=None, film=None,
                 iteration: int = 0, accumulate: bool = True,
                 pixel_filter: str = 'box', progress_cb=None,
                 stop_flag=None, mesh=None, sampler: str = 'stateless'):
    """Render spp samples per pixel into `film` (a new one when it is
    None or accumulate is false) on `device` (default: the scene's; it
    must be the scene's device).

    iteration: the frame's index in a progressive run; its samples are
    the ids iteration * spp + s, so frames 0..n-1 add up to one frame of
    n * spp samples.  The film's weight grows by spp.
    pixel_filter: 'box' or 'bspline' (the reference's default filter,
    sampled by importance).
    backplate: an optional (H, W, 3) image (an array or a tensor; a
    fourth channel is dropped) that escaped rays no bounce has bent see
    at their position on the film, in place of the environment lights
    (as the reference's render_frame).
    progress_cb(fraction) is called after each pass; stop_flag() is
    checked before each pass, and a true value ends the frame there
    (the film then holds the passes done, and its weight still grows by
    spp, as the reference's).

    compaction ('auto', 'on' or 'off'; see `compacts`) picks
    trace_compacted or trace for every pass; both give the same film.
    bounce_stats: an optional list that collects trace_compacted's
    per-bounce {'depth', 'width', 'live', 'seconds'} dicts of every pass.
    sampler: 'stateless' (per-ray hashed stratification) or
    'precomputed', the reference's 64 sample sets (sample_tables: built
    on the host once a frame; tables cover RoundUpPow2(spp) samples).
    mesh: a parallel.sharding.Mesh whose 'px' axis splits every pass's
    pixels over its slots (and, after parallel.sharding.init_distributed,
    over the processes); its 'tri' axis must be 1 (a triangle-sharded
    mesh renders through parallel.sharding.render_frame_sharded, else
    ValueError).  Each pixel's samples stay on one slot and are summed in
    the same order, so the film is bit-equal to the one-device film.
    Another kind of mesh (a jax.sharding.Mesh, say) raises
    NotImplementedError.  Deterministic per (scene, spp, seed,
    iteration).  Returns (film, FrameStats); the stats' seconds end after
    the device finished."""
    if mesh is not None:
        from .parallel import sharding
        if not isinstance(mesh, sharding.Mesh):
            raise NotImplementedError(
                f"render_frame(mesh=) takes a parallel.sharding.Mesh "
                f"(make_mesh), not {type(mesh).__name__}")
        if mesh.shape['tri'] > 1:
            raise ValueError("render_frame meshes are pixel-parallel; use "
                             "parallel.sharding.render_frame_sharded for a "
                             "tri axis")
    return _frame(scene, camera, params, width, height, spp, seed=seed,
                  device=device, compaction=compaction,
                  bounce_stats=bounce_stats, backplate=backplate, film=film,
                  iteration=iteration, accumulate=accumulate,
                  pixel_filter=pixel_filter, progress_cb=progress_cb,
                  stop_flag=stop_flag, mesh=mesh, sampler=sampler)


def _frame(scene, camera, params, width, height, spp, *, seed=0, device=None,
           compaction='auto', bounce_stats=None, backplate=None, film=None,
           iteration=0, accumulate=True, pixel_filter='box', progress_cb=None,
           stop_flag=None, mesh=None, sampler='stateless', pixels=None):
    """render_frame's body, over a mesh of any shape.  pixels: the ids
    of the pixels to render (a render server's bands; None: all of them,
    in tile order); the film's other pixels get no samples.  A pixel's
    samples are grouped and summed as in the whole frame, so its sum
    does not depend on which others are rendered with it."""
    if sampler not in ('stateless', 'precomputed'):
        raise ValueError("sampler must be 'stateless' or 'precomputed'")
    compacted = compacts(scene, params, compaction)
    device = scene.device if device is None else torch.device(device)
    if device != scene.device:
        raise ValueError(f"render_frame on {device}, but the scene lives "
                         f"on {scene.device}")
    with prof.span(prof.FRAME, width=width, height=height, spp=spp):
        npix = width * height
        t0 = time.perf_counter()
        if film is None or not accumulate:
            film = None
            rgb_flat = torch.zeros((npix, 3), device=device)
        else:
            rgb_flat = film.rgb_sum.reshape(npix, 3).clone()
        total_rays = torch.zeros((), device=device)
        spp_grid = patterns.grid_scalars(spp)
        if backplate is not None:
            backplate = torch.as_tensor(backplate, dtype=torch.float32,
                                        device=device)[..., :3]
        tables = (sample_tables(spp, iteration, params.max_depth, pixel_filter,
                                width, height, device)
                  if sampler == 'precomputed' else None)
        if mesh is not None:
            from .parallel import sharding
            slots = sharding.replicate(mesh, scene, camera, backplate, tables)
        order = torch.as_tensor(_tile_order(width, height) if pixels is None
                                else np.asarray(pixels), dtype=torch.int64,
                                device=device)
        # sample-major batching: fold k samples of every pixel into one pass
        fold = max(1, min(spp, MAX_RAYS_PER_PASS // npix))
        pix_per_pass = max(1, min(order.shape[0], MAX_RAYS_PER_PASS // fold))
        work = [(lo, s0) for lo in range(0, order.shape[0], pix_per_pass)
                for s0 in range(0, spp, fold)]
        for wi, (lo, s0) in enumerate(work):
            if stop_flag is not None and stop_flag():
                break
            pix = order[lo:lo + pix_per_pass]
            kw = dict(params=params, width=width, height=height,
                      spp_grid=spp_grid, sample0=iteration * spp + s0,
                      k=min(fold, spp - s0), seed=seed,
                      pixel_filter=pixel_filter, compacted=compacted,
                      bounce_stats=bounce_stats)
            if mesh is None:
                rgb, nrays = _render_pass(scene, camera, pix=pix,
                                          tables=tables, backplate=backplate,
                                          **kw)
            else:
                rgb, nrays = sharding.mesh_pass(mesh, slots, pix, **kw)
            # pixels are unique within a pass, so the scatter is a
            # deterministic permutation add
            with prof.span(prof.FILM):
                rgb_flat.index_add_(0, pix, rgb)
            total_rays = total_rays + nrays
            if progress_cb is not None:
                progress_cb((wi + 1) / len(work))
        with prof.span(prof.FILM):
            weight = (torch.full((height, width), float(spp), device=device)
                      if film is None else film.weight + float(spp))
            film = accum.Film(rgb_flat.reshape(height, width, 3), weight)
        with prof.span(prof.SYNC):
            # waits for the device (under the tracer, for its counts too)
            num_rays = prof.settle(total_rays)
        return film, FrameStats(num_rays, time.perf_counter() - t0)


def pick(scene, camera, x: float, y: float):
    """rtPick (the reference's renderer.py:503-514): one ray through the
    image point (x, y) in [0, 1]^2, with the lens at its centre, traced
    by the scene's closest-hit path on its device (a motion scene at
    time 0).  Returns (hit, p): a bool and the (3,) float32 world point
    of the hit (zeros on a miss), on the host."""
    dev = scene.device
    uv = torch.tensor([[x, y]], dtype=torch.float32, device=dev)
    org, dirn = camera.ray(uv, torch.full((1, 2), 0.5, device=dev))
    hit = pathtracer._intersect(
        scene, org, dirn, torch.zeros((1,), device=dev),
        torch.full((1,), float('inf'), device=dev),
        None if scene.motion is None else torch.zeros((1,), device=dev))
    ok = bool(hit.valid[0])
    p = org[0] + hit.t[0] * dirn[0]
    return ok, (p.cpu().numpy() if ok else np.zeros(3, np.float32))


def render_progressive(scene, camera, params, width: int, height: int,
                       spp_per_iteration: int, iterations: int,
                       checkpoint_path=None, seed: int = 0,
                       progress_cb=None, stop_flag=None):
    """Progressive refinement with a durable checkpoint (the reference's
    renderer.py:517-551): iteration it renders spp_per_iteration samples
    (render_frame's iteration it) into the film, then, with a
    checkpoint_path, writes the film's rgb_sum and weight and the next
    iteration to that .npz (atomically, through os.replace).  A run
    finding the checkpoint resumes from it, its film restored onto the
    scene's device, so a stopped and resumed run gives the film of an
    uninterrupted one.  stop_flag() is checked before each iteration;
    progress_cb(fraction) is called after each.  Returns (film, the
    iterations completed)."""
    film = None
    start_iter = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as d:
            film = accum.from_numpy_checkpoint(d, device=scene.device)
            start_iter = int(d['iteration'])
    for it in range(start_iter, iterations):
        if stop_flag is not None and stop_flag():
            break
        film, _ = render_frame(scene, camera, params, width, height,
                               spp_per_iteration, film=film, iteration=it,
                               seed=seed)
        if checkpoint_path:
            tmp = checkpoint_path + '.tmp.npz'
            np.savez(tmp, iteration=it + 1,
                     **accum.to_numpy_checkpoint(film))
            os.replace(tmp, checkpoint_path)
        if progress_cb is not None:
            progress_cb((it + 1) / iterations)
        start_iter = it + 1
    return film, start_iter
