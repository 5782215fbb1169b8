"""Frame rendering: the frame as passes of camera-sample ray batches.

Counterpart of `yulio_raytracer_tpu/renderer.py` (`render_frame` on one
device, with `_gen_rays` and `_tile_order`).  Rays run in 32 x 32 pixel
tile order; every (pixel, sample) ray is keyed by its absolute ids, so
a render is deterministic and independent of how the frame is cut into
passes.  Passes are sized by device memory alone: a pass holds at most
`MAX_RAYS_PER_PASS` rays, folding several samples of every pixel into
one batch when the frame is small enough (the reference's sample-major
batching), and any ray count is accepted.  Where the frame's paths run
past the Russian-roulette start on a BVH scene, each pass runs
`pathtracer.trace_compacted`, which drops dead rays between bounces
(`compaction`, as the reference's render_frame).  A frame adds to a
film: progressive frames salt their sample ids with the iteration, as
the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .film import accum
from .integrator import pathtracer
from .sampling import patterns

# RNG dims reserved for the camera
DIM_PIXEL = 0
DIM_LENS = 1
DIM_TIME = 2   # motion-blur time sample
# rays per pass: ~1 KB of wavefront state per ray (shadow batches
# included) keeps a pass within a few GB of device memory
MAX_RAYS_PER_PASS = 1 << 22


def _gen_rays(scene, camera, width, height, spp, pixel_ids, sample_ids,
              seed, pixel_filter: str = 'box'):
    """Camera samples -> (org, dir, time, uv); time (R,) in [0, 1) for a
    motion scene, else None; uv (R, 2) each ray's position on the film
    ([0, 1)^2 under the box filter; the b-spline's reaches 1.5 pixels
    past it).  pixel_ids/sample_ids: (R,) int64; spp:
    patterns.grid_scalars(spp); pixel_filter: 'box' or 'bspline'."""
    px = (pixel_ids % width).to(torch.float32)
    py = (pixel_ids // width).to(torch.float32)
    if pixel_filter == 'bspline':
        juv = patterns.pixel_sample_bspline(seed, pixel_ids, sample_ids,
                                            spp, DIM_PIXEL)
    elif pixel_filter == 'box':
        juv = patterns.pixel_sample(seed, pixel_ids, sample_ids, spp,
                                    DIM_PIXEL)
    else:
        raise ValueError(f"pixel_filter must be 'box' or 'bspline', got "
                         f"{pixel_filter!r}")
    lens = patterns.sample_2d(seed, pixel_ids, sample_ids, DIM_LENS)
    uv = torch.stack([(px + juv[:, 0]) / width,
                      (py + juv[:, 1]) / height], dim=-1)
    org, dirn = camera.ray(uv, lens)
    time = (patterns.sample_1d(seed, pixel_ids, sample_ids, DIM_TIME)
            if scene.motion is not None else None)
    return org, dirn, time, uv


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
    The reference's `mesh` (pixel parallelism over devices) and
    `sampler='precomputed'` are not ported: they raise
    NotImplementedError.  Deterministic per (scene, spp, seed,
    iteration).  Returns (film, FrameStats); the stats' seconds end
    after the device finished."""
    if mesh is not None:
        raise NotImplementedError("render_frame(mesh=): multi-device pixel "
                                  "parallelism is not ported yet (ROADMAP "
                                  "A8)")
    if sampler == 'precomputed':
        raise NotImplementedError("render_frame(sampler='precomputed'): the "
                                  "precomputed sample sets are not ported "
                                  "yet (ROADMAP A9)")
    if sampler != 'stateless':
        raise ValueError("sampler must be 'stateless' or 'precomputed'")
    compacted = compacts(scene, params, compaction)
    device = scene.device if device is None else torch.device(device)
    if device != scene.device:
        raise ValueError(f"render_frame on {device}, but the scene lives "
                         f"on {scene.device}")
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
    order = torch.as_tensor(_tile_order(width, height), device=device)
    pix_per_pass = max(1, min(npix, MAX_RAYS_PER_PASS))
    # sample-major batching: fold k samples of every pixel into one batch
    fold = max(1, min(spp, MAX_RAYS_PER_PASS // npix))
    work = [(lo, s0) for lo in range(0, npix, pix_per_pass)
            for s0 in range(0, spp, fold)]
    for wi, (lo, s0) in enumerate(work):
        if stop_flag is not None and stop_flag():
            break
        pix = order[lo:lo + pix_per_pass]
        k = min(fold, spp - s0)
        pixel_ids = pix.repeat(k)
        sample_ids = (iteration * spp + s0 + torch.arange(
            k, device=device)).repeat_interleave(pix.shape[0])
        org, dirn, ray_time, uv = _gen_rays(
            scene, camera, width, height, spp_grid, pixel_ids,
            sample_ids, seed, pixel_filter)
        if compacted:
            rgb, nrays = pathtracer.trace_compacted(
                scene, params, org, dirn, seed, pixel_ids, sample_ids,
                ray_time, bounce_stats, uv, backplate)
        else:
            rgb, nrays = pathtracer.trace(scene, params, org, dirn, seed,
                                          pixel_ids, sample_ids, ray_time,
                                          uv, backplate)
        # pixels are unique within each of the k sample slices, so
        # the scatter is a deterministic permutation add
        rgb_flat.index_add_(0, pix, rgb.reshape(k, -1, 3).sum(dim=0))
        total_rays = total_rays + nrays
        if progress_cb is not None:
            progress_cb((wi + 1) / len(work))
    weight = (torch.full((height, width), float(spp), device=device)
              if film is None else film.weight + float(spp))
    film = accum.Film(rgb_flat.reshape(height, width, 3), weight)
    num_rays = float(total_rays)          # waits for the device
    return film, FrameStats(num_rays, time.perf_counter() - t0)
