"""Ranged sweeps over triangle tiles: the pair kernels of the grid path
and of the 'dense' ray binning.

Counterpart of `yulio_raytracer_tpu/ops/pallas_pairs.py` (`pack_planes`,
`intersect_pairs_raw`, `occluded_pairs`, `recompute_uv` and
`intersect_pairs`), which imports jax, so the packing is copied here.
The grid path (ops/grid.py) sweeps each ray's cell's tiles; the 'dense'
binning (ops/treelets.py) sweeps its nearest treelet's tiles of a static
BVH scene's own rows.  Triangles sit in tiles of TL = 128 slots; slot s holds the 16 constants
[woop.T (12) | ng (3) | cull] of one triangle, and zero padding never
hits.  The reference's kernels read them lane-major (`planes`,
(Gt, 16, 128)), the layout of the TPU's vector unit; a thread that tests
one triangle reads its 64-byte row, so the port's kernels and plain
versions take the row-major copy `rows` (Gt * 128, 16).

Each ray sweeps the slots of its own tile range [gs, ge) (per-ray (R,)
int32 tensors; with no range, the whole table).  The reference gives a
range to each 64-ray block: the case where a block's rays carry equal
ranges.  Closest-hit ties follow the TPU kernel, which keeps a best t per
lane (slot % TL), updated only on a strictly nearer hit, then takes the
least lane among the minima: among equal t the least slot % TL wins,
then the least tile.

On a CUDA tensor each wrapper launches its kernel from `csrc/grid.cu`:
with ranges, `bin_rays` first groups the rays by their first tile (the
reference's grouping), then the sweep gives each 128-ray block rays of
one group and stages each of their tiles once in shared memory; without
ranges each block takes 128 consecutive rays over the whole table.  On a
CPU tensor it runs the plain torch version: the pair test
(`ops/intersect.py` woop_test, which is `_pair_tile`'s operation order)
over one tile of every ray at a time.  Any ray count is accepted.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build as cb
from .intersect import Hit, woop_test

TL = 128             # slots per tile (pallas_pairs.TL)
INF = float('inf')
# rays per slice of the plain sweep: its largest temporary, the (16, n, TL)
# f32 rows of one tile step, stays at 256 MB
_PLAIN_RAYS = 1 << 15

_V, _I = ctypes.c_void_p, ctypes.c_int
# every entry point of csrc/grid.cu (ops/grid.py launches the march)
_SIGNATURES = {
    'yrt_pairs_scratch': [_I] * 2,
    'yrt_bin_pairs': [_V] * 4 + [_I] * 2 + [_V] * 5,
    'yrt_intersect_pairs': [_V] * 7 + [_I] * 2 + [_V] * 3,
    'yrt_occluded_pairs': [_V] * 7 + [_I] * 2 + [_V] * 2,
    'yrt_grid_march': [_V] * 9 + [_I] * 2 + [_V] * 3,
}


def pack_planes(woop: np.ndarray, geom_host: dict):
    """(planes, rows): the triangle constants of every triangle in tiles
    of TL slots.  planes (Gt, 16, TL) f32 holds constant j of slot
    g * TL + l at [g, j, l] (the reference kernels' layout); rows
    (Gt * TL, 16) f32 is the row-major copy the port's kernels read.
    Padding slots are zero."""
    t = woop.shape[1] // 3
    gt = (t + TL - 1) // TL
    rows = np.zeros((gt * TL, 16), np.float32)
    wv = np.asarray(woop, np.float32).reshape(4, t, 3)
    for i in range(4):
        rows[:t, 3 * i:3 * i + 3] = wv[i]
    rows[:t, 12:15] = geom_host['ng']
    rows[:t, 15] = geom_host['cull']
    return planes_of(rows), rows


def planes_of(rows: np.ndarray) -> np.ndarray:
    """The lane-major planes (Gt, 16, TL) of rows (Gt * TL, 16)."""
    return np.ascontiguousarray(rows.reshape(-1, TL, 16).transpose(0, 2, 1))


def recompute_uv(rows, org, dirn, t, slot):
    """Barycentric u/v of each ray's hit slot (-1: none, u = v = 0) at
    distance t, in the pair test's operation order."""
    s = rows[torch.clamp(slot, min=0).to(torch.int64)]
    ok = slot >= 0
    oup = (org[:, 0] * s[:, 0] + org[:, 1] * s[:, 3]
           + org[:, 2] * s[:, 6] + s[:, 9])
    ovp = (org[:, 0] * s[:, 1] + org[:, 1] * s[:, 4]
           + org[:, 2] * s[:, 7] + s[:, 10])
    dup = dirn[:, 0] * s[:, 0] + dirn[:, 1] * s[:, 3] + dirn[:, 2] * s[:, 6]
    dvp = dirn[:, 0] * s[:, 1] + dirn[:, 1] * s[:, 4] + dirn[:, 2] * s[:, 7]
    return (torch.where(ok, oup + t * dup, 0.0),
            torch.where(ok, ovp + t * dvp, 0.0))


def better(t, slot, best_t, best_slot):
    """Where the hit (t, slot) replaces (best_t, best_slot) under the TPU
    kernel's tie rule (strictly nearer, or as near in a lesser lane)."""
    return (t < best_t) | ((t == best_t) & (slot >= 0) & (best_slot >= 0)
                           & (slot % TL < best_slot % TL))


# ------------------------------------------------------- plain versions

def _full_ranges(rows, org, gs, ge):
    if gs is None:
        gs = torch.zeros(org.shape[:1], dtype=torch.int32, device=org.device)
        ge = torch.full_like(gs, rows.shape[0] // TL)
    return gs, ge


def _sweep(rows, org, dirn, tnear, tfar, gs, ge):
    """The plain sweep, step by step: (ray slice, tile (n,), in range
    (n,), th (n, TL), ok (n, TL)), where step k tests tile gs + k of
    every ray of the slice whose range holds it."""
    lane = torch.arange(TL, device=org.device)
    for r0 in range(0, org.shape[0], _PLAIN_RAYS):
        sl = slice(r0, r0 + _PLAIN_RAYS)
        g0, g1 = gs[sl], ge[sl]
        o, d = org[sl][:, None, :], dirn[sl][:, None, :]
        tn, tf = tnear[sl][:, None], tfar[sl][:, None]
        for k in range(max(0, int((g1 - g0).max()))):
            tile = g0 + k
            inrange = tile < g1
            slot = torch.where(inrange, tile, 0)[:, None] * TL + lane
            s = rows[slot.to(torch.int64)].permute(2, 0, 1)   # (16, n, TL)
            th, _, _, ok = woop_test(s, o, d, tn, tf)
            yield sl, tile, inrange, th, ok & inrange[:, None]


def intersect_pairs_raw_plain(rows, org, dirn, tnear, tfar, gs=None,
                              ge=None, counts=None):
    """Plain torch version of the ranged closest-hit kernel (K8): (t, slot)
    of each ray's best hit (inf, -1 on a miss).  counts, a dict, gathers
    the pair tests the kernel makes ('pair')."""
    if org.is_cuda:
        intersect_pairs_raw_plain.cuda_calls += 1
    gs, ge = _full_ranges(rows, org, gs, ge)
    best_t = torch.full(org.shape[:1], INF, device=org.device)
    best_s = torch.full(org.shape[:1], -1, dtype=torch.int32,
                        device=org.device)
    lane = torch.arange(TL, device=org.device)
    for sl, tile, inrange, th, ok in _sweep(rows, org, dirn, tnear, tfar,
                                            gs, ge):
        th = torch.where(ok, th, INF)
        tmin = torch.amin(th, dim=1)
        first = torch.amin(torch.where(th == tmin[:, None], lane, TL), dim=1)
        slot = torch.where(tmin < INF, tile * TL + first, -1).to(torch.int32)
        take = better(tmin, slot, best_t[sl], best_s[sl])
        best_t[sl] = torch.where(take, tmin, best_t[sl])
        best_s[sl] = torch.where(take, slot, best_s[sl])
        cb.count(counts, 'pair', inrange.sum() * TL)
    return best_t, best_s


def occluded_pairs_plain(rows, org, dirn, tnear, tfar, gs=None, ge=None,
                         counts=None):
    """Plain torch version of the ranged any-hit kernel (K9); rays with
    tfar <= tnear report not occluded.  counts gathers the pair tests
    the kernel makes up to each ray's first hit ('pair')."""
    if org.is_cuda:
        occluded_pairs_plain.cuda_calls += 1
    gs, ge = _full_ranges(rows, org, gs, ge)
    occ = torch.zeros(org.shape[:1], dtype=torch.bool, device=org.device)
    lane = torch.arange(TL, device=org.device)
    for sl, _, inrange, _, ok in _sweep(rows, org, dirn, tnear, tfar, gs,
                                        ge):
        if counts is not None:
            first = torch.amin(torch.where(ok, lane + 1, TL), dim=1)
            cb.count(counts, 'pair',
                     torch.where(inrange & ~occ[sl], first, 0).sum())
        occ[sl] |= torch.any(ok, dim=1)
    return occ


# ------------------------------------------------------------- wrappers

def lib():
    """The loaded library of csrc/grid.cu."""
    return cb.library('grid', _SIGNATURES)


def index_arg(name, x, shape, device):
    """Check an int32 index tensor of `shape` on `device`; contiguous."""
    x = x.contiguous()
    if x.dtype != torch.int32 or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"{name}: expected an int32 tensor of shape {shape} "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x


def kernel_args(rows, org, dirn, tnear, tfar, gs, ge):
    if rows.shape[0] % TL:
        raise ValueError(f"rows: {rows.shape[0]} slots are not whole tiles "
                         f"of {TL}")
    if (gs is None) != (ge is None):
        raise ValueError("gs and ge are given together or not at all")
    rays = cb.ray_args(org, dirn, tnear, tfar)
    r, dev = rays[0].shape[0], rays[0].device
    if gs is not None:
        gs = index_arg('gs', gs, (r,), dev)
        ge = index_arg('ge', ge, (r,), dev)
    return (cb.table_arg('rows', rows, 16, dev), *rays, gs, ge,
            rows.shape[0] // TL, r)


def launch(lib, entry, *args):
    """The binning yrt_bin_pairs of lib, a build of csrc/grid.cu, on (gs,
    ge, tnear, tfar, n_tiles, scratch, t, slot, occ), or its sweep K8
    (yrt_intersect_pairs) or K9 (yrt_occluded_pairs) on (rows, org, dirn,
    tnear, tfar, ge, scratch, n_tiles, outputs); the C interface takes
    the ray count after n_tiles."""
    k, rays = (5, args[0]) if entry == 'yrt_bin_pairs' else (8, args[1])
    cb.launch(getattr(lib, entry), entry, rays.device, *args[:k],
              rays.shape[0], *args[k:])


def bin_rays(gs, ge, tnear, tfar, n_tiles, t=None, slot=None, occ=None):
    """Group the rays that sweep something (ge > gs, tfar > tnear) by
    their first tile gs on the card (csrc/grid.cu yrt_bin_pairs: a count,
    a scan and a scatter), and write the results of the others: inf and
    -1 into t and slot (K8), or false into occ (K9).  Returns the int32
    scratch (the permutation and the work list) that the sweep reads.
    The arguments are checked by the sweep's wrapper."""
    scratch = torch.empty((lib().yrt_pairs_scratch(n_tiles, gs.shape[0]),),
                          dtype=torch.int32, device=gs.device)
    _OPS['bin_pairs'](gs, ge, tnear, tfar, n_tiles, scratch, t, slot, occ)
    return scratch


def intersect_pairs_raw(rows, org, dirn, tnear, tfar, gs=None, ge=None):
    """(t, slot): each ray's closest hit over the slots of its tiles
    [gs, ge) (the whole table without ranges); inf and -1 on a miss."""
    if org.device.type == 'cpu':
        return intersect_pairs_raw_plain(rows, org, dirn, tnear, tfar, gs,
                                         ge)
    rows, *rays, gs, ge, n_tiles, r = kernel_args(rows, org, dirn, tnear,
                                                  tfar, gs, ge)
    dev = rows.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    slot = torch.empty((r,), dtype=torch.int32, device=dev)
    scratch = None if gs is None else bin_rays(gs, ge, *rays[2:], n_tiles,
                                               t=t, slot=slot)
    _OPS['intersect_pairs'](rows, *rays, ge, scratch, n_tiles, t, slot)
    return t, slot


def occluded_pairs(rows, org, dirn, tnear, tfar, gs=None, ge=None):
    """(R,) bool: does any slot of each ray's tiles [gs, ge) occlude the
    segment (tnear, tfar); false where tfar <= tnear."""
    if org.device.type == 'cpu':
        return occluded_pairs_plain(rows, org, dirn, tnear, tfar, gs, ge)
    rows, *rays, gs, ge, n_tiles, r = kernel_args(rows, org, dirn, tnear,
                                                  tfar, gs, ge)
    occ = torch.empty((r,), dtype=torch.bool, device=rows.device)
    scratch = None if gs is None else bin_rays(gs, ge, *rays[2:], n_tiles,
                                               occ=occ)
    _OPS['occluded_pairs'](rows, *rays, ge, scratch, n_tiles, occ)
    return occ


def intersect_pairs(rows, org, dirn, tnear, tfar, gs=None, ge=None) -> Hit:
    """Closest hit over [gs, ge) with u/v rebuilt from the hit slot; `tri`
    is the slot (the triangle index for pack_planes' rows)."""
    t, slot = intersect_pairs_raw(rows, org, dirn, tnear, tfar, gs, ge)
    return Hit(t, slot, *recompute_uv(rows, org, dirn, t, slot))


_SWEEP = f'(Tensor rows, {cb.RAYS}, Tensor? ge, Tensor? scratch, int n_tiles'
_OPS = {
    'bin_pairs': cb.operator(
        'bin_pairs', '(Tensor gs, Tensor ge, Tensor tnear, Tensor tfar, '
        'int n_tiles, Tensor(a!) scratch, Tensor(b!)? t, Tensor(c!)? slot, '
        'Tensor(d!)? occ) -> ()', launch, lib, bin_rays),
    'intersect_pairs': cb.operator(
        'intersect_pairs', f'{_SWEEP}, Tensor(a!) t, Tensor(b!) slot) -> ()',
        launch, lib, intersect_pairs_raw),
    'occluded_pairs': cb.operator(
        'occluded_pairs', f'{_SWEEP}, {cb.OCC}) -> ()', launch, lib,
        occluded_pairs)}

# launch counts: kernels launched (bin_rays: the binning before a ranged
# sweep), and plain versions run on CUDA tensors
intersect_pairs_raw.launches = 0
occluded_pairs.launches = 0
bin_rays.launches = 0
intersect_pairs_raw_plain.cuda_calls = 0
occluded_pairs_plain.cuda_calls = 0
