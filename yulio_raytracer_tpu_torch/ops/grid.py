"""Uniform-grid traversal: DDA rounds of ranged sweeps, and the grid march.

Counterpart of `yulio_raytracer_tpu/ops/grid.py` (`build_grid`,
`_dda_init`, `_dda_step`, `_cell_id`, `intersect_grid`, `occluded_grid`
and `intersect_march`), which imports jax, so the table build is copied
here.  A res^3 grid is laid over the triangles; each cell holds, in whole
tiles of 128 slots, every triangle whose bounding box touches it
(`build_grid`), so a triangle may own several slots and `tri_orig` maps
slots to triangles.  Cells do not overlap, so a ray that marches its
cells near to far may stop at the first cell whose entry distance exceeds
its best hit.

`intersect_grid` / `occluded_grid` run the reference's rounds: each round
sweeps every active ray's current cell, each ray with its own cell's tile
range, through the pair kernels (ops/pairs.py, K8/K9), and steps it one
cell on; after the last round the rays still marching finish in the
binary BVH kernels (ops/traverse.py, K5/K6), bounded by their best t, so
the result is exact.  The reference groups a round's rays into 64-ray
blocks of one cell (`_binned_layout` / `_dense_ranges`) so that a TPU
program shares one range, and sorts the fallback's rays.  The port's
pair kernels group each call's rays by range themselves (ops/pairs.py
bin_rays), and the fallback's rays stay unsorted.

`march_raw` is K10 (the reference's `_march_raw`): each ray's whole
march in one kernel (csrc/grid.cu), no fallback, a warp's rays in one
cell sharing its rows; `intersect_march` sorts the rays by entry cell
and origin first, as the reference's `_march_sorted` does, and maps the
slots to triangles.  Its plain version runs the same rounds until every
ray retires, from the kernel's entry cell (an absolute 1e-6 past the box
entry, where the rounds nudge by a part of a cell).

One deliberate difference: the reference's `_dda_step` adds
onehot * tdelta, which turns an axis whose direction is zero (tdelta =
inf) into NaN after the first step, so such a ray stops marching and
never reaches the fallback; the port steps with a select, as the
reference's march kernel does (`_axis_advance`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_build as cb
from . import binning, pairs, traverse, wide
from .intersect import Hit
from .pairs import TL

GRID_RES = 8         # cells per axis (the reference's scene.GRID_RES)
WARP = 32            # rays a warp of the march kernel holds
INF = float('inf')
# the tables a committed scene keeps on its device (the lane-major
# `planes` serve only the reference's TPU kernels)
GRID_KEYS = ('rows', 'tri_orig', 'cell_tile_lo', 'cell_tile_hi', 'grid_lo',
             'grid_hi')


def build_grid(woop: np.ndarray, geom_host: dict, res: int = GRID_RES):
    """Voxelize the (BVH-permuted) triangles into a res^3 grid: a numpy
    dict of planes (Gt, 16, 128) and rows (Tp, 16), each cell's triangles
    in whole tiles (padding is zero); tri_orig (Tp,) int32 (slot ->
    triangle, -1 for padding); cell_tile_lo/hi (res^3,) int32 (each
    cell's tile range); grid_lo/grid_hi (3,) f32 (the box, padded by
    1e-4 of its span).  A triangle lands in every cell its bounding box
    touches (conservative: the extra tests are exact)."""
    v0 = np.asarray(geom_host['v0'], np.float64)
    e1 = np.asarray(geom_host['e1'], np.float64)
    e2 = np.asarray(geom_host['e2'], np.float64)
    valid = np.asarray(geom_host['valid'], bool)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    glo = lo[valid].min(axis=0)
    ghi = hi[valid].max(axis=0)
    span = np.maximum(ghi - glo, 1e-6)
    glo = glo - span * 1e-4
    ghi = ghi + span * 1e-4
    cell = (ghi - glo) / res

    ilo = np.clip(((lo - glo) / cell).astype(np.int64), 0, res - 1)
    ihi = np.clip(((hi - glo) / cell).astype(np.int64), 0, res - 1)
    single = valid & (ilo == ihi).all(axis=1)
    multi = valid & ~single
    tids = [np.nonzero(single)[0]]
    cids = [(ilo[single, 0] * res + ilo[single, 1]) * res + ilo[single, 2]]
    for t in np.nonzero(multi)[0]:
        xs = np.arange(ilo[t, 0], ihi[t, 0] + 1)
        ys = np.arange(ilo[t, 1], ihi[t, 1] + 1)
        zs = np.arange(ilo[t, 2], ihi[t, 2] + 1)
        cc = ((xs[:, None, None] * res + ys[None, :, None]) * res
              + zs[None, None, :]).reshape(-1)
        cids.append(cc)
        tids.append(np.full(cc.shape, t, np.int64))
    cids = np.concatenate(cids)
    tids = np.concatenate(tids)
    order = np.argsort(cids, kind='stable')
    cids, tids = cids[order], tids[order]

    counts = np.bincount(cids, minlength=res ** 3)
    pad = (counts + TL - 1) // TL * TL
    offs = np.concatenate([[0], np.cumsum(pad)])
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = offs[cids] + np.arange(len(cids)) - starts[cids]

    t_total = woop.shape[1] // 3
    w = np.asarray(woop, np.float32).reshape(4, t_total, 3)
    flat = np.concatenate([
        w.transpose(1, 0, 2).reshape(t_total, 12),
        np.asarray(geom_host['ng'], np.float32),
        np.asarray(geom_host['cull'], np.float32)[:, None]], axis=1)
    rows = np.zeros((int(offs[-1]), 16), np.float32)
    rows[slot] = flat[tids]
    tri_orig = np.full((rows.shape[0],), -1, np.int32)
    tri_orig[slot] = tids.astype(np.int32)
    return {
        'planes': pairs.planes_of(rows),
        'rows': rows,
        'tri_orig': tri_orig,
        'cell_tile_lo': (offs[:-1] // TL).astype(np.int32),
        'cell_tile_hi': (offs[1:] // TL).astype(np.int32),
        'grid_lo': glo.astype(np.float32),
        'grid_hi': ghi.astype(np.float32),
    }


# ------------------------------------------------------------------ DDA

def _dda_init(lo, hi, cellsz, res, org, dirn, tnear, nudge):
    """Amanatides-Woo set-up in the box [lo, hi] of res^3 cells of size
    cellsz: (ci (R, 3) int32 cell, tnext (R, 3) next crossing per axis,
    tdelta (R, 3), step (R, 3) int32, t0 (R,) box entry, inside (R,)).
    The entry cell holds the point at t0 + nudge."""
    inv = wide._safe_inv(dirn)
    t0a = (lo - org) * inv
    t1a = (hi - org) * inv
    tmin = torch.amax(torch.minimum(t0a, t1a), dim=-1)
    tmax = torch.amin(torch.maximum(t0a, t1a), dim=-1)
    t0 = torch.maximum(tmin, tnear)
    pos = org + dirn * (t0 + nudge)[:, None]
    # clamped before the conversion, which truncates: the reference's
    # clip after it, for every finite value
    ci = torch.clamp((pos - lo) / cellsz, 0, res - 1).to(torch.int32)
    step = torch.where(dirn >= 0, 1, -1).to(torch.int32)
    nxt = lo + (ci + (step > 0)).to(torch.float32) * cellsz
    moving = torch.abs(dirn) > 1e-30
    tnext = torch.where(moving, (nxt - org) * inv, INF)
    tdelta = torch.where(moving, torch.abs(cellsz * inv), INF)
    return ci, tnext, tdelta, step, t0, t0 <= tmax


def _dda_step(ci, tnext, tdelta, step, res):
    """Step every ray into its next cell across the nearest crossing
    (ties: x, then y, then z): (ci, tnext, entry t of the new cell,
    inside)."""
    entry = torch.amin(tnext, dim=-1)
    gx = tnext[:, 0] <= entry
    gy = ~gx & (tnext[:, 1] <= entry)
    go = torch.stack([gx, gy, ~gx & ~gy], dim=1)
    ci = torch.where(go, ci + step, ci)
    tnext = torch.where(go, tnext + tdelta, tnext)
    return ci, tnext, entry, torch.all((ci >= 0) & (ci < res), dim=-1)


def _cell_id(ci, res):
    return ((ci[:, 0] * res + ci[:, 1]) * res + ci[:, 2]).to(torch.int64)


def _cell_ranges(grid, ci, act, res):
    """Per-ray tile ranges (gs, ge) of each active ray's cell; empty for
    the others."""
    cid = torch.clamp(_cell_id(ci, res), 0, res ** 3 - 1)
    return (torch.where(act, grid['cell_tile_lo'][cid], 0),
            torch.where(act, grid['cell_tile_hi'][cid], 0))


def _rounds_init(grid, org, dirn, tnear, res):
    """_dda_init with the rounds' nudge, 1e-4 of the smallest cell side
    in t along the ray's largest direction component."""
    lo, hi = grid['grid_lo'], grid['grid_hi']
    cellsz = (hi - lo) / res
    nudge = 1e-4 * torch.amin(cellsz) / torch.clamp(
        torch.amax(torch.abs(dirn), dim=-1), min=1e-30)
    return _dda_init(lo, hi, cellsz, res, org, dirn, tnear, nudge)


def entry_ranges(grid, org, dirn, tnear, tfar, res: int = GRID_RES):
    """Per-ray tile ranges (gs, ge) of each ray's entry cell, as the
    first round of intersect_grid sweeps it (empty for rays that miss
    the grid or are dead)."""
    ci, _, _, _, t0, inside = _rounds_init(grid, org, dirn, tnear, res)
    return _cell_ranges(grid, ci, inside & (tfar > tnear) & (t0 <= tfar),
                        res)


def _to_hit(grid, org, dirn, t, slot) -> Hit:
    """(t, slot) of the grid's rows -> a Hit of the triangle slot holds,
    u/v rebuilt from its row."""
    tri = torch.where(slot >= 0,
                      grid['tri_orig'][torch.clamp(slot, min=0).long()], -1)
    u, v = pairs.recompute_uv(grid['rows'], org, dirn, t, slot)
    return Hit(torch.where(tri >= 0, t, INF), tri, u, v)


# --------------------------------------------------------- grid rounds

def intersect_grid(grid, nodes, tris, org, dirn, tnear, tfar,
                   res: int = GRID_RES, rounds: int = 8) -> Hit:
    """Exact closest hit: `rounds` DDA rounds of ranged sweeps (K8), then
    the binary BVH kernel (K5, over nodes and tris) for the rays still
    marching, bounded by their best t."""
    ci, tnext, tdelta, step, t0, inside = _rounds_init(grid, org, dirn,
                                                       tnear, res)
    live = inside & (tfar > tnear) & (t0 <= tfar)
    entry = t0
    best_t = torch.full_like(tfar, INF)
    best_i = torch.full(tfar.shape, -1, dtype=torch.int32, device=org.device)
    for _ in range(rounds):
        bound = torch.minimum(tfar, best_t)
        t_s, i_s = pairs.intersect_pairs_raw(
            grid['rows'], org, dirn, tnear, bound,
            *_cell_ranges(grid, ci, live & (entry <= bound), res))
        take = t_s < best_t
        best_t = torch.where(take, t_s, best_t)
        best_i = torch.where(take, i_s, best_i)
        ci, tnext, entry, inside = _dda_step(ci, tnext, tdelta, step, res)
        live = live & inside
    bound = torch.minimum(tfar, best_t)
    fb = traverse.intersect_packet(
        nodes, tris, org, dirn, tnear,
        torch.where(live & (entry <= bound), bound, -1.0))
    hit = _to_hit(grid, org, dirn, best_t, best_i)
    take = fb.t < best_t
    return Hit(*(torch.where(take, f, h) for f, h in zip(fb, hit)))


def occluded_grid(grid, nodes, tris, org, dirn, tnear, tfar,
                  res: int = GRID_RES, rounds: int = 4):
    """Exact any hit: `rounds` DDA rounds of ranged sweeps (K9), then the
    binary BVH kernel (K6) for the rays still marching unoccluded.  Rays
    with tfar <= tnear report not occluded."""
    ci, tnext, tdelta, step, t0, inside = _rounds_init(grid, org, dirn,
                                                       tnear, res)
    live = inside & (tfar > tnear) & (t0 <= tfar)
    entry = t0
    occ = torch.zeros_like(live)
    for _ in range(rounds):
        occ = occ | pairs.occluded_pairs(
            grid['rows'], org, dirn, tnear, tfar,
            *_cell_ranges(grid, ci, live & ~occ & (entry <= tfar), res))
        ci, tnext, entry, inside = _dda_step(ci, tnext, tdelta, step, res)
        live = live & inside
    return occ | traverse.occluded_packet(
        nodes, tris, org, dirn, tnear,
        torch.where(live & ~occ & (entry <= tfar), tfar, -1.0))


# ----------------------------------------------------------- grid march

def march_raw_plain(grid, org, dirn, tnear, tfar, res: int = GRID_RES,
                    counts=None):
    """Plain torch version of the grid march (K10): the rounds of
    intersect_grid, from the march kernel's entry cell, until every ray
    retires.  Returns (t, slot) as march_raw; counts gathers the pair
    tests ('pair') and the rows the kernel loads ('rows': a cell's rows
    once per round for each warp of WARP consecutive rays with a ray in
    it)."""
    if org.is_cuda:
        march_raw_plain.cuda_calls += 1
    lo = grid['grid_lo']
    cellsz = (grid['grid_hi'] - lo) / res
    # the kernel's far corner: lo + res * cellsz in doubles, rounded once
    hi = (lo.double() + res * cellsz.double()).float()
    ci, tnext, tdelta, step, t0, inside = _dda_init(lo, hi, cellsz, res, org,
                                                    dirn, tnear, 1e-6)
    live = inside & (tfar > tnear) & (t0 <= tfar)
    best_t = torch.full_like(tfar, INF)
    best_s = torch.full(tfar.shape, -1, dtype=torch.int32, device=org.device)
    while bool(live.any()):
        idx = torch.nonzero(live)[:, 0]
        gs, ge = _cell_ranges(grid, ci[idx], live[idx], res)
        if counts is not None:      # distinct (warp, cell) this round
            cells = torch.unique(idx // WARP * res ** 3
                                 + _cell_id(ci[idx], res)) % res ** 3
            cb.count(counts, 'rows', (grid['cell_tile_hi'][cells]
                                      - grid['cell_tile_lo'][cells])
                     .to(torch.int64).sum() * TL)
        t_s, s_s = pairs.intersect_pairs_raw_plain(
            grid['rows'], org[idx], dirn[idx], tnear[idx], tfar[idx], gs, ge,
            counts=counts)
        take = pairs.better(t_s, s_s, best_t[idx], best_s[idx])
        best_t[idx] = torch.where(take, t_s, best_t[idx])
        best_s[idx] = torch.where(take, s_s, best_s[idx])
        ci, tnext, entry, inside = _dda_step(ci, tnext, tdelta, step, res)
        live = live & inside & (entry <= torch.minimum(tfar, best_t))
    return best_t, best_s


def march_raw(grid, org, dirn, tnear, tfar, res: int = GRID_RES):
    """(t, slot) of each ray's closest hit over the grid's rows (inf and
    -1 on a miss), each ray marching the whole grid in one kernel (K10),
    which shares a cell's rows among the rays of a warp that are in it:
    the rays in any order, best grouped by cell (march_sort_key)."""
    if org.device.type == 'cpu':
        return march_raw_plain(grid, org, dirn, tnear, tfar, res)
    args = kernel_args(grid, org, dirn, tnear, tfar, res)
    r, dev = org.shape[0], org.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    slot = torch.empty((r,), dtype=torch.int32, device=dev)
    _op(*args, t, slot)
    return t, slot


def kernel_args(grid, org, dirn, tnear, tfar, res: int = GRID_RES):
    """K10's checked inputs: (rows, cell_tile_lo, cell_tile_hi, grid_lo,
    grid_hi, org, dirn, tnear, tfar, res)."""
    rays = cb.ray_args(org, dirn, tnear, tfar)
    dev = rays[0].device
    rows = cb.table_arg('rows', grid['rows'], 16, dev)
    cells = [pairs.index_arg(k, grid[k], (res ** 3,), dev)
             for k in ('cell_tile_lo', 'cell_tile_hi')]
    box = [grid[k].contiguous() for k in ('grid_lo', 'grid_hi')]
    if any(b.dtype != torch.float32 or b.shape != (3,) or b.device != dev
           for b in box):
        raise ValueError(f"grid_lo/grid_hi: expected float32 (3,) on {dev}")
    return (rows, *cells, *box, *rays, res)


def launch(lib, entry, rows, cell_lo, cell_hi, grid_lo, grid_hi, org, dirn,
           tnear, tfar, res, t, slot):
    """K10 (yrt_grid_march) of lib, a build of csrc/grid.cu, on
    kernel_args' inputs and its outputs."""
    cb.launch(getattr(lib, entry), entry, org.device, rows, cell_lo, cell_hi,
              grid_lo, grid_hi, org, dirn, tnear, tfar, res, org.shape[0], t,
              slot)


def march_sort_key(grid, org, dirn, tnear, tfar, res: int = GRID_RES):
    """(R,) int64 key of the reference's `_march_sorted`: the entry cell
    of the rounds' DDA set-up (res^3 for a ray that misses the grid or is
    dead) above the 18-bit octant/Morton key (ops/binning.py) of the
    origin in the grid's box."""
    ci, _, _, _, _, inside = _rounds_init(grid, org, dirn, tnear, res)
    cid = torch.where(inside & (tfar > tnear), _cell_id(ci, res), res ** 3)
    return (cid << 18) | binning.ray_sort_key(org, dirn, grid['grid_lo'],
                                              grid['grid_hi'])


def intersect_march(grid, org, dirn, tnear, tfar,
                    res: int = GRID_RES) -> Hit:
    """Exact closest hit through the grid march (K10): no rounds, no
    fallback.  The rays run sorted by march_sort_key (stable), so that a
    warp's rays share cells; each ray's result depends on that ray alone,
    so the sort changes no bit.  Slots are mapped to triangles and u/v
    rebuilt from the rows, in the caller's order."""
    perm = torch.argsort(march_sort_key(grid, org, dirn, tnear, tfar, res),
                         stable=True)
    t_p, s_p = march_raw(grid, org[perm], dirn[perm], tnear[perm],
                         tfar[perm], res)
    t, slot = torch.empty_like(t_p), torch.empty_like(s_p)
    t[perm] = t_p
    slot[perm] = s_p
    return _to_hit(grid, org, dirn, t, slot)


_op = cb.operator(
    'grid_march', '(Tensor rows, Tensor cell_tile_lo, Tensor cell_tile_hi, '
    f'Tensor grid_lo, Tensor grid_hi, {cb.RAYS}, int res, Tensor(a!) t, '
    'Tensor(b!) slot) -> ()', launch, pairs.lib, march_raw)

# launch counts: kernels launched, and plain versions run on CUDA tensors
march_raw.launches = 0
march_raw_plain.cuda_calls = 0
