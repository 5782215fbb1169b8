"""Treelets: a cut of the binary BVH into disjoint subtrees, the per-ray
choice of the nearest one still to visit, and the 'treelet' and 'dense'
ray binnings built on that choice.

Counterpart of `treelet_cut`, `treelet_tri_tiles`, `_mark_processed`,
`_treelet_assign`, `intersect_packet_binned`, `occluded_packet_binned`,
`intersect_dense_binned` and `occluded_dense_binned` of
`yulio_raytracer_tpu/ops/pallas_traverse.py`, which imports jax, so they
are copied here.  Both binnings visit each ray's treelets nearest first
(a treelet's box entry distance bounds every hit inside it from below):
`closest_binned` / `occluded_binned` run the rounds and the whole-tree
fallback, and take the per-round kernel call as an argument: the binary
kernels (ops/traverse.py, K5/K6) from each ray's treelet root for
'treelet', the ranged pair sweeps (ops/pairs.py, K8/K9) over the
treelet's tiles for 'dense'.  The reference groups each round's rays so
that a TPU packet starts at one root or sweeps one range
(`_binned_layout`, `_packet_roots`, `_dense_ranges`) and sorts the
fallback's rays.  The port's binary kernels take each ray's own root
(one ray per thread), its pair kernels group each call's rays by range
themselves (ops/pairs.py bin_rays), and the fallback's rays stay
unsorted.

A ray's visited treelets are a bit mask of (R, W) int64 words of 32 bits
each (W = ceil(T / 32)), the reference's uint32 layout widened to a type
the CPU build of torch shifts.  `treelet_assign` tests `_ASSIGN_ELEMS`
ray-treelet pairs at a time, a few treelets per step, where the
reference unrolls over every treelet: the choice is the same, the
nearest entry with ties to the lowest index.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from . import pairs, traverse, wide
from .intersect import Hit

INF = float('inf')
MAX_TREELETS = 64    # the reference commit's cut (scene.py treelet_cut)
# ray-treelet pairs per step of treelet_assign: each (R, k) f32
# temporary stays at 256 MB
_ASSIGN_ELEMS = 1 << 26


def treelet_cut(nodes: np.ndarray, max_treelets: int = 32):
    """Cut the binary node rows (ops/traverse.py pack_nodes) into at most
    max_treelets disjoint subtrees that cover every leaf, splitting the
    subtree of the most triangles until the largest is a leaf.  Returns
    (roots (T,) int32 ascending, boxes (T, 6) f32 [lo | hi])."""
    tag = nodes[:, 7]
    a = nodes[:, 6].astype(np.int64)
    n = nodes.shape[0]
    # triangles per subtree: the cut balances leaf work
    size = np.where(tag > 0, tag, 0).astype(np.int64)
    for i in range(n - 1, -1, -1):
        if tag[i] <= 0:
            size[i] = size[i + 1] + size[int(a[i])]
    heap = [(-int(size[0]), 0)]
    while len(heap) < max_treelets:
        neg, i = heapq.heappop(heap)
        if tag[i] > 0:          # the largest remaining is a leaf
            heapq.heappush(heap, (neg, i))
            break
        heapq.heappush(heap, (-int(size[i + 1]), i + 1))
        heapq.heappush(heap, (-int(size[int(a[i])]), int(a[i])))
    roots = np.asarray(sorted(i for _, i in heap), np.int32)
    boxes = np.concatenate([nodes[roots, 0:3], nodes[roots, 3:6]],
                           axis=1).astype(np.float32)
    return roots, boxes


def treelet_tri_tiles(nodes: np.ndarray, roots: np.ndarray, tl: int = 128):
    """Per-treelet tile range [gs, ge) of tl-slot tiles over the triangles
    in their packed order (ops/pairs.py pack_planes): depth-first nodes
    and leaf-ordered triangles make a subtree's triangles one contiguous
    range; rounding it out to whole tiles adds real triangles of
    neighbouring treelets, whose hits are true hits."""
    tag = nodes[:, 7]
    a = nodes[:, 6].astype(np.int64)
    n = nodes.shape[0]
    nsize = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        if tag[i] <= 0:
            nsize[i] = 1 + nsize[i + 1] + nsize[int(a[i])]
    gs = np.zeros(len(roots), np.int32)
    ge = np.zeros(len(roots), np.int32)
    for j, r in enumerate(np.asarray(roots)):
        end = int(r + nsize[r])
        leaf = tag[r:end] > 0
        starts = a[r:end][leaf]
        counts = tag[r:end][leaf].astype(np.int64)
        gs[j] = int(starts.min()) // tl
        ge[j] = -(-int((starts + counts).max()) // tl)
    return gs, ge


def no_treelets_visited(r: int, n_treelets: int, device):
    """The (R, W) int64 visited mask of R rays, all clear."""
    return torch.zeros((r, (n_treelets + 31) // 32), dtype=torch.int64,
                       device=device)


def mark_processed(processed, sel, has):
    """processed with bit sel set for every ray where has."""
    w = processed.shape[1]
    s = torch.clamp(sel.to(torch.int64), 0, 32 * w - 1)
    word = s // 32
    bit = torch.ones_like(s) << (s % 32)
    hit = has[:, None] & (word[:, None] == torch.arange(
        w, device=sel.device))
    return processed | torch.where(hit, bit[:, None], 0)


def treelet_assign(boxes, org, dirn, tnear, tfar, processed):
    """Nearest unvisited candidate treelet of each ray: (sel (R,) int32,
    has (R,) bool), sel the treelet whose box the segment (tnear, tfar)
    enters first among those not set in processed (-1 and False where
    there is none); equal entries go to the lowest index."""
    r, n_t = org.shape[0], boxes.shape[0]
    inv = wide._safe_inv(dirn)
    best_t = torch.full((r,), INF, device=org.device)
    sel = torch.full((r,), -1, dtype=torch.int64, device=org.device)
    k = max(1, min(n_t, _ASSIGN_ELEMS // max(r, 1)))
    for t0 in range(0, n_t, k):
        ts = torch.arange(t0, min(t0 + k, n_t), device=org.device)
        tmin, tmax = tnear[:, None], tfar[:, None]
        for ax in range(3):
            lo = (boxes[ts, ax] - org[:, ax:ax + 1]) * inv[:, ax:ax + 1]
            hi = (boxes[ts, 3 + ax] - org[:, ax:ax + 1]) * inv[:, ax:ax + 1]
            tmin = torch.maximum(tmin, torch.minimum(lo, hi))
            tmax = torch.minimum(tmax, torch.maximum(lo, hi))
        done = ((processed[:, ts // 32] >> (ts % 32)) & 1) != 0
        cand = torch.where((tmin <= tmax) & ~done, tmin, INF)
        m = torch.amin(cand, dim=1)
        first = torch.amin(torch.where(cand == m[:, None], ts, n_t), dim=1)
        take = m < best_t
        best_t = torch.where(take, m, best_t)
        sel = torch.where(take, first, sel)
    return sel.to(torch.int32), sel >= 0


# ------------------------------------------------------------- binnings

def _nearer(new, best):
    """The fields of new where its t (field 0) is strictly below best's."""
    if best is None:
        return tuple(new)
    take = new[0] < best[0]
    return tuple(torch.where(take, n, b) for n, b in zip(new, best))


def closest_binned(step, tboxes, org, dirn, tnear, tfar, rounds: int = 2):
    """Exact closest hit through treelet rounds and a bounded fallback.
    step(tfar, sel) is one closest-hit kernel call on the rays' segments
    (tnear, tfar), each ray within its treelet sel ((R,) int32, -1: none)
    or, where sel is None, within the whole tree; rays with tfar <= tnear
    take no part.  It returns a tuple whose field 0 is t (inf on a miss).
    Each round every ray visits its nearest unvisited candidate treelet,
    bounded by its best t so far; a strictly nearer hit replaces the
    best.  The rays that still hold a candidate after `rounds` finish in
    one whole-tree call bounded by their best t."""
    processed = no_treelets_visited(org.shape[0], tboxes.shape[0], org.device)
    best = None
    for _ in range(rounds):
        bound = tfar if best is None else torch.minimum(tfar, best[0])
        sel, has = treelet_assign(tboxes, org, dirn, tnear, bound, processed)
        processed = mark_processed(processed, sel, has)
        best = _nearer(step(torch.where(has, bound, -1.0), sel), best)
    bound = tfar if best is None else torch.minimum(tfar, best[0])
    _, remaining = treelet_assign(tboxes, org, dirn, tnear, bound, processed)
    return _nearer(step(torch.where(remaining, bound, -1.0), None), best)


def occluded_binned(step, tboxes, org, dirn, tnear, tfar, rounds: int = 2):
    """Exact any hit through treelet rounds and the whole-tree fallback.
    step(tfar, sel) is one any-hit kernel call ((R,) bool), sel as in
    closest_binned.  Each round every unoccluded ray tests its nearest
    unvisited candidate treelet; the rays that still hold a candidate
    finish in one whole-tree call.  Rays with tfar <= tnear report not
    occluded."""
    processed = no_treelets_visited(org.shape[0], tboxes.shape[0], org.device)
    occ = torch.zeros(tfar.shape, dtype=torch.bool, device=org.device)
    for _ in range(rounds):
        live = torch.where(occ, -1.0, tfar)
        sel, has = treelet_assign(tboxes, org, dirn, tnear, live, processed)
        processed = mark_processed(processed, sel, has)
        occ = occ | step(torch.where(has, live, -1.0), sel)
    live = torch.where(occ, -1.0, tfar)
    _, remaining = treelet_assign(tboxes, org, dirn, tnear, live, processed)
    return occ | step(torch.where(remaining, live, -1.0), None)


def _roots(troots, sel):
    """Each ray's start node: its treelet's root (None: the tree's)."""
    return None if sel is None else troots[torch.clamp(sel, min=0).long()]


def _tiles(tgs, tge, sel):
    """Each ray's tile range of its treelet sel; empty where sel < 0."""
    s, has = torch.clamp(sel, min=0).long(), sel >= 0
    return (torch.where(has, tgs[s], 0).to(torch.int32),
            torch.where(has, tge[s], 0).to(torch.int32))


def intersect_packet_binned(nodes, tris, troots, tboxes, org, dirn, tnear,
                            tfar, rounds: int = 2) -> Hit:
    """'treelet' closest hit: each round walks the binary tables (K5)
    from the root troots[sel] of each ray's treelet (troots/tboxes from
    treelet_cut), the fallback from the tree's root."""
    def step(tf, sel):
        return traverse.intersect_packet(nodes, tris, org, dirn, tnear, tf,
                                         _roots(troots, sel))
    return Hit(*closest_binned(step, tboxes, org, dirn, tnear, tfar, rounds))


def occluded_packet_binned(nodes, tris, troots, tboxes, org, dirn, tnear,
                           tfar, rounds: int = 2):
    """'treelet' any hit: as intersect_packet_binned, with K6."""
    def step(tf, sel):
        return traverse.occluded_packet(nodes, tris, org, dirn, tnear, tf,
                                        _roots(troots, sel))
    return occluded_binned(step, tboxes, org, dirn, tnear, tfar, rounds)


def intersect_dense_binned(nodes, tris, rows, tboxes, tgs, tge, org, dirn,
                           tnear, tfar, rounds: int = 2) -> Hit:
    """'dense' closest hit: each round sweeps the tiles [tgs, tge) of
    each ray's treelet (K8) over rows, pack_planes' rows of the scene's
    triangles in their packed order (slot = triangle); the fallback walks
    the binary tables (K5).  u/v are rebuilt once, for the winner."""
    def step(tf, sel):
        if sel is None:
            return traverse.intersect_packet(nodes, tris, org, dirn, tnear,
                                             tf)[:2]
        return pairs.intersect_pairs_raw(rows, org, dirn, tnear, tf,
                                         *_tiles(tgs, tge, sel))
    t, tri = closest_binned(step, tboxes, org, dirn, tnear, tfar, rounds)
    return Hit(t, tri, *pairs.recompute_uv(rows, org, dirn, t, tri))


def occluded_dense_binned(nodes, tris, rows, tboxes, tgs, tge, org, dirn,
                          tnear, tfar, rounds: int = 2):
    """'dense' any hit: as intersect_dense_binned, with K9 and K6."""
    def step(tf, sel):
        if sel is None:
            return traverse.occluded_packet(nodes, tris, org, dirn, tnear, tf)
        return pairs.occluded_pairs(rows, org, dirn, tnear, tf,
                                    *_tiles(tgs, tge, sel))
    return occluded_binned(step, tboxes, org, dirn, tnear, tfar, rounds)
