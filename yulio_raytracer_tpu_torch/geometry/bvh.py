"""Host-side BVH build and triangle permutation.

The part of `yulio_raytracer_tpu/geometry/bvh.py` that the port's commit
runs.  Static scenes build with `native/libyrt_native.so` at one of the
reference's three qualities (bvh.py:174-265): 'high' (the default:
object-split binned SAH with leaf starts aligned to the packed
8-triangle rows), 'normal' (the object-split build without the
alignment) and 'high-spatial' ('high' with SBVH spatial splits, which
reference a triangle that straddles a split from both sides).  Motion
scenes build with the reference's numpy object-split binned SAH over
given per-triangle boxes (the union of each triangle's t=0 and t=1
boxes).  Where the library is missing a static build raises.  Layout:
depth-first nodes with skip pointers; leaf triangle ranges are
contiguous in the gathered triangle order (`permute_geom`).
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'native', 'libyrt_native.so')


@dataclass
class FlatBVH:
    lo: np.ndarray      # (N, 3) f32
    hi: np.ndarray      # (N, 3) f32
    start: np.ndarray   # (N,) i32  leaf: first triangle (in permuted order)
    count: np.ndarray   # (N,) i32  leaf: #tris; 0 for interior nodes
    skip: np.ndarray    # (N,) i32  next node on miss / after leaf (N = done)
    # (R,) i64 gather list new position -> old triangle index; R >= T
    # where aligned leaf starts pad the list or spatial splits duplicate
    # triangles ('high', 'high-spatial'), R == T for 'normal' and the
    # numpy build (permute_geom gathers)
    order: np.ndarray
    num_nodes: int

    @property
    def num_refs(self) -> int:
        return int(len(self.order))


QUALITIES = ('normal', 'high', 'high-spatial')


_native = None


def _load_native():
    """ctypes binding to native/libyrt_native.so (`make -C native`)."""
    global _native
    if _native is None:
        if not os.path.exists(_SO):
            raise RuntimeError(f"BVH builder {_SO} missing: build it with "
                               "`make -C native`")
        lib = ctypes.CDLL(_SO)
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C')
        u8p = np.ctypeslib.ndpointer(np.uint8, flags='C')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C')
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C')
        lib.yrt_build_bvh.restype = ctypes.c_int64
        lib.yrt_build_bvh.argtypes = [
            f32p, f32p, f32p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, f32p, f32p, i32p, i32p, i32p, i64p,
            ctypes.c_int64]
        lib.yrt_build_sbvh.restype = ctypes.c_int64
        lib.yrt_build_sbvh.argtypes = [
            f32p, f32p, f32p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.c_float, f32p, f32p, i32p, i32p,
            i32p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
        _native = lib
    return _native


def build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
          valid: np.ndarray, leaf_size: int = 64,
          nbins: int = 16, bounds=None, quality: str = 'high') -> FlatBVH:
    """Build a flattened skip-pointer BVH over triangles (v0, v0+e1, v0+e2)
    at `quality` (QUALITIES; the reference's build with the native
    library).  Invalid (padding/degenerate) triangles get empty bounds
    and are never hit.  `bounds` = (lo, hi), each (T, 3), overrides the
    per-triangle boxes and builds with the numpy builder instead (motion
    scenes), whatever the quality.  Raises ValueError for another
    quality and RuntimeError where the native build fails."""
    if quality not in QUALITIES:
        raise ValueError(f"unknown BVH quality {quality!r}: expected one "
                         f"of {QUALITIES}")
    if bounds is not None:
        return _build_numpy(valid, leaf_size, nbins, bounds)
    lib = _load_native()
    t = len(v0)
    tris = tuple(np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    valid = np.ascontiguousarray(valid, np.uint8)
    # the reference's buffers: T references for 'normal', else 2T + 64
    max_refs = t if quality == 'normal' else 2 * max(t, 1) + 64
    max_nodes = max(2 * max_refs + 8, 64)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    start = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    skip = np.empty(max_nodes, np.int32)
    order = np.empty(max_refs, np.int64)
    if quality == 'normal':
        n = lib.yrt_build_bvh(*tris, valid, t, leaf_size, nbins, lo, hi,
                              start, count, skip, order, max_nodes)
        nrefs = t
    else:
        refs = np.zeros(1, np.int64)
        # flags: 1 spatial splits, 2 leaf starts aligned to the rows
        flags = 2 | (1 if quality == 'high-spatial' else 0)
        n = lib.yrt_build_sbvh(*tris, valid, t, leaf_size, nbins,
                               np.float32(1e-5), flags, np.float32(-1.0),
                               lo, hi, start, count, skip, order, max_nodes,
                               max_refs, refs)
        nrefs = int(refs[0])
    if n < 0:
        raise RuntimeError(f"native BVH build ({quality}) failed ({n}) on "
                           f"{t} triangles")
    n = int(n)
    return FlatBVH(lo[:n].copy(), hi[:n].copy(), start[:n].copy(),
                   count[:n].copy(), skip[:n].copy(), order[:nrefs].copy(), n)


def _sah_split(lo, hi, cent, idx, nbins=16):
    """Binned SAH split of triangle subset idx. Returns (axis, left_idx,
    right_idx) or None if no good split."""
    clo = cent[idx].min(axis=0)
    chi = cent[idx].max(axis=0)
    ext = chi - clo
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-30:
        return None
    # bin by centroid
    scale = nbins * (1.0 - 1e-6) / ext[axis]
    b = ((cent[idx, axis] - clo[axis]) * scale).astype(np.int32)
    b = np.clip(b, 0, nbins - 1)

    # per-bin counts and bounds
    counts = np.zeros(nbins, np.int64)
    blo = np.full((nbins, 3), np.inf, np.float64)
    bhi = np.full((nbins, 3), -np.inf, np.float64)
    for k in range(nbins):
        sel = b == k
        counts[k] = sel.sum()
        if counts[k]:
            blo[k] = lo[idx[sel]].min(axis=0)
            bhi[k] = hi[idx[sel]].max(axis=0)

    def area(l, h):
        d = np.maximum(h - l, 0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])

    # sweep: cost of splitting after bin k
    llo = np.minimum.accumulate(blo, axis=0)
    lhi = np.maximum.accumulate(bhi, axis=0)
    rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
    rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
    lcnt = np.cumsum(counts)
    rcnt = np.cumsum(counts[::-1])[::-1]
    cost = np.full(nbins - 1, np.inf)
    for k in range(nbins - 1):
        if lcnt[k] == 0 or rcnt[k + 1] == 0:
            continue
        cost[k] = (lcnt[k] * area(llo[k], lhi[k])
                   + rcnt[k + 1] * area(rlo[k + 1], rhi[k + 1]))
    k = int(np.argmin(cost))
    if not np.isfinite(cost[k]):
        # fallback: median split on the widest axis
        med = np.median(cent[idx, axis])
        left = idx[cent[idx, axis] <= med]
        right = idx[cent[idx, axis] > med]
        if len(left) == 0 or len(right) == 0:
            half = len(idx) // 2
            srt = idx[np.argsort(cent[idx, axis], kind='stable')]
            left, right = srt[:half], srt[half:]
        return axis, left, right
    sel = b <= k
    return axis, idx[sel], idx[~sel]


def _build_numpy(valid, leaf_size, nbins, bounds) -> FlatBVH:
    """The reference's numpy object-split binned-SAH build over the boxes
    `bounds`; every node's triangles form one contiguous range of the
    returned permutation (invalid triangles last, in no leaf)."""
    lo = np.asarray(bounds[0], np.float64).copy()
    hi = np.asarray(bounds[1], np.float64).copy()
    valid = np.asarray(valid, bool)
    cent = 0.5 * (lo + hi)
    cent[~valid] = 0.0
    lo[~valid] = np.inf
    hi[~valid] = -np.inf
    live = np.nonzero(valid)[0]
    dead = np.nonzero(~valid)[0]

    nodes = []      # [lo, hi, start, count] in DFS order
    is_leaf = []
    order = []
    stack = [live]
    while stack:
        sub = stack.pop()
        if len(sub):
            nlo, nhi = lo[sub].min(axis=0), hi[sub].max(axis=0)
        else:
            nlo, nhi = np.full(3, np.inf), np.full(3, -np.inf)
        split = (_sah_split(lo, hi, cent, sub, nbins)
                 if len(sub) > leaf_size else None)
        is_leaf.append(split is None)
        if split is None:
            nodes.append([nlo, nhi, len(order), len(sub)])
            order.extend(sub.tolist())
        else:
            nodes.append([nlo, nhi, 0, 0])
            # the left subtree follows its parent: push the right first
            stack.append(split[2])
            stack.append(split[1])
    n = len(nodes)

    # skip[i] = end of node i's subtree: i + 1 for a leaf, else the end of
    # its right child, which was pushed before the left child's end
    skip = np.zeros(n, np.int32)
    ends: list[int] = []
    for i in range(n - 1, -1, -1):
        if is_leaf[i]:
            skip[i] = i + 1
        else:
            ends.pop()
            skip[i] = ends.pop()
        ends.append(int(skip[i]))
    order.extend(dead.tolist())
    return FlatBVH(
        lo=np.stack([nd[0] for nd in nodes]).astype(np.float32),
        hi=np.stack([nd[1] for nd in nodes]).astype(np.float32),
        start=np.asarray([nd[2] for nd in nodes], np.int32),
        count=np.asarray([nd[3] for nd in nodes], np.int32),
        skip=skip, order=np.asarray(order, np.int64), num_nodes=n)


PER_TRIANGLE_KEYS = ('v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id',
                     'light_id', 'cull', 'illum_mask', 'shadow_mask', 'valid',
                     'mv0', 'me1', 'me2', 'ptx', 'pty')


def permute_geom(geom: dict, order: np.ndarray) -> dict:
    """Apply the BVH triangle permutation to the per-triangle arrays of a
    geometry dict (an absent one, None, stays None)."""
    return {k: (a[order] if k in PER_TRIANGLE_KEYS and a is not None else a)
            for k, a in geom.items()}
