"""Host-side BVH build (the native C++ builder) and triangle permutation.

The part of `yulio_raytracer_tpu/geometry/bvh.py` that the port's commit
runs: its default tree (`build(..., quality='high')` there: object-split
binned SAH with leaf starts aligned to the packed 8-triangle rows), built
by `native/libyrt_native.so`.  Layout: depth-first nodes with skip
pointers; leaf triangle ranges are contiguous in the permuted triangle
order (`permute_geom`).
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
    # (R,) i64 gather list new position -> old triangle index; R >= T,
    # since aligning leaf starts pads the list (permute_geom gathers)
    order: np.ndarray
    num_nodes: int


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
          nbins: int = 16) -> FlatBVH:
    """Build a flattened skip-pointer BVH over triangles (v0, v0+e1, v0+e2):
    object splits, leaf starts aligned to the packed 8-triangle rows.
    Invalid (padding/degenerate) triangles get empty bounds and are never
    hit."""
    lib = _load_native()
    t = len(v0)
    max_refs = 2 * max(t, 1) + 64
    max_nodes = max(2 * max_refs + 8, 64)
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    start = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    skip = np.empty(max_nodes, np.int32)
    order = np.empty(max_refs, np.int64)
    nrefs = np.zeros(1, np.int64)
    align_rows = 2                  # flags: no spatial splits (1)
    n = lib.yrt_build_sbvh(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        np.ascontiguousarray(valid, np.uint8),
        t, leaf_size, nbins, np.float32(1e-5), align_rows,
        np.float32(-1.0), lo, hi, start, count,
        skip, order, max_nodes, max_refs, nrefs)
    if n < 0:
        raise RuntimeError(f"native BVH build failed ({n}) on {t} triangles")
    n = int(n)
    return FlatBVH(lo[:n].copy(), hi[:n].copy(), start[:n].copy(),
                   count[:n].copy(), skip[:n].copy(),
                   order[:int(nrefs[0])].copy(), n)


PER_TRIANGLE_KEYS = ('v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id',
                     'light_id', 'cull', 'illum_mask', 'shadow_mask', 'valid')


def permute_geom(geom: dict, order: np.ndarray) -> dict:
    """Apply the BVH triangle permutation to the per-triangle arrays of a
    geometry dict."""
    return {k: (a[order] if k in PER_TRIANGLE_KEYS else a)
            for k, a in geom.items()}
