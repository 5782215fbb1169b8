"""Dense intersector: every ray against every triangle.

Counterpart of `yulio_raytracer_tpu/ops/pallas_dense.py`
(`intersect_dense` / `occluded_dense`), the traversal of scenes of at
most 2048 triangles.  On a CUDA tensor each wrapper launches its kernel
from `csrc/dense.cu`; on a CPU tensor it runs the plain torch version,
which is also what the kernels are held against on the card.  Unlike the
reference, any ray count is accepted.

tris: (G, 128) f32 packed rows, 8 triangles x [woop (12) | ng (3) | cull]
(ops/wide.py pack_tris); zero padding rows never hit.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build as cb
from .intersect import Hit, closest_rows, any_rows

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'yrt_intersect_dense': [_V, _I, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V],
    'yrt_occluded_dense': [_V, _I, _V, _V, _V, _V, _I, _V, _V],
}


def _rows(tris):
    return tris.reshape(-1, 16)


def intersect_dense_plain(tris, org, dirn, tnear, tfar) -> Hit:
    """Plain torch version of the closest-hit kernel."""
    if org.is_cuda:
        intersect_dense_plain.cuda_calls += 1
    return closest_rows(_rows(tris), org, dirn, tnear, tfar)


def occluded_dense_plain(tris, org, dirn, tnear, tfar):
    """Plain torch version of the any-hit kernel."""
    if org.is_cuda:
        occluded_dense_plain.cuda_calls += 1
    return any_rows(_rows(tris), org, dirn, tnear, tfar)


def _lib():
    return cb.library('dense', _SIGNATURES)


def intersect_dense(tris, org, dirn, tnear, tfar) -> Hit:
    """Closest hit of each ray (R, 3) against all triangles."""
    if org.device.type == 'cpu':
        return intersect_dense_plain(tris, org, dirn, tnear, tfar)
    org, dirn, tnear, tfar = cb.ray_args(org, dirn, tnear, tfar)
    rows = cb.table_arg('tris', _rows(tris), 16, org.device)
    r = org.shape[0]
    hit = cb.empty_hit(r, org.device)
    cb.launch(_lib().yrt_intersect_dense, 'intersect_dense', org.device,
              rows, rows.shape[0], org, dirn, tnear, tfar, r, *hit)
    intersect_dense.launches += 1
    return Hit(*hit)


def occluded_dense(tris, org, dirn, tnear, tfar):
    """(R,) bool: is each ray segment (tnear, tfar) occluded."""
    if org.device.type == 'cpu':
        return occluded_dense_plain(tris, org, dirn, tnear, tfar)
    org, dirn, tnear, tfar = cb.ray_args(org, dirn, tnear, tfar)
    rows = cb.table_arg('tris', _rows(tris), 16, org.device)
    r = org.shape[0]
    occ = torch.empty((r,), dtype=torch.bool, device=org.device)
    cb.launch(_lib().yrt_occluded_dense, 'occluded_dense', org.device,
              rows, rows.shape[0], org, dirn, tnear, tfar, r, occ)
    occluded_dense.launches += 1
    return occ


# launch counts: kernels launched, and plain versions run on CUDA tensors
intersect_dense.launches = 0
occluded_dense.launches = 0
intersect_dense_plain.cuda_calls = 0
occluded_dense_plain.cuda_calls = 0
