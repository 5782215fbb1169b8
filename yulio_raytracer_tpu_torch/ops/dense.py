"""Dense intersector: every ray against every triangle.

Counterpart of `yulio_raytracer_tpu/ops/pallas_dense.py`
(`intersect_dense` / `occluded_dense`), the traversal of scenes of at
most 2048 triangles.  On a CUDA tensor each wrapper launches its kernel
from `csrc/dense.cu` over the table's live rows (`live_rows`: up to the
last non-zero row, so the padding is not tested); on a CPU tensor it runs
the plain torch version over every row, which is also what the kernels
are held against on the card.  Unlike the reference, any ray count is
accepted.

tris: (G, 128) f32 packed rows, 8 triangles x [woop (12) | ng (3) | cull]
(ops/wide.py pack_tris); zero padding rows never hit.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import cuda_build as cb
from .intersect import (BARY_EPS, INF, Hit, any_rows, closest_rows,
                        woop_test)
from .wide import tests_to_first_hit

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'yrt_intersect_dense': [_V, _I, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V],
    'yrt_occluded_dense': [_V, _I, _V, _V, _V, _V, _I, _V, _V],
}
_COUNT_ELEMS = 1 << 22  # (ray, row) pairs per slice of the test count
# flops of each stage of the kernels' Woop test (csrc/dense.cu), counted
# from the source: every multiply, add, negate, divide, abs and compare
PLANE_FLOPS = 18    # stage 1: o'_w (6), d'_w (5), |d'_w| test (2),
#                     1/d'_w (1), th (2), tnear < th < limit (2)
INSIDE_FLOPS = 31   # stage 2: o'_u, o'_v (12), d'_u, d'_v (10), u and v
#                     (4), their tests (4), the cull flag (1)
CULL_FLOPS = 6      # stage 3: ng.d (5), its sign (1)
# the live rows of each table given to a kernel, with the tensor's
# version then: one read from the card per table
_LIVE_ROWS = WeakIdKeyDictionary()


def _rows(tris):
    return tris.reshape(-1, 16)


def intersect_dense_plain(tris, org, dirn, tnear, tfar, counts=None) -> Hit:
    """Plain torch version of the closest-hit kernel, over every row.
    counts, a dict, gathers the tests the kernel makes on the live rows
    (staged_tests)."""
    if org.is_cuda:
        intersect_dense_plain.cuda_calls += 1
    if counts is not None:
        staged_tests(_rows(tris)[:live_rows(tris)], org, dirn, tnear, tfar,
                     True, counts)
    return closest_rows(_rows(tris), org, dirn, tnear, tfar)


def occluded_dense_plain(tris, org, dirn, tnear, tfar, counts=None):
    """Plain torch version of the any-hit kernel, over every row.  counts,
    a dict, gathers the tests the kernel makes on the live rows
    (staged_tests)."""
    if org.is_cuda:
        occluded_dense_plain.cuda_calls += 1
    if counts is not None:
        staged_tests(_rows(tris)[:live_rows(tris)], org, dirn, tnear, tfar,
                     False, counts)
    return any_rows(_rows(tris), org, dirn, tnear, tfar)


def staged_tests(rows, org, dirn, tnear, tfar, closest, counts):
    """Add to counts the stages of the Woop tests a dense kernel makes
    over rows (T, 16), in order, summed on the rays' device:
    'pair' stage 1, every ray against every row (closest) or each ray up
    to its first hit (any hit); 'stage2' those whose plane distance lies
    in (tnear, limit), the limit being the best t so far (closest; tfar
    before the first hit) or tfar (any hit); 'stage3' those of them
    inside the triangle on a row whose cull flag is 1."""
    n = rows.shape[0]
    step = max(1, _COUNT_ELEMS // max(n, 1))
    s, culled = rows.T, rows[:, 15] == 1.0
    j = torch.arange(1, n + 1, device=org.device)
    for i in range(0, org.shape[0] if n else 0, step):
        o, d = org[i:i + step, None, :], dirn[i:i + step, None, :]
        tn, tf = tnear[i:i + step, None], tfar[i:i + step, None]
        th, uh, vh, ok = woop_test(s, o, d, tn, tf)
        dwp = d[..., 0] * s[2] + d[..., 1] * s[5] + d[..., 2] * s[8]
        if closest:
            best = torch.where(ok, th, INF).cummin(dim=1).values
            limit = torch.minimum(torch.cat([tf, best[:, :-1]], dim=1), tf)
            tested = torch.ones_like(ok)
        else:
            limit = tf
            tested = j <= tests_to_first_hit(ok, torch.full(
                (ok.shape[0],), n, device=org.device))[:, None]
        plane = tested & (torch.abs(dwp) > 1e-12) & (th > tn) & (th < limit)
        inside = ((uh >= -BARY_EPS) & (vh >= -BARY_EPS)
                  & (uh + vh <= 1.0 + BARY_EPS))
        cb.count(counts, 'pair', tested.sum())
        cb.count(counts, 'stage2', plane.sum())
        cb.count(counts, 'stage3', (plane & inside & culled).sum())


def staged_flops(counts) -> int:
    """The flops of the staged tests gathered in counts (staged_tests)."""
    return (int(counts.get('pair', 0)) * PLANE_FLOPS
            + int(counts.get('stage2', 0)) * INSIDE_FLOPS
            + int(counts.get('stage3', 0)) * CULL_FLOPS)


def live_rows(tris) -> int:
    """The count of packed triangles (16-float rows) of tris up to its
    last row that is not all zero: the rows the kernels test.  A zero row
    never hits (its d'_w is 0, or NaN for a non-finite direction), so the
    padding after the last live row is left out; zero rows between live
    ones stay.  Read once per version of the tensor."""
    seen = _LIVE_ROWS.get(tris)
    if seen is None or seen[0] != tris._version:
        nz = torch.nonzero(_rows(tris).ne(0).any(dim=1))
        seen = (tris._version, int(nz[-1]) + 1 if nz.numel() else 0)
        _LIVE_ROWS[tris] = seen
    return seen[1]


def _lib():
    return cb.library('dense', _SIGNATURES)


def kernel_args(tris, org, dirn, tnear, tfar):
    """The kernels' checked inputs: (rows, live rows, org, dirn, tnear,
    tfar)."""
    org, dirn, tnear, tfar = cb.ray_args(org, dirn, tnear, tfar)
    rows = cb.table_arg('tris', _rows(tris), 16, org.device)
    return rows, live_rows(tris), org, dirn, tnear, tfar


def launch(lib, entry, rows, live, org, dirn, tnear, tfar, *out):
    """K1 (yrt_intersect_dense) or K2 (yrt_occluded_dense) of lib, a
    build of csrc/dense.cu, on kernel_args' inputs and its outputs."""
    cb.launch(getattr(lib, entry), entry, org.device, rows, live, org, dirn,
              tnear, tfar, org.shape[0], *out)


def intersect_dense(tris, org, dirn, tnear, tfar) -> Hit:
    """Closest hit of each ray (R, 3) against all triangles."""
    if org.device.type == 'cpu':
        return intersect_dense_plain(tris, org, dirn, tnear, tfar)
    args = kernel_args(tris, org, dirn, tnear, tfar)
    r, dev = org.shape[0], org.device
    if args[1] == 0:
        return Hit(torch.full((r,), INF, device=dev),
                   torch.full((r,), -1, dtype=torch.int32, device=dev),
                   torch.zeros((r,), device=dev),
                   torch.zeros((r,), device=dev))
    return Hit(*cb.closest(_intersect_op, *args))


def occluded_dense(tris, org, dirn, tnear, tfar):
    """(R,) bool: is each ray segment (tnear, tfar) occluded."""
    if org.device.type == 'cpu':
        return occluded_dense_plain(tris, org, dirn, tnear, tfar)
    args = kernel_args(tris, org, dirn, tnear, tfar)
    if args[1] == 0:
        return torch.zeros((org.shape[0],), dtype=torch.bool,
                           device=org.device)
    return cb.occluded(_occluded_op, *args)


_intersect_op = cb.operator(
    'intersect_dense', f'(Tensor rows, int live, {cb.RAYS}, {cb.HIT}) -> ()',
    launch, _lib, intersect_dense)
_occluded_op = cb.operator(
    'occluded_dense', f'(Tensor rows, int live, {cb.RAYS}, {cb.OCC}) -> ()',
    launch, _lib, occluded_dense)

# launch counts: kernels launched, and plain versions run on CUDA tensors
intersect_dense.launches = 0
occluded_dense.launches = 0
intersect_dense_plain.cuda_calls = 0
occluded_dense_plain.cuda_calls = 0
