"""Ray binning: the octant/Morton sort of a ray batch around a traversal.

Counterpart of `_ray_sort_key` and `_sorted_call` of
`yulio_raytracer_tpu/ops/pallas_traverse.py`, which imports jax, so they
are copied here.  The key is the direction octant (3 bits) above a
15-bit Morton code of the origin's cell in a 32^3 lattice over the
scene's box; `sorted_call` adds a segment id above the octant (bit 18)
and puts dead rays (tfar <= tnear) last (bit 30).  Keys are int64 (the
CPU build of torch has no shifts of uint32), with the same bits as the
reference's uint32 keys, and the argsort is stable, as `jnp.argsort` is,
so the permutation is the reference's.

The reference sorts so that a 1024-ray packet of its TPU kernels holds
coherent rays.  Of the port's kernels the split-leaf kernel
(ops/splitleaf.py, K11) shares work across a packet, and its `_sorted`
form runs through `sorted_call`; the grid march (ops/grid.py, K10)
shares a cell's rows among a warp's rays, and sorts by the entry cell
above this key (`march_sort_key`).  Sharing one sort among a bounce's batches
(`hitpoint_sort_perm`) and sorting under ray_binning='morton' are not
ported.
"""
from __future__ import annotations

import torch


def ray_sort_key(org, dirn, bbox_lo, bbox_hi):
    """(R,) int64 coherence key of rays org/dirn (R, 3) in the box
    [bbox_lo, bbox_hi]: octant bits 15-17 over the origin's Morton code."""
    lo = torch.as_tensor(bbox_lo, dtype=torch.float32, device=org.device)
    hi = torch.as_tensor(bbox_hi, dtype=torch.float32, device=org.device)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((org - lo) / span, 0.0, 1.0)
    cell = (q * 31.0).to(torch.int64)                 # 5 bits per axis
    m = torch.zeros(org.shape[:1], dtype=torch.int64, device=org.device)
    for b in range(5):                                 # interleave (Morton)
        for a in range(3):
            m = m | (((cell[:, a] >> b) & 1) << (3 * b + a))
    octant = ((dirn[:, 0] < 0).long() | ((dirn[:, 1] < 0).long() << 1)
              | ((dirn[:, 2] < 0).long() << 2))
    return (octant << 15) | m


def sort_perm(org, dirn, tnear, tfar, bbox_lo, bbox_hi, seg=None):
    """The permutation `sorted_call` traces in: by segment id (seg, a
    small int per ray, above the octant), then key, dead rays last."""
    key = ray_sort_key(org, dirn, bbox_lo, bbox_hi)
    if seg is not None:
        key = key | (seg.to(torch.int64) << 18)
    key = key | ((tfar <= tnear).long() << 30)
    return torch.argsort(key, stable=True)


def sorted_call(fn, org, dirn, tnear, tfar, bbox_lo, bbox_hi, seg=None):
    """fn(org, dirn, tnear, tfar) on the rays in `sort_perm` order, its
    outputs (a tensor, a tuple or a named tuple of (R, ...) tensors)
    unsorted by scatter."""
    perm = sort_perm(org, dirn, tnear, tfar, bbox_lo, bbox_hi, seg)
    outs = fn(org[perm], dirn[perm], tnear[perm], tfar[perm])

    def unsort(o):
        out = torch.empty_like(o)
        out[perm] = o
        return out
    if isinstance(outs, torch.Tensor):
        return unsort(outs)
    res = tuple(map(unsort, outs))
    return type(outs)(*res) if hasattr(outs, '_fields') else res
