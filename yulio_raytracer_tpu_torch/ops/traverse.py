"""Binary-BVH and motion-blur traversal.

Counterpart of `yulio_raytracer_tpu/ops/pallas_traverse.py`
(`intersect_packet`, `occluded_packet`, `intersect_packet_mb` and
`occluded_packet_mb`, with the tables `pack_nodes`, `pack_tris_mb` and
`motion_bounds`), which imports jax, so the table packing is copied here.
The plain versions are also the counterpart of the per-ray BVH walk of
`yulio_raytracer_tpu/ops/traverse.py`.  On a CUDA tensor each wrapper
launches its kernel from `csrc/binary.cu` (one ray per lane with a
private stack, the leaves tested by each lane or across the warp; see its
header); on a CPU tensor it runs the plain torch version, a vectorized
per-ray stack traversal of the same tables in the same order, which the
kernels are held against on the card.  Any ray count is accepted.

`intersect_packet` / `occluded_packet` take an optional start node per
ray (`roots`), where the reference takes one per 1024-ray packet: the
'treelet' binning (ops/treelets.py) starts each ray at the root of its
nearest unvisited treelet.  `intersect_packet_staged` /
`occluded_packet_staged` walk each ray's segment in stages of growing
length over the same kernels (the reference's staged-t walks); no render
path takes them, nor in the reference.

Node rows, (N, 8) f32 [lo.x lo.y lo.z hi.x hi.y hi.z A tag] in
depth-first order: tag > 0 is a leaf of `tag` triangles from packed
triangle A; tag = -(axis + 1) an interior node whose left child is the
next row and whose right child is row A.  A closest-hit ray pops first
the child on the side its own direction points to along `axis` (the
reference's packets use the packet's summed direction); an any-hit ray,
whose mask does not depend on the order, the hit child of least entry t,
that side on a tie, as its kernel does.

Motion triangle rows, (G, 128) f32: 4 triangles of 32 floats
[v0 e1 e2 mv0 me1 me2 cull | pad]; at time s in [0, 1] the triangle is
(v0 + s mv0, e1 + s me1, e2 + s me2).  Motion scenes build their tree
over `motion_bounds`, so one node table serves every time.
"""
from __future__ import annotations

import ctypes
import math
from functools import partial

import numpy as np
import torch

from . import cuda_build as cb
from . import wide
from .intersect import BARY_EPS, Hit

STACK = wide.STACK   # per-ray stack entries (pallas_traverse.STACK)
MB_STRIDE = 32       # floats per motion triangle
INF = float('inf')

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'yrt_intersect_binary': [_V] * 7 + [_I] + [_V] * 5,
    'yrt_occluded_binary': [_V] * 7 + [_I] + [_V] * 2,
    'yrt_intersect_motion': [_V] * 7 + [_I] + [_V] * 5,
    'yrt_occluded_motion': [_V] * 7 + [_I] + [_V] * 2,
}


# ---------------------------------------------------------------- tables

def pack_nodes(bvh) -> np.ndarray:
    """FlatBVH -> (N, 8) f32 node rows (see module docstring)."""
    n = bvh.num_nodes
    idx = np.arange(n)
    interior = bvh.count == 0
    # DFS layout: left child = i+1, right child = skip[i+1] (the end of
    # the left subtree is where the right subtree starts)
    left = np.minimum(idx + 1, n - 1)
    right = np.zeros(n, np.int32)
    right[interior] = bvh.skip[left[interior]]
    a = np.where(interior, right, bvh.start).astype(np.float32)
    # traversal-order axis: the dominant separation axis of the two
    # children's box centroids
    ctr = 0.5 * (bvh.lo.astype(np.float64) + bvh.hi.astype(np.float64))
    sep = np.abs(ctr[right] - ctr[left])
    sep[~np.isfinite(sep)] = 0.0
    axis = np.argmax(sep, axis=1).astype(np.int32)
    tag = np.where(interior, -(axis + 1), bvh.count).astype(np.float32)
    return _check_nodes(np.concatenate([
        bvh.lo.astype(np.float32), bvh.hi.astype(np.float32),
        a[:, None], tag[:, None]], axis=1))


def _check_nodes(nodes: np.ndarray) -> np.ndarray:
    """Raise ValueError unless the binary table is exact in f32 (node
    indices and leaf ranges below 2^24) and its worst-case stack
    occupancy, depth + 1, fits STACK."""
    a, tag = nodes[:, 6], nodes[:, 7]
    if nodes.shape[0] >= 1 << 24:
        raise ValueError("binary node index exceeds f32 exact range 2^24")
    leaf = tag > 0
    if np.any(leaf) and float(np.max(a[leaf] + tag[leaf])) >= float(1 << 24):
        raise ValueError("leaf triangle range exceeds f32-exact 2^24")
    worst = stack_bound(nodes)
    if worst > STACK:
        raise ValueError(
            f"binary tree depth {worst - 1} could occupy {worst} stack "
            f"slots (> STACK={STACK}); rebuild with a shallower tree")
    return nodes


def stack_bound(nodes: np.ndarray) -> int:
    """The most stack entries a walk of the binary table from its root
    can hold: the tree's depth + 1 (a walk holds at most one entry a
    level, plus the near child just pushed)."""
    a, tag = nodes[:, 6], nodes[:, 7]
    depth = np.ones(nodes.shape[0], np.int64)
    for i in np.nonzero(tag < 0)[0]:      # parents precede their children
        depth[i + 1] = depth[int(a[i])] = depth[i] + 1
    return int(depth.max()) + 1


def pack_tris_mb(geom_host: dict) -> np.ndarray:
    """(G, 128) f32: 4 motion triangles per row, 32 floats each
    [v0(3) e1(3) e2(3) mv0(3) me1(3) me2(3) cull | pad].  Invalid
    triangles and padding rows are zero (zero edges give det == 0)."""
    v0 = np.asarray(geom_host['v0'], np.float32)
    t = v0.shape[0]
    flat = np.zeros((t, MB_STRIDE), np.float32)
    flat[:, 0:3] = v0
    flat[:, 3:6] = geom_host['e1']
    flat[:, 6:9] = geom_host['e2']
    flat[:, 9:12] = geom_host['mv0']
    flat[:, 12:15] = geom_host['me1']
    flat[:, 15:18] = geom_host['me2']
    flat[:, 18] = geom_host['cull']
    flat[~np.asarray(geom_host['valid'], bool)] = 0.0
    g = (t + 3) // 4
    out = np.zeros((g * 4, MB_STRIDE), np.float32)
    out[:t] = flat
    return out.reshape(g, 128)


def motion_bounds(v0, e1, e2, mv0, me1, me2):
    """Per-triangle union bounds over t in [0, 1] (linear motion: the
    union of the t=0 and t=1 triangle boxes is exact)."""
    cs = [v0, v0 + e1, v0 + e2]
    cs += [c + m for c, m in zip(cs, (mv0, mv0 + me1, mv0 + me2))]
    lo = np.min(np.stack(cs), axis=0)
    hi = np.max(np.stack(cs), axis=0)
    return lo.astype(np.float64), hi.astype(np.float64)


# ------------------------------------------------------- plain versions

def mb_test(w, time, org, dirn):
    """Time-interpolated Moller-Trumbore with the cull test, in the
    operation order of the reference's `_mb_tri_test`.  w: the 19 row
    fields [v0 e1 e2 mv0 me1 me2 cull], each broadcastable against time
    and org[..., k].  Returns (ok, th, uh, vh); the (tnear, tfar) window
    is the caller's."""
    ox, oy, oz = org[..., 0], org[..., 1], org[..., 2]
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    e1x = w[3] + time * w[12]
    e1y = w[4] + time * w[13]
    e1z = w[5] + time * w[14]
    e2x = w[6] + time * w[15]
    e2y = w[7] + time * w[16]
    e2z = w[8] + time * w[17]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ngx = e1y * e2z - e1z * e2y
    ngy = e1z * e2x - e1x * e2z
    ngz = e1x * e2y - e1y * e2x
    ngd = dx * ngx + dy * ngy + dz * ngz
    cull_ok = (w[18] != 1.0) | (ngd < 0.0)
    nz = torch.abs(det) > 1e-12
    inv_det = torch.where(nz, 1.0 / det, 0.0)
    tvx = ox - (w[0] + time * w[9])
    tvy = oy - (w[1] + time * w[10])
    tvz = oz - (w[2] + time * w[11])
    uh = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vh = (dx * qx + dy * qy + dz * qz) * inv_det
    th = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (nz & (uh >= -BARY_EPS) & (vh >= -BARY_EPS)
          & (uh + vh <= 1.0 + BARY_EPS) & cull_ok)
    return ok, th, uh, vh


def _woop_leaf(tris):
    """Leaf test over Woop rows (K5/K6): (a, c, org, dirn, tnear, tfar,
    time) -> (th, uh, vh, ok), each (n, max c)."""
    rows = tris.reshape(-1, 16)

    def test(a, c, org, dirn, tnear, tfar, _time):
        return wide._leaf_test(rows, a, c, org, dirn, tnear, tfar)
    return test


def _motion_leaf(tris_mb):
    """Leaf test over motion rows at each ray's time (K7)."""
    rows = tris_mb.reshape(-1, MB_STRIDE)

    def test(a, c, org, dirn, tnear, tfar, time):
        w, inrange = wide._leaf_rows(rows, a, c)     # (32, n, max c)
        ok, th, uh, vh = mb_test(w, time[:, None], org[:, None, :],
                                 dirn[:, None, :])
        ok = ok & (th > tnear[:, None]) & (th < tfar[:, None]) & inrange
        return th, uh, vh, ok
    return test


def _children(nodes, node, a, tag, org, dirn, inv, tnear, tfar,
              by_entry=False):
    """Both children of interior nodes, the one to visit second first:
    (kids, hit, tmin), each (n, 2).  The near child, visited first, is the
    left one when the ray's direction along the node's axis is >= 0; with
    by_entry, where both are hit and the far one's entry t is strictly
    less, the far one."""
    kids = torch.stack([node + 1, a], dim=1)
    left_near = dirn.gather(1, -tag[:, None] - 1) >= 0.0
    kids = torch.where(left_near, kids.flip(1), kids)
    hit, tmin = wide._slab(nodes[kids], org[:, None, :], inv[:, None, :],
                           tnear[:, None], tfar[:, None])
    if by_entry:
        swap = (hit.all(dim=1) & (tmin[:, 0] < tmin[:, 1]))[:, None]
        kids, hit, tmin = (torch.where(swap, x.flip(1), x)
                           for x in (kids, hit, tmin))
    return kids, hit, tmin


def _closest_plain(nodes, leaf, org, dirn, tnear, tfar, time=None,
                   roots=None, counts=None) -> Hit:
    r, dev = org.shape[0], org.device
    inv = wide._safe_inv(dirn)
    st_n = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    if roots is not None:
        st_n[:, 0] = roots
    st_t = torch.zeros((r, STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    deepest = torch.ones((r,), dtype=torch.int64, device=dev)
    t_b = tfar.clone()
    tri_b = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    act = torch.arange(r, device=dev)
    while act.numel():
        top = sp[act]
        node, tpop = st_n[act, top], st_t[act, top]
        sp[act] = top - 1
        live = tpop <= t_b[act]
        nd = nodes[node]
        a, tag = nd[:, 6].to(torch.int64), nd[:, 7].to(torch.int64)
        lf = live & (tag > 0)
        if bool(lf.any()):
            rid, la = act[lf], a[lf]
            th, uh, vh, ok = leaf(la, tag[lf], org[rid], dirn[rid],
                                  tnear[rid], t_b[rid],
                                  None if time is None else time[rid])
            tmin, j = torch.min(torch.where(ok, th, INF), dim=1)
            hit = torch.any(ok, dim=1)
            rid, j = rid[hit], j[hit]
            t_b[rid] = tmin[hit]
            tri_b[rid] = (la[hit] + j).to(torch.int32)
            u_b[rid] = uh[hit].gather(1, j[:, None])[:, 0]
            v_b[rid] = vh[hit].gather(1, j[:, None])[:, 0]
            cb.count(counts, 'pair', tag[lf].sum())
        inner = live & (tag < 0)
        if bool(inner.any()):
            rid = act[inner]
            cb.count(counts, 'box', 2 * rid.numel())
            kids, hit, tmin = _children(nodes, node[inner], a[inner],
                                        tag[inner], org[rid], dirn[rid],
                                        inv[rid], tnear[rid], t_b[rid])
            for k in range(2):
                wide._push((st_n, st_t), sp, rid, hit[:, k],
                           (kids[:, k], tmin[:, k]))
            if counts is not None:
                deepest[rid] = torch.maximum(deepest[rid], sp[rid] + 1)
        act = act[sp[act] >= 0]
    if counts is not None:
        counts.setdefault('stack', []).append(deepest)
    t = torch.where(tri_b >= 0, t_b, INF)
    return Hit(t, tri_b, u_b, v_b)


def _any_plain(nodes, leaf, org, dirn, tnear, tfar, time=None, roots=None,
               counts=None, root_entry=False):
    """The any-hit walk of the rays with tfar > tnear (with root_entry
    also 0 <= tfar, as the closest walk takes its root at entry t 0)."""
    r, dev = org.shape[0], org.device
    inv = wide._safe_inv(dirn)
    st_n = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    if roots is not None:
        st_n[:, 0] = roots
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    deepest = torch.ones((r,), dtype=torch.int64, device=dev)
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    live = tfar > tnear
    if root_entry:
        live &= tfar >= 0.0
    act = torch.nonzero(live)[:, 0]
    while act.numel():
        top = sp[act]
        node = st_n[act, top]
        sp[act] = top - 1
        nd = nodes[node]
        a, tag = nd[:, 6].to(torch.int64), nd[:, 7].to(torch.int64)
        lf = tag > 0
        if bool(lf.any()):
            rid = act[lf]
            ok = leaf(a[lf], tag[lf], org[rid], dirn[rid], tnear[rid],
                      tfar[rid], None if time is None else time[rid])[3]
            occ[rid] = torch.any(ok, dim=1)
            cb.count(counts, 'pair',
                     wide.tests_to_first_hit(ok, tag[lf]).sum())
        inner = tag < 0
        if bool(inner.any()):
            rid = act[inner]
            cb.count(counts, 'box', 2 * rid.numel())
            kids, hit, _ = _children(nodes, node[inner], a[inner],
                                     tag[inner], org[rid], dirn[rid],
                                     inv[rid], tnear[rid], tfar[rid],
                                     by_entry=True)
            for k in range(2):
                wide._push((st_n,), sp, rid, hit[:, k], (kids[:, k],))
            if counts is not None:
                deepest[rid] = torch.maximum(deepest[rid], sp[rid] + 1)
        act = act[(sp[act] >= 0) & ~occ[act]]
    if counts is not None:
        counts.setdefault('stack', []).append(deepest)
    return occ


def intersect_binary_plain(nodes, tris, org, dirn, tnear, tfar, roots=None,
                           counts=None) -> Hit:
    """Plain torch version of the binary closest-hit kernel, each ray
    from its node of roots ((R,) int32; None: node 0).  counts, a dict,
    gathers the kernel's triangle ('pair') and slab ('box') tests, and
    under 'stack' a list of (R,) tensors: each ray's largest stack
    occupancy, in entries, the root's included."""
    if org.is_cuda:
        intersect_binary_plain.cuda_calls += 1
    return wide._chunked(partial(_closest_plain, counts=counts),
                         (nodes, _woop_leaf(tris)), org, dirn, tnear, tfar,
                         None, roots)


def occluded_binary_plain(nodes, tris, org, dirn, tnear, tfar, roots=None,
                          counts=None):
    """Plain torch version of the binary any-hit kernel; rays with
    tfar <= tnear report not occluded.  Its walk is the kernel's: the hit
    child of least entry t first (the near one on a tie), up to the first
    hit, so that its counts are the kernel's tests.  roots and counts as
    above."""
    if org.is_cuda:
        occluded_binary_plain.cuda_calls += 1
    return wide._chunked(partial(_any_plain, counts=counts),
                         (nodes, _woop_leaf(tris)), org, dirn, tnear, tfar,
                         None, roots)


def intersect_motion_plain(nodes, tris_mb, org, dirn, tnear, tfar, time,
                           counts=None) -> Hit:
    """Plain torch version of the motion-blur closest-hit kernel.  counts
    as above."""
    if org.is_cuda:
        intersect_motion_plain.cuda_calls += 1
    return wide._chunked(partial(_closest_plain, counts=counts),
                         (nodes, _motion_leaf(tris_mb)), org, dirn, tnear,
                         tfar, time)


def occluded_motion_plain(nodes, tris_mb, org, dirn, tnear, tfar, time,
                          counts=None):
    """Plain torch version of the motion-blur any-hit kernel: the binary
    any-hit walk (hit child of least entry t first, up to the first hit)
    over the motion rows at each ray's time.  Its mask is
    intersect_motion_plain's tri >= 0 on every ray: a ray walks where
    tfar > tnear and 0 <= tfar (the closest walk's root, entry t 0), and a
    hit inside (tnear, tfar) exists exactly where the closest walk finds
    one.  counts as above, in this walk's order."""
    if org.is_cuda:
        occluded_motion_plain.cuda_calls += 1
    return wide._chunked(partial(_any_plain, counts=counts, root_entry=True),
                         (nodes, _motion_leaf(tris_mb)), org, dirn, tnear,
                         tfar, time)


# ------------------------------------------------------------- wrappers

def kernel_args(nodes, tris, org, dirn, tnear, tfar, roots=None, time=None):
    """The kernels' checked inputs: (nodes, tris, org, dirn, tnear, tfar,
    then the rays' times for a motion walk (time given; pack_tris_mb
    rows), else their roots (roots_arg; pack_tris rows))."""
    motion = time is not None
    rays = cb.ray_args(org, dirn, tnear, tfar, *((time,) if motion else ()))
    r, dev = rays[0].shape[0], rays[0].device
    rows = tris.reshape(-1, MB_STRIDE if motion else 16)
    return (cb.table_arg('nodes', nodes, 8, dev),
            cb.table_arg('tris', rows, rows.shape[1], dev), *rays[:4],
            rays[4] if motion else _roots_arg(roots, r, dev))


def _roots_arg(roots, r, dev):
    """Check per-ray start nodes: an int32 (R,) tensor on dev, or None
    (node 0; a null pointer to the kernel).  The kernel trusts them to
    index the node rows, as it trusts the rows' own child indices."""
    if roots is None:
        return None
    if (roots.dtype != torch.int32 or tuple(roots.shape) != (r,)
            or roots.device != dev):
        raise ValueError(f"roots: expected an int32 tensor of shape ({r},) "
                         f"on {dev}, got {roots.dtype} "
                         f"{tuple(roots.shape)} on {roots.device}")
    return roots.contiguous()


def _lib():
    return cb.library('binary', _SIGNATURES)


def launch(lib, entry, nodes, tris, org, dirn, tnear, tfar, last, *out):
    """K5/K6 (yrt_intersect_binary / yrt_occluded_binary) or K7
    (yrt_intersect_motion / yrt_occluded_motion) of lib, a build of
    csrc/binary.cu, on kernel_args' inputs and its outputs."""
    cb.launch(getattr(lib, entry), entry, org.device, nodes, tris, org,
              dirn, tnear, tfar, last, org.shape[0], *out)


def intersect_packet(nodes, tris, org, dirn, tnear, tfar, roots=None) -> Hit:
    """Closest hit of each ray (R, 3) through the binary BVH tables,
    each ray walking the subtree of its node of roots ((R,) int32; None:
    the whole tree)."""
    if org.device.type == 'cpu':
        return intersect_binary_plain(nodes, tris, org, dirn, tnear, tfar,
                                      roots)
    return Hit(*cb.closest(_OPS['intersect_binary'], *kernel_args(
        nodes, tris, org, dirn, tnear, tfar, roots)))


def occluded_packet(nodes, tris, org, dirn, tnear, tfar, roots=None):
    """(R,) bool: is each ray segment (tnear, tfar) occluded (within the
    subtree of its node of roots, as intersect_packet)."""
    if org.device.type == 'cpu':
        return occluded_binary_plain(nodes, tris, org, dirn, tnear, tfar,
                                     roots)
    return cb.occluded(_OPS['occluded_binary'], *kernel_args(
        nodes, tris, org, dirn, tnear, tfar, roots))


def intersect_packet_mb(nodes, tris_mb, org, dirn, tnear, tfar,
                        time) -> Hit:
    """Closest hit of each ray at its time (R,) in [0, 1], through nodes
    built over motion_bounds and the pack_tris_mb rows."""
    if org.device.type == 'cpu':
        return intersect_motion_plain(nodes, tris_mb, org, dirn, tnear,
                                      tfar, time)
    return Hit(*cb.closest(_OPS['intersect_motion'], *kernel_args(
        nodes, tris_mb, org, dirn, tnear, tfar, time=time)))


def occluded_packet_mb(nodes, tris_mb, org, dirn, tnear, tfar, time):
    """(R,) bool: is each ray segment (tnear, tfar) occluded at its time:
    the reference's occluded_packet_mb, intersect_packet_mb's hit mask,
    computed by the motion kernel's any-hit form, which stops at the
    first hit."""
    if org.device.type == 'cpu':
        return occluded_motion_plain(nodes, tris_mb, org, dirn, tnear, tfar,
                                     time)
    return cb.occluded(_OPS['occluded_motion'], *kernel_args(
        nodes, tris_mb, org, dirn, tnear, tfar, time=time))


_OPS = {name: cb.operator(
    name, f'(Tensor nodes, Tensor tris, {cb.RAYS}, {last}, {out}) -> ()',
    launch, _lib, counted) for name, last, out, counted in (
        ('intersect_binary', 'Tensor? roots', cb.HIT, intersect_packet),
        ('occluded_binary', 'Tensor? roots', cb.OCC, occluded_packet),
        ('intersect_motion', 'Tensor time', cb.HIT, intersect_packet_mb),
        ('occluded_motion', 'Tensor time', cb.OCC, occluded_packet_mb))}


# ---------------------------------------------------------- staged walks
#
# The reference's staged-t walks (pallas_traverse.py intersect_packet_staged
# and occluded_packet_staged): each ray's segment is walked in stages that
# end at growing fractions of the scene's diagonal, then once to its own
# tfar.  A closest hit found within a stage is the closest of all, and an
# occluded ray is done, so a ray resolved in one stage is a dead lane
# (tfar = -1) in the later ones.  Stage k + 1 starts a hair before stage
# k's cap, cap * (1 - 1e-5), so that a hit at the cap is not lost between
# them, or at the ray's own tnear where that is later (the reference
# moves every live ray's start back to that point, even one whose tnear
# lies past it, and can then report a hit in front of the ray: ROADMAP
# C7).  The reference sorts the rays
# first for its packets; a ray's result here does not depend on its place
# in the batch, so the port does not.

def _staged_caps(bbox_lo, bbox_hi, stages):
    diag = math.sqrt(sum((h - l) ** 2 for l, h in zip(bbox_lo, bbox_hi)))
    return [diag * s for s in stages]


def _next_start(live, lo_t, cap):
    """Where each live ray's next stage starts: a hair before the cap
    just walked, never before the ray's own start."""
    return torch.where(live, torch.clamp(lo_t, min=cap * (1.0 - 1e-5)), lo_t)


def _closest_staged(closest, nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                    bbox_hi, stages) -> Hit:
    best = Hit(torch.full_like(tnear, INF),
               torch.full(tnear.shape, -1, dtype=torch.int32,
                          device=tnear.device),
               torch.zeros_like(tnear), torch.zeros_like(tnear))
    lo_t = tnear
    for cap in _staged_caps(bbox_lo, bbox_hi, stages) + [None]:
        live = (best.tri < 0) & (tfar > lo_t)
        tf_k = torch.where(live, tfar if cap is None
                           else torch.clamp(tfar, max=cap), -1.0)
        h = closest(nodes, tris, org, dirn, lo_t, tf_k)
        upd = live & (h.tri >= 0)
        best = Hit(*(torch.where(upd, x, y) for x, y in zip(h, best)))
        if cap is not None:
            lo_t = _next_start(live, lo_t, cap)
    return best


def _occluded_staged(occluded, nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                     bbox_hi, stages):
    occ = torch.zeros(tnear.shape, dtype=torch.bool, device=tnear.device)
    lo_t = tnear
    for cap in _staged_caps(bbox_lo, bbox_hi, stages) + [None]:
        live = ~occ & (tfar > lo_t)
        tf_k = torch.where(live, tfar if cap is None
                           else torch.clamp(tfar, max=cap), -1.0)
        occ = occ | occluded(nodes, tris, org, dirn, lo_t, tf_k)
        if cap is not None:
            lo_t = _next_start(live, lo_t, cap)
    return occ


def intersect_packet_staged(nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                            bbox_hi, stages=(0.07, 0.3)) -> Hit:
    """Closest hit of each ray through the binary tables, walked in
    stages (K5 once a stage): caps at `stages` fractions of the diagonal
    of the box bbox_lo / bbox_hi (tuples), then a last uncapped stage."""
    return _closest_staged(intersect_packet, nodes, tris, org, dirn, tnear,
                           tfar, bbox_lo, bbox_hi, stages)


def occluded_packet_staged(nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                           bbox_hi, stages=(0.07, 0.3)):
    """(R,) bool: is each ray segment (tnear, tfar) occluded, walked in
    stages as intersect_packet_staged (K6 once a stage)."""
    return _occluded_staged(occluded_packet, nodes, tris, org, dirn, tnear,
                            tfar, bbox_lo, bbox_hi, stages)


def intersect_staged_plain(nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                           bbox_hi, stages=(0.07, 0.3), counts=None) -> Hit:
    """intersect_packet_staged over K5's plain version, which the staged
    walk on the card is held against; counts gathers every stage's
    tests (intersect_binary_plain)."""
    return _closest_staged(partial(intersect_binary_plain, counts=counts),
                           nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                           bbox_hi, stages)


def occluded_staged_plain(nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                          bbox_hi, stages=(0.07, 0.3), counts=None):
    """occluded_packet_staged over K6's plain version; counts as
    intersect_staged_plain."""
    return _occluded_staged(partial(occluded_binary_plain, counts=counts),
                            nodes, tris, org, dirn, tnear, tfar, bbox_lo,
                            bbox_hi, stages)


# launch counts: kernels launched, and plain versions run on CUDA tensors
intersect_packet.launches = 0
occluded_packet.launches = 0
intersect_packet_mb.launches = 0
occluded_packet_mb.launches = 0
intersect_binary_plain.cuda_calls = 0
occluded_binary_plain.cuda_calls = 0
intersect_motion_plain.cuda_calls = 0
occluded_motion_plain.cuda_calls = 0
