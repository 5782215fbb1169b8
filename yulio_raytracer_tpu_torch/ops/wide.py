"""Wide-BVH traversal: BVH4, the default accel for scenes above 2048
triangles, and the 8-wide form of the same walks.

Counterpart of `yulio_raytracer_tpu/ops/pallas_wide.py`
(`intersect_packet4` / `occluded_packet4` at `width` 4 or 8, with
`pack_nodes4` and `pack_nodes8`) and of the table packing in
`yulio_raytracer_tpu/ops/pallas_traverse.py` (`pack_tris`), which imports
jax and so is copied here.  On a CUDA tensor each wrapper launches its
kernel from `csrc/wide.cu` (one ray per lane, leaves tested by each lane
or across the warp; see its header), one per width, in its *_slots form
for a table with a leaf of SLOTS_MIN triangles or more; on a CPU tensor
it runs the plain torch version, a vectorized per-ray stack traversal of
the same tables in the same order (the counterpart of `ops/traverse.py`),
which the kernels are held against on the card.  Any ray count is
accepted.  No render path takes width 8, nor in the reference: it is
reached through these ops, the tests and `wide_ab`.

Node rows, (Nw, 8 * width) f32, `width` slots of [lo.x lo.y lo.z hi.x
hi.y hi.z A tag]: tag > 0 leaf of `tag` triangles from packed triangle A;
tag == -1 interior, A = child row; tag == 0 empty (its +inf/-inf box is
don't-care: a slot is decided by its tag, never by its box).  The plain
versions read the width from the rows (32 columns: 4, 64: 8); the
wrappers raise where it is not their `width`.
"""
from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import cuda_build as cb
from .intersect import Hit, woop_test

STACK = 128          # per-ray stack entries (pallas_traverse.STACK)
INF = float('inf')
_PLAIN_RAYS = 1 << 18  # rays per slice of the plain traversal
# a leaf of this many triangles or more does not fit the 8 count bits of
# the kernels' stack words: a table with one takes their *_slots forms
SLOTS_MIN = 1 << 8

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'yrt_intersect_wide': [_V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V],
    'yrt_occluded_wide': [_V, _V, _V, _V, _V, _V, _I, _V, _V],
}
_SIGNATURES.update({name + '8': args for name, args in _SIGNATURES.items()})
_SIGNATURES.update({name + '_slots': args
                    for name, args in _SIGNATURES.items()})
# the largest leaf of each wide table given to a kernel, with the
# tensor's version then: one read from the card per table
_LARGEST_LEAF = WeakIdKeyDictionary()
# descending compare-exchange networks over the slots (far first),
# pallas_wide._SORT_NETS: 4 odd-even transposition (5), 8 Batcher's
# odd-even merge (19)
_SORT_NETS = {
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: ((0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)),
}


# ---------------------------------------------------------------- tables

def pack_tris(woop: np.ndarray, geom_host: dict) -> np.ndarray:
    """(G, 128) f32: 8 triangles per row, 16 floats each
    [woop.T flattened (12) | ng (3) | cull], the last row filled with
    zero triangles (inert: zero woop gives d'_z == 0, which never hits).
    The reference's table is this one followed by zero rows that only
    its TPU kernels read."""
    t = woop.shape[1] // 3
    w = np.asarray(woop, np.float32).reshape(4, t, 3)
    w = np.transpose(w, (1, 0, 2)).reshape(t, 12)
    flat = np.concatenate([
        w, np.asarray(geom_host['ng'], np.float32),
        np.asarray(geom_host['cull'], np.float32)[:, None]], axis=1)
    g = (t + 7) // 8
    out = np.zeros((g * 8, 16), np.float32)
    out[:t] = flat
    return out.reshape(g, 128)


def _check_packed(out: np.ndarray, width: int) -> np.ndarray:
    """Raise ValueError unless the wide table is exact in f32 (node
    indices and leaf ranges below 2^24, which is also what the kernels'
    stack words hold: a node row, or a leaf's A and count or its slot;
    csrc/wide.cu) and its worst-case stack occupancy, (width - 1) * depth
    + 1, fits STACK."""
    tags = out.reshape(-1, width, 8)[:, :, 7]
    a = out.reshape(-1, width, 8)[:, :, 6]
    if out.shape[0] >= 1 << 24:
        raise ValueError("wide node index exceeds f32 exact range 2^24")
    leaf = tags > 0
    if np.any(leaf) and float(np.max(a[leaf] + tags[leaf])) >= float(1 << 24):
        raise ValueError("leaf triangle range exceeds f32-exact 2^24")
    children = [[] for _ in range(out.shape[0])]
    interior = tags < 0
    for w in range(out.shape[0]):
        for k in range(width):
            if interior[w, k]:
                children[w].append(int(a[w, k]))
    depth = 1
    frontier = [0]
    while frontier:
        nxt = [c for w in frontier for c in children[w]]
        if nxt:
            depth += 1
        frontier = nxt
    worst = (width - 1) * depth + 1
    if worst > STACK:
        raise ValueError(
            f"wide tree depth {depth} could occupy {worst} stack slots "
            f"(> STACK={STACK}); rebuild with a shallower/balanced tree")
    return out


def _pack_wide(bvh, width, row_slots) -> np.ndarray:
    """(Nw, 8 * width) f32 rows of a binary FlatBVH (skip-pointer
    layout): the root's row, then the row of each interior slot's binary
    node, breadth first, each row's slots the binary nodes that
    row_slots(b, children) gives for its node b (children(b): b's two
    children), leaves with their ranges and interior slots patched to
    their child rows."""
    lo, hi = bvh.lo, bvh.hi
    start, count, skip = bvh.start, bvh.count, bvh.skip
    interior = count == 0

    def children(b):
        l = b + 1
        return l, int(skip[l])

    rows = []
    wide_of = {}            # binary interior node -> wide row index
    pending = []            # (wide_row, slot_k, binary_interior_node)

    def emit(b):
        slots = row_slots(b, children) if interior[b] else [b]
        row = np.zeros(8 * width, np.float32)
        me = len(rows)
        rows.append(row)
        for k, s in enumerate(slots):
            row[8 * k:8 * k + 3] = lo[s]
            row[8 * k + 3:8 * k + 6] = hi[s]
            if interior[s]:
                row[8 * k + 7] = -1.0
                pending.append((me, k, s))
            else:
                row[8 * k + 6] = float(start[s])
                row[8 * k + 7] = float(count[s])
        for k in range(len(slots), width):
            row[8 * k + 0:8 * k + 3] = INF
            row[8 * k + 3:8 * k + 6] = -INF
            row[8 * k + 7] = 0.0
        return me

    wide_of[0] = emit(0)
    i = 0
    while i < len(pending):
        w, k, b = pending[i]
        i += 1
        if b not in wide_of:
            wide_of[b] = emit(b)
        rows[w][8 * k + 6] = float(wide_of[b])
    return _check_packed(np.stack(rows).astype(np.float32), width)


def pack_nodes4(bvh) -> np.ndarray:
    """Collapse a binary FlatBVH (skip-pointer layout) into (N4, 32) f32
    4-wide rows: each wide node holds a binary node's children, interior
    children expanded one more level."""
    interior = bvh.count == 0

    def row_slots(b, children):
        slots = []
        for c in children(b):
            slots.extend(children(c) if interior[c] else (c,))
        return slots
    return _pack_wide(bvh, 4, row_slots)


def pack_nodes8(bvh) -> np.ndarray:
    """Collapse a binary FlatBVH into (N8, 64) f32 8-wide rows, slots as
    pack_nodes4's.  A row starts as the binary node's two children and
    replaces its interior slot of largest surface area by that slot's two
    children while it has fewer than 8 slots (the first of equal
    areas)."""
    lo, hi, interior = bvh.lo, bvh.hi, bvh.count == 0

    def area(b):
        d = np.maximum(hi[b] - lo[b], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def row_slots(b, children):
        slots = list(children(b))
        while len(slots) < 8:
            cand = [s for s in slots if interior[s]]
            if not cand:
                break
            i = slots.index(max(cand, key=area))
            slots[i:i + 1] = children(slots[i])
        return slots
    return _pack_wide(bvh, 8, row_slots)


def table_width(nodes) -> int:
    """The slots a row of the wide table nodes holds, from its row
    length: 32 columns are 4 slots, 64 are 8; anything else raises."""
    width = {32: 4, 64: 8}.get(nodes.shape[-1] if nodes.dim() == 2 else 0)
    if width is None:
        raise ValueError(f"wide nodes: expected (N, 32) or (N, 64) rows, "
                         f"got shape {tuple(nodes.shape)}")
    return width


# ------------------------------------------------------- plain versions

def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-30, d,
                             torch.where(d >= 0, 1e-30, -1e-30))


def _slab(nd, o, inv, tnear, tfar):
    """Slab test of the (n, w) slots nd (n, w, 8) for rays o/inv (n, 1,
    3); returns (hit, tmin), each (n, w), in the kernels' order."""
    t0x = (nd[..., 0] - o[..., 0]) * inv[..., 0]
    t1x = (nd[..., 3] - o[..., 0]) * inv[..., 0]
    t0y = (nd[..., 1] - o[..., 1]) * inv[..., 1]
    t1y = (nd[..., 4] - o[..., 1]) * inv[..., 1]
    t0z = (nd[..., 2] - o[..., 2]) * inv[..., 2]
    t1z = (nd[..., 5] - o[..., 2]) * inv[..., 2]
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), tnear))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.minimum(torch.maximum(t0z, t1z), tfar))
    return tmin <= tmax, tmin


def _leaf_rows(rows, a, c):
    """The rows of triangles [a, a + c) of each ray's leaf, field-major
    (width, n, max c) with column j = triangle a + j, and which columns
    are in range."""
    j = torch.arange(int(c.max()), device=a.device)
    inrange = j < c[:, None]
    idx = torch.where(inrange, a[:, None] + j, 0)
    return rows[idx].permute(2, 0, 1), inrange


def _leaf_test(rows, a, c, org, dirn, tnear, tfar):
    """Triangles [a, a + c) of each ray's leaf: (th, uh, vh, ok), each
    (n, max c), column j = triangle a + j."""
    s, inrange = _leaf_rows(rows, a, c)              # (16, n, max c)
    th, uh, vh, ok = woop_test(s, org[:, None, :], dirn[:, None, :],
                               tnear[:, None], tfar[:, None])
    return th, uh, vh, ok & inrange


def tests_to_first_hit(ok, c):
    """(n,) triangle tests an any-hit leaf loop makes over leaves of c
    triangles whose results are ok (n, max c): up to the first hit."""
    j = torch.arange(1, ok.shape[1] + 1, device=ok.device)
    return torch.amin(torch.where(ok, j, c[:, None]), dim=1)


def _push(stacks, sp, rid, mask, values):
    """Push values[k] (n,) onto the stacks of rays rid where mask (n,)."""
    sp[rid] += mask
    r, s = rid[mask], sp[rid][mask]
    for st, val in zip(stacks, values):
        st[r, s] = val[mask]


def _count_boxes(counts, tag):
    """Count the box tests of the visited rows whose slot tags are tag
    (n, width): 'box', those the function needs (the non-empty slots),
    and 'slots', those the kernels make (all width slots of a row)."""
    cb.count(counts, 'box', (tag != 0).sum())
    cb.count(counts, 'slots', tag.numel())


def _chunked(fn, tables, *rays):
    """Run fn(*tables, *rays) over slices of at most _PLAIN_RAYS rays
    (bounds the per-ray stacks' memory) and concatenate the results; a
    ray argument may be None."""
    outs = [fn(*tables, *(x if x is None else x[i:i + _PLAIN_RAYS]
                          for x in rays))
            for i in range(0, rays[0].shape[0], _PLAIN_RAYS)] or [
        fn(*tables, *rays)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return Hit(*(torch.cat(x) for x in zip(*outs)))


def intersect_wide_plain(nodes4, tris, org, dirn, tnear, tfar,
                         counts=None) -> Hit:
    """Plain torch version of the closest-hit kernels of both widths (the
    width read from the rows): every ray walks the tree with its own
    stack, in the kernel's order.  counts, a dict, gathers the triangle
    ('pair') and slab ('box', the non-empty slots of each row visited)
    tests the walk needs, the slab tests the kernel makes ('slots': empty
    slots included), and under 'stack' a list of (R,) tensors: each ray's
    largest stack occupancy, in entries."""
    if org.is_cuda:
        intersect_wide_plain.cuda_calls += 1
    return _chunked(partial(_closest_plain, counts=counts), (nodes4, tris),
                    org, dirn, tnear, tfar)


def occluded_wide_plain(nodes4, tris, org, dirn, tnear, tfar, counts=None):
    """Plain torch version of the any-hit kernels of both widths; rays
    with tfar <= tnear report not occluded.  counts as
    intersect_wide_plain."""
    if org.is_cuda:
        occluded_wide_plain.cuda_calls += 1
    return _chunked(partial(_any_plain, counts=counts), (nodes4, tris),
                    org, dirn, tnear, tfar)


def _closest_plain(nodes4, tris, org, dirn, tnear, tfar, counts=None) -> Hit:
    r, dev, width = org.shape[0], org.device, table_width(nodes4)
    rows, nodes = tris.reshape(-1, 16), nodes4.reshape(-1, width, 8)
    inv = _safe_inv(dirn)
    st_a = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    st_t = torch.zeros((r, STACK), dtype=torch.float32, device=dev)
    st_c = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    deepest = torch.ones((r,), dtype=torch.int64, device=dev)
    t_b = tfar.clone()
    tri_b = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    act = torch.arange(r, device=dev)
    while act.numel():
        top = sp[act]
        a, tpop, c = st_a[act, top], st_t[act, top], st_c[act, top]
        sp[act] = top - 1
        live = tpop <= t_b[act]
        leaf = live & (c > 0)
        if bool(leaf.any()):
            rid, la, lc = act[leaf], a[leaf], c[leaf]
            th, uh, vh, ok = _leaf_test(rows, la, lc, org[rid], dirn[rid],
                                        tnear[rid], t_b[rid])
            tmin, j = torch.min(torch.where(ok, th, INF), dim=1)
            hit = torch.any(ok, dim=1)
            rid, j = rid[hit], j[hit]
            t_b[rid] = tmin[hit]
            tri_b[rid] = (la[hit] + j).to(torch.int32)
            u_b[rid] = uh[hit].gather(1, j[:, None])[:, 0]
            v_b[rid] = vh[hit].gather(1, j[:, None])[:, 0]
            cb.count(counts, 'pair', lc.sum())
        inner = live & (c == 0)
        if bool(inner.any()):
            rid = act[inner]
            nd = nodes[a[inner]]                     # (n, width, 8)
            tag = nd[..., 7].to(torch.int64)
            _count_boxes(counts, tag)
            hit, tmin = _slab(nd, org[rid][:, None, :], inv[rid][:, None, :],
                              tnear[rid][:, None], t_b[rid][:, None])
            has = hit & (tag != 0)
            cols = [list(x.unbind(1)) for x in (
                torch.where(has, tmin, -INF), nd[..., 6].to(torch.int64),
                torch.clamp(tag, min=0), has)]
            for x, y in _SORT_NETS[width]:
                lt = cols[0][x] < cols[0][y]
                for col in cols:
                    col[x], col[y] = (torch.where(lt, col[y], col[x]),
                                      torch.where(lt, col[x], col[y]))
            m, ca, cc, hs = cols
            for k in range(width):
                _push((st_a, st_t, st_c), sp, rid, hs[k], (ca[k], m[k], cc[k]))
            if counts is not None:
                deepest[rid] = torch.maximum(deepest[rid], sp[rid] + 1)
        act = act[sp[act] >= 0]
    if counts is not None:
        counts.setdefault('stack', []).append(deepest)
    t = torch.where(tri_b >= 0, t_b, INF)
    return Hit(t, tri_b, u_b, v_b)


def _any_plain(nodes4, tris, org, dirn, tnear, tfar, counts=None):
    r, dev, width = org.shape[0], org.device, table_width(nodes4)
    rows, nodes = tris.reshape(-1, 16), nodes4.reshape(-1, width, 8)
    inv = _safe_inv(dirn)
    st_a = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    st_c = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    deepest = torch.ones((r,), dtype=torch.int64, device=dev)
    occ = torch.zeros((r,), dtype=torch.bool, device=dev)
    act = torch.nonzero(tfar > tnear)[:, 0]
    while act.numel():
        top = sp[act]
        a, c = st_a[act, top], st_c[act, top]
        sp[act] = top - 1
        leaf = c > 0
        if bool(leaf.any()):
            rid = act[leaf]
            ok = _leaf_test(rows, a[leaf], c[leaf], org[rid], dirn[rid],
                            tnear[rid], tfar[rid])[3]
            occ[rid] = torch.any(ok, dim=1)
            cb.count(counts, 'pair', tests_to_first_hit(ok, c[leaf]).sum())
        inner = ~leaf
        if bool(inner.any()):
            rid = act[inner]
            nd = nodes[a[inner]]
            tag = nd[..., 7].to(torch.int64)
            _count_boxes(counts, tag)
            hit, _ = _slab(nd, org[rid][:, None, :], inv[rid][:, None, :],
                           tnear[rid][:, None], tfar[rid][:, None])
            push = hit & (tag != 0)
            ca, cc = nd[..., 6].to(torch.int64), torch.clamp(tag, min=0)
            for k in range(width):
                _push((st_a, st_c), sp, rid, push[:, k], (ca[:, k], cc[:, k]))
            if counts is not None:
                deepest[rid] = torch.maximum(deepest[rid], sp[rid] + 1)
        act = act[(sp[act] >= 0) & ~occ[act]]
    if counts is not None:
        counts.setdefault('stack', []).append(deepest)
    return occ


# ------------------------------------------------------------- wrappers

def kernel_args(nodes4, tris, org, dirn, tnear, tfar, width=4):
    """The kernels' checked inputs: (nodes, tris, org, dirn, tnear,
    tfar)."""
    org, dirn, tnear, tfar = cb.ray_args(org, dirn, tnear, tfar)
    return (cb.table_arg('nodes4', nodes4, 8 * width, org.device),
            cb.table_arg('tris', tris.reshape(-1, 16), 16, org.device),
            org, dirn, tnear, tfar)


def _lib():
    return cb.library('wide', _SIGNATURES)


def _entry(lib, name, nodes4):
    """The C entry point `name` of lib for the table nodes4: its *_slots
    form where a leaf has SLOTS_MIN triangles or more."""
    seen = _LARGEST_LEAF.get(nodes4)
    if seen is None or seen[0] != nodes4._version:
        seen = (nodes4._version, int(nodes4.reshape(-1, 8)[:, 7].max()))
        _LARGEST_LEAF[nodes4] = seen
    return getattr(lib, name + '_slots' if seen[1] >= SLOTS_MIN else name)


def launch(lib, entry, nodes, tris, org, dirn, tnear, tfar, *out):
    """K3/K4 (yrt_intersect_wide[8] / yrt_occluded_wide[8], in the
    *_slots form the table needs) of lib, a build of csrc/wide.cu, on
    kernel_args' inputs and its outputs."""
    cb.launch(_entry(lib, entry, nodes), entry, org.device, nodes, tris,
              org, dirn, tnear, tfar, org.shape[0], *out)


def _check_width(nodes4, width):
    """Raise unless nodes4 holds rows of `width` slots (4 or 8)."""
    if width not in (4, 8) or table_width(nodes4) != width:
        raise ValueError(f"wide nodes: a width-{width} walk takes (N, "
                         f"{8 * width}) rows, got shape "
                         f"{tuple(nodes4.shape)}")


def intersect_packet4(nodes4, tris, org, dirn, tnear, tfar,
                      width=4) -> Hit:
    """Closest hit of each ray (R, 3) through the wide tables: BVH4 rows
    (pack_nodes4), or with width 8 pack_nodes8's."""
    _check_width(nodes4, width)
    if org.device.type == 'cpu':
        return intersect_wide_plain(nodes4, tris, org, dirn, tnear, tfar)
    return Hit(*cb.closest(_OPS['intersect', width], *kernel_args(
        nodes4, tris, org, dirn, tnear, tfar, width)))


def occluded_packet4(nodes4, tris, org, dirn, tnear, tfar, width=4):
    """(R,) bool: is each ray segment (tnear, tfar) occluded; tables as
    intersect_packet4's."""
    _check_width(nodes4, width)
    if org.device.type == 'cpu':
        return occluded_wide_plain(nodes4, tris, org, dirn, tnear, tfar)
    return cb.occluded(_OPS['occluded', width], *kernel_args(
        nodes4, tris, org, dirn, tnear, tfar, width))


def intersect_packet8(nodes8, tris, org, dirn, tnear, tfar) -> Hit:
    """intersect_packet4 at width 8; its `launches` count the width-8
    kernel's."""
    return intersect_packet4(nodes8, tris, org, dirn, tnear, tfar, width=8)


def occluded_packet8(nodes8, tris, org, dirn, tnear, tfar):
    """occluded_packet4 at width 8; its `launches` count the width-8
    kernel's."""
    return occluded_packet4(nodes8, tris, org, dirn, tnear, tfar, width=8)


_OPS = {('intersect', w): cb.operator(
    'intersect_wide' + suffix, f'(Tensor nodes, Tensor tris, {cb.RAYS}, '
    f'{cb.HIT}) -> ()', launch, _lib, counted)
    for w, suffix, counted in ((4, '', intersect_packet4),
                               (8, '8', intersect_packet8))}
_OPS.update({('occluded', w): cb.operator(
    'occluded_wide' + suffix, f'(Tensor nodes, Tensor tris, {cb.RAYS}, '
    f'{cb.OCC}) -> ()', launch, _lib, counted)
    for w, suffix, counted in ((4, '', occluded_packet4),
                               (8, '8', occluded_packet8))})

# launch counts: kernels launched, and plain versions run on CUDA tensors
intersect_packet4.launches = 0
occluded_packet4.launches = 0
intersect_packet8.launches = 0
occluded_packet8.launches = 0
intersect_wide_plain.cuda_calls = 0
occluded_wide_plain.cuda_calls = 0
