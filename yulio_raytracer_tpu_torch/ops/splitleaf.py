"""Split-leaf traversal (K11): a packet shares one walk of the binary BVH
and defers its leaf rows into one list, each row tested only by the rays
that reached it.

Counterpart of `yulio_raytracer_tpu/ops/pallas_splitleaf.py`
(`intersect_packet_split` and `intersect_packet_split_sorted`), the
reference's ablation of its packet kernel for incoherent bounce rays.  A
packet of PACKET = 32 rays, one warp (the reference: 1024 rays in 8
sub-blocks of 128), walks the tree with one shared stack of (node, entry
t): an interior pop slab-tests both children against every ray's own best
t and pushes the children some ray hits, far first, each with the least
entry t of the rays that hit it; near is the side the packet's summed
direction points to along the node's axis.  A pop whose entry t exceeds
the largest best t of the packet is culled.  A leaf pop whose box some
ray hits appends the leaf's packed triangle rows [a // 8,
(a + count + 7) // 8) to the packet's list, each with the mask of the
rays that hit the box; at a flush (when the list holds min(FLUSH_ROWS,
LISTCAP - max_groups) rows, and at the end) each ray tests all 8
triangles of each row its mask holds.  A triangle replaces a ray's best
hit only when strictly nearer; its index is row * 8 + m.  The result is
the closest hit of every ray, as K5's, up to the triangle chosen among
equal t.  The reference flushes at LISTCAP - max_groups rows; on the card
a flush after a few rows (FLUSH_ROWS) keeps the best t that culls the
walk's pops fresh, which pays more than longer sweeps do.

On a CUDA tensor `intersect_packet_split` launches the kernel of
csrc/splitleaf.cu, one packet per warp; on a CPU tensor it runs
`intersect_split_plain`, which replays that schedule step by step with
the packets as the batch dimension: the same pops, culls, list appends
and flushes, so the same pairs are tested.  The packet's direction sum is
taken in the kernel's order (a butterfly over the lanes), so the near
side agrees too.  Any ray count is accepted: the tail packet's missing
rays are dead.
"""
from __future__ import annotations

import ctypes

import torch

from . import binning
from . import cuda_build as cb
from . import traverse, wide
from .intersect import Hit, woop_test

WARP = 32                # rays per packet (one warp)
PACKET = WARP
STACK = wide.STACK       # shared stack entries (pallas_splitleaf.STACK)
LISTCAP = 48             # rows a packet's list holds
FLUSH_ROWS = 3           # rows that start a flush (the kernel's)
INF = float('inf')
# ray-triangle pairs of one step of the plain flush: each temporary of
# the Woop test stays at 64 MB
_FLUSH_ELEMS = 1 << 24

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {'yrt_intersect_split': [_V] * 6 + [_I] * 2 + [_V] * 5}


def max_groups(max_leaf: int) -> int:
    """Rows one leaf of at most max_leaf triangles can span."""
    return (max_leaf + 7) // 8 + 1


def _groups(nodes, max_leaf):
    """max_groups of max_leaf (None: the table's largest leaf); raises
    where a leaf of the table is larger, or one leaf's rows could not be
    appended by one warp or fit a list."""
    largest = max(1, int(nodes[:, 7].max()))
    max_leaf = largest if max_leaf is None else max_leaf
    g = max_groups(max_leaf)
    if largest > max_leaf or g > WARP or g >= LISTCAP:
        raise ValueError(f"split-leaf traversal: leaves of up to {largest} "
                         f"triangles, max_leaf {max_leaf}: a leaf must fit "
                         f"max_leaf, and max_leaf {8 * (WARP - 1) - 7} at "
                         f"most")
    return g


# ------------------------------------------------------- plain version

def _dir_sum(d):
    """(P,) sum of d (P, WARP) in the kernel's order: a butterfly over the
    lanes."""
    lane = torch.arange(WARP, device=d.device)
    for off in (16, 8, 4, 2, 1):
        d = d + d[..., lane ^ off]
    return d[:, 0]


def _flush(pk, rows, lists, masks, cnt, o, dirn, tn, best, counts):
    """Sweep the lists of packets pk and empty them: every ray tests each
    row its mask holds, in list order, keeping a strictly nearer hit.
    That sequence's winner is the first test in order at the least t
    below the best t the flush started from, which is what this takes at
    once."""
    t_b, tri_b, u_b, v_b = best
    q = int(cnt[pk].max()) if pk.numel() else 0
    if q == 0:
        return
    held = masks[pk] & (torch.arange(LISTCAP, device=pk.device)
                        < cnt[pk][:, None])[..., None]
    cb.count(counts, 'pair', held.sum() * 8)
    cb.count(counts, 'row', cnt[pk].sum())
    m = torch.arange(8 * q, device=pk.device)
    step = max(1, _FLUSH_ELEMS // (PACKET * 8 * q))
    for c0 in range(0, pk.numel(), step):
        p = pk[c0:c0 + step]
        tri = (lists[p, :q, None] * 8
               + torch.arange(8, device=p.device)).flatten(1)  # (n, 8q)
        valid = held[c0:c0 + step, :q].repeat_interleave(8, dim=1)
        s = rows[tri].permute(2, 0, 1)[:, :, None, :]
        th, uh, vh, ok = woop_test(s, o[p][..., None, :], dirn[p][..., None, :],
                                   tn[p][..., None], t_b[p][..., None])
        th = torch.where(ok & valid.transpose(1, 2), th, INF)  # (n, WARP, 8q)
        tmin = torch.amin(th, dim=-1)
        first = torch.amin(torch.where(th == tmin[..., None], m, 8 * q),
                           dim=-1, keepdim=True)
        hit = tmin < INF
        t_b[p] = torch.where(hit, tmin, t_b[p])
        tri_b[p] = torch.where(
            hit, tri[:, None, :].expand_as(th).gather(-1, first)[..., 0]
            .to(torch.int32), tri_b[p])
        u_b[p] = torch.where(hit, uh.gather(-1, first)[..., 0], u_b[p])
        v_b[p] = torch.where(hit, vh.gather(-1, first)[..., 0], v_b[p])
    cnt[pk] = 0


def intersect_split_plain(nodes, tris, org, dirn, tnear, tfar,
                          max_leaf=None, counts=None) -> Hit:
    """Plain torch version of the split-leaf kernel, its schedule replayed
    packet by packet (module docstring).  counts, a dict, gathers the
    kernel's triangle ('pair') and slab ('box') tests, every lane of a
    packet per box and each ray's 8 a row its mask holds, and the list
    rows swept ('row')."""
    if org.is_cuda:
        intersect_split_plain.cuda_calls += 1
    limit = min(FLUSH_ROWS, LISTCAP - _groups(nodes, max_leaf))
    r, dev = org.shape[0], org.device
    p = -(-r // PACKET)
    pad = p * PACKET - r

    def packets(x, fill):
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        return x.reshape((p, WARP) + x.shape[1:])
    o, d = packets(org, 0.0), packets(dirn, 0.0)
    tn, t_b = packets(tnear, 0.0), packets(tfar, -1.0)
    inv = wide._safe_inv(d)
    left_first = torch.stack([_dir_sum(d[..., k]) >= 0.0 for k in range(3)],
                             dim=1)                     # (P, 3)
    rows = tris.reshape(-1, 16)
    best = (t_b, torch.full(t_b.shape, -1, dtype=torch.int32, device=dev),
            torch.zeros_like(t_b), torch.zeros_like(t_b))
    st_n = torch.zeros((p, STACK), dtype=torch.int64, device=dev)
    st_t = torch.zeros((p, STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros((p,), dtype=torch.int64, device=dev)
    lists = torch.zeros((p, LISTCAP), dtype=torch.int64, device=dev)
    masks = torch.zeros((p, LISTCAP, WARP), dtype=torch.bool, device=dev)
    cnt = torch.zeros((p,), dtype=torch.int64, device=dev)
    t_allmax = torch.full((p,), INF, device=dev)
    cur_max = torch.amax(t_b, dim=1)
    far_near = torch.tensor([[0, 1], [1, 0]], device=dev)
    act = torch.arange(p, device=dev)
    while act.numel():
        top = sp[act]
        node, tpop = st_n[act, top], st_t[act, top]
        sp[act] = top - 1
        live = tpop <= t_allmax[act]
        nd = nodes[node]
        a, tag = nd[:, 6].to(torch.int64), nd[:, 7].to(torch.int64)
        lf = live & (tag > 0)
        if bool(lf.any()):
            pk = act[lf]
            cb.count(counts, 'box', PACKET * pk.numel())
            hit, _ = wide._slab(nd[lf][:, None, :], o[pk], inv[pk], tn[pk],
                                t_b[pk])                # (n, WARP)
            wh = hit.any(-1)
            g0 = a[lf] // 8
            gc = (a[lf] + tag[lf] + 7) // 8 - g0
            j = torch.arange(int(gc.max()), device=dev)
            ni, ji = torch.nonzero(wh[:, None] & (j < gc[:, None]),
                                   as_tuple=True)
            at = (pk[ni], cnt[pk[ni]] + ji)
            lists[at] = g0[ni] + ji
            masks[at] = hit[ni]
            cnt[pk] += torch.where(wh, gc, 0)
            fl = pk[cnt[pk] >= limit]
            if fl.numel():
                _flush(fl, rows, lists, masks, cnt, o, d, tn, best, counts)
                cur_max[fl] = torch.amax(t_b[fl], dim=1)
            t_allmax[pk] = cur_max[pk]
        inner = live & (tag < 0)
        if bool(inner.any()):
            pk = act[inner]
            cb.count(counts, 'box', 2 * PACKET * pk.numel())
            kids = torch.stack([node[inner] + 1, a[inner]], dim=1)
            hit, tmin = wide._slab(nodes[kids][:, :, None, :],
                                   o[pk][:, None], inv[pk][:, None],
                                   tn[pk][:, None], t_b[pk][:, None])
            any_k = hit.any(-1)                         # (n, 2) left, right
            m_k = torch.amin(torch.where(hit, tmin, INF), dim=-1)
            ln = left_first[pk].gather(1, -tag[inner][:, None] - 1)[:, 0]
            order = far_near[ln.long()]                 # far, then near
            kids, any_k, m_k = (x.gather(1, order) for x in (kids, any_k, m_k))
            for k in range(2):
                wide._push((st_n, st_t), sp, pk, any_k[:, k],
                           (kids[:, k], m_k[:, k]))
        act = act[sp[act] >= 0]
    _flush(torch.arange(p, device=dev), rows, lists, masks, cnt, o, d, tn,
           best, counts)
    t_b, tri_b, u_b, v_b = (x.reshape(-1)[:r] for x in best)
    return Hit(torch.where(tri_b >= 0, t_b, INF), tri_b, u_b, v_b)


# ------------------------------------------------------------- wrapper

def intersect_packet_split(nodes, tris, org, dirn, tnear, tfar,
                           max_leaf=None) -> Hit:
    """Closest hit of each ray (R, 3) through the binary BVH tables
    (ops/traverse.py pack_nodes, ops/wide.py pack_tris), a packet of
    PACKET rays at a time.  max_leaf sets the flush threshold as the
    reference's does (None: the table's largest leaf)."""
    if org.device.type == 'cpu':
        return intersect_split_plain(nodes, tris, org, dirn, tnear, tfar,
                                     max_leaf)
    return Hit(*cb.closest(_op, *kernel_args(nodes, tris, org, dirn, tnear,
                                             tfar, max_leaf)))


def kernel_args(nodes, tris, org, dirn, tnear, tfar, max_leaf=None):
    """The kernel's checked inputs: (nodes, tris, org, dirn, tnear, tfar,
    the rows a leaf spans (_groups))."""
    args = traverse.kernel_args(nodes, tris, org, dirn, tnear, tfar)[:6]
    return (*args, _groups(nodes, max_leaf))


def launch(lib, entry, nodes, tris, org, dirn, tnear, tfar, groups, *out):
    """K11 (yrt_intersect_split) of lib, a build of csrc/splitleaf.cu, on
    kernel_args' inputs and its outputs."""
    cb.launch(getattr(lib, entry), entry, org.device, nodes, tris, org,
              dirn, tnear, tfar, org.shape[0], groups, *out)


def _lib():
    return cb.library('splitleaf', _SIGNATURES)


def intersect_packet_split_sorted(nodes, tris, org, dirn, tnear, tfar,
                                  bbox_lo, bbox_hi, max_leaf=None) -> Hit:
    """intersect_packet_split on the rays in octant/Morton order over the
    box [bbox_lo, bbox_hi], dead rays last (ops/binning.py sorted_call);
    the results come back in the callers' order."""
    return binning.sorted_call(
        lambda o, d, tn, tf: intersect_packet_split(nodes, tris, o, d, tn,
                                                    tf, max_leaf),
        org, dirn, tnear, tfar, bbox_lo, bbox_hi)


_op = cb.operator(
    'intersect_split', f'(Tensor nodes, Tensor tris, {cb.RAYS}, int groups, '
    f'{cb.HIT}) -> ()', launch, _lib, intersect_packet_split)

# launch counts: kernels launched, and plain versions run on CUDA tensors
intersect_packet_split.launches = 0
intersect_split_plain.cuda_calls = 0
