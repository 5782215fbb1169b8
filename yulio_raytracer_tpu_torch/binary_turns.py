"""The binary-BVH kernels K5/K6 (csrc/binary.cu) of this checkout against
another checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.binary_turns OTHER_ROOT [--rounds N]
        [--spp S] [--bounds]

OTHER_ROOT is the root of another checkout of the repository whose
`csrc/binary.cu` has the entry points `yrt_intersect_binary` and
`yrt_occluded_binary` with this checkout's C interface (`ops/traverse.py`
`_SIGNATURES`).  Both sources are built.  The colonnade (leaf 32) is
committed on the card, and the sets are made from seed 42:
- the entry sets `chip_smoke.py` times: its 1024^2 camera rays, 1M
  hemisphere rays from their hits (K5), the shadow rays from those hits
  to its 4 lights (K6), and the hemisphere and shadow rays each started
  at the root of its nearest treelet (raysets.from_treelet_roots);
- the frame sets: every K5 and every K6 call of one bounce-1 trace at
  1024^2 and `--spp` samples a pixel (default 1: a pass of 2^20 rays)
  with accel 'bvh2' (both bounces) and through ray_binning 'grid',
  'dense' (bounce 1's fallback) and 'treelet' (bounce 1's two rounds
  from treelet roots and the fallback), as raysets.frame_binary_calls
  records them.  A frame set is timed as all its calls in a row.
Each round times every set with both libraries (CUDA events, median of 5
after a warm-up), this checkout's first on even rounds and the other's
first on odd ones (wide_turns.run_turns).  The results must be bit-equal
on every call.  One line per set: each library's median over the rounds
with its min, max and quartile spread, the ratio of the medians and in
how many rounds this checkout's kernel was the faster, and the share of
its rays whose segment is not empty (tfar > tnear); with --bounds also
the set's triangle and box tests (the plain versions' count, in the
kernels' order; the plain results must equal the kernels'), the plain
versions' largest stack occupancy per ray (median, 99th percentile,
max), bytes, bound (the larger of the bytes at 3.35 TB/s and 55 flops a
triangle test plus 25 a box test at 67 TFLOP/s f32) and each library's
share of it.  Then each library's machine instructions per kernel of its
`binary`, `wide`, `splitleaf` and `grid` sources (`cuobjdump -sass`);
the last line is the same as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from . import raysets, wide_turns
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import traverse, wide

SEED = 42
PEAK_BYTES = 3.35e12        # the H100 SXM's HBM3 bytes/s
PEAK_FLOPS = 67e12          # its f32 flops/s outside the tensor cores
WOOP_FLOPS = 55             # one triangle test (chip_smoke.py WOOP_FLOPS)
SLAB_FLOPS = 25             # one box test (chip_smoke.py SLAB_FLOPS)
PLAIN = {'intersect_packet': traverse.intersect_binary_plain,
         'occluded_packet': traverse.occluded_binary_plain}
# the sources whose machine instructions are compared
SASS_SOURCES = ('binary', 'wide', 'splitleaf', 'grid')


def launch(lib, kernel, args):
    """One K5 ('intersect_packet') or K6 ('occluded_packet') launch from
    lib on args (nodes, tris, org, dirn, tnear, tfar, roots), as the
    wrappers make it; returns its outputs as a tuple."""
    nodes, tris, *rays, roots = args
    targs = traverse._kernel_args(nodes, tris.reshape(-1, 16), *rays)
    r, dev = targs[2].shape[0], targs[2].device
    roots = traverse._roots_arg(roots, r, dev)
    if kernel == 'occluded_packet':
        out = (torch.empty((r,), dtype=torch.bool, device=dev),)
        cb.launch(lib.yrt_occluded_binary, kernel, dev, *targs, roots, r,
                  *out)
    else:
        out = cb.empty_hit(r, dev)
        cb.launch(lib.yrt_intersect_binary, kernel, dev, *targs, roots, r,
                  *out)
    return out


def make_sets(spp):
    """{name: [(kernel, args), ...]}: the entry sets and the bvh2, grid,
    dense and treelet frame sets, on the card."""
    dev = torch.device('cuda')
    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    tables = (sc.nodes, sc.tris)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cam = bs.colonnade_camera(1024, 1024)
    org, dirn, _ = raysets.camera_rays(sc, cam, 1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    camera = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, *camera)
    *hemi, dg, eps = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)
    shadow = raysets.shadow_rays(sc, dg, eps, hit.valid, gen, dev)
    sets = {
        'K5 camera': [('intersect_packet', (*tables, *camera, None))],
        'K5 hemisphere': [('intersect_packet', (*tables, *hemi, None))],
        'K6 shadow': [('occluded_packet', (*tables, *shadow, None))],
        'K5 hemisphere from treelet roots': [('intersect_packet', (
            *tables, *raysets.from_treelet_roots(sc, *hemi)))],
        'K6 shadow from treelet roots': [('occluded_packet', (
            *tables, *raysets.from_treelet_roots(sc, *shadow)))]}
    for how in ('bvh2', 'grid', 'dense', 'treelet'):
        calls = raysets.frame_binary_calls(sc, cam, how, 1024, 1024,
                                           spp=spp, seed=SEED)
        for k, name in (('K5', 'intersect_packet'),
                        ('K6', 'occluded_packet')):
            mine = [(c['kernel'], c['args']) for c in calls
                    if c['kernel'] == name]
            sets[f'{k} {how} frame ({len(mine)} calls)'] = mine
    return sets


def live_share(calls):
    """The share of a set's rays whose segment is not empty."""
    live = sum(int((args[5] > args[4]).sum()) for _, args in calls)
    return live / sum(args[2].shape[0] for _, args in calls)


def bound_of(calls, outs):
    """A set's tests, stack occupancy and bound: the triangle and box
    tests its plain versions count (their results must equal outs, the
    kernels'), the quantiles of each ray's largest stack occupancy, the
    bytes of its inputs read once and outputs written once, and the bound
    in ms."""
    pair, box, moved, depth = 0, 0, 0, []
    for (kernel, args), out in zip(calls, outs):
        counts = {}
        ref = PLAIN[kernel](*args, counts=counts)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{kernel}: the kernel and its plain "
                                 "version disagree")
        pair += int(counts.get('pair', 0))
        box += int(counts.get('box', 0))
        depth += counts['stack']
        moved += sum(x.numel() * x.element_size() for x in (*args, *out)
                     if x is not None)
    d = torch.cat(depth).float()
    q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device))
    flops = pair * WOOP_FLOPS + box * SLAB_FLOPS
    return {'pair_tests': pair, 'box_tests': box, 'bytes': moved,
            'stack_median': float(q[0]), 'stack_p99': float(q[1]),
            'stack_max': float(d.max()),
            'bound_ms': max(moved / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3,
            'bound_by': ('bytes' if moved / PEAK_BYTES >= flops / PEAK_FLOPS
                         else 'operations')}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--bounds', action='store_true')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("binary_turns: no CUDA device", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    timed = {k: traverse._SIGNATURES[k]
             for k in ('yrt_intersect_binary', 'yrt_occluded_binary')}
    libs = {'this': traverse._lib(),
            'other': cb.library('binary', timed, other)}
    card = wide_turns.card_name()
    sets = make_sets(opts.spp)

    def run(k, calls):
        return [launch(libs[k], kernel, args) for kernel, args in calls]

    def extra(what, calls, outs, med):
        share = live_share(calls)
        more, text = {'live_share': share}, f"; {share:.1%} live"
        if opts.bounds:
            b = bound_of(calls, outs)
            more.update(b, **{f'{k}_share': b['bound_ms'] / med[k]
                              for k in libs})
            text += (f"; {b['pair_tests']} triangle and {b['box_tests']} "
                     f"box tests, stack occupancy median "
                     f"{b['stack_median']:.0f}, 99th percentile "
                     f"{b['stack_p99']:.0f}, max {b['stack_max']:.0f}, "
                     f"{b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by "
                     f"{b['bound_by']}: this "
                     f"{b['bound_ms'] / med['this']:.2%}, other "
                     f"{b['bound_ms'] / med['other']:.2%} of it; plain "
                     f"versions equal")
        return more, text

    summary, _ = wide_turns.run_turns(
        sets, run, opts.rounds, card,
        lambda calls: sum(args[2].shape[0] for _, args in calls),
        extra=extra)
    sass = {k: {} for k in libs}
    for src in SASS_SOURCES:
        for k, csrc in (('this', cb.CSRC), ('other', other)):
            sass[k].update(wide_turns._sass_sizes(cb.build(src, csrc)))
    wide_turns.report(sass, card=card, rounds=opts.rounds, spp=opts.spp,
                      sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
