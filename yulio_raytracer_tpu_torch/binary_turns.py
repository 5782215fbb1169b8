"""The binary-BVH kernels K5/K6 and the motion kernel K7 (csrc/binary.cu)
of this checkout against another checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.binary_turns OTHER_ROOT [--rounds N]
        [--spp S] [--bounds] [--sets all|binary|motion]

OTHER_ROOT is the root of another checkout of the repository whose
`csrc/binary.cu` has the entry points `yrt_intersect_binary`,
`yrt_occluded_binary` and `yrt_intersect_motion` with this checkout's C
interface (`ops/traverse.py` `_SIGNATURES`); where it has no
`yrt_occluded_motion` (K7's any-hit form), its closest form and
`tri >= 0` are timed in its place, as that tree's wrapper computed the
mask.  Both sources are built.  The sets are made from seed 42.  With
`--sets binary` (or `all`, the default) the colonnade (leaf 32) is
committed on the card, with these sets:
- the entry sets `chip_smoke.py` times: its 1024^2 camera rays, 1M
  hemisphere rays from their hits (K5), the shadow rays from those hits
  to its 4 lights (K6), and the hemisphere and shadow rays each started
  at the root of its nearest treelet (raysets.from_treelet_roots);
- the frame sets: every K5 and every K6 call of one bounce-1 trace at
  1024^2 and `--spp` samples a pixel (default 1: a pass of 2^20 rays)
  with accel 'bvh2' (both bounces) and through ray_binning 'grid',
  'dense' (bounce 1's fallback) and 'treelet' (bounce 1's two rounds
  from treelet roots and the fallback), as raysets.frame_binary_calls
  records them.
With `--sets motion` (or `all`) the motion field is committed on the card
(173 binary nodes over union bounds, leaves of up to 64 motion rows),
with these sets:
- the entry sets `chip_smoke.py` holds K7 on: 512^2 camera rays with
  their times, and 1M rays scattered through its box at random times;
- the frame sets: every K7 call of one bounce-1 trace at the
  motion_field_512 frame's own size, 512^2 at 16 samples a pixel (a pass
  of 2^22 rays and its 2^23 shadow rays to the 2 lights), the closest
  calls and the any-hit calls apart (raysets.frame_motion_calls).
A frame set is timed as all its calls in a row.  Each round times every
set with both libraries (CUDA events, median of 5 after a warm-up), this
checkout's first on even rounds and the other's first on odd ones
(wide_turns.run_turns).  The results must be bit-equal
on every call.  One line per set: each library's median over the rounds
with its min, max and quartile spread, the ratio of the medians and in
how many rounds this checkout's kernel was the faster, and the share of
its rays whose segment is not empty (tfar > tnear); with --bounds also
the set's triangle and box tests (the plain versions' count, in the
kernels' order; the plain results must equal the kernels'), the plain
versions' largest stack occupancy per ray (median, 99th percentile,
max), bytes, bound (the larger of the bytes at 3.35 TB/s and 55 flops a
triangle test, 87 a motion test, plus 25 a box test at 67 TFLOP/s f32)
and each library's share of it.  Then each library's machine
instructions per kernel of its `binary`, `wide`, `splitleaf` and `grid`
sources (`cuobjdump -sass`);
the last line is the same as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from . import raysets, wide_turns
from .roofline import MOTION_FLOPS, SLAB_FLOPS, WOOP_FLOPS, bound
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import traverse, wide

SEED = 42
# each wrapper's plain version and the flops of its triangle test
PLAIN = {'intersect_packet': (traverse.intersect_binary_plain, WOOP_FLOPS),
         'occluded_packet': (traverse.occluded_binary_plain, WOOP_FLOPS),
         'intersect_packet_mb': (traverse.intersect_motion_plain,
                                 MOTION_FLOPS),
         'occluded_packet_mb': (traverse.occluded_motion_plain,
                                MOTION_FLOPS)}
# each wrapper's C entry point
ENTRY = {'intersect_packet': 'yrt_intersect_binary',
         'occluded_packet': 'yrt_occluded_binary',
         'intersect_packet_mb': 'yrt_intersect_motion',
         'occluded_packet_mb': 'yrt_occluded_motion'}
# the sources whose machine instructions are compared
SASS_SOURCES = ('binary', 'wide', 'splitleaf', 'grid')


def launch(lib, kernel, args):
    """One launch from lib as the wrappers make it, of K5
    ('intersect_packet') or K6 ('occluded_packet') on args (nodes, tris,
    org, dirn, tnear, tfar, roots), or of K7's closest form
    ('intersect_packet_mb') or any-hit form ('occluded_packet_mb') on
    (nodes, tris_mb, org, dirn, tnear, tfar, time); returns its outputs as
    a tuple.  A lib without K7's any-hit form gives its closest form's
    tri >= 0."""
    nodes, tris, *rays, last = args
    if kernel.endswith('_mb'):
        targs = traverse._kernel_args(
            nodes, tris.reshape(-1, traverse.MB_STRIDE), *rays, last)
        roots = ()
    else:
        targs = traverse._kernel_args(nodes, tris.reshape(-1, 16), *rays)
        roots = (traverse._roots_arg(last, targs[2].shape[0],
                                     targs[2].device),)
    r, dev = targs[2].shape[0], targs[2].device
    entry = ENTRY[kernel]
    if kernel == 'occluded_packet_mb' and not hasattr(lib, entry):
        return (launch(lib, 'intersect_packet_mb', args)[1] >= 0,)
    if kernel.startswith('occluded'):
        out = (torch.empty((r,), dtype=torch.bool, device=dev),)
    else:
        out = cb.empty_hit(r, dev)
    cb.launch(getattr(lib, entry), kernel, dev, *targs, *roots, r, *out)
    return out


def make_sets(spp, which='all'):
    """{name: [(kernel, args), ...]} on the card: with which 'binary' or
    'all' K5/K6's entry sets and bvh2, grid, dense and treelet frame sets,
    with 'motion' or 'all' K7's."""
    sets = {}
    if which in ('binary', 'all'):
        sets.update(_binary_sets(spp))
    if which in ('motion', 'all'):
        sets.update(_motion_sets())
    return sets


def _binary_sets(spp):
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


def _motion_sets():
    dev = torch.device('cuda')
    sc = bs.motion_field().commit(device=dev)
    tables = (sc.nodes, sc.tris_mb)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, tm = raysets.camera_rays(sc, bs.motion_field_camera(512, 512),
                                        512, 512, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    camera = (org, dirn, zeros, torch.full_like(zeros, float('inf')), tm)
    scattered = raysets.scattered_rays(sc, 1 << 20, gen, dev)
    sets = {'K7 camera': [('intersect_packet_mb', (*tables, *camera))],
            'K7 scattered': [('intersect_packet_mb', (*tables, *scattered))]}
    calls = raysets.frame_motion_calls(sc, bs.motion_field_camera(512, 512),
                                       512, 512, spp=16, seed=SEED)
    for form, name in (('closest', 'intersect_packet_mb'),
                       ('any-hit', 'occluded_packet_mb')):
        mine = [(c['kernel'], c['args']) for c in calls
                if c['kernel'] == name]
        sets[f'K7 {form} motion frame ({len(mine)} calls)'] = mine
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
    pair, box, flops, moved, depth = 0, 0, 0, 0, []
    for (kernel, args), out in zip(calls, outs):
        counts = {}
        plain, pair_flops = PLAIN[kernel]
        ref = plain(*args, counts=counts)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{kernel}: the kernel and its plain "
                                 "version disagree")
        pair += int(counts.get('pair', 0))
        box += int(counts.get('box', 0))
        flops += (int(counts.get('pair', 0)) * pair_flops
                  + int(counts.get('box', 0)) * SLAB_FLOPS)
        depth += counts['stack']
        moved += sum(x.numel() * x.element_size() for x in (*args, *out)
                     if x is not None)
    d = torch.cat(depth).float()
    q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device))
    bound_ms, bound_by = bound(moved, flops)
    return {'pair_tests': pair, 'box_tests': box, 'bytes': moved,
            'stack_median': float(q[0]), 'stack_p99': float(q[1]),
            'stack_max': float(d.max()),
            'bound_ms': bound_ms, 'bound_by': bound_by}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--bounds', action='store_true')
    ap.add_argument('--sets', choices=('all', 'binary', 'motion'),
                    default='all')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("binary_turns: no CUDA device", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    with open(os.path.join(other, 'binary.cu')) as f:
        source = f.read()
    timed = {k: v for k, v in traverse._SIGNATURES.items()
             if f'"C" int {k}(' in source}
    libs = {'this': traverse._lib(),
            'other': cb.library('binary', timed, other)}
    card = wide_turns.card_name()
    sets = make_sets(opts.spp, opts.sets)

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
                      which=opts.sets, sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
