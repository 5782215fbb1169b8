"""The grid march K10 (csrc/grid.cu) and the split-leaf walk K11
(csrc/splitleaf.cu) of this checkout against another checkout's, timed in
turns on the card: the port's counterpart of the reference's
scripts/bench_incoherent.py 'march' and 'split' runs.

    python -m yulio_raytracer_tpu_torch.incoherent_turns OTHER_ROOT
        [--rounds N] [--bounds] [--sets all|march|split]

OTHER_ROOT is the root of another checkout of the repository (or a
directory holding a copy of `yulio_raytracer_tpu_torch/csrc/` alone, for
a variant).  Its `csrc/grid.cu` and `csrc/splitleaf.cu` must have the
entry points `yrt_grid_march` and `yrt_intersect_split`, whose C
interface has not changed since they were ported (`ops/pairs.py` and
`ops/splitleaf.py` `_SIGNATURES`); the tool checks their sources for
them.  Both trees' sources are built.  The colonnade (leaf 32) is
committed on the card and the sets are those `chip_smoke.py` holds K10
and K11 on, made from seed 42: 1M hemisphere rays from the hits of its
1024^2 camera rays for K10, in call order and sorted as
`grid.intersect_march` sorts them (`grid.march_sort_key`), and for K11
those rays in octant/Morton order (`binning.sort_perm`) and the camera
rays.  Each round times every set with both libraries (CUDA events,
median of 5 after a warm-up), this checkout's first on even rounds and
the other's first on odd ones, then the set's sort alone
(wide_turns.run_turns).  The two libraries' results must be bit-equal.
One line per set: each library's median over the
rounds with its min, max and quartile spread, the ratio of the medians
and in how many rounds this checkout's kernel was the faster; with
--bounds also the set's tests and bound (the larger of the bytes at 3.35
TB/s and 55 flops a pair test plus 25 a box test at 67 TFLOP/s f32) and
each library's share of it.  K10's tests are its plain version's count,
beside the rows its kernel loads in GB (64 bytes a row; one ray per
thread loads a row for every test); K11's are the tests K5's plain
version makes on the same rays, which its closest hits need, beside the
tests of this checkout's schedule (its plain version's count).  The
plain versions must agree with this checkout's kernels.  Then each
library's machine instructions per kernel of all six sources
(`cuobjdump -sass`); the last line is the same as one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import raysets, roofline, wide_turns
from .io import builtin_scenes as bs
from .ops import binning, grid, pairs, splitleaf, traverse, wide
from .ops import cuda_build as cb

SEED = 42
ROW_BYTES = 64              # one slot's row of the grid
SASS_SOURCES = ('dense', 'wide', 'binary', 'grid', 'splitleaf', 'sweep')
# each kernel's source and C entry point, with this checkout's interface
ENTRY = {'march': ('grid', 'yrt_grid_march', pairs._SIGNATURES),
         'split': ('splitleaf', 'yrt_intersect_split',
                   splitleaf._SIGNATURES)}


def load(csrc):
    """{'march': lib, 'split': lib} for the sources in directory csrc,
    after checking that each has its entry point."""
    libs = {}
    for kernel, (src, entry, sigs) in ENTRY.items():
        with open(os.path.join(csrc, src + '.cu')) as f:
            if f'"C" int {entry}(' not in f.read():
                raise ValueError(f"{csrc}/{src}.cu has no {entry}")
        libs[kernel] = cb.library(src, {entry: sigs[entry]}, csrc)
    return libs


def launch(libs, kernel, args):
    """One launch of K10 ('march': args (grid, org, dirn, tnear, tfar)) or
    K11 ('split': args (nodes, tris, org, dirn, tnear, tfar, max_leaf))
    from libs, as the wrappers make it; returns its outputs as a tuple."""
    if kernel == 'march':
        g, *rays = args
        rays = cb.ray_args(*rays)
        r, dev = rays[0].shape[0], rays[0].device
        res = round(g['cell_tile_lo'].numel() ** (1 / 3))
        out = (torch.empty((r,), dtype=torch.float32, device=dev),
               torch.empty((r,), dtype=torch.int32, device=dev))
        cb.launch(libs['march'].yrt_grid_march, 'march_raw', dev, g['rows'],
                  g['cell_tile_lo'], g['cell_tile_hi'], g['grid_lo'],
                  g['grid_hi'], *rays, res, r, *out)
        return out
    nodes, tris, *rays, max_leaf = args
    targs = traverse._kernel_args(nodes, tris.reshape(-1, 16), *rays)
    r, dev = targs[2].shape[0], targs[2].device
    out = cb.empty_hit(r, dev)
    cb.launch(libs['split'].yrt_intersect_split, 'intersect_packet_split',
              dev, *targs, r, splitleaf._groups(nodes, max_leaf), *out)
    return out


def make_sets(which='all'):
    """(scene, {name: [(kernel, args), ...]}) on the card."""
    dev = torch.device('cuda')
    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = raysets.camera_rays(sc, bs.colonnade_camera(1024, 1024),
                                       1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, *cam)
    hemi = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)[:4]
    march = {k: sc.grid[k] for k in ('rows', 'cell_tile_lo', 'cell_tile_hi',
                                     'grid_lo', 'grid_hi')}
    sets = {}
    if which in ('march', 'all'):
        perm = torch.argsort(grid.march_sort_key(march, *hemi), stable=True)
        sets['K10 hemisphere (call order)'] = [('march', (march, *hemi))]
        sets['K10 hemisphere (sorted)'] = [
            ('march', (march, *(x[perm] for x in hemi)))]
    if which in ('split', 'all'):
        perm = binning.sort_perm(*hemi, sc.bbox_lo, sc.bbox_hi)
        sets['K11 hemisphere (sorted)'] = [(
            'split', (sc.nodes, sc.tris, *(x[perm] for x in hemi),
                      sc.leaf_size))]
        sets['K11 camera'] = [('split', (sc.nodes, sc.tris, *cam,
                                         sc.leaf_size))]
    return sc, sets


def sort_alone(sc, calls):
    """The permutation the set's entry point sorts its rays by: K10's
    `march_sort_key` order, K11's `binning.sort_perm`."""
    kernel, args = calls[0]
    if kernel == 'march':
        return torch.argsort(grid.march_sort_key(*args), stable=True)
    return binning.sort_perm(*args[2:6], sc.bbox_lo, sc.bbox_hi)


def bound_of(calls, outs):
    """The set's tests, bytes and bound; raises where a plain version
    disagrees with this checkout's kernel."""
    (kernel, args), out = calls[0], outs[0]
    moved = sum(x.numel() * x.element_size() for x in (
        *(v for a in args if isinstance(a, dict) for v in a.values()),
        *(a for a in args if isinstance(a, torch.Tensor)), *out))
    b = {'bytes': moved}
    if kernel == 'march':
        counts = {}
        ref = grid.march_raw_plain(*args, counts=counts)
        if not all(torch.equal(x, y) for x, y in zip(out, ref)):
            raise AssertionError("K10 and its plain version disagree")
        b.update(pair_tests=int(counts['pair']), box_tests=0,
                 rows_gb=int(counts['rows']) * ROW_BYTES / 1e9,
                 one_ray_rows_gb=int(counts['pair']) * ROW_BYTES / 1e9)
    else:
        counts, k5 = {}, {}
        ref = splitleaf.intersect_split_plain(*args, counts=counts)
        if not all(torch.equal(x, y) for x, y in zip(out, ref)):
            raise AssertionError("K11 and its plain version disagree")
        traverse.intersect_binary_plain(*args[:6], counts=k5)
        b.update(pair_tests=int(k5['pair']), box_tests=int(k5['box']),
                 schedule_pair_tests=int(counts['pair']),
                 schedule_box_tests=int(counts['box']))
    b['bound_ms'], b['bound_by'] = roofline.bound(
        moved, b['pair_tests'] * roofline.WOOP_FLOPS
        + b['box_tests'] * roofline.SLAB_FLOPS)
    return b


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--bounds', action='store_true')
    ap.add_argument('--sets', choices=('all', 'march', 'split'),
                    default='all')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("incoherent_turns: no CUDA device", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    # each source of both trees, one nvcc each, a library built once
    jobs = [(src, csrc) for csrc in (cb.CSRC, other) for src in SASS_SOURCES]
    unique = {cb.lib_path(*job): job for job in jobs}
    with ThreadPoolExecutor(len(unique)) as pool:
        list(pool.map(lambda job: cb.build(*job), unique.values()))
    libs = {'this': load(cb.CSRC), 'other': load(other)}
    card = wide_turns.card_name()
    sc, sets = make_sets(opts.sets)

    def run(k, calls):
        return [launch(libs[k], kernel, args) for kernel, args in calls]

    def bounds(what, calls, outs, med):
        b = bound_of(calls, outs)
        text = f"; {b['pair_tests']} pair and {b['box_tests']} box tests"
        if 'rows_gb' in b:
            text += (f"; rows loaded {b['rows_gb']:.2f} GB (one ray per "
                     f"thread: {b['one_ray_rows_gb']:.2f} GB)")
        else:
            text += (f" (K5's); this schedule's {b['schedule_pair_tests']} "
                     f"and {b['schedule_box_tests']}, "
                     f"{b['schedule_pair_tests'] / b['pair_tests']:.2f}x and "
                     f"{b['schedule_box_tests'] / b['box_tests']:.2f}x")
        text += (f"; {b['bytes']} bytes, bound {b['bound_ms']:.4f} ms by "
                 f"{b['bound_by']}: this {b['bound_ms'] / med['this']:.2%}, "
                 f"other {b['bound_ms'] / med['other']:.2%} of it; plain "
                 f"versions equal")
        return {**b, **{f'{k}_share': b['bound_ms'] / med[k]
                        for k in ('this', 'other')}}, text

    summary, _ = wide_turns.run_turns(
        sets, run, opts.rounds, card,
        lambda calls: sum(args[1 if k == 'march' else 2].shape[0]
                          for k, args in calls),
        also={'sort': lambda calls: sort_alone(sc, calls)},
        extra=bounds if opts.bounds else None)
    sass = {'this': {}, 'other': {}}
    for src, csrc in jobs:
        sass['this' if csrc == cb.CSRC else 'other'].update(
            wide_turns._sass_sizes(cb.lib_path(src, csrc)))
    wide_turns.report(sass, card=card, rounds=opts.rounds, which=opts.sets,
                      sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
