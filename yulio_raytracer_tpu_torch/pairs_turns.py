"""The pair kernels K8/K9 (csrc/grid.cu) of this checkout against another
checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.pairs_turns OTHER_ROOT [--rounds N]
        [--spp S] [--bounds]

OTHER_ROOT is the root of another checkout of the repository.  Its
`csrc/grid.cu` has either this checkout's C interface (`yrt_bin_pairs`,
then a sweep that takes the binning's scratch) or the one-ray-per-thread
interface before it (`yrt_intersect_pairs` / `yrt_occluded_pairs` taking
per-ray gs and ge); the source says which.  Both sources are built.  The
colonnade (leaf 32) is committed on the card, and the sets are made from
seed 42:
- the entry-cell sets `chip_smoke.py` times: 1M hemisphere rays from
  the hits of its 1024^2 camera rays (K8) and their shadow rays to its 4
  lights (K9), each over its entry cell's tiles (ops/grid.py
  entry_ranges);
- the frame sets: every K8 and K9 call of one bounce-1 trace at 1024^2
  and `--spp` samples a pixel (default 1: a pass of 2^20 rays; 4 is the
  timed frames' pass) through ray_binning 'grid' (8 K8 and 4 K9 rounds
  over the grid's rows) and 'dense' (2 and 2 over the treelets' rows),
  as raysets.frame_pair_calls records them.  A frame set is timed as
  all its calls in a row.
Each round times every set with both libraries (CUDA events, median of 5
after a warm-up), this checkout's first on even rounds and the other's
first on odd ones, then this checkout's binning kernels alone
(wide_turns.run_turns).  A timed call includes its binning kernels.  The
two libraries' results must be bit-equal on every call.  One line per
set: each library's median over the rounds with its min, max and
quartile spread, the ratio of the medians and in how many rounds this
checkout's kernels were the faster, the median of this checkout's
binning alone; with --bounds also the set's pair tests (the plain
versions' count), bytes, bound (the larger of the bytes at 3.35 TB/s and
55 flops a test at 67 TFLOP/s f32) and each library's share of it.
Then each library's machine instructions per kernel (`cuobjdump -sass`);
the last line is the same as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

from . import raysets, roofline, wide_turns
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import grid, pairs, wide

SEED = 42
_V, _I = ctypes.c_void_p, ctypes.c_int
# the one-ray-per-thread interface: per-ray gs and ge, no binning
_PER_RAY_SIGNATURES = {
    'yrt_intersect_pairs': [_V] * 7 + [_I] * 2 + [_V] * 3,
    'yrt_occluded_pairs': [_V] * 7 + [_I] * 2 + [_V] * 2,
}


def load(csrc):
    """(library, binned) for the grid.cu in directory csrc: binned says
    whether it has this checkout's interface."""
    with open(os.path.join(csrc, 'grid.cu')) as f:
        binned = 'yrt_bin_pairs' in f.read()
    sigs = ({k: pairs._SIGNATURES[k] for k in (
        'yrt_pairs_scratch', 'yrt_bin_pairs', 'yrt_intersect_pairs',
        'yrt_occluded_pairs')} if binned else _PER_RAY_SIGNATURES)
    return cb.library('grid', sigs, csrc), binned


def launch(lib, binned, kernel, args, sweep=True):
    """One K8 ('intersect_pairs_raw') or K9 ('occluded_pairs') call from
    lib on args (rows, org, dirn, tnear, tfar, gs, ge), as the wrappers
    make it: with this checkout's interface the binning first (when there
    are ranges), then the sweep unless sweep is False.  Returns the
    outputs as a tuple."""
    rows, *rays, gs, ge, n_tiles, r = pairs._kernel_args(*args)
    dev = rows.device
    anyhit = kernel == 'occluded_pairs'
    out = ((torch.empty((r,), dtype=torch.bool, device=dev),) if anyhit
           else (torch.empty((r,), dtype=torch.float32, device=dev),
                 torch.empty((r,), dtype=torch.int32, device=dev)))
    fn = lib.yrt_occluded_pairs if anyhit else lib.yrt_intersect_pairs
    if not binned:
        cb.launch(fn, kernel, dev, rows, *rays, gs, ge, n_tiles, r, *out)
        return out
    scratch = None
    if gs is not None:
        scratch = torch.empty((lib.yrt_pairs_scratch(n_tiles, r),),
                              dtype=torch.int32, device=dev)
        cb.launch(lib.yrt_bin_pairs, 'bin_rays', dev, gs, ge, *rays[2:],
                  n_tiles, r, scratch,
                  *((None, None, *out) if anyhit else (*out, None)))
    if sweep:
        cb.launch(fn, kernel, dev, rows, *rays, ge, scratch, n_tiles, r,
                  *out)
    return out


def make_sets(spp):
    """{name: [(kernel, args), ...]}: the entry-cell sets and the grid
    and dense frame sets, on the card."""
    dev = torch.device('cuda')
    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    g = sc.grid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = raysets.camera_rays(sc, bs.colonnade_camera(1024, 1024),
                                       1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, *cam)
    *hemi, dg, eps = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)
    shadow = raysets.shadow_rays(sc, dg, eps, hit.valid, gen, dev)
    sets = {
        'K8 entry cells (hemisphere)': [('intersect_pairs_raw', (
            g['rows'], *hemi, *grid.entry_ranges(g, *hemi)))],
        'K9 entry cells (shadow)': [('occluded_pairs', (
            g['rows'], *shadow, *grid.entry_ranges(g, *shadow)))]}
    for binning in ('grid', 'dense'):
        calls = raysets.frame_pair_calls(
            sc, bs.colonnade_camera(1024, 1024), binning, 1024, 1024,
            spp=spp, seed=SEED)
        for k, name in (('K8', 'intersect_pairs_raw'),
                        ('K9', 'occluded_pairs')):
            mine = [(c['kernel'], c['args']) for c in calls
                    if c['kernel'] == name]
            sets[f'{k} {binning} frame ({len(mine)} calls)'] = mine
    return sets


def bound_of(calls):
    """(pair tests, bytes, bound ms) of a set: the tests its plain
    versions count, its inputs read once and outputs written once."""
    tests, moved = 0, 0
    for kernel, args in calls:
        counts = {}
        plain = (pairs.occluded_pairs_plain if kernel == 'occluded_pairs'
                 else pairs.intersect_pairs_raw_plain)
        out = plain(*args, counts=counts)
        tests += int(counts['pair'])
        moved += sum(x.numel() * x.element_size() for x in
                     (*args, *(out if isinstance(out, tuple) else (out,)))
                     if x is not None)
    return tests, moved, roofline.bound(moved,
                                        tests * roofline.WOOP_FLOPS)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--bounds', action='store_true')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pairs_turns: no CUDA device", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    libs = {'this': (pairs.lib(), True), 'other': load(other)}
    card = wide_turns.card_name()
    sets = make_sets(opts.spp)

    def run(k, calls, sweep=True):
        return [launch(*libs[k], kernel, args, sweep)
                for kernel, args in calls]

    def bounds(what, calls, outs, med):
        tests, moved, bound = bound_of(calls)
        return ({'pair_tests': tests, 'bytes': moved, 'bound_ms': bound,
                 **{f'{k}_share': bound / med[k] for k in libs}},
                f"; {tests} pair tests, {moved} bytes, bound {bound:.4f} "
                f"ms: this {bound / med['this']:.2%}, other "
                f"{bound / med['other']:.2%} of it")

    summary, _ = wide_turns.run_turns(
        sets, run, opts.rounds, card,
        lambda calls: sum(args[1].shape[0] for _, args in calls),
        also={'this_binning': lambda calls: run('this', calls, sweep=False)},
        extra=bounds if opts.bounds else None)
    wide_turns.report(
        {'this': wide_turns._sass_sizes(cb.lib_path('grid')),
         'other': wide_turns._sass_sizes(cb.lib_path('grid', other))},
        card=card, rounds=opts.rounds, spp=opts.spp, sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
