"""The dense kernels K1/K2 (csrc/dense.cu) of this checkout against another
checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.dense_turns OTHER_ROOT [--rounds N]
        [--bounds]

OTHER_ROOT is the root of another checkout of the repository whose
`csrc/dense.cu` has the entry points `yrt_intersect_dense` and
`yrt_occluded_dense` with this checkout's C interface (`ops/dense.py`
`_SIGNATURES`), or a variant of this checkout's `csrc/` copied alone
under `build/<dir>/yulio_raytracer_tpu_torch/csrc/`.  Both sources are
built, and both libraries are launched over the table's live rows
(`ops/dense.py` `live_rows`).  Cornell is committed on the card, and the
sets are made from seed 42:
- the entry sets `chip_smoke.py` holds K1/K2 on: 64^2 camera rays and the
  hemisphere rays from their hits (K1), and the shadow rays from those
  hits to its 2 lights (K2; raysets.dense_entry_rays);
- the frame sets: every K1 and every K2 call of one bounce-1 trace at the
  cornell_512 frame's pass, 512^2 at 16 samples a pixel (2^22 closest
  rays and their 2^23 shadow rays a bounce; raysets.frame_dense_calls),
  the closest calls and the any-hit calls apart.
A frame set is timed as all its calls in a row.  Each round times every
set with both libraries (CUDA events, median of 5 after a warm-up), this
checkout's first on even rounds and the other's first on odd ones
(wide_turns.run_turns).  The results must be bit-equal on every call.
One line per set: each library's median over the rounds with its min,
max and quartile spread, the ratio of the medians and in how many rounds
this checkout's kernels were the faster, the live and full row counts of
the table; with --bounds also the set's tests on the live rows by stage
(the plain versions' count, `ops/dense.py` `staged_tests`; the plain
results must equal the kernels'), bytes (inputs read once, outputs
written once), bound (the larger of the bytes at 3.35 TB/s and the
staged tests' flops at 67 TFLOP/s f32, `staged_flops`) and each
library's share of it, and the bound of a one-pass test (55 flops a
test, as `woop.cuh` `woop_test` runs it).  Then each library's machine instructions per kernel of
every source (`cuobjdump -sass`); the last line is the same as one JSON
object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import raysets, roofline, wide_turns
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import dense

SEED = 42
PLAIN = {'intersect_dense': dense.intersect_dense_plain,
         'occluded_dense': dense.occluded_dense_plain}
# the sources whose machine instructions are compared
SASS_SOURCES = ('dense', 'wide', 'binary', 'grid', 'splitleaf', 'sweep')


def launch(lib, kernel, args):
    """One launch from lib of K1 ('intersect_dense') or K2
    ('occluded_dense') on args (tris, org, dirn, tnear, tfar), over the
    table's live rows; returns its outputs as a tuple."""
    tris, *rays = args
    org, dirn, tnear, tfar = cb.ray_args(*rays)
    dev, r = org.device, org.shape[0]
    table = cb.table_arg('tris', dense._rows(tris), 16, dev)
    if kernel == 'occluded_dense':
        out = (torch.empty((r,), dtype=torch.bool, device=dev),)
        fn = lib.yrt_occluded_dense
    else:
        out = cb.empty_hit(r, dev)
        fn = lib.yrt_intersect_dense
    cb.launch(fn, kernel, dev, table, dense.live_rows(tris), org, dirn,
              tnear, tfar, r, *out)
    return out


def make_sets():
    """(cornell on the card, {name: [(kernel, args), ...]}): the entry
    sets and the frame sets."""
    dev = torch.device('cuda')
    sc = bs.cornell_box().commit(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    closest, shadow = raysets.dense_entry_rays(
        sc, bs.cornell_camera(64, 64), 64, dev, gen, SEED)
    sets = {'K1 entry (camera + hemisphere)': [('intersect_dense',
                                                (sc.tris, *closest))],
            'K2 entry (shadow)': [('occluded_dense', (sc.tris, *shadow))]}
    calls = raysets.frame_dense_calls(sc, bs.cornell_camera(512, 512), 512,
                                      512, spp=16, seed=SEED)
    for k, name in (('K1', 'intersect_dense'), ('K2', 'occluded_dense')):
        mine = [(c['kernel'], c['args']) for c in calls
                if c['kernel'] == name]
        sets[f'{k} cornell frame ({len(mine)} calls)'] = mine
    return sc, sets


def bound_of(calls, outs):
    """A set's tests on the live rows by stage (its plain versions' count;
    their results must equal outs, the kernels'), bytes of its inputs
    read once and outputs written once, and bound, staged and one-pass:
    a dict."""
    counts, moved = {}, 0
    for (kernel, args), out in zip(calls, outs):
        ref = PLAIN[kernel](*args, counts=counts)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{kernel}: the kernel and its plain "
                                 "version disagree")
        moved += sum(x.numel() * x.element_size() for x in (*args, *out))
    tests = {k: int(v) for k, v in counts.items()}
    bound_ms, bound_by = roofline.bound(moved, dense.staged_flops(tests))
    return {'pair_tests': tests['pair'], 'stage2_tests': tests['stage2'],
            'stage3_tests': tests['stage3'], 'bytes': moved,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'one_pass_bound_ms': roofline.bound(
                moved, tests['pair'] * roofline.WOOP_FLOPS)[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--bounds', action='store_true')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_turns: no CUDA device", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    # each source of both trees, one nvcc each, a library built once
    jobs = [(src, csrc) for csrc in (cb.CSRC, other) for src in SASS_SOURCES]
    unique = {cb.lib_path(*job): job for job in jobs}
    with ThreadPoolExecutor(len(unique)) as pool:
        list(pool.map(lambda job: cb.build(*job), unique.values()))
    libs = {'this': dense._lib(),
            'other': cb.library('dense', dense._SIGNATURES, other)}
    card = wide_turns.card_name()
    sc, sets = make_sets()
    live, full = dense.live_rows(sc.tris), dense._rows(sc.tris).shape[0]

    def run(k, calls):
        return [launch(libs[k], kernel, args) for kernel, args in calls]

    def extra(what, calls, outs, med):
        more = {'live_rows': live, 'table_rows': full}
        text = f"; {live} live rows of {full}"
        if opts.bounds:
            b = bound_of(calls, outs)
            more.update(b, **{f'{k}_share': b['bound_ms'] / med[k]
                              for k in med})
            text += (f"; {b['pair_tests']} tests on the live rows, "
                     f"{b['stage2_tests']} past stage 1, "
                     f"{b['stage3_tests']} to stage 3, {b['bytes']} bytes, "
                     f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}: "
                     + ', '.join(f"{k} {b['bound_ms'] / med[k]:.2%}"
                                 for k in med)
                     + f" of it; one-pass bound "
                     f"{b['one_pass_bound_ms']:.4f} ms: " + ', '.join(
                         f"{k} {b['one_pass_bound_ms'] / med[k]:.2%}"
                         for k in med)
                     + "; plain versions equal")
        return more, text

    summary, _ = wide_turns.run_turns(
        sets, run, opts.rounds, card,
        lambda calls: sum(args[1].shape[0] for _, args in calls),
        extra=extra)
    sass = {'this': {}, 'other': {}}
    for src, csrc in jobs:
        sass['this' if csrc == cb.CSRC else 'other'].update(
            wide_turns._sass_sizes(cb.lib_path(src, csrc)))
    wide_turns.report(sass, card=card, rounds=opts.rounds,
                      sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
