"""The BVH4 kernels (csrc/wide.cu) of this checkout against another
checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.wide_turns OTHER_ROOT [--rounds N]

OTHER_ROOT is the root of another checkout of the repository whose
`csrc/wide.cu` has the entry points `yrt_intersect_wide` and
`yrt_occluded_wide` with this checkout's C interface (`ops/wide.py`
`_SIGNATURES`): those are timed, the forms the wrappers launch for a
table whose leaves fit the stack words' 8 count bits, as the colonnade's
at leaf 32 do.  Both sources are built.  The colonnade (leaf 32) is committed on the card
with the ray sets `chip_smoke.py` times K3 and K4 on, made from seed 42:
its 1024^2 camera rays, 1M hemisphere rays from their hits, and the
shadow rays from those hits to its 4 lights.  Each round times every set
with both libraries (CUDA events, median of 5 launches after a warm-up),
this checkout's first on even rounds and the other's first on odd ones.
The two libraries' results must be bit-equal.  One line per set: each
library's median over the rounds with its min, max and the distance
between its quartiles, the ratio of the medians, and in how many rounds
this checkout's kernel was the faster; then each library's machine
instructions per kernel (`cuobjdump -sass`, beside nvcc); the last line
is the same as one JSON object.  Needs a CUDA device.  Its run_turns,
card_name and report drive pairs_turns and binary_turns too.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from . import raysets
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import wide
from .ops.intersect import Hit

SEED = 42


def median_ms(fn, reps=5):
    """Median milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _quartile_spread(v):
    """The distance between the first and third quartiles of v."""
    if len(v) < 2:
        return 0.0
    q = statistics.quantiles(v, n=4)
    return q[2] - q[0]


def _sass_sizes(lib_path):
    """Machine instructions per kernel of a built library, from
    `cuobjdump -sass` (the CUDA toolkit's, beside nvcc)."""
    tool = os.path.join(os.path.dirname(cb._nvcc()), 'cuobjdump')
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, check=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.search(r'/\*[0-9a-f]{4,}\*/', line):
            sizes[name] += 1
    return sizes


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _equal(a, b):
    """Whether two lists of per-call output tuples are bit-equal."""
    return all(torch.equal(x, y) for ca, cb_ in zip(a, b)
               for x, y in zip(ca, cb_))


def run_turns(sets, run, rounds, card, rays_of, also=None, extra=None):
    """Time this checkout's kernels against another checkout's in turns
    and print one [turns] line per set; returns (summary, outputs), each
    {set name: ...}, outputs this checkout's.

    sets is {name: calls}; run(k, calls) launches a set's calls with
    library k ('this' or 'other') and returns their outputs, a list of
    tuples, which must be bit-equal between the two.  Each round times
    every set with both libraries (median_ms), this checkout's first on
    even rounds and the other's first on odd ones, then each of also's
    {key: fn(calls)} alone.  rays_of(calls) is a set's ray count;
    extra(name, calls, outputs, medians), where given, returns a dict
    for the set's summary and text for its line."""
    also = also or {}
    libs = ('this', 'other')
    outs = {}
    for what, calls in sets.items():
        outs[what] = run('this', calls)
        if not _equal(outs[what], run('other', calls)):
            raise AssertionError(f"{what}: this checkout's kernels and the "
                                 "other's disagree")
    times = {what: {k: [] for k in (*libs, *also)} for what in sets}
    for i in range(rounds):
        order = libs if i % 2 == 0 else libs[::-1]
        for what, calls in sets.items():
            for k in order:
                times[what][k].append(median_ms(lambda: run(k, calls)))
            for k, fn in also.items():
                times[what][k].append(median_ms(lambda: fn(calls)))
    summary = {}
    for what, calls in sets.items():
        t = times[what]
        med = {k: statistics.median(v) for k, v in t.items()}
        iqr = {k: _quartile_spread(t[k]) for k in libs}
        wins = sum(a < b for a, b in zip(t['this'], t['other']))
        rays = rays_of(calls)
        summary[what] = {'calls': len(calls), 'rays': rays, **{
            k: {'median_ms': med[k], 'min_ms': min(t[k]),
                'max_ms': max(t[k]), 'quartile_spread_ms': iqr[k]}
            for k in libs},
            'other_over_this': med['other'] / med['this'],
            'this_faster_rounds': wins,
            **{f'{k}_ms': med[k] for k in also}}
        text = ''.join(f"; {k} alone {med[k]:.4f} ms" for k in also)
        if extra is not None:
            more, more_text = extra(what, calls, outs[what], med)
            summary[what].update(more)
            text += more_text
        print(f"[turns] {what} on {rays} rays, {rounds} rounds: "
              + ', '.join(f"{k} median {med[k]:.4f} ms (min "
                          f"{min(t[k]):.4f}, max {max(t[k]):.4f}, quartile "
                          f"spread {iqr[k]:.4f})" for k in libs)
              + f"; other / this {med['other'] / med['this']:.3f}; this "
              f"faster in {wins} of {rounds} rounds; bit-equal results"
              f"{text}; {card}", flush=True)
    return summary, outs


def report(sass, **record):
    """Print each library's machine instructions per kernel (sass:
    {'this': sizes, 'other': sizes}), then record with them as one JSON
    object, the last line."""
    for k, sizes in sass.items():
        print(f"[sass] {k}: " + ', '.join(f"{n} {v} instructions"
                                          for n, v in sizes.items()))
    print(json.dumps({**record, 'sass': sass}))


def _launch(lib, anyhit, tables, rays):
    """One launch of K4 (anyhit) or K3 from lib, as the wrappers make it;
    returns its outputs as a tuple."""
    args = wide._kernel_args(*tables, *rays)
    r, dev = args[2].shape[0], args[2].device
    if anyhit:
        out = (torch.empty((r,), dtype=torch.bool, device=dev),)
        cb.launch(lib.yrt_occluded_wide, 'occluded_wide', dev, *args, r,
                  *out)
    else:
        out = cb.empty_hit(r, dev)
        cb.launch(lib.yrt_intersect_wide, 'intersect_wide', dev, *args, r,
                  *out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=10)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_turns: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    other = os.path.join(os.path.abspath(opts.other_root),
                         'yulio_raytracer_tpu_torch', 'csrc')
    timed = {k: wide._SIGNATURES[k]
             for k in ('yrt_intersect_wide', 'yrt_occluded_wide')}
    libs = {'this': wide._lib(), 'other': cb.library('wide', timed, other)}
    card = card_name()

    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    tables = (sc.nodes4, sc.tris)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = raysets.camera_rays(sc, bs.colonnade_camera(1024, 1024),
                                       1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = Hit(*_launch(libs['this'], False, tables, cam))
    *hemi, dg, eps = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)
    shadow = raysets.shadow_rays(sc, dg, eps, hit.valid, gen, dev)
    sets = {'K3 camera': [(False, cam)], 'K3 hemisphere': [(False, hemi)],
            'K4 shadow': [(True, shadow)]}

    def run(k, calls):
        return [_launch(libs[k], anyhit, tables, rays)
                for anyhit, rays in calls]

    summary, _ = run_turns(
        sets, run, opts.rounds, card,
        lambda calls: sum(rays[0].shape[0] for _, rays in calls))
    report({'this': _sass_sizes(cb.lib_path('wide')),
            'other': _sass_sizes(cb.lib_path('wide', other))},
           card=card, rounds=opts.rounds, sets=summary)
    return 0


if __name__ == '__main__':
    sys.exit(main())
