"""A family of this checkout's kernels against another checkout's, timed
in turns on the card.

    python -m yulio_raytracer_tpu_torch.turns FAMILY OTHER_ROOT
        [--rounds N] [--bounds] [--spp S] [--sets ...] [--sass-dir DIR]

OTHER_ROOT is the root of another checkout (or, but for `sweep`, holds a
copy of `yulio_raytracer_tpu_torch/csrc/` alone, for a variant).  Every
traversal source of both trees is built.  Both sides of a call go
through the launch function its operator runs (`launch` of its ops
module), given either tree's library; `sweep` runs each tree's own
wrappers, the other's `proto_sublane_sweep` imported under a package name
of its own.  FAMILY: wide (K3/K4), pairs (K8/K9 with their binning;
--spp), binary (K5/K6 and K7; --spp, --sets), dense (K1/K2), incoherent
(K10 and K11; --sets) or sweep (K12; --sass-dir).  Each family's
function below builds its sets (seed 42): chip_smoke.py's entry sets on
the colonnade (leaf 32), cornell or the motion field, and the kernel's
calls in one bounce-1 trace of a frame (raysets.frame_*_calls).
Each round times every set with both libraries (CUDA events, median of 5
after a warm-up), this checkout's first on even rounds and the other's on
odd ones; the results must be bit-equal on every call.  One [turns] line
per set: each library's median with its min, max and quartile spread,
their ratio and the rounds this checkout won; with --bounds (every
family but wide) the set's
tests (the plain versions' count, their results equal to the kernels'),
bytes, bound and each library's share of it.  Then the machine
instructions per kernel of both trees (`cuobjdump -sass`); the last line
is the same as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import proto_sublane_sweep as sweep
from . import raysets, roofline
from .io import builtin_scenes as bs
from .ops import binning, dense, grid, pairs, splitleaf, traverse, wide
from .ops import cuda_build as cb

SEED = 42
# the traversal sources, with the entry points each library declares
SIGNATURES = {'dense': dense._SIGNATURES, 'wide': wide._SIGNATURES,
              'binary': traverse._SIGNATURES, 'grid': pairs._SIGNATURES,
              'splitleaf': splitleaf._SIGNATURES, 'sweep': sweep._SIGNATURES}
# each call's kernel, by the wrapper name the call carries: its source,
# its ops module (kernel_args and launch), its C entry point, its outputs
# ('hit', 'occ' or 'slot': t and slot), the place of org among the
# call's arguments, and its plain version
KERNELS = {
    'intersect_dense': ('dense', dense, 'yrt_intersect_dense', 'hit', 1,
                        dense.intersect_dense_plain),
    'occluded_dense': ('dense', dense, 'yrt_occluded_dense', 'occ', 1,
                       dense.occluded_dense_plain),
    'intersect_packet4': ('wide', wide, 'yrt_intersect_wide', 'hit', 2,
                          None),
    'occluded_packet4': ('wide', wide, 'yrt_occluded_wide', 'occ', 2, None),
    'intersect_packet': ('binary', traverse, 'yrt_intersect_binary', 'hit',
                         2, traverse.intersect_binary_plain),
    'occluded_packet': ('binary', traverse, 'yrt_occluded_binary', 'occ', 2,
                        traverse.occluded_binary_plain),
    'intersect_packet_mb': ('binary', traverse, 'yrt_intersect_motion',
                            'hit', 2, traverse.intersect_motion_plain),
    'occluded_packet_mb': ('binary', traverse, 'yrt_occluded_motion', 'occ',
                           2, traverse.occluded_motion_plain),
    'intersect_pairs_raw': ('grid', pairs, 'yrt_intersect_pairs', 'slot', 1,
                            pairs.intersect_pairs_raw_plain),
    'occluded_pairs': ('grid', pairs, 'yrt_occluded_pairs', 'occ', 1,
                       pairs.occluded_pairs_plain),
    'march_raw': ('grid', grid, 'yrt_grid_march', 'slot', 1,
                  grid.march_raw_plain),
    'intersect_packet_split': ('splitleaf', splitleaf, 'yrt_intersect_split',
                               'hit', 2, splitleaf.intersect_split_plain),
}
ROW_BYTES = 64              # one slot's row of the grid
SCHEDULERS = 4              # warp schedulers of an SM, one issue a clock
TEST_FMULS = 21             # multiplies of one K12 test (csrc/sweep.cu)
# machine instruction classes, by opcode (its first word)
SASS_CLASSES = {
    'fmul/fadd': ('FMUL', 'FADD', 'FMUL32I', 'FADD32I'),
    'ffma': ('FFMA', 'FFMA32I'),
    'mufu': ('MUFU',),
    'compare': ('FSETP', 'ISETP', 'PLOP3', 'FCHK', 'FMNMX', 'IMNMX'),
    'select/move': ('FSEL', 'SEL', 'MOV', 'P2R', 'R2P', 'CS2R', 'S2R'),
    'lds': ('LDS', 'LDSM'),
    'shfl/vote': ('SHFL', 'VOTE', 'VOTEU'),
    'branch/sync': ('BRA', 'BSSY', 'BSYNC', 'CALL', 'RET', 'WARPSYNC',
                    'BAR', 'EXIT', 'YIELD', 'NOP', 'BMOV', 'BREAK'),
    'integer': ('IADD3', 'IMAD', 'LOP3', 'SHF', 'LEA', 'IABS', 'ISCADD',
                'FLO', 'POPC', 'PRMT'),
}
_CLASS_OF = {op: k for k, ops in SASS_CLASSES.items() for op in ops}


# ---------------------------------------------------------------- driver

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
    for the set's summary, printed at the end of its line."""
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
        more = extra(what, calls, outs[what], med) if extra else {}
        summary[what].update(more)
        text = ''.join([*(f"; {k} alone {med[k]:.4f} ms" for k in also), *(
            f"; {k} {v:.4g}" if isinstance(v, float) else f"; {k} {v}"
            for k, v in more.items())])
        print(f"[turns] {what} on {rays} rays, {rounds} rounds: "
              + ', '.join(f"{k} median {med[k]:.4f} ms (min "
                          f"{min(t[k]):.4f}, max {max(t[k]):.4f}, quartile "
                          f"spread {iqr[k]:.4f})" for k in libs)
              + f"; other / this {med['other'] / med['this']:.3f}; this "
              f"faster in {wins} of {rounds} rounds; bit-equal results"
              f"{text}; {card}", flush=True)
    return summary, outs


def sass_text(lib_path):
    """`cuobjdump -sass` of a built library (the CUDA toolkit's, beside
    nvcc)."""
    tool = os.path.join(os.path.dirname(cb._nvcc()), 'cuobjdump')
    return subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(text):
    """{kernel's mangled name: [(address, instruction)]} of sass_text's
    text."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and (m := re.search(r'/\*([0-9a-f]{4,})\*/\s*([^;]*)',
                                      line)):
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def report(sass, **record):
    """Print each library's machine instructions per kernel (sass:
    {'this': sizes, 'other': sizes}), then record with them as one JSON
    object, the last line."""
    for k, sizes in sass.items():
        print(f"[sass] {k}: " + ', '.join(f"{n} {v} instructions"
                                          for n, v in sizes.items()))
    print(json.dumps({**record, 'sass': sass}))


# ------------------------------------------------------- calls and sets

def libraries(csrc):
    """{source: library} of the traversal sources in csrc."""
    return {src: cb.library(src, sigs, csrc)
            for src, sigs in SIGNATURES.items()}


def _outputs(kind, org):
    """Fresh outputs of a kernel on org's rays: 'hit' (t, tri, u, v),
    'occ' or 'slot' (t, slot)."""
    r, dev = org.shape[0], org.device
    if kind == 'hit':
        return cb.empty_hit(r, dev)
    if kind == 'occ':
        return (torch.empty((r,), dtype=torch.bool, device=dev),)
    return (torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev))


def launch(libs, call):
    """One call (wrapper name, its arguments) through its ops module's
    kernel_args and launch with the library of libs {source: library};
    returns its outputs."""
    kernel, args = call
    src, mod, entry, kind, at, _ = KERNELS[kernel]
    if kernel.endswith('_mb'):
        checked = traverse.kernel_args(*args[:6], time=args[6])
    else:
        checked = mod.kernel_args(*args)
    out = _outputs(kind, args[at])
    mod.launch(libs[src], entry, *checked, *out)
    return out


def launch_pairs(libs, call, with_sweep=True):
    """A K8 or K9 call as the wrappers make it: the binning first (where
    there are ranges), then the sweep unless with_sweep is False."""
    kernel, args = call
    lib, (_, _, entry, kind, _, _) = libs['grid'], KERNELS[kernel]
    rows, *rays, gs, ge, n_tiles, r = pairs.kernel_args(*args)
    out = _outputs(kind, rays[0])
    scratch = None
    if gs is not None:
        scratch = torch.empty((lib.yrt_pairs_scratch(n_tiles, r),),
                              dtype=torch.int32, device=rows.device)
        pairs.launch(lib, 'yrt_bin_pairs', gs, ge, *rays[2:], n_tiles,
                     scratch, *((None, None, *out) if kind == 'occ'
                                else (*out, None)))
    if with_sweep:
        pairs.launch(lib, entry, rows, *rays, ge, scratch, n_tiles, *out)
    return out


def rays_of(calls):
    """The rays of a set's calls."""
    return sum(args[KERNELS[k][4]].shape[0] for k, args in calls)


def colonnade(dev):
    """The colonnade (leaf 32) on the card and chip_smoke.py's sets from
    seed 42: (scene, camera rays, their closest hits, hemisphere rays,
    shadow rays), each set (org, dirn, tnear, tfar)."""
    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = raysets.camera_rays(sc, bs.colonnade_camera(1024, 1024),
                                       1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, *cam)
    *hemi, dg, eps = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)
    shadow = raysets.shadow_rays(sc, dg, eps, hit.valid, gen, dev)
    return sc, cam, hit, hemi, shadow


def _frame_sets(calls, names, label):
    """One set a kernel of a frame's recorded calls, f'{K} {label} ({n}
    calls)' for names {K: wrapper}."""
    sets = {}
    for k, name in names.items():
        mine = [(c['kernel'], c['args']) for c in calls
                if c['kernel'] == name]
        sets[f'{k} {label} ({len(mine)} calls)'] = mine
    return sets


def nbytes(*xs):
    """Bytes of the tensors among xs and in the dicts among them."""
    xs = [*xs, *(v for x in xs if isinstance(x, dict) for v in x.values())]
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def _checked(what, out, ref):
    ref = ref if isinstance(ref, tuple) else (ref,)
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError(f"{what}: the kernel and its plain version "
                             "disagree")


def _plain(calls, outs):
    """The tests the set's plain versions count, in one dict (their
    results must equal outs, the kernels'), and the bytes of its inputs
    read once and outputs written once."""
    counts, moved = {}, 0
    for (kernel, args), out in zip(calls, outs):
        _checked(kernel, out, KERNELS[kernel][5](*args, counts=counts))
        moved += nbytes(*args, *out)
    return counts, moved


def _bound(b, moved, flops, med):
    """b with its bytes, bound and each library's share of it."""
    b['bytes'] = moved
    b['bound_ms'], b['bound_by'] = roofline.bound(moved, flops)
    b.update({f'{k}_share': b['bound_ms'] / med[k] for k in med
              if k in ('this', 'other')}, plain='equal')
    return b


# -------------------------------------------------------------- families
#
# family(opts, dev) returns a dict: sets {name: [(wrapper, args), ...]},
# and where a family has them also {key: fn(calls)} (timed alone),
# extra(name, calls, outs, medians), and run(libs, call) in place of
# `launch`.

def family_wide(opts, dev):
    sc, cam, _, hemi, shadow = colonnade(dev)
    tables = (sc.nodes4, sc.tris)
    return {'sets': {
        'K3 camera': [('intersect_packet4', (*tables, *cam))],
        'K3 hemisphere': [('intersect_packet4', (*tables, *hemi))],
        'K4 shadow': [('occluded_packet4', (*tables, *shadow))]}}


def family_pairs(opts, dev):
    sc, cam, _, hemi, shadow = colonnade(dev)
    g = sc.grid
    sets = {'K8 entry cells (hemisphere)': [('intersect_pairs_raw', (
                g['rows'], *hemi, *grid.entry_ranges(g, *hemi)))],
            'K9 entry cells (shadow)': [('occluded_pairs', (
                g['rows'], *shadow, *grid.entry_ranges(g, *shadow)))]}
    for how in ('grid', 'dense'):
        sets.update(_frame_sets(raysets.frame_pair_calls(
            sc, bs.colonnade_camera(1024, 1024), how, 1024, 1024,
            spp=opts.spp, seed=SEED), {'K8': 'intersect_pairs_raw',
                                       'K9': 'occluded_pairs'},
            f'{how} frame'))

    def bounds(what, calls, outs, med):
        counts, moved = _plain(calls, outs)
        tests = int(counts['pair'])
        return _bound({'pair_tests': tests}, moved,
                      tests * roofline.WOOP_FLOPS, med)
    this = libraries(cb.CSRC)
    return {'sets': sets, 'run': launch_pairs,
            'also': {'this_binning': lambda calls: [
                launch_pairs(this, c, with_sweep=False) for c in calls]},
            'extra': bounds if opts.bounds else None}


def family_binary(opts, dev):
    sets = {}
    if opts.sets in ('binary', 'all'):
        sc, cam, _, hemi, shadow = colonnade(dev)
        tables = (sc.nodes, sc.tris)
        sets.update({
            'K5 camera': [('intersect_packet', (*tables, *cam, None))],
            'K5 hemisphere': [('intersect_packet', (*tables, *hemi, None))],
            'K6 shadow': [('occluded_packet', (*tables, *shadow, None))],
            'K5 hemisphere from treelet roots': [('intersect_packet', (
                *tables, *raysets.from_treelet_roots(sc, *hemi)))],
            'K6 shadow from treelet roots': [('occluded_packet', (
                *tables, *raysets.from_treelet_roots(sc, *shadow)))]})
        for how in ('bvh2', 'grid', 'dense', 'treelet'):
            sets.update(_frame_sets(raysets.frame_binary_calls(
                sc, bs.colonnade_camera(1024, 1024), how, 1024, 1024,
                spp=opts.spp, seed=SEED), {'K5': 'intersect_packet',
                                           'K6': 'occluded_packet'},
                f'{how} frame'))
    if opts.sets in ('motion', 'all'):
        sc = bs.motion_field().commit(device=dev)
        tables = (sc.nodes, sc.tris_mb)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cam = bs.motion_field_camera(512, 512)
        org, dirn, tm = raysets.camera_rays(sc, cam, 512, 512, dev, SEED)
        zeros = torch.zeros(org.shape[0], device=dev)
        camera = (org, dirn, zeros, torch.full_like(zeros, float('inf')),
                  tm)
        sets.update({
            'K7 camera': [('intersect_packet_mb', (*tables, *camera))],
            'K7 scattered': [('intersect_packet_mb', (
                *tables, *raysets.scattered_rays(sc, 1 << 20, gen, dev)))]})
        sets.update(_frame_sets(raysets.frame_motion_calls(
            sc, cam, 512, 512, spp=16, seed=SEED),
            {'K7 closest': 'intersect_packet_mb',
             'K7 any-hit': 'occluded_packet_mb'}, 'motion frame'))

    def extra(what, calls, outs, med):
        share = (sum(int((args[5] > args[4]).sum()) for _, args in calls)
                 / rays_of(calls))
        if not opts.bounds:
            return {'live_share': share}
        counts, moved = _plain(calls, outs)
        pair, box = int(counts.get('pair', 0)), int(counts.get('box', 0))
        pair_flops = (roofline.MOTION_FLOPS if calls[0][0].endswith('_mb')
                      else roofline.WOOP_FLOPS)
        d = torch.cat(counts['stack']).float()
        q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device))
        return _bound({'live_share': share, 'pair_tests': pair,
                       'box_tests': box, 'stack_median': float(q[0]),
                       'stack_p99': float(q[1]), 'stack_max': float(d.max())},
                      moved, pair * pair_flops + box * roofline.SLAB_FLOPS,
                      med)
    return {'sets': sets, 'extra': extra}


def family_dense(opts, dev):
    sc = bs.cornell_box().commit(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    closest, shadow = raysets.dense_entry_rays(
        sc, bs.cornell_camera(64, 64), 64, dev, gen, SEED)
    sets = {'K1 entry (camera + hemisphere)': [('intersect_dense',
                                                (sc.tris, *closest))],
            'K2 entry (shadow)': [('occluded_dense', (sc.tris, *shadow))]}
    sets.update(_frame_sets(raysets.frame_dense_calls(
        sc, bs.cornell_camera(512, 512), 512, 512, spp=16, seed=SEED),
        {'K1': 'intersect_dense', 'K2': 'occluded_dense'}, 'cornell frame'))
    live, full = dense.live_rows(sc.tris), dense._rows(sc.tris).shape[0]

    def extra(what, calls, outs, med):
        more = {'live_rows': live, 'table_rows': full}
        if not opts.bounds:
            return more
        counts, moved = _plain(calls, outs)
        tests = {k: int(v) for k, v in counts.items()}
        b = _bound({**more, 'pair_tests': tests['pair'],
                    'stage2_tests': tests['stage2'],
                    'stage3_tests': tests['stage3']}, moved,
                   dense.staged_flops(tests), med)
        # a one-pass test (woop.cuh woop_test) on every pair
        one = roofline.bound(moved, tests['pair'] * roofline.WOOP_FLOPS)[0]
        return {**b, 'one_pass_bound_ms': one, **{
            f'{k}_one_pass_share': one / med[k] for k in med}}
    return {'sets': sets, 'extra': extra}


def family_incoherent(opts, dev):
    sc, cam, _, hemi, _ = colonnade(dev)
    march = {k: sc.grid[k] for k in ('rows', 'cell_tile_lo', 'cell_tile_hi',
                                     'grid_lo', 'grid_hi')}
    sets = {}
    if opts.sets in ('march', 'all'):
        perm = torch.argsort(grid.march_sort_key(march, *hemi), stable=True)
        sets['K10 hemisphere (call order)'] = [('march_raw', (march, *hemi))]
        sets['K10 hemisphere (sorted)'] = [
            ('march_raw', (march, *(x[perm] for x in hemi)))]
    if opts.sets in ('split', 'all'):
        perm = binning.sort_perm(*hemi, sc.bbox_lo, sc.bbox_hi)
        sets['K11 hemisphere (sorted)'] = [('intersect_packet_split', (
            sc.nodes, sc.tris, *(x[perm] for x in hemi), sc.leaf_size))]
        sets['K11 camera'] = [('intersect_packet_split', (
            sc.nodes, sc.tris, *cam, sc.leaf_size))]

    def sort_alone(calls):
        kernel, args = calls[0]
        if kernel == 'march_raw':
            return torch.argsort(grid.march_sort_key(*args), stable=True)
        return binning.sort_perm(*args[2:6], sc.bbox_lo, sc.bbox_hi)

    def bounds(what, calls, outs, med):
        counts, moved = _plain(calls, outs)
        if calls[0][0] == 'march_raw':
            # rows loaded, beside a one-ray-per-thread march's: a row a test
            b = {'pair_tests': int(counts['pair']), 'box_tests': 0,
                 'rows_gb': int(counts['rows']) * ROW_BYTES / 1e9,
                 'one_ray_rows_gb': int(counts['pair']) * ROW_BYTES / 1e9}
        else:
            # the tests K5 makes on the rays, beside this schedule's
            k5 = {}
            traverse.intersect_binary_plain(*calls[0][1][:6], counts=k5)
            b = {'pair_tests': int(k5['pair']), 'box_tests': int(k5['box']),
                 'schedule_pair_tests': int(counts['pair']),
                 'schedule_box_tests': int(counts['box'])}
        return _bound(b, moved, b['pair_tests'] * roofline.WOOP_FLOPS
                      + b['box_tests'] * roofline.SLAB_FLOPS, med)
    return {'sets': sets, 'also': {'sort': sort_alone},
            'extra': bounds if opts.bounds else None}


# ------------------------------------------------------------ K12 sweep

def other_sweep(root):
    """The `proto_sublane_sweep` module of the checkout at root, imported
    under its own package name `_other_yrt` so that its wrappers build
    and load that checkout's kernels."""
    pkg = os.path.join(root, 'yulio_raytracer_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        '_other_yrt', os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules['_other_yrt'] = module
    spec.loader.exec_module(module)
    return importlib.import_module('_other_yrt.proto_sublane_sweep')


@contextlib.contextmanager
def one_slice(module, on):
    """With on, module's wrappers sweep the whole triangle range in every
    block while the context lasts (a module without the triangle split
    always does)."""
    saved = getattr(module, 'SLICE_BLOCKS_PER_SM', None)
    if on and saved is not None:
        module.SLICE_BLOCKS_PER_SM = 0
    try:
        yield
    finally:
        if saved is not None:
            module.SLICE_BLOCKS_PER_SM = saved


def sweep_call(module, kind, switch, table, org, dirn, reps, one):
    """(t, tri) of one set's call through module's wrappers."""
    with one_slice(module, one):
        if kind == 'rows':
            return module.sweep_rows(table, org, dirn, reps)
        return module.sweep_tiles(table, org, dirn, reps, switch)


def stage_passes(tris, org, dirn, reps=1):
    """How far the tests of a sweep of rays (R, 3) over triangles
    tris (T, 16), `reps` times, get, each ray testing the triangles in
    ascending order with its running best t: {'pair': every test,
    'sign': those past |dwp| > 1e-12 and the sign test (t can be > 0),
    'window': those with 0 < t < the best t before them}."""
    n = org.shape[0]
    t_b = torch.full((n,), sweep.INF, dtype=torch.float32,
                     device=org.device)
    counts = {'pair': n * tris.shape[0] * reps, 'sign': 0, 'window': 0}
    step = max(1, sweep._CHUNK_ELEMS // max(n, 1))
    for _ in range(reps):
        for c0 in range(0, tris.shape[0], step):
            w = tris[c0:c0 + step]
            th, ok = sweep._proto_test(w, org, dirn,
                                       torch.full_like(t_b, sweep.INF))
            owp = (org[:, :1] * w[:, 2] + org[:, 1:2] * w[:, 5]
                   + org[:, 2:] * w[:, 8] + w[:, 11])
            dwp = (dirn[:, :1] * w[:, 2] + dirn[:, 1:2] * w[:, 5]
                   + dirn[:, 2:] * w[:, 8])
            sign = ((torch.abs(dwp) > 1e-12)
                    & (((owp > 0) & (dwp < 0)) | ((owp < 0) & (dwp > 0))))
            # the best t before each test: the least of the hits before
            # it in the chunk and the best before the chunk
            cand = torch.where(ok, th, sweep.INF)
            before = torch.cummin(torch.cat([t_b[:, None], cand[:, :-1]], 1),
                                  dim=1).values
            counts['sign'] += int(sign.sum())
            counts['window'] += int((sign & (th > 0) & (th < before)).sum())
            t_b = torch.minimum(t_b, cand.min(dim=1).values)
    return counts


def _kernel_name(mangled):
    """A kernel's name with its template argument, from its mangled
    name."""
    m = re.match(r'_Z(\d+)(\w+)', mangled)
    if not m:
        return mangled
    name, rest = m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):]
    t = re.match(r'IL([bi])(\d+)E', rest)
    if t:
        arg = t.group(2) if t.group(1) == 'i' else ('true' if t.group(2)
                                                     == '1' else 'false')
        name += f'<{arg}>'
    return name


def test_loops(text):
    """Each kernel's innermost loops that hold tests in `cuobjdump -sass`
    text, a test counted as the 21 multiplies of its source (FMUL: 18 in
    the dot products, t, u and v; --fmad=false fuses none, and nothing
    else multiplies): {kernel: [{'start', 'end' (addresses),
    'instructions', 'tests', 'per_test', 'classes' (instructions a test
    by class)}, ...]}, fewest instructions a test first; kernels with no
    such loop are left out."""
    loops = {}
    for mangled, ins in sass_functions(text).items():
        name = _kernel_name(mangled)
        ops = []
        for addr, txt in ins:
            words = re.sub(r'^@!?U?P\w+\s+', '', txt).split()
            ops.append((addr, words[0] if words else '', txt))
        back = []
        for addr, op, txt in ops:
            t = re.search(r'0x([0-9a-f]+)', txt)
            if op.startswith('BRA') and t and int(t.group(1), 16) <= addr:
                back.append((int(t.group(1), 16), addr))
        found = []
        for lo, hi in back:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi
                   for o in back):
                continue        # not innermost
            body = [op for addr, op, _ in ops if lo <= addr <= hi]
            tests = sum(op.split('.')[0] == 'FMUL'
                        for op in body) / TEST_FMULS
            if tests < 1:
                continue
            classes = {}
            for op in body:
                k = ('select/move' if op.startswith('IMAD.MOV') else
                     'uniform' if op.startswith('U') else
                     _CLASS_OF.get(op.split('.')[0], 'other'))
                classes[k] = classes.get(k, 0) + 1
            found.append({'start': hex(lo), 'end': hex(hi),
                          'instructions': len(body), 'tests': tests,
                          'per_test': len(body) / tests,
                          'classes': {k: v / tests for k, v in
                                      sorted(classes.items())}})
        if found:
            loops[name] = sorted(found, key=lambda lp: lp['per_test'])
    return loops


def registers(lib_path):
    """{kernel: registers} from the ptxas report in a library's build
    log."""
    regs, name = {}, None
    with open(lib_path[:-3] + '.log') as f:
        for line in f:
            m = re.search(r'Function properties for (\S+)', line)
            if m:
                name = _kernel_name(m.group(1))
            m = re.search(r'Used (\d+) registers', line)
            if m and name:
                regs[name] = int(m.group(1))
                name = None
    return regs


class ClockSampler(threading.Thread):
    """The SM clock (MHz) as nvidia-smi reads it, every 0.5 s until
    done is set: samples, and max_mhz the card's maximum."""

    def __init__(self):
        super().__init__(daemon=True)
        self.samples, self.max_mhz, self.done = [], None, threading.Event()
        self.start()

    def run(self):
        while not self.done.is_set():
            out = subprocess.run(
                ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm',
                 '--format=csv,noheader,nounits'], capture_output=True,
                text=True, check=True).stdout.splitlines()[0]
            sm, self.max_mhz = (float(x) for x in out.split(','))
            self.samples.append(sm)
            self.done.wait(0.5)


def family_sweep(opts, dev, mods):
    """mods: {'this', 'other'} the two trees' sweep modules, their
    libraries built."""
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    loops, regs = {}, {}
    for k, mod in mods.items():
        path = mod.cb.lib_path('sweep')
        text = sass_text(path)
        if opts.sass_dir:
            os.makedirs(opts.sass_dir, exist_ok=True)
            with open(os.path.join(opts.sass_dir, f'sweep_{k}.sass'),
                      'w') as f:
                f.write(text)
        loops[k], regs[k] = test_loops(text), registers(path)
    sc, cam, hit, hemi, _ = colonnade(dev)
    rows, held, b, b_hemi = raysets.sweep_sets(sc, hit, cam, hemi[:2])
    tiles = sweep.supertiles(rows)
    shape_a = {'rows': sweep.shape_a('old', 512, dev),
               'tiles': sweep.shape_a('new', 512, dev)}
    sets = {}
    for name, rays in (('b', b), ('b-hemi', b_hemi)):
        for kind, switch, table in (('rows', False, rows),
                                    ('tiles', False, tiles),
                                    ('tiles', True, tiles)):
            sets[f"{name} {kind}{' switch' if switch else ''}"] = [
                (kind, switch, table, *rays, 1, False)]
    for one, what in ((False, 'split'), (True, 'one slice')):
        for kind, switch in (('rows', False), ('tiles', False),
                             ('tiles', True)):
            sets[f"a {kind}{' switch' if switch else ''}, {what}"] = [
                (kind, switch, *shape_a[kind], 64, one)]
    print(f"[sets] the colonnade's 512 rows holding {held} of its "
          f"{int((hit.tri >= 0).sum())} camera hits", flush=True)
    clock, passes = ClockSampler(), {}

    def bounds(what, calls, outs, med):
        kind, switch, table, org, dirn, reps, _ = calls[0]
        tris = (sweep._tile_rows(table) if kind == 'tiles'
                else table.reshape(-1, 16))
        _checked(what, outs[0], sweep._sweep_plain(tris, org, dirn, reps))
        key = (table.data_ptr(), org.data_ptr(), reps)
        if key not in passes:
            passes[key] = stage_passes(tris, org, dirn, reps)
        c = passes[key]
        flops = c['pair'] * roofline.PROTO_FLOPS
        mhz = statistics.median(clock.samples)
        b = {'pair_tests': c['pair'], 'sign_tests': c['sign'],
             'window_tests': c['window'],
             'bytes': nbytes(table, org, dirn, *outs[0])}
        b.update(bound_ms=roofline.bound(b['bytes'], flops)[0],
                 unfused_ms=2 * roofline.times(0, flops)[1], sm_mhz=mhz,
                 max_sm_mhz=clock.max_mhz)
        kernel = ('sweep_rows_kernel' if kind == 'rows' else
                  f"sweep_tiles_kernel<{'true' if switch else 'false'}>")
        for k in ('this', 'other'):
            b[f'{k}_share'] = b['bound_ms'] / med[k]
            b[f'{k}_unfused_share'] = b['unfused_ms'] / med[k]
            # the sets' stages hold no wide float: the fastest loop
            loop = next((v[0] for n, v in loops[k].items()
                         if n.startswith(kernel)), None)
            if loop:
                b[f'{k}_per_test'] = loop['per_test']
                issue = b[f'{k}_issue_ms'] = (
                    c['pair'] / 32 * loop['per_test']
                    / (sm_count * SCHEDULERS * mhz * 1e6) * 1e3)
                b[f'{k}_issue_share'] = issue / med[k]
        return {**b, 'plain': 'equal'}

    def after():
        clock.done.set()
        clock.join()
        mhz = statistics.median(clock.samples)
        print(f"[clock] SM clock while the rounds ran: median {mhz:.0f} MHz "
              f"(min {min(clock.samples):.0f}, max {max(clock.samples):.0f}, "
              f"{len(clock.samples)} samples), card maximum "
              f"{clock.max_mhz:.0f} MHz", flush=True)
        for k in ('this', 'other'):
            for name, lps in loops[k].items():
                for lp in lps:
                    print(f"[loop] {k} {name} ({regs[k].get(name, '?')} "
                          f"registers): innermost test loop {lp['start']}-"
                          f"{lp['end']}, {lp['instructions']} instructions "
                          f"for {lp['tests']:g} tests, {lp['per_test']:.2f} "
                          "a test: " + ', '.join(
                              f"{c} {v:.2f}"
                              for c, v in lp['classes'].items()), flush=True)
        return {'loops': loops, 'registers': regs, 'sm_mhz': mhz,
                'max_sm_mhz': clock.max_mhz}
    return {'sets': sets, 'run': lambda mod, call: sweep_call(mod, *call),
            'rays': lambda calls: calls[0][3].shape[0],
            'extra': bounds if opts.bounds else None, 'after': after}


# --------------------------------------------------------------- command

FAMILIES = {'wide': family_wide, 'pairs': family_pairs,
            'binary': family_binary, 'dense': family_dense,
            'incoherent': family_incoherent, 'sweep': family_sweep}
# each family's flags beside OTHER_ROOT and --rounds
FLAGS = {'pairs': ('bounds', 'spp'), 'binary': ('bounds', 'spp', 'sets'),
         'dense': ('bounds',), 'incoherent': ('bounds', 'sets'),
         'sweep': ('bounds', 'sass_dir')}
SETS = {'binary': ('all', 'binary', 'motion'),
        'incoherent': ('all', 'march', 'split')}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    sub = ap.add_subparsers(dest='family', required=True)
    for name in FAMILIES:
        p = sub.add_parser(name)
        p.add_argument('other_root')
        p.add_argument('--rounds', type=int, default=9)
        flags = FLAGS.get(name, ())
        if 'bounds' in flags:
            p.add_argument('--bounds', action='store_true')
        if 'spp' in flags:
            p.add_argument('--spp', type=int, default=1)
        if 'sets' in flags:
            p.add_argument('--sets', choices=SETS[name], default='all')
        if 'sass_dir' in flags:
            p.add_argument('--sass-dir')
    return ap


def main(argv=None):
    opts = parser().parse_args(argv)
    if not torch.cuda.is_available():
        print(f"turns {opts.family}: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    root = os.path.abspath(opts.other_root)
    if opts.family == 'sweep':
        libs = {'this': sweep, 'other': other_sweep(root)}
        trees = {k: (m.cb, m.cb.CSRC) for k, m in libs.items()}
    else:
        trees = {'this': (cb, cb.CSRC), 'other': (cb, os.path.join(
            root, 'yulio_raytracer_tpu_torch', 'csrc'))}
    # each source of both trees, one nvcc each, a library built once
    paths = {(k, src): tcb.lib_path(src, csrc)
             for k, (tcb, csrc) in trees.items() for src in SIGNATURES}
    unique = {paths[k, src]: (trees[k][0], src, trees[k][1])
              for k, src in paths}
    with ThreadPoolExecutor(len(unique)) as pool:
        list(pool.map(lambda job: job[0].build(*job[1:]), unique.values()))
    if opts.family == 'sweep':
        fam = family_sweep(opts, dev, libs)
    else:
        libs = {k: libraries(csrc) for k, (_, csrc) in trees.items()}
        fam = FAMILIES[opts.family](opts, dev)
    card, run = card_name(), fam.get('run', launch)
    summary, _ = run_turns(
        fam['sets'], lambda k, calls: [run(libs[k], c) for c in calls],
        opts.rounds, card, fam.get('rays', rays_of), also=fam.get('also'),
        extra=fam.get('extra'))
    record = fam['after']() if 'after' in fam else {}
    sass = {'this': {}, 'other': {}}
    for (k, _), path in paths.items():
        sass[k].update({n: len(ins) for n, ins in
                        sass_functions(sass_text(path)).items()})
    more = {'spp': getattr(opts, 'spp', None),
            'which': getattr(opts, 'sets', None)}
    report(sass, card=card, family=opts.family, rounds=opts.rounds,
           **{k: v for k, v in more.items() if v is not None},
           sets=summary, **record)
    return 0


if __name__ == '__main__':
    sys.exit(main())
