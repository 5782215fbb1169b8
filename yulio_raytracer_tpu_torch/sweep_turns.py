"""The sweep prototype's kernels K12 (csrc/sweep.cu) of this checkout
against another checkout's, timed in turns on the card.

    python -m yulio_raytracer_tpu_torch.sweep_turns OTHER_ROOT [--rounds N]
        [--bounds] [--sass-dir DIR]

OTHER_ROOT is the root of another checkout of the repository.  Its
`proto_sublane_sweep` module is imported as it stands there, bound to
its own `csrc/` and build directory, and each set is launched through
the two trees' own wrappers `sweep_rows` and `sweep_tiles` (both forms:
the unrolled groups and the switch).  The sets are:
- shape b: the colonnade's 512 packed rows holding the most closest hits
  of its 1024^2 camera rays (seed 42) against every fourth of those rays
  (2^18), one rep; b-hemi: the same rows against every fourth of the
  hemisphere rays from those hits (raysets.sweep_sets);
- shape a: the prototype's own (`proto_sublane_sweep.shape_a`: random
  rows in [0, 1), which no ray hits; 512 rows x 1024 rays, or 512
  super-tiles x 128 rays; 64 reps), with the triangle split the wrappers
  choose and with one slice (`SLICE_BLOCKS_PER_SM` set to 0 for the
  call; a tree without the split always runs one).
Each round times every set with both trees (CUDA events, median of 5
after a warm-up), this checkout's first on even rounds and the other's
first on odd ones (wide_turns.run_turns); the results must be bit-equal
on every call.  One line per set: each tree's median over the rounds
with its min, max and quartile spread, the ratio of the medians and in
how many rounds this checkout's kernel was the faster; with --bounds
also the set's tests, how many of them pass the sign test and the t
window (`stage_passes`), the one-pass bound (48 flops a test at
67 TFLOP/s f32), the ceiling of one issue slot a multiply or add (the
flops at half that rate: --fmad=false fuses none), and each tree's
issue ceiling: the machine instructions of one test in its kernel's
innermost loop, a warp instruction per scheduler and clock at the SM
clock nvidia-smi read while the rounds ran; the plain version must
agree.  Then each kernel's innermost test loop by instruction class and
its registers (ptxas), and the machine instructions per kernel of all
six sources of both trees (`cuobjdump -sass`); the last line is the same
as one JSON object.  --sass-dir writes both trees' `sweep` SASS there.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import proto_sublane_sweep as sweep
from . import raysets, roofline, wide_turns
from .io import builtin_scenes as bs
from .ops import cuda_build as cb
from .ops import wide

SEED = 42
SCHEDULERS = 4              # warp schedulers of an SM, one issue a clock
TEST_FMULS = 21             # multiplies of one test (csrc/sweep.cu)
SASS_SOURCES = ('dense', 'wide', 'binary', 'grid', 'splitleaf', 'sweep')
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


def make_sets():
    """{name: [(kind, switch, table, org, dirn, reps, one slice)]} on the
    card, and the colonnade rows' share of its camera hits (text)."""
    dev = torch.device('cuda')
    sc = bs.colonnade().commit(device=dev, leaf_size=32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = raysets.camera_rays(sc, bs.colonnade_camera(1024, 1024),
                                       1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, *cam)
    hemi = raysets.hemisphere_rays(sc, org, dirn, hit, gen, dev)[:2]
    rows, held, b, b_hemi = raysets.sweep_sets(sc, hit, cam, hemi)
    tiles = sweep.supertiles(rows)
    a_rows = sweep.shape_a('old', 512, dev)
    a_tiles = sweep.shape_a('new', 512, dev)
    sets = {}
    for name, rays in (('b', b), ('b-hemi', b_hemi)):
        sets[f'{name} rows'] = [('rows', False, rows, *rays, 1, False)]
        sets[f'{name} tiles'] = [('tiles', False, tiles, *rays, 1, False)]
        sets[f'{name} tiles switch'] = [('tiles', True, tiles, *rays, 1,
                                         False)]
    for one, what in ((False, 'split'), (True, 'one slice')):
        sets[f'a rows, {what}'] = [('rows', False, *a_rows, 64, one)]
        sets[f'a tiles, {what}'] = [('tiles', False, *a_tiles, 64, one)]
        sets[f'a tiles switch, {what}'] = [('tiles', True, *a_tiles, 64,
                                            one)]
    return sets, (f"the colonnade's 512 rows holding {held} of its "
                  f"{int((hit.tri >= 0).sum())} camera hits")


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


def sass_text(lib_path):
    tool = os.path.join(os.path.dirname(cb._nvcc()), 'cuobjdump')
    return subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True).stdout


def test_loops(text):
    """Each kernel's innermost loops that hold tests in `cuobjdump -sass`
    text, a test counted as the 21 multiplies of its source (FMUL: 18 in
    the dot products, t, u and v; --fmad=false fuses none, and nothing
    else multiplies): {kernel: [{'start', 'end' (addresses),
    'instructions', 'tests', 'per_test', 'classes' (instructions a test
    by class)}, ...]}, fewest instructions a test first; kernels with no
    such loop are left out."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = _kernel_name(m.group(1))
            funcs[name] = []
            continue
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    loops = {}
    for name, ins in funcs.items():
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
    for line in open(lib_path[:-3] + '.log'):
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


class ClockSampler:
    """The SM clock (MHz) as nvidia-smi reads it, every 0.5 s on a thread
    until stop(); samples holds them, max_mhz the card's maximum."""

    def __init__(self):
        self.samples, self.max_mhz = [], None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm',
                 '--format=csv,noheader,nounits'], capture_output=True,
                text=True, check=True).stdout.splitlines()[0]
            sm, mx = (float(x) for x in out.split(','))
            self.samples.append(sm)
            self.max_mhz = mx
            self._stop.wait(0.5)

    def median_mhz(self):
        return statistics.median(self.samples)

    def stop(self):
        self._stop.set()
        self._thread.join()


def kernel_of(kind, switch):
    """The kernel of the sweep a set launches, by name prefix."""
    if kind == 'rows':
        return 'sweep_rows_kernel'
    return f"sweep_tiles_kernel<{'true' if switch else 'false'}>"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('other_root')
    ap.add_argument('--rounds', type=int, default=9)
    ap.add_argument('--bounds', action='store_true')
    ap.add_argument('--sass-dir')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_turns: no CUDA device", file=sys.stderr)
        return 1
    mods = {'this': sweep,
            'other': other_sweep(os.path.abspath(opts.other_root))}
    # each source of both trees, one nvcc each, each tree's library in its
    # own build directory
    jobs = [(k, src) for k in mods for src in SASS_SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: mods[job[0]].cb.build(job[1]), jobs))
    card = wide_turns.card_name()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
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
    sets, held = make_sets()
    print(f"[sets] {held}; {card}", flush=True)
    clock = ClockSampler()

    def run(k, calls):
        return [sweep_call(mods[k], *call) for call in calls]

    passes = {}

    def bounds(what, calls, outs, med):
        kind, switch, table, org, dirn, reps, _ = calls[0]
        tris = (sweep._tile_rows(table) if kind == 'tiles'
                else table.reshape(-1, 16))
        ref = sweep._sweep_plain(tris, org, dirn, reps)
        if not all(torch.equal(a, b) for a, b in zip(outs[0], ref)):
            raise AssertionError(f"{what}: the kernel and the plain sweep "
                                 "disagree")
        key = (table.data_ptr(), org.data_ptr(), reps)
        if key not in passes:
            passes[key] = stage_passes(tris, org, dirn, reps)
        c = passes[key]
        flops = c['pair'] * roofline.PROTO_FLOPS
        moved = sum(x.numel() * x.element_size()
                    for x in (table, org, dirn, *outs[0]))
        b = {'pair_tests': c['pair'], 'sign_tests': c['sign'],
             'window_tests': c['window'], 'bytes': moved,
             'bound_ms': roofline.bound(moved, flops)[0],
             'unfused_ms': 2 * roofline.times(0, flops)[1],
             'sm_mhz': clock.median_mhz(), 'max_sm_mhz': clock.max_mhz}
        text = (f"; {c['pair']} tests, {c['sign'] / c['pair']:.2%} past "
                f"the sign test, {c['window'] / c['pair']:.2%} past the t "
                f"window; bound {b['bound_ms']:.4f} ms (one pass, "
                f"operations), unfused ceiling {b['unfused_ms']:.4f} ms")
        for k in ('this', 'other'):
            b[f'{k}_share'] = b['bound_ms'] / med[k]
            # the sets' stages hold no wide float: the fastest loop
            loop = next((v[0] for n, v in loops[k].items()
                         if n.startswith(kernel_of(kind, switch))), None)
            if loop:
                b[f'{k}_per_test'] = loop['per_test']
                b[f'{k}_issue_ms'] = (c['pair'] / 32 * loop['per_test']
                                      / (sm_count * SCHEDULERS
                                         * b['sm_mhz'] * 1e6) * 1e3)
            text += (f"; {k} {b[f'{k}_share']:.2%} of the bound, "
                     f"{b['unfused_ms'] / med[k]:.2%} of the unfused "
                     "ceiling" + (f", issue ceiling {b[f'{k}_issue_ms']:.4f} "
                                  f"ms ({loop['per_test']:.2f} instructions "
                                  f"a test at {b['sm_mhz']:.0f} MHz): "
                                  f"{b[f'{k}_issue_ms'] / med[k]:.2%} of it"
                                  if loop else ''))
        return b, text + "; plain sweep equal"

    summary, _ = wide_turns.run_turns(
        sets, run, opts.rounds, card, lambda calls: calls[0][3].shape[0],
        extra=bounds if opts.bounds else None)
    clock.stop()
    print(f"[clock] SM clock while the rounds ran: median "
          f"{clock.median_mhz():.0f} MHz (min {min(clock.samples):.0f}, max "
          f"{max(clock.samples):.0f}, {len(clock.samples)} samples), card "
          f"maximum {clock.max_mhz:.0f} MHz", flush=True)
    for k in ('this', 'other'):
        for name, lp in ((n, lp) for n, lps in loops[k].items()
                         for lp in lps):
            print(f"[loop] {k} {name} ({regs[k].get(name, '?')} registers): "
                  f"innermost test loop {lp['start']}-{lp['end']}, "
                  f"{lp['instructions']} instructions for {lp['tests']:g} "
                  f"tests, {lp['per_test']:.2f} a test: " + ', '.join(
                      f"{c} {v:.2f}" for c, v in lp['classes'].items()),
                  flush=True)
    sass = {k: {} for k in mods}
    for k, src in jobs:
        sass[k].update(wide_turns._sass_sizes(mods[k].cb.lib_path(src)))
    wide_turns.report(sass, card=card, rounds=opts.rounds, sets=summary,
                      loops=loops, registers=regs,
                      sm_mhz=clock.median_mhz(), max_sm_mhz=clock.max_mhz)
    return 0


if __name__ == '__main__':
    sys.exit(main())
