#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yulio_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failure raises and the exit code is nonzero):
 1. toolchain: torch / CUDA / nvcc versions, the card's name and power limit;
 2. build: the CUDA kernels from yulio_raytracer_tpu_torch/csrc, one nvcc
    per source (six), all started together;
 3. every kernel against its plain torch version on the card, at the main
    paths' shapes: the dense pair on cornell (64^2 camera rays plus
    hemisphere rays from their hits; shadow rays to its lights), the BVH4
    pair and the binary pair on the full colonnade (1024^2 camera rays, 1M
    hemisphere rays from their hits, the shadow rays to its 4 triangle
    lights; the binary pair also with each ray started at its nearest
    treelet's root, and bit-equal on every call of one bounce-1 trace
    with accel 'bvh2' and through 'treelet', raysets.frame_binary_calls),
    the pair kernels on the colonnade's grid (the
    hemisphere and shadow rays, each over its entry cell's tiles), bit-
    equal on every call of one bounce-1 trace through 'grid' and 'dense'
    (1024^2 rays, raysets.frame_pair_calls), and the grid march K10 (the
    hemisphere rays in call order and sorted as grid.intersect_march
    sorts them), the split-leaf kernel K11 (the
    sorted hemisphere rays and the camera rays), the motion kernel K7 on
    the motion field (its closest form on 512^2 camera rays with their
    times and 1M scattered rays at random times; both forms bit-equal on
    every call of one bounce-1 trace at 512^2 and 16 spp,
    raysets.frame_motion_calls), the dense kernels K1/K2 on cornell's own
    calls at the pass size (one bounce-1 trace at 512^2 and 16 spp: 2^22
    closest and 2^23 shadow rays a bounce, raysets.frame_dense_calls),
    bit-equal, with their tests and bound on the table's live rows; then
    the grid, treelet and dense paths (ops/grid.py, ops/treelets.py
    intersect_packet_binned and intersect_dense_binned,
    and their any-hit forms) against the binary
    kernels on the same hemisphere and shadow rays, and K11 unsorted and
    sorted against K5 on the hemisphere rays, timed in turns; the BVH4
    and binary pairs again on the colonnade at leaf 512 (leaves of up to
    504 triangles; 256^2 camera rays, hemisphere rays from their hits,
    their shadow rays), bit-equal; the sweep prototype's kernels K12
    (proto_sublane_sweep.py) on the colonnade's 512 packed rows holding
    the most closest hits of its camera rays against every fourth of those
    rays (2^18, shape b) and every fourth of the hemisphere rays from
    their hits (b-hemi), each bit-equal to its plain version and the two
    layouts to each other, timed there and at the script's own shapes
    and random rows (shape a: run(which, 512, 64, 8), the triangle range
    split over blocks); every form bit-equal to its plain version
    over triangle slices at 64 reps, the same rows against 1024 of those
    camera rays (some hit) and shape a's own inputs; and sponza_like
    (committed on the card and timed, leaf 32): the BVH4 and binary pairs
    on its tables and the pair kernels on its grid, over 256^2 camera
    rays, the hemisphere rays from their hits and the shadow rays to its
    6 lights, and the pair and binary kernels on every call of the
    sponza_64 golden's 'grid' render, all bit-equal, with the launch
    counters zeroed before and every one of those kernels launched; and
    sphere_glass (leaf 32, under the ambient dome): the BVH4 pair over
    256^2 camera rays, the hemisphere rays from their hits and the dome's
    shadow rays from them, each with its finite tmax (the far hit of the
    scene's bounding sphere x 1.5), bit-equal, K3 and K4 alone launched.
    The plain versions count the pair and box tests their kernels make,
    and the BVH4 and binary ones each ray's largest stack occupancy
    (printed as median, 99th percentile and max);
 4. the pinned CPU goldens rendered through render_frame on the card, one
    path each, PSNR >= 40 dB: cornell_64 and stereo_64 (the cornell box
    through a StereoCube face, depth 2) through the dense kernels,
    colonnade_64 through the BVH4 kernels, again with accel='bvh2' through
    the binary kernels and again with ray_binning 'grid', 'treelet' and
    'dense' (BVH4 on bounce 0, then the grid's or the treelets' kernels),
    motion_64 through the motion kernel's two forms, sponza_64 (the
    textured sponza_like of phase 3, depth 2, 4 spp) through the BVH4
    kernels alone and again with ray_binning 'grid', sphere_glass_64
    (depth 8, 32 spp, the ambient dome, compacted) through the BVH4
    kernels, each with its trimmed-1% PSNR beside; sphere_mirror_64 (the
    HDRI light, sphere_mirror.ecs through the port's loader, depth 3, 8
    spp) on the card against the port's CPU render, >= 40 dB; K10's entry
    point
    (grid.intersect_march on the colonnade's 1M hemisphere rays) and
    K11's (sorted on those rays, unsorted on its camera rays), whose t
    and hit mask must equal K5's.
    Every launch counter is set to 0 before each run and read after it:
    the path's kernels must have run, no other kernel (so K12, which no
    path runs, never), and no plain version on a CUDA tensor; the pair
    kernels' binning (ops/pairs.py bin_rays) ran once for each of their
    ranged calls and on no other path;
 5. timed full-size frames (cornell_512, colonnade_1024,
    colonnade_1024_bvh2, colonnade_1024_grid, colonnade_1024_treelet,
    colonnade_1024_dense, motion_field_512, sponza_like_1024 with its
    commit's seconds), with each kernel's launches per frame and peak
    memory; then the production stereo face stereo_face_1536 (the
    colonnade's BVH4 through StereoCube face 1, 1536^2, 2 spp, depth 10,
    the dome shadow cap 120) with compaction 'off' and 'auto', 1 warm-up
    and 3 frames each, with its per-bounce widths and live counts, the
    two modes' films of one seed bit-equal; and sphere_glass_512 (leaf 32,
    512^2, 32 spp, depth 8) the same way;
 6. each kernel's bound: the larger of the bytes it must move (tables,
    rays and ranges read once, results written once) over 3.35 TB/s and
    its pair and box tests (counted by the plain versions in phase 3; K12's
    from its shapes; K1/K2's by stage, as they run the Woop test) times
    their flops over 67 TFLOP/s f32, against its time in phase 3.  K11's
    tests are those K5's plain version counts on the same rays, the tests
    their closest hits need; the tests K11's schedule makes (a lane per
    box of its packet's walk, 8 a row for the rays that hit its leaf) are
    printed beside them as that schedule's waste.  Beside K10's bound, the
    rows its kernel loads (a cell's rows once a round for each warp's
    rays in it, as its plain version counts) in GB, and those one ray per
    thread would load (a 64-byte row for every test).
The last lines are a JSON summary of the kernels, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'assets', 'golden')
SEED = 42
TRI_MISMATCH_MAX = 1e-4      # ties only: equal t, another triangle
MASK_MISMATCH_MAX = 1e-4     # hit/miss and occlusion masks
T_REL_ERR_MAX = 1e-6         # where the triangle agrees
PSNR_MIN = 40.0
# the H100 SXM's published peaks: HBM3 bytes/s, and f32
# flops/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# flops of one test, counted from the sources: every multiply, add,
# subtract, negate, divide, abs and compare (selects are free)
WOOP_FLOPS = 55     # csrc/woop.cuh woop_test: six 3-term dot products
#                     (33), |dwp| test (2), 1/dwp (1), th (2), u and v (4),
#                     ng.d (5), cull (2), window tests (6); the dense
#                     kernels run it in stages, counted per stage by their
#                     plain versions (ops/dense.py staged_flops)
MOTION_FLOPS = 87   # csrc/motion.cuh motion_test: edges at time s (12),
#                     p, ng, q crosses (27), det, ng.d, u, v, th (28), tv (9),
#                     |det| test and 1/det (3), cull (2), window tests (6)
SLAB_FLOPS = 25     # csrc/bvh.cuh slab: 6 subtracts, 6 multiplies, 12
#                     min/max, 1 compare
PROTO_FLOPS = 48    # csrc/sweep.cu proto_test: six dot products (33), |dwp|
#                     and its test (2), 1/dwp (1), th (2), u and v (4),
#                     u + v and five compares (6)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_report(log):
    """Each kernel's registers and stack frame (with its spills), from the
    `-Xptxas -v` report in a kernel library's build log."""
    rows, name, frame = [], None, ''
    for line in open(log):
        m = re.search(r'Function properties for _Z(\d+)(\w+)', line)
        if m:
            name = m.group(2)[:int(m.group(1))]
        elif name and 'stack frame' in line:
            frame = line.strip()
        elif name and 'registers' in line:
            regs = re.search(r'Used (\d+) registers', line).group(1)
            rows.append(f"{name} {regs} registers, {frame}")
            name = None
    return rows


def cuda_ms(fn, reps=5, warm=True):
    """Median milliseconds of fn() over reps runs (CUDA events), after
    one warm-up run unless warm is False."""
    if warm:
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


def nbytes(*xs):
    """Bytes of the tensors among xs, and of the tensors of dicts among
    them."""
    n = 0
    for x in xs:
        if isinstance(x, dict):
            n += nbytes(*x.values())
        elif isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def psnr(img, ref):
    mse = float(((img - ref) ** 2).mean())
    return 10 * np.log10(max(float(img.max()), 1e-9) ** 2 / max(mse, 1e-20))


def trimmed_psnr(img, ref, keep=0.99):
    """PSNR over the 99% of values closest to the reference: a few
    chaotic specular paths apart from a fault across the image."""
    err = np.sort(((img - ref) ** 2).ravel())[:int(img.size * keep)]
    return 10 * np.log10(max(float(img.max()), 1e-9) ** 2
                         / max(float(err.mean()), 1e-20))


def compare(name, kernel, plain, args, counts=None, labels=('kernel',
                                                              'plain'),
            other_tie_rule=False, exact=False):
    """Hold a kernel against its plain version; returns a result dict with
    the bytes the kernel must move (tensor arguments read once, results
    written once).  counts, a dict, is handed to the plain version's first
    call to gather its tests.  With other_tie_rule (two traversals that
    order equal-t triangles differently), a triangle that differs at a
    bit-equal t is a tie: reported, not held to the bound.  With exact,
    every output must be bit-equal."""
    from yulio_raytracer_tpu_torch.ops.intersect import Hit
    k = kernel(*args)
    p = plain(*args) if counts is None else plain(*args, counts=counts)
    torch.cuda.synchronize()
    out = k if isinstance(k, tuple) else (k,)
    moved = nbytes(*args) + nbytes(*out)
    if exact and not all(torch.equal(a, b) for a, b in zip(
            out, p if isinstance(p, tuple) else (p,))):
        raise AssertionError(f"{name}: the kernel's outputs are not "
                             f"bit-equal to its {labels[1]} version's")
    if isinstance(k, tuple) and len(k) == 2:        # raw (t, slot)
        k, p = (Hit(*k, None, None), Hit(*p, None, None))
    if isinstance(k, torch.Tensor):
        mism = float((k != p).float().mean())
        err = float((k.float() - p.float()).abs().max()) if k.numel() else 0.0
        line = f"occlusion mismatch {mism:.3g}"
        ok = mism <= MASK_MISMATCH_MAX
    else:
        hk, hp = k.tri >= 0, p.tri >= 0
        mask_mism = float((hk != hp).float().mean())
        differ = k.tri != p.tri
        ties = differ & (k.t == p.t) if other_tie_rule else differ & False
        tri_mism = float((differ & ~ties).float().mean())
        same = (k.tri == p.tri) & hk
        dt = (k.t[same] - p.t[same]).abs()
        err = float(dt.max()) if dt.numel() else 0.0
        rel = float((dt / p.t[same].abs().clamp(min=1e-30)).max()) \
            if dt.numel() else 0.0
        line = (f"hit-mask mismatch {mask_mism:.3g}, tri mismatch "
                f"{tri_mism:.3g}, max rel t err {rel:.3g}")
        if other_tie_rule:
            line += (f", ties at a bit-equal t resolved otherwise "
                     f"{float(ties.float().mean()):.3g}")
        ok = (mask_mism <= MASK_MISMATCH_MAX and tri_mism <= TRI_MISMATCH_MAX
              and rel <= T_REL_ERR_MAX)
    ms = cuda_ms(lambda: kernel(*args))
    # the plain versions are slow loops of torch ops and no yardstick of
    # speed: one run, warmed by the one above
    plain_ms = cuda_ms(lambda: plain(*args), reps=1, warm=False)
    r = next(a.shape[0] for a in args if isinstance(a, torch.Tensor)
             and a.dim() == 2 and a.shape[1] == 3)
    phase('kernels', f"{name} on {r} rays: {line}; {labels[0]} {ms:.3f} ms, "
          f"{labels[1]} {plain_ms:.3f} ms")
    if not ok:
        raise AssertionError(f"{name} disagrees with its {labels[1]} "
                             f"version: {line}")
    return {'rays': r, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bytes': moved}


def stack_depth(what, counts):
    """The plain versions' largest stack occupancy per ray on the sets of
    one table (median, 99th percentile, max), from each set's counts."""
    depth = []
    for name, cs in counts:
        d = torch.cat([x for c in cs for x in c['stack']]).float()
        q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device))
        depth.append(f"{name} median {float(q[0]):.0f}, 99th percentile "
                     f"{float(q[1]):.0f}, max {float(d.max()):.0f}")
    phase('kernels', f"largest stack occupancy per ray of the plain {what} "
          "versions, in entries: " + '; '.join(depth))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from yulio_raytracer_tpu_torch.film import accum
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    from yulio_raytracer_tpu_torch.io import ecs
    from yulio_raytracer_tpu_torch.ops import (binning, cuda_build, dense,
                                               grid, pairs, splitleaf,
                                               traverse, treelets, wide)
    from yulio_raytracer_tpu_torch import proto_sublane_sweep as sweep
    from yulio_raytracer_tpu_torch import renderer
    from yulio_raytracer_tpu_torch.profile_frame import (
        SPHERE_MIRROR, STEREO_PARAMS, sphere_mirror_camera,
        stereo_face_camera)
    from yulio_raytracer_tpu_torch.raysets import (
        camera_rays, dense_entry_rays, frame_binary_calls,
        frame_dense_calls, frame_motion_calls, frame_pair_calls,
        from_treelet_roots, hemisphere_rays, scattered_rays, shadow_rays,
        sweep_sets)

    dev = torch.device('cuda')
    card = smi_line()
    nvcc = subprocess.run([cuda_build._nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    phase('toolchain', f"python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}; card: {card}")

    t0 = time.perf_counter()
    names = ('dense', 'wide', 'binary', 'grid', 'splitleaf', 'sweep')
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc per source
        libs = list(pool.map(cuda_build.build, names))
    for name, lib in zip(names, libs):
        phase('build', f"{name}.cu: "
              f"{'; '.join(ptxas_report(lib[:-3] + '.log'))}")
    phase('build', f"kernels built in {time.perf_counter() - t0:.2f} s")

    # every kernel: (wrapper, plain version, source, TPU kernel it replaces,
    # flops of its pair test: stage 1's for the dense kernels, whose later
    # stages are counted apart)
    kernels = (
        (dense.intersect_dense, dense.intersect_dense_plain, 'dense.cu',
         'yulio_raytracer_tpu/ops/pallas_dense.py:94', dense.PLANE_FLOPS),
        (dense.occluded_dense, dense.occluded_dense_plain, 'dense.cu',
         'yulio_raytracer_tpu/ops/pallas_dense.py:167', dense.PLANE_FLOPS),
        (wide.intersect_packet4, wide.intersect_wide_plain, 'wide.cu',
         'yulio_raytracer_tpu/ops/pallas_wide.py:507', WOOP_FLOPS),
        (wide.occluded_packet4, wide.occluded_wide_plain, 'wide.cu',
         'yulio_raytracer_tpu/ops/pallas_wide.py:676', WOOP_FLOPS),
        (traverse.intersect_packet, traverse.intersect_binary_plain,
         'binary.cu', 'yulio_raytracer_tpu/ops/pallas_traverse.py:514',
         WOOP_FLOPS),
        (traverse.occluded_packet, traverse.occluded_binary_plain,
         'binary.cu', 'yulio_raytracer_tpu/ops/pallas_traverse.py:820',
         WOOP_FLOPS),
        (traverse.intersect_packet_mb, traverse.intersect_motion_plain,
         'binary.cu', 'yulio_raytracer_tpu/ops/pallas_traverse.py:1570',
         MOTION_FLOPS),
        (traverse.occluded_packet_mb, traverse.occluded_motion_plain,
         'binary.cu', 'yulio_raytracer_tpu/ops/pallas_traverse.py:1596',
         MOTION_FLOPS),
        (pairs.intersect_pairs_raw, pairs.intersect_pairs_raw_plain,
         'grid.cu', 'yulio_raytracer_tpu/ops/pallas_pairs.py:248',
         WOOP_FLOPS),
        (pairs.occluded_pairs, pairs.occluded_pairs_plain, 'grid.cu',
         'yulio_raytracer_tpu/ops/pallas_pairs.py:320', WOOP_FLOPS),
        (grid.march_raw, grid.march_raw_plain, 'grid.cu',
         'yulio_raytracer_tpu/ops/grid.py:513', WOOP_FLOPS),
        (splitleaf.intersect_packet_split, splitleaf.intersect_split_plain,
         'splitleaf.cu', 'yulio_raytracer_tpu/ops/pallas_splitleaf.py:349',
         WOOP_FLOPS),
        (sweep.sweep_rows, sweep.sweep_rows_plain, 'sweep.cu',
         'scripts/proto_sublane_sweep.py:36', PROTO_FLOPS),
        (sweep.sweep_tiles, sweep.sweep_tiles_plain, 'sweep.cu',
         'scripts/proto_sublane_sweep.py:99', PROTO_FLOPS),
    )
    counters = [k[0] for k in kernels]
    plains = [k[1] for k in kernels]

    def zero_counters():
        for f in (*counters, pairs.bin_rays):
            f.launches = 0
        for f in plains:
            f.cuda_calls = 0

    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def record(f, res, tests, schedule):
        """Add one compared set of kernel f: res from compare(), tests
        and schedule {'pair': n, 'box': n} (ints or device tensors; the
        dense kernels' tests also 'stage2' and 'stage3' n)."""
        acc = results.setdefault(f.__name__, {
            'rays': 0, 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
            'bytes': 0, 'pair': 0, 'box': 0, 'stage2': 0, 'stage3': 0,
            'rows': 0, 'schedule_pair': 0, 'schedule_box': 0})
        for key in ('rays', 'ms', 'plain_ms', 'bytes'):
            acc[key] += res[key]
        acc['max_abs_err'] = max(acc['max_abs_err'], res['max_abs_err'])
        for key in ('stage2', 'stage3', 'rows'):
            acc[key] += int(tests.get(key, 0))
        for key in ('pair', 'box'):
            acc[key] += int(tests.get(key, 0))
            acc['schedule_' + key] += int(schedule.get(key, 0))

    def check(f, name, args, tests=None, schedule=False, exact=False):
        """compare() kernel f against its plain version and record it;
        returns the tests the plain version counted.  `tests` gives the
        tests the function needs where that count is not it: K12's follow
        from the shapes; with schedule (K11) the plain version's count,
        the tests of the kernel's schedule, is kept beside them."""
        counted = {} if tests is None or schedule else None
        record(f, compare(name, f, plains[counters.index(f)], args,
                          counted, exact=exact), tests or counted,
               counted if schedule else {})
        return counted

    t0 = time.perf_counter()
    cornell = bs.cornell_box().commit(device=dev)
    live, table_rows = (dense.live_rows(cornell.tris),
                        cornell.tris.reshape(-1, 16).shape[0])
    phase('kernels', f"cornell: {live} live triangle rows (up to the last "
          f"non-zero row) of the packed table's {table_rows}: the dense "
          f"kernels test those, K1 every one, K2 up to each ray's first hit, "
          f"in stages (u, v only past the plane test), as the plain versions "
          f"count")
    closest, cshadow = dense_entry_rays(cornell, bs.cornell_camera(64, 64),
                                        64, dev, gen, SEED)
    check(dense.intersect_dense, 'intersect_dense (cornell)',
          (cornell.tris, *closest))
    check(dense.occluded_dense, 'occluded_dense (cornell)',
          (cornell.tris, *cshadow))

    t1 = time.perf_counter()
    colonnade = bs.colonnade().commit(device=dev, leaf_size=32)
    t2 = time.perf_counter()
    colonnade2 = bs.colonnade().commit(device=dev, leaf_size=32,
                                       accel='bvh2')
    phase('kernels', f"colonnade: {colonnade.num_triangles} triangles, "
          f"{colonnade.nodes4.shape[0]} BVH4 nodes, leaf 32, with its grid, "
          f"committed in {t2 - t1:.2f} s; with accel='bvh2': "
          f"{colonnade2.nodes.shape[0]} binary nodes, committed in "
          f"{time.perf_counter() - t2:.2f} s")
    if not torch.equal(colonnade.tris, colonnade2.tris):
        raise AssertionError("the bvh2 and bvh4 commits differ in their "
                             "triangle rows")
    g = colonnade.grid
    per_cell = (g['cell_tile_hi'] - g['cell_tile_lo']).float()
    phase('kernels', f"colonnade grid: {per_cell.numel()} cells, "
          f"{g['rows'].shape[0] // pairs.TL} tiles of {pairs.TL} slots "
          f"({nbytes(g['rows']) / 1e6:.2f} MB of rows), tiles per cell mean "
          f"{float(per_cell.mean()):.2f}, max {float(per_cell.max()):.0f}, "
          f"{int((per_cell > 0).sum())} cells non-empty")
    tables = (colonnade.nodes4, colonnade.tris)
    tables2 = (colonnade2.nodes, colonnade2.tris)
    org, dirn, _ = camera_rays(colonnade, bs.colonnade_camera(1024, 1024),
                               1024, 1024, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    cam_rays = (org, dirn, zeros, inf)
    hit = wide.intersect_packet4(*tables, *cam_rays)
    ho, hd, htn, htf, dg, eps = hemisphere_rays(colonnade, org, dirn, hit,
                                                gen, dev)
    hemi = (ho, hd, htn, htf)
    shadow = shadow_rays(colonnade, dg, eps, hit.valid, gen, dev)
    k5_tests = {}     # the tests the closest hits need, per ray set
    k3_counts = []
    for what, rays in (('camera', cam_rays), ('hemisphere', hemi)):
        k3_counts.append(check(wide.intersect_packet4,
                               f'intersect_packet4 (colonnade {what})',
                               (*tables, *rays)))
        k5_tests[what] = check(traverse.intersect_packet,
                               f'intersect_packet (colonnade bvh2 {what})',
                               (*tables2, *rays))
    k4_counts = check(wide.occluded_packet4,
                      'occluded_packet4 (colonnade shadow)', (*tables, *shadow))
    k6_counts = check(traverse.occluded_packet,
                      'occluded_packet (colonnade bvh2 shadow)',
                      (*tables2, *shadow))
    stack_depth(f"BVH4 (the kernels keep STACK={wide.STACK} entries a "
                "thread in local memory and take the nearest hit child "
                "without a push)", (
                    ('intersect_packet4 (camera + hemisphere)', k3_counts),
                    ('occluded_packet4 (shadow)', [k4_counts])))
    # the grid's kernels: each ray over its entry cell's tiles, and the
    # whole march (the tables it reads)
    check(pairs.intersect_pairs_raw,
          'intersect_pairs_raw (colonnade grid, hemisphere, entry cells)',
          (g['rows'], *hemi, *grid.entry_ranges(g, *hemi)))
    check(pairs.occluded_pairs,
          'occluded_pairs (colonnade grid, shadow, entry cells)',
          (g['rows'], *shadow, *grid.entry_ranges(g, *shadow)))
    # K8/K9 on every call of one bounce-1 trace through the grid's and the
    # treelets' rounds (a pass of 2^20 rays), bit-equal
    for how in ('grid', 'dense'):
        calls = frame_pair_calls(colonnade, bs.colonnade_camera(1024, 1024),
                                 how, 1024, 1024, seed=SEED)
        for n, c in enumerate(calls):
            f = getattr(pairs, c['kernel'])
            check(f, f"{c['kernel']} (colonnade {how} frame, call {n + 1} "
                  f"of {len(calls)})", c['args'], exact=True)
        del calls
    march_tables = {k: g[k] for k in ('rows', 'cell_tile_lo', 'cell_tile_hi',
                                      'grid_lo', 'grid_hi')}
    march_perm = torch.argsort(grid.march_sort_key(march_tables, *hemi),
                               stable=True)
    check(grid.march_raw, 'march_raw (colonnade grid, hemisphere)',
          (march_tables, *hemi), exact=True)
    check(grid.march_raw, 'march_raw (colonnade grid, hemisphere, sorted)',
          (march_tables, *(x[march_perm] for x in hemi)), exact=True)
    # the grid path end to end (K8/K9 rounds, K5/K6 fallback) against
    # the binary kernels alone
    compare('intersect_grid vs intersect_packet (colonnade hemisphere)',
            lambda *r: grid.intersect_grid(g, colonnade.nodes,
                                           colonnade.tris, *r),
            lambda *r: traverse.intersect_packet(*tables2, *r), hemi,
            labels=('grid path', 'K5'), other_tie_rule=True)
    compare('occluded_grid vs occluded_packet (colonnade shadow)',
            lambda *r: grid.occluded_grid(g, colonnade.nodes,
                                          colonnade.tris, *r),
            lambda *r: traverse.occluded_packet(*tables2, *r), shadow,
            labels=('grid path', 'K6'), other_tie_rule=True)

    # the treelet binnings' kernels: K5/K6 with each ray started at the
    # root of its nearest treelet (the first round's choice)
    tl = colonnade.treelets
    if not torch.equal(colonnade.nodes, colonnade2.nodes):
        raise AssertionError("the bvh2 and bvh4 commits differ in their "
                             "binary rows")
    span = (tl['treelet_tile_hi'] - tl['treelet_tile_lo']).float()
    phase('kernels', f"colonnade treelets: {tl['treelet_roots'].numel()}, "
          f"tiles of {pairs.TL} slots per treelet mean "
          f"{float(span.mean()):.2f}, max {float(span.max()):.0f}")

    k5_rooted = check(traverse.intersect_packet, 'intersect_packet (colonnade '
                      'bvh2 hemisphere, from round-1 treelet roots)',
                      (*tables2, *from_treelet_roots(colonnade, *hemi)))
    k6_rooted = check(traverse.occluded_packet, 'occluded_packet (colonnade '
                      'bvh2 shadow, from round-1 treelet roots)',
                      (*tables2, *from_treelet_roots(colonnade, *shadow)))
    stack_depth(f"binary (the kernels keep STACK={traverse.STACK} entries a "
                "thread in local memory and take the child that would pop "
                "next without a push)", (
                    ('intersect_packet (camera + hemisphere)',
                     list(k5_tests.values())),
                    ('occluded_packet (shadow)', [k6_counts]),
                    ('intersect_packet (hemisphere from treelet roots)',
                     [k5_rooted]),
                    ('occluded_packet (shadow from treelet roots)',
                     [k6_rooted])))
    # K5/K6 on every call of one bounce-1 trace (a pass of 2^20 rays) with
    # accel 'bvh2' (both bounces) and through the 'treelet' rounds (two
    # from treelet roots, then the fallback), bit-equal
    for how in ('bvh2', 'treelet'):
        calls = frame_binary_calls(colonnade, bs.colonnade_camera(1024, 1024),
                                   how, 1024, 1024, seed=SEED)
        for n, c in enumerate(calls):
            f = getattr(traverse, c['kernel'])
            rooted = ', from roots' if c['args'][6] is not None else ''
            check(f, f"{c['kernel']} (colonnade {how} frame, call {n + 1} "
                  f"of {len(calls)}{rooted})", c['args'], exact=True)
        del calls
    # K11 on the sorted bounce-1 rays and on the camera rays
    # (scripts/bench_incoherent.py's 'split' runs), max_leaf the leaf size;
    # its closest hits need the tests K5 made on the same rays (a per-ray
    # walk's count does not depend on the order of the rays)
    lo, hi, leaf = colonnade.bbox_lo, colonnade.bbox_hi, colonnade.leaf_size
    hemi_sorted = tuple(x[binning.sort_perm(*hemi, lo, hi)] for x in hemi)
    check(splitleaf.intersect_packet_split, 'intersect_packet_split '
          '(colonnade hemisphere, sorted)', (*tables2, *hemi_sorted, leaf),
          k5_tests['hemisphere'], schedule=True)
    check(splitleaf.intersect_packet_split, 'intersect_packet_split '
          '(colonnade camera)', (*tables2, *cam_rays, leaf),
          k5_tests['camera'], schedule=True)
    # the treelet and dense paths end to end (rounds, then the fallback)
    # against the binary kernels alone
    binned = {
        'treelet': (lambda *r: treelets.intersect_packet_binned(
            colonnade.nodes, colonnade.tris, tl['treelet_roots'],
            tl['treelet_boxes'], *r),
            lambda *r: treelets.occluded_packet_binned(
            colonnade.nodes, colonnade.tris, tl['treelet_roots'],
            tl['treelet_boxes'], *r)),
        'dense': (lambda *r: treelets.intersect_dense_binned(
            colonnade.nodes, colonnade.tris, tl['planes_rows'],
            tl['treelet_boxes'], tl['treelet_tile_lo'], tl['treelet_tile_hi'],
            *r),
            lambda *r: treelets.occluded_dense_binned(
            colonnade.nodes, colonnade.tris, tl['planes_rows'],
            tl['treelet_boxes'], tl['treelet_tile_lo'], tl['treelet_tile_hi'],
            *r)),
    }
    for how, (closest, anyhit) in binned.items():
        compare(f'intersect {how} path vs intersect_packet (colonnade '
                'hemisphere)', closest,
                lambda *r: traverse.intersect_packet(*tables2, *r), hemi,
                labels=(f'{how} path', 'K5'), other_tie_rule=True)
        compare(f'occluded {how} path vs occluded_packet (colonnade shadow)',
                anyhit, lambda *r: traverse.occluded_packet(*tables2, *r),
                shadow, labels=(f'{how} path', 'K6'), other_tie_rule=True)
    # does sorting pay?  K11 unsorted and sorted against K5 on the same
    # 1M hemisphere rays, then all of them timed in turns
    split_runs = {
        'K11': lambda *r: splitleaf.intersect_packet_split(*tables2, *r,
                                                           leaf),
        'K11 sorted': lambda *r: splitleaf.intersect_packet_split_sorted(
            *tables2, *r, lo, hi, leaf)}
    for what, fn in split_runs.items():
        compare(f'{what} vs intersect_packet (colonnade hemisphere)', fn,
                lambda *r: traverse.intersect_packet(*tables2, *r), hemi,
                labels=(what, 'K5'), other_tie_rule=True)
    runs = {
        'K5': lambda: traverse.intersect_packet(*tables2, *hemi),
        'K5 sorted': lambda: binning.sorted_call(
            lambda *r: traverse.intersect_packet(*tables2, *r), *hemi, lo,
            hi),
        'K11': lambda: split_runs['K11'](*hemi),
        'K11 sorted': lambda: split_runs['K11 sorted'](*hemi),
        'sort alone': lambda: binning.sort_perm(*hemi, lo, hi)}
    turns = {k: [] for k in runs}
    for k in [*runs, *reversed(runs)]:
        turns[k].append(cuda_ms(runs[k], reps=3))
    phase('kernels', "colonnade 1M hemisphere rays in turns (median of 3, "
          "each way), ms: " + ', '.join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in turns.items())
          + f" on {card}")

    # K12, the sweep prototype.  Shape b: the colonnade's 512 packed rows
    # (4,096 triangles) that hold the most closest hits of its camera
    # rays, in table order, against every fourth of those rays (2^18), one
    # rep, both layouts on the same triangles; b-hemi: those rows against
    # every fourth of the hemisphere rays from those hits
    rows, held, b_rays, hemi_rays = sweep_sets(colonnade, hit, cam_rays,
                                               hemi)
    tiles = sweep.supertiles(rows)
    b_pairs = b_rays[0].shape[0] * rows.shape[0] * 8
    phase('kernels', f"K12's rows: the colonnade's 512 packed rows holding "
          f"the most closest hits of its camera rays (their {held} of "
          f"{int((hit.tri >= 0).sum())})")
    k12_ms = {}
    for name, rays in (('b', b_rays), ('b-hemi', hemi_rays)):
        args = (*rays, 1)
        ms = {}
        for f, table, more, key in (
                (sweep.sweep_rows, rows, (), 'old'),
                (sweep.sweep_tiles, tiles, (False,), 'new')):
            before = results.get(f.__name__, {}).get('ms', 0.0)
            check(f, f'{f.__name__} (colonnade, shape {name})',
                  (table, *args, *more), {'pair': b_pairs}, exact=True)
            ms[key] = results[f.__name__]['ms'] - before
        old = sweep.sweep_rows(rows, *args)
        if not all(torch.equal(x, y) for sw in (False, True)
                   for x, y in zip(old, sweep.sweep_tiles(tiles, *args,
                                                           sw))):
            raise AssertionError(f"the sweep layouts disagree on the same "
                                 f"triangles (shape {name})")
        ms['newsw'] = cuda_ms(lambda: sweep.sweep_tiles(tiles, *args, True))
        k12_ms[name] = ms
        b_bound = b_pairs * PROTO_FLOPS / PEAK_FLOPS * 1e3
        phase('kernels', f"K12 at shape {name} ({rays[0].shape[0]} rays x "
              f"4,096 triangles, reps 1, "
              f"{float((old[1] >= 0).float().mean()):.1%} of the rays hit; "
              f"median of 5): " + ', '.join(
                  f"{k} {v:.4f} ms, {b_pairs / v / 1e6:.2f} Gpairs/s, "
                  f"{b_bound / v:.2%} of the bound" for k, v in ms.items())
              + f"; new / old {ms['old'] / ms['new']:.3f}, newsw / old "
              f"{ms['old'] / ms['newsw']:.3f} (in Gpairs/s); the layouts "
              f"bit-equal with and without the switch; {card}")
    # the triangle split over blocks and its merge by key, held exactly:
    # the same rows against every 256th of shape b's rays (1024, some of
    # which hit) and shape a's own inputs (the script's random rows, which
    # no ray hits), at the script's 64 reps, every form on each
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block_rays = sweep._lib().yrt_sweep_block_rays
    few = tuple(x[::256].contiguous() for x in b_rays)
    few_hits = int((sweep.sweep_rows_plain(rows, *few)[1] >= 0).sum())
    if not few_hits:
        raise AssertionError("none of the 1024 rays of K12's split set hits")
    a_old, a_new = (sweep.shape_a(w, 512, dev) for w in ('old', 'new'))
    zero_counters()
    split = []
    for name, kind, table, rays in (('colonnade', 'rows', rows, few),
                                    ('colonnade', 'tiles', tiles, few),
                                    ('shape a', 'rows', a_old[0], a_old[1:]),
                                    ('shape a', 'tiles', a_new[0],
                                     a_new[1:])):
        units = table.shape[0] // (8 if kind == 'tiles' else 1)
        n = sweep.slices(block_rays(int(kind == 'tiles')), rays[0].shape[0],
                         units, sweep.MIN_SLICE[kind], sms)
        if n < 2:
            raise AssertionError(f"K12's {name} set does not split the "
                                 f"triangle range ({kind})")
        n_pairs = rays[0].shape[0] * table.shape[0] * 8 * 64
        for more in ((),) if kind == 'rows' else ((False,), (True,)):
            f = sweep.sweep_rows if kind == 'rows' else sweep.sweep_tiles
            check(f, f"{f.__name__}{' switch' if more == (True,) else ''} "
                  f"({name}, {rays[0].shape[0]} rays, reps 64, {n} triangle "
                  f"slices)", (table, *rays, 64, *more), {'pair': n_pairs},
                  exact=True)
        split.append(f"{name} {kind} {n}")
    old = sweep.sweep_rows(rows, *few, 64)
    if not all(torch.equal(x, y) for sw in (False, True)
               for x, y in zip(old, sweep.sweep_tiles(tiles, *few, 64, sw))):
        raise AssertionError("the sweep layouts disagree on the same "
                             "triangles (split set)")
    phase('kernels', f"K12 over triangle slices bit-equal to the plain "
          f"versions, every form, and the layouts to each other: "
          f"{few_hits} of the colonnade set's 1024 rays hit; slices "
          f"{', '.join(split)}; launches sweep_rows "
          f"{sweep.sweep_rows.launches}, sweep_tiles "
          f"{sweep.sweep_tiles.launches}")
    if not (sweep.sweep_rows.launches and sweep.sweep_tiles.launches):
        raise AssertionError("the split sets did not launch K12")
    # shape a: the script's own shapes, defaults and random rows (which no
    # ray hits), the triangle range split over blocks by the wrappers
    a_runs = {w: sweep.run(w, 512, 64, 8) for w in ('old', 'new', 'newsw')}
    a_bound = 512 * 8 * 1024 * 64 * PROTO_FLOPS / PEAK_FLOPS * 1e3
    phase('kernels', "K12 at shape a (the script's: 512 rows x 1024 rays, or "
          "512 super-tiles x 128 rays, reps 64; median of 8): " + ', '.join(
              f"{w} {gp:.2f} Gpairs/s ({ms:.3f} ms, {a_bound / ms:.2%} of "
              f"the bound)" for w, (gp, ms) in a_runs.items())
          + f"; new / old {a_runs['new'][0] / a_runs['old'][0]:.3f}, newsw / "
          f"old {a_runs['newsw'][0] / a_runs['old'][0]:.3f}; {card}")
    k12_extra = {
        'sweep_rows': {'gpairs_per_s': b_pairs / k12_ms['b']['old'] / 1e6,
                       'shape_b_ms': k12_ms['b']['old'],
                       'shape_b_hemi_ms': k12_ms['b-hemi']['old'],
                       'shape_a_ms': a_runs['old'][1],
                       'shape_a_gpairs_per_s': a_runs['old'][0]},
        'sweep_tiles': {'gpairs_per_s': b_pairs / k12_ms['b']['new'] / 1e6,
                        'shape_b_ms': k12_ms['b']['new'],
                        'shape_b_hemi_ms': k12_ms['b-hemi']['new'],
                        'switch_ms': k12_ms['b']['newsw'],
                        'hemi_switch_ms': k12_ms['b-hemi']['newsw'],
                        'shape_a_ms': a_runs['new'][1],
                        'shape_a_gpairs_per_s': a_runs['new'][0],
                        'shape_a_switch_ms': a_runs['newsw'][1]}}

    # BVH4 with leaves of 128 triangles and more (which go on the stack by
    # their slot): the colonnade at leaf 512, on rays of its own
    t1 = time.perf_counter()
    big = bs.colonnade().commit(device=dev, leaf_size=512)
    tags = big.nodes4.reshape(-1, 4, 8)[:, :, 7]
    phase('kernels', f"colonnade at leaf 512: accel {big.accel}, "
          f"{big.nodes4.shape[0]} BVH4 nodes, largest leaf "
          f"{float(tags.max()):.0f} triangles, {int((tags >= 128).sum())} "
          f"leaves of 128 or more, {big.nodes.shape[0]} binary nodes, "
          f"committed in {time.perf_counter() - t1:.2f} s")
    if big.accel != 'bvh4' or float(tags.max()) < 256:
        raise AssertionError("the colonnade at leaf 512 did not commit BVH4 "
                             "with leaves of 256 triangles or more")
    gen512 = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = camera_rays(big, bs.colonnade_camera(256, 256), 256, 256,
                               dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    big_cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    big_hit = wide.intersect_packet4(big.nodes4, big.tris, *big_cam)
    *big_hemi, dg, eps = hemisphere_rays(big, org, dirn, big_hit, gen512,
                                         dev)
    # the binary table at leaf 512 (the commit's binary rows, as
    # accel='bvh2' commits them) under K5/K6 on the same rays
    for what, rays, fs in (
            ('camera', big_cam, (wide.intersect_packet4,
                                 traverse.intersect_packet)),
            ('hemisphere', big_hemi, (wide.intersect_packet4,
                                      traverse.intersect_packet)),
            ('shadow', shadow_rays(big, dg, eps, big_hit.valid, gen512, dev),
             (wide.occluded_packet4, traverse.occluded_packet))):
        for f, table in zip(fs, (big.nodes4, big.nodes)):
            compare(f'{f.__name__} (colonnade leaf 512, {what})', f,
                    plains[counters.index(f)], (table, big.tris, *rays),
                    exact=True)

    t1 = time.perf_counter()
    motion = bs.motion_field().commit(device=dev)
    phase('kernels', f"motion_field: {motion.num_triangles} triangles, "
          f"{motion.nodes.shape[0]} binary nodes over union bounds, "
          f"accel {motion.accel}, committed in "
          f"{time.perf_counter() - t1:.2f} s")
    org, dirn, tm = camera_rays(motion, bs.motion_field_camera(512, 512),
                                512, 512, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    for what, rays in (('camera', (org, dirn, zeros, inf, tm)),
                       ('scattered', scattered_rays(motion, 1 << 20, gen,
                                                    dev))):
        check(traverse.intersect_packet_mb,
              f'intersect_packet_mb (motion_field {what})',
              (motion.nodes, motion.tris_mb, *rays))
    # K7's two forms on every call of one bounce-1 trace at the
    # motion_field_512 frame's pass (2^22 rays, 2^23 shadow rays), bit-equal
    calls = frame_motion_calls(motion, bs.motion_field_camera(512, 512), 512,
                               512, spp=16, seed=SEED)
    for n, c in enumerate(calls):
        check(getattr(traverse, c['kernel']), f"{c['kernel']} (motion_field "
              f"frame, call {n + 1} of {len(calls)})", c['args'], exact=True)
    del calls
    # K1/K2 on cornell's own calls at the pass size (one bounce-1 trace at
    # 512^2 and 16 spp: 2^22 closest rays, 2^23 shadow rays a bounce),
    # bit-equal; their staged tests on the live rows as the plain versions
    # count
    dense_pass = {}
    calls = frame_dense_calls(cornell, bs.cornell_camera(512, 512), 512, 512,
                              spp=16, seed=SEED)
    for n, c in enumerate(calls):
        f = getattr(dense, c['kernel'])
        counts = {}
        res = compare(f"{c['kernel']} (cornell frame, call {n + 1} of "
                      f"{len(calls)})", f, plains[counters.index(f)],
                      c['args'], counts, exact=True)
        acc = dense_pass.setdefault(f.__name__, {
            'pass_calls': 0, 'pass_rays': 0, 'pass_ms': 0.0,
            'pass_pair_tests': 0, 'pass_stage2_tests': 0,
            'pass_stage3_tests': 0, 'pass_bytes': 0, 'pass_live_rows': live,
            'pass_table_rows': table_rows})
        for key, v in (('pass_calls', 1), ('pass_rays', res['rays']),
                       ('pass_ms', res['ms']),
                       ('pass_pair_tests', int(counts['pair'])),
                       ('pass_stage2_tests', int(counts['stage2'])),
                       ('pass_stage3_tests', int(counts['stage3'])),
                       ('pass_bytes', res['bytes'])):
            acc[key] += v
    del calls
    for name, acc in dense_pass.items():
        acc['pass_bound_ms'] = max(
            acc['pass_bytes'] / PEAK_BYTES,
            dense.staged_flops({k: acc[f'pass_{k}_tests'] for k in (
                'pair', 'stage2', 'stage3')}) / PEAK_FLOPS) * 1e3
        phase('kernels', f"{name} at cornell's pass size: "
              f"{acc['pass_calls']} calls, {acc['pass_rays']} rays, "
              f"{acc['pass_pair_tests']} pair tests on the {live} live rows "
              f"of {table_rows} ({acc['pass_stage2_tests']} past stage 1, "
              f"{acc['pass_stage3_tests']} to stage 3), "
              f"{acc['pass_ms']:.3f} ms, bound "
              f"{acc['pass_bound_ms']:.4f} ms: "
              f"{acc['pass_bound_ms'] / acc['pass_ms']:.2%} of it; {card}")
    # sponza_like (bench.py bench_psnr_hbm and bench_sponza): 238,208
    # triangles, 269 materials, 20 textures; its commit timed on the card.
    # The kernels of its golden paths on its own tables, bit-equal: K3/K4
    # on its BVH4, K5/K6 on its binary rows (the grid's fallback) and
    # K8/K9 on its grid, over 256^2 camera rays, the hemisphere rays from
    # their hits and the shadow rays to its 6 triangle lights; then K8/K9
    # and K5/K6 on every call of the sponza_64 golden's 'grid' render
    sponza_sb = bs.sponza_like()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sponza = sponza_sb.commit(device=dev, leaf_size=32)
    torch.cuda.synchronize()
    sponza_commit_s = time.perf_counter() - t1
    phase('kernels', f"sponza_like committed in {sponza_commit_s:.2f} s: "
          f"{sponza.num_triangles} triangles, accel {sponza.accel}, "
          f"{sponza.nodes4.shape[0]} BVH4 nodes, "
          f"{sponza.nodes.shape[0]} binary nodes, "
          f"{sponza.materials['mat_tab'].shape[0]} materials, lobe types "
          f"{sponza.lobe_types}, texture modes {sponza.tex_modes}, atlas "
          f"{sponza.textures['data'].shape[0]} texels in "
          f"{sponza.textures['off'].numel()} textures")
    gen_s = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = camera_rays(sponza, bs.sponza_like_camera(256, 256), 256,
                               256, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    s_cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    s_hit = wide.intersect_packet4(sponza.nodes4, sponza.tris, *s_cam)
    *s_hemi, dg, eps = hemisphere_rays(sponza, org, dirn, s_hit, gen_s, dev)
    s_shadow = shadow_rays(sponza, dg, eps, s_hit.valid, gen_s, dev)
    sg = sponza.grid
    s_stack = {'BVH4': [], 'binary': []}
    zero_counters()
    for what, rays, pair in (('camera', s_cam, (wide.intersect_packet4,
                                                traverse.intersect_packet)),
                             ('hemisphere', s_hemi,
                              (wide.intersect_packet4,
                               traverse.intersect_packet)),
                             ('shadow', s_shadow,
                              (wide.occluded_packet4,
                               traverse.occluded_packet))):
        for f, table, tree in zip(pair, (sponza.nodes4, sponza.nodes),
                                  s_stack):
            counts = {}
            compare(f'{f.__name__} (sponza {what})', f,
                    plains[counters.index(f)], (table, sponza.tris, *rays),
                    counts, exact=True)
            s_stack[tree].append((f'{f.__name__} ({what})', [counts]))
        if what != 'camera':
            f = (pairs.intersect_pairs_raw if what == 'hemisphere'
                 else pairs.occluded_pairs)
            compare(f'{f.__name__} (sponza grid, {what}, entry cells)', f,
                    plains[counters.index(f)],
                    (sg['rows'], *rays, *grid.entry_ranges(sg, *rays)),
                    exact=True)
    for tree, sets in s_stack.items():
        stack_depth(f"{tree} on sponza", sets)
    s_calls = 0
    for record_calls, module in ((frame_pair_calls, pairs),
                                 (frame_binary_calls, traverse)):
        calls = record_calls(sponza, bs.sponza_like_camera(64, 64), 'grid',
                             64, 64, spp=4, seed=SEED)
        for n, c in enumerate(calls):
            f = getattr(module, c['kernel'])
            compare(f"{c['kernel']} (sponza_64 grid frame, call {n + 1} of "
                    f"{len(calls)})", f, plains[counters.index(f)],
                    c['args'], exact=True)
        s_calls += len(calls)
        del calls
    ix = {f.__name__: i for i, f in enumerate(counters)}
    k3, k4, k5, k6, k8, k9 = (ix[n] for n in (
        'intersect_packet4', 'occluded_packet4', 'intersect_packet',
        'occluded_packet', 'intersect_pairs_raw', 'occluded_pairs'))
    ran = {counters[k].__name__: counters[k].launches
           for k in (k3, k4, k5, k6, k8, k9)}
    phase('kernels', f"sponza's sets bit-equal to the plain versions "
          f"({s_calls} recorded calls of the grid frame among them); "
          f"launches {ran}")
    if not all(ran.values()):
        raise AssertionError(f"sponza's sets did not launch every kernel "
                             f"of its golden paths: {ran}")
    del s_cam, s_hemi, s_shadow, s_hit, dg, eps
    # sphere_glass (bench.py bench_tpu_psnr_glass): 4,992 triangles under
    # the ambient dome, at the sphere_glass_512 frame's leaf 32.  K3/K4 on
    # its tables, bit-equal: 256^2 camera rays, the hemisphere rays from
    # their hits, and the dome's shadow rays from those hits, each ending
    # at the far hit of 1.5x the scene's bounding sphere (ray_sphere_tfar)
    glass = bs.sphere_glass().commit(device=dev, leaf_size=32)
    gen_g = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = camera_rays(glass, bs.sphere_glass_camera(256, 256), 256,
                               256, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    g_cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    g_hit = wide.intersect_packet4(glass.nodes4, glass.tris, *g_cam)
    *g_hemi, dg, eps = hemisphere_rays(glass, org, dirn, g_hit, gen_g, dev)
    back = (dg['Ng'] * dirn).sum(-1, keepdim=True) > 0
    g_shadow = shadow_rays(glass, dg, eps, g_hit.valid, gen_g, dev,
                           torch.where(back, -dg['Ns'], dg['Ns']))
    g_live = g_shadow[3] >= 0
    if not bool(torch.isfinite(g_shadow[3]).all()) or not bool(g_live.any()):
        raise AssertionError("sphere_glass: the dome's shadow rays have no "
                             "finite tmax")
    phase('kernels', f"sphere_glass: {glass.num_triangles} triangles, accel "
          f"{glass.accel}, {glass.nodes4.shape[0]} BVH4 nodes, lights "
          f"{[l['kind'] for l in glass.lights]}, dome radius "
          f"{float(glass.lights[0]['bsphere_radius']):.2f}; "
          f"{int(g_hit.valid.sum())} of {org.shape[0]} camera rays hit, "
          f"dome shadow tmax median "
          f"{float(g_shadow[3][g_live].median()):.2f}")
    zero_counters()
    g_stack = []
    for what, rays, f in (('camera', g_cam, wide.intersect_packet4),
                          ('hemisphere', g_hemi, wide.intersect_packet4),
                          ('dome shadow', g_shadow, wide.occluded_packet4)):
        counts = check(f, f'{f.__name__} (sphere_glass {what})',
                       (glass.nodes4, glass.tris, *rays), exact=True)
        g_stack.append((f'{f.__name__} ({what})', [counts]))
    stack_depth("BVH4 on sphere_glass", g_stack)
    ran = {f.__name__: f.launches for f in counters if f.launches}
    phase('kernels', f"sphere_glass's sets bit-equal to the plain versions; "
          f"launches {ran}")
    if set(ran) != {'intersect_packet4', 'occluded_packet4'}:
        raise AssertionError(f"sphere_glass's sets did not launch K3 and K4 "
                             f"alone: {ran}")
    del g_cam, g_hemi, g_shadow, g_hit, dg, eps
    phase('kernels', f"all kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 4. goldens, one path each ----------------------------------------
    main_launches = [0] * len(counters)
    goldens = (
        ('cornell_64', cornell, bs.cornell_camera(64, 64), 4, 32, 'morton',
         (0, 1)),
        ('stereo_64', cornell, bs.cornell_stereo_camera(64, 64), 2, 8,
         'morton', (0, 1)),
        ('colonnade_64', colonnade, bs.colonnade_camera(64, 64), 3, 8,
         'morton', (k3, k4)),
        ('colonnade_64', colonnade2, bs.colonnade_camera(64, 64), 3, 8,
         'morton', (k5, k6)),
        ('colonnade_64', colonnade, bs.colonnade_camera(64, 64), 3, 8,
         'grid', (k3, k4, k5, k6, k8, k9)),
        ('colonnade_64', colonnade, bs.colonnade_camera(64, 64), 3, 8,
         'treelet', (k3, k4, k5, k6)),
        ('colonnade_64', colonnade, bs.colonnade_camera(64, 64), 3, 8,
         'dense', (k3, k4, k5, k6, k8, k9)),
        ('motion_64', motion, bs.motion_field_camera(64, 64), 2, 16,
         'morton', (ix['intersect_packet_mb'], ix['occluded_packet_mb'])),
        # textured shading, the plastic's layered and microfacet lobes;
        # above the reference's VMEM budget, so its 'grid' render takes
        # the sorted BVH there and the grid's kernels here
        ('sponza_64', sponza, bs.sponza_like_camera(64, 64), 2, 4, 'morton',
         (k3, k4)),
        ('sponza_64', sponza, bs.sponza_like_camera(64, 64), 2, 4, 'grid',
         (k3, k4, k5, k6, k8, k9)),
        # glass and Beer media under the ambient dome, depth 8 past the
        # roulette start ('auto' compacts), at the commit's default leaf
        ('sphere_glass_64', bs.sphere_glass().commit(device=dev),
         bs.sphere_glass_camera(64, 64), 8, 32, 'morton', (k3, k4)),
    )
    for name, scene, cam, depth, spp, binning, used in goldens:
        zero_counters()
        film, stats = renderer.render_frame(
            scene, cam, pt.PTParams(max_depth=depth, ray_binning=binning),
            64, 64, spp=spp, seed=SEED)
        img = accum.resolve(film).cpu().numpy()
        ran = [f.launches for f in counters]
        ref = np.load(os.path.join(GOLDEN, name + '_cpu.npz'))['img']
        if img.shape != ref.shape or not np.isfinite(img).all():
            raise AssertionError(f"{name}: image {img.shape} not finite or "
                                 f"not of the golden's shape {ref.shape}")
        db = psnr(img, ref)
        counts = {f.__name__: n for f, n in zip(counters, ran) if n}
        phase('golden', f"{name} (accel {scene.accel}, ray_binning "
              f"{binning}): PSNR {db:.2f} dB (trimmed-1% "
              f"{trimmed_psnr(img, ref):.2f}) vs {name}_cpu.npz (gate "
              f"{PSNR_MIN}), {stats.num_rays:.0f} rays, kernel launches "
              f"{counts}, pair binnings {pairs.bin_rays.launches}")
        if db < PSNR_MIN:
            raise AssertionError(f"{name}: PSNR {db:.2f} < {PSNR_MIN}")
        if any((ran[i] > 0) != (i in used) for i in range(len(counters))):
            raise AssertionError(f"{name} (accel {scene.accel}): its path's "
                                 "kernels did not run, or others did")
        # every pair call of the rounds has ranges, so is binned first
        if pairs.bin_rays.launches != ran[k8] + ran[k9]:
            raise AssertionError(f"{name}: {pairs.bin_rays.launches} pair "
                                 f"binnings for {ran[k8] + ran[k9]} pair "
                                 "kernel calls")
        # the grid path: BVH4 on bounce 0 only; on each later bounce 8
        # closest rounds and 4 any-hit rounds, each with one fallback
        if binning == 'grid' and not (
                ran[k3] == ran[k4] and ran[k5] == ran[k6] == (depth - 1)
                * ran[k3] and ran[k8] == 8 * ran[k5]
                and ran[k9] == 4 * ran[k6]):
            raise AssertionError(f"{name} (grid): launches {counts} are not "
                                 "BVH4 on bounce 0 and the grid after it")
        # the treelet binnings: BVH4 on bounce 0 only; on each later
        # bounce 2 rounds (K5/K6 from roots, or K8/K9 over treelet tiles)
        # and one K5/K6 fallback per call
        bounces = (depth - 1) * ran[k3]
        if binning == 'treelet' and not (
                ran[k3] == ran[k4] and ran[k5] == ran[k6] == 3 * bounces):
            raise AssertionError(f"{name} (treelet): launches {counts} are "
                                 "not BVH4 on bounce 0 and 3 binary calls "
                                 "per call after it")
        if binning == 'dense' and not (
                ran[k3] == ran[k4] and ran[k5] == ran[k6] == bounces
                and ran[k8] == 2 * ran[k5] and ran[k9] == 2 * ran[k6]):
            raise AssertionError(f"{name} (dense): launches {counts} are not "
                                 "BVH4 on bounce 0 and 2 pair rounds and a "
                                 "binary fallback per call after it")
        if any(f.cuda_calls for f in plains):
            raise AssertionError(f"{name}: a plain version ran on CUDA "
                                 "tensors in the main path")
        main_launches = [a + b for a, b in zip(main_launches, ran)]
    # the HDRI light: sphere_mirror.ecs (the mirror ball under the
    # lines.ppm map) through the port's own loader, its camera made from
    # the parsed settings as the reference's api/output.py mono_camera
    # does; rendered on the card and by the port on this machine's CPU
    mst, msb = ecs.parse_ecs(SPHERE_MIRROR)
    mcam = sphere_mirror_camera(64, 64)
    mparams = pt.PTParams(max_depth=3)
    mirror = msb.commit(device=dev, accel=mst.accel)
    zero_counters()
    film, stats = renderer.render_frame(mirror, mcam, mparams, 64, 64, spp=8,
                                        seed=SEED)
    img = accum.resolve(film).cpu().numpy()
    ran = [f.launches for f in counters]
    counts = {f.__name__: n for f, n in zip(counters, ran) if n}
    cpu_film, _ = renderer.render_frame(msb.commit(device='cpu',
                                                   accel=mst.accel),
                                        mcam, mparams, 64, 64, spp=8,
                                        seed=SEED)
    ref = accum.resolve(cpu_film).numpy()
    db = psnr(img, ref)
    phase('golden', f"sphere_mirror_64 (HDRI {mirror.lights[0]['width']}x"
          f"{mirror.lights[0]['height']}, accel {mirror.accel}, depth 3, 8 "
          f"spp): PSNR {db:.2f} dB (trimmed-1% {trimmed_psnr(img, ref):.2f})"
          f" vs the port's CPU render (gate {PSNR_MIN}), "
          f"{stats.num_rays:.0f} rays, kernel launches {counts}")
    if (not np.isfinite(img).all() or db < PSNR_MIN
            or set(counts) != {'intersect_packet4', 'occluded_packet4'}
            or any(f.cuda_calls for f in plains)):
        raise AssertionError(f"sphere_mirror_64: PSNR {db:.2f}, launches "
                             f"{counts}: not K3/K4 alone, or disagrees with "
                             "the CPU")
    main_launches = [a + b for a, b in zip(main_launches, ran)]
    # K11's entry points, the reference's bench_incoherent.py 'split'
    # runs: sorted on the 1M bounce-1 rays, unsorted on the camera rays;
    # their hits are K5's
    k5_hits = [traverse.intersect_packet(*tables2, *rays)
               for rays in (hemi, cam_rays)]
    zero_counters()
    split_hits = [
        splitleaf.intersect_packet_split_sorted(*tables2, *hemi, lo, hi,
                                                leaf),
        splitleaf.intersect_packet_split(*tables2, *cam_rays, leaf)]
    ran = [f.launches for f in counters]
    counts = {f.__name__: n for f, n in zip(counters, ran) if n}
    same = all(torch.equal(a.t, b.t) and torch.equal(a.tri >= 0, b.tri >= 0)
               for a, b in zip(split_hits, k5_hits))
    phase('golden', f"split-leaf entry points on the colonnade's "
          f"{hemi[0].shape[0]} hemisphere rays (sorted) and "
          f"{cam_rays[0].shape[0]} camera rays: t and hit mask equal to "
          f"K5's: {same}, kernel launches {counts}")
    if not same or counts != {'intersect_packet_split': 2} or any(
            f.cuda_calls for f in plains):
        raise AssertionError("the split-leaf entry points did not run K11 "
                             "alone, or disagree with K5")
    main_launches = [a + b for a, b in zip(main_launches, ran)]
    # K10's entry point, the reference's bench_incoherent.py 'march' run,
    # on the 1M bounce-1 rays (sorted inside); its hits are K5's
    zero_counters()
    march_hit = grid.intersect_march(g, *hemi)
    ran = [f.launches for f in counters]
    counts = {f.__name__: n for f, n in zip(counters, ran) if n}
    same = (torch.equal(march_hit.t, k5_hits[0].t)
            and torch.equal(march_hit.tri >= 0, k5_hits[0].tri >= 0))
    phase('golden', f"grid march entry point on the colonnade's "
          f"{hemi[0].shape[0]} hemisphere rays: t and hit mask equal to "
          f"K5's: {same}, kernel launches {counts}")
    if not same or counts != {'march_raw': 1} or any(
            f.cuda_calls for f in plains):
        raise AssertionError("the grid march entry point did not run K10 "
                             "alone, or disagrees with K5")
    main_launches = [a + b for a, b in zip(main_launches, ran)]

    # ---- 5. timed full-size frames ----------------------------------------
    frames = (
        ('cornell_512', cornell, bs.cornell_camera(512, 512), 512, 32, 4,
         'morton'),
        ('colonnade_1024', colonnade, bs.colonnade_camera(1024, 1024), 1024,
         8, 4, 'morton'),
        ('colonnade_1024_bvh2', colonnade2, bs.colonnade_camera(1024, 1024),
         1024, 8, 4, 'morton'),
        ('colonnade_1024_grid', colonnade, bs.colonnade_camera(1024, 1024),
         1024, 8, 4, 'grid'),
        ('colonnade_1024_treelet', colonnade,
         bs.colonnade_camera(1024, 1024), 1024, 8, 4, 'treelet'),
        ('colonnade_1024_dense', colonnade, bs.colonnade_camera(1024, 1024),
         1024, 8, 4, 'dense'),
        ('motion_field_512', motion, bs.motion_field_camera(512, 512), 512,
         16, 4, 'morton'),
        ('sponza_like_1024', sponza, bs.sponza_like_camera(1024, 1024),
         1024, 8, 4, 'morton'),
    )
    commits = {'sponza_like_1024': sponza_commit_s}
    for name, scene, cam, res, spp, depth, binning in frames:
        params = pt.PTParams(max_depth=depth, ray_binning=binning)
        torch.cuda.reset_peak_memory_stats()
        renderer.render_frame(scene, cam, params, res, res, spp=spp,
                              seed=SEED)
        zero_counters()
        runs = [renderer.render_frame(scene, cam, params, res, res, spp=spp,
                                      seed=SEED + i)[1] for i in (1, 2, 3)]
        per_frame = {f.__name__: (f.launches // len(runs)
                                  if f.launches % len(runs) == 0
                                  else f.launches / len(runs))
                     for f in (*counters, pairs.bin_rays) if f.launches}
        mrps = sorted(s.mrps for s in runs)
        secs = sorted(s.seconds for s in runs)
        phase('frame', f"{name} ({res}^2, {spp} spp, depth {depth}, accel "
              f"{scene.accel}, ray_binning {binning}): "
              f"{mrps[1]:.2f} Mrays/s (min {mrps[0]:.2f}, max {mrps[2]:.2f}),"
              f" frame_s {secs[1]:.3f} (min {secs[0]:.3f}, max "
              f"{secs[2]:.3f}), {runs[0].num_rays / 1e6:.1f} Mrays/frame, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
              f", launches per frame {per_frame}"
              + (f", commit {commits[name]:.2f} s" if name in commits else '')
              + f" on {card}")

    def timed_modes(name, scene, cam, params, res, spp, desc):
        """A frame past the roulette start with compaction 'off' and
        'auto', 1 warm-up and 3 frames each: frame_s, Mrays/s, peak
        memory, launches per frame (BVH4's alone), the 'auto' passes'
        per-bounce widths and live counts, and the two modes' films of
        one seed held bit-equal."""
        films, lives = {}, {}
        for how in ('off', 'auto'):
            torch.cuda.reset_peak_memory_stats()
            renderer.render_frame(scene, cam, params, res, res, spp=spp,
                                  seed=SEED, compaction=how)
            zero_counters()
            runs = []
            for i in (1, 2, 3):
                bounces = []
                film, st = renderer.render_frame(
                    scene, cam, params, res, res, spp=spp, seed=SEED + i,
                    compaction=how, bounce_stats=bounces)
                runs.append(st)
                if i == 1:
                    films[how], lives[how] = film.rgb_sum, bounces
            per_frame = {f.__name__: f.launches / len(runs)
                         for f in (*counters, pairs.bin_rays) if f.launches}
            mrps = sorted(s.mrps for s in runs)
            secs = sorted(s.seconds for s in runs)
            phase('frame', f"{name} ({desc}, accel {scene.accel}, compaction "
                  f"{how}): {mrps[1]:.2f} Mrays/s (min {mrps[0]:.2f}, max "
                  f"{mrps[2]:.2f}), frame_s {secs[1]:.3f} (min {secs[0]:.3f}, "
                  f"max {secs[2]:.3f}), {runs[0].num_rays / 1e6:.1f} "
                  f"Mrays/frame, peak mem "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"launches per frame {per_frame} on {card}")
            if set(per_frame) != {'intersect_packet4', 'occluded_packet4'}:
                raise AssertionError(f"{name} ({how}) ran other kernels "
                                     f"than BVH4's: {per_frame}")
        starts = [i for i, b in enumerate(lives['auto']) if b['depth'] == 0]
        if lives['off'] or not starts or starts[0] != 0:
            raise AssertionError(f"{name}: compaction 'off' compacted, or "
                                 "'auto' did not")
        for n, (p0, p1) in enumerate(zip(starts, starts[1:] + [None])):
            phase('frame', f"{name} (compaction auto, seed {SEED + 1}) pass "
                  f"{n + 1} of {len(starts)} by bounce (depth, width, live, "
                  "ms): " + ', '.join(
                      f"({b['depth']}, {b['width']}, {b['live']}, "
                      f"{b['seconds'] * 1e3:.1f})"
                      for b in lives['auto'][p0:p1]))
        differ = (films['off'] != films['auto']).any(dim=-1)
        phase('frame', f"{name} films of compaction off and auto: bit-equal "
              f"{not bool(differ.any())}, {int(differ.sum())} pixels differ, "
              f"largest difference "
              f"{float((films['off'] - films['auto']).abs().max()):.3g}")
        if differ.any():
            raise AssertionError(f"{name}: the films of compaction off and "
                                 "auto differ")

    # the production stereo face (bench.py bench_stereo_face): BVH4, depth
    # 10 past the roulette start, the dome cap 120, two passes of 1536^2
    # rays
    timed_modes('stereo_face_1536', colonnade, stereo_face_camera(1536, 1536),
                pt.PTParams(**STEREO_PARAMS), 1536, 2,
                "1536^2, 2 spp, depth 10, t_max_shadow_ray 120")
    # sphere_glass at its camera's own size with the golden's spp and
    # depth: the ambient dome's NEE and escaped rays, glass chains past the
    # roulette start; two passes of 2^22 rays
    timed_modes('sphere_glass_512', glass, bs.sphere_glass_camera(512, 512),
                pt.PTParams(max_depth=8), 512, 32,
                "512^2, 32 spp, depth 8, leaf 32")

    # ---- 6. bounds ---------------------------------------------------------
    summary = []
    for (f, _, src, replaces, pair_flops), n in zip(kernels, main_launches):
        res = results[f.__name__]
        flops = (res['pair'] * pair_flops + res['box'] * SLAB_FLOPS
                 + res['stage2'] * dense.INSIDE_FLOPS
                 + res['stage3'] * dense.CULL_FLOPS)
        staged = (f" + {res['stage2']} past stage 1 x {dense.INSIDE_FLOPS} "
                  f"+ {res['stage3']} to stage 3 x {dense.CULL_FLOPS}"
                  if f in (dense.intersect_dense, dense.occluded_dense)
                  else '')
        bytes_ms = res['bytes'] / PEAK_BYTES * 1e3
        flops_ms = flops / PEAK_FLOPS * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = 'bytes' if bytes_ms >= flops_ms else 'operations'
        waste = ''
        if res['rows']:
            waste = (f"; its kernel loaded {res['rows'] * 64 / 1e9:.2f} GB "
                     f"of rows ({res['rows']} rows; one ray per thread: "
                     f"{res['pair'] * 64 / 1e9:.2f} GB)")
        if res['schedule_pair'] or res['schedule_box']:
            waste = (f"; its schedule made {res['schedule_pair']} pair and "
                     f"{res['schedule_box']} box tests, "
                     f"{res['schedule_pair'] / max(res['pair'], 1):.2f}x and "
                     f"{res['schedule_box'] / max(res['box'], 1):.2f}x "
                     f"those the function needs")
        phase('bounds', f"{f.__name__} on {res['rays']} rays: "
              f"{res['pair']} pair tests x {pair_flops} flops{staged} + "
              f"{res['box']} box tests x {SLAB_FLOPS} flops = {flops:.4g} "
              f"flops ({flops_ms:.4f} ms), {res['bytes']} bytes "
              f"({bytes_ms:.4f} ms); bound {bound_ms:.4f} ms by {bound_by}, "
              f"kernel {res['ms']:.3f} ms: {bound_ms / res['ms']:.2%} of the "
              f"bound's rate{waste}; no single PyTorch call computes it")
        summary.append({
            'name': f.__name__, 'route': 'cuda',
            'source': 'yulio_raytracer_tpu_torch/csrc/' + src,
            'replaces': replaces, 'launches': n,
            'max_abs_err': res['max_abs_err'], 'ms': res['ms'],
            'plain_ms': res['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None, 'rays': res['rays'],
            'pair_tests': res['pair'], 'box_tests': res['box'],
            'bytes': res['bytes']})
        if staged:
            summary[-1].update(stage2_tests=res['stage2'],
                               stage3_tests=res['stage3'])
        if res['rows']:
            summary[-1].update(rows_loaded=res['rows'],
                               rows_gb=res['rows'] * 64 / 1e9)
        if res['schedule_pair'] or res['schedule_box']:
            summary[-1].update(schedule_pair_tests=res['schedule_pair'],
                               schedule_box_tests=res['schedule_box'])
        summary[-1].update(k12_extra.get(f.__name__, {}),
                           **dense_pass.get(f.__name__, {}))
    phase('done', f"all phases passed in {time.perf_counter() - t_start:.1f}"
          f" s")
    print(json.dumps({'kernels': summary}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
