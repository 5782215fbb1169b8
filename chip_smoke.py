#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yulio_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failure raises and the exit code is nonzero):
 1. toolchain: torch / CUDA / nvcc versions, the card's name and power limit;
 2. build: the CUDA kernels from yulio_raytracer_tpu_torch/csrc, one nvcc
    per source (nine), all started together;
 3. every kernel against its plain torch version on the card, at the main
    paths' shapes: the dense pair on cornell (64^2 camera rays plus
    hemisphere rays from their hits; shadow rays to its lights), the BVH4
    pair and the binary pair on the full colonnade (1024^2 camera rays, 1M
    hemisphere rays from their hits, the shadow rays to its 4 triangle
    lights; the binary pair also with each ray started at its nearest
    treelet's root, and bit-equal on every call of one bounce-1 trace
    with accel 'bvh2' and through 'treelet', raysets.frame_binary_calls),
    the width-8 kernels on the same tree as 8-wide rows (raysets.nodes8)
    and the same sets, bit-equal, with the same t, hit mask and occlusion
    as K3/K4 and timed beside them, the staged walks (K5/K6 a stage) on
    the hemisphere and shadow rays, bit-equal to their plain versions and
    timed against one K5/K6 walk,
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
    sorted against K5 on the hemisphere rays, timed in turns; the BVH4,
    binary and width-8 pairs again on the colonnade at leaf 512 (leaves of
    up to 504 triangles, the *_slots forms; 256^2 camera rays, hemisphere
    rays from their hits, their shadow rays), bit-equal; the sweep
    prototype's kernels K12
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
    scene's bounding sphere x 1.5), bit-equal, K3 and K4 alone launched;
    and test_stereo.ecs (the production strip's scene, 14,704 triangles):
    the BVH4 pair over the 800^2 camera rays of the CLI rig's back face,
    the hemisphere rays from their hits and the dome's shadow rays,
    bit-equal, K3 and K4 alone launched; and the fetch kernel F1
    (textures.fetch) on every fetch call of bounces 0 and 1 of a
    sponza_like frame at 1024^2 and 4 spp (2^22 hits x 4 lobe slots a
    call, raysets.frame_fetch_calls), bit-equal to the plain fetch on
    sponza's own atlas and on an atlas of sponza.frame_1024's size (24
    maps of 1024^2, 402.7 MB), F1 alone launched, once a call; and the
    lobe kernels F2 (lobes.eval_lobes, lobes.sample_lobes) on every eval
    and sample call of a sponza_like frame at 1024^2, 8 spp and depth 4
    (sponza.frame_1024's traffic: 2^23 hits a bounce, its 6 triangle
    lights in one eval, raysets.frame_lobe_calls), bit-equal in every
    output to the plain versions on the card and to the frame's own
    results, F2 alone launched, once a call; and the RNG kernel F3
    (rng.draw, under uniform1/2/3 and hash_u32) on every draw of that
    frame (its camera samples, each bounce's 6-light NEE draw and the
    scatter's two; 2^23 lanes a call, raysets.frame_rng_calls), bit-equal
    to the plain versions on the card and to the frame's own results, F3
    alone launched, once a call.
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
    kernels and F1 alone and again with ray_binning 'grid', sphere_glass_64
    (depth 8, 32 spp, the ambient dome, compacted) through the BVH4
    kernels, each with its trimmed-1% PSNR beside; sphere_mirror_64 (the
    HDRI light, sphere_mirror.ecs through the port's loader, depth 3, 8
    spp) on the card against the port's CPU render, >= 40 dB; K10's entry
    point
    (grid.intersect_march on the colonnade's 1M hemisphere rays) and
    K11's (sorted on those rays, unsorted on its camera rays), whose t
    and hit mask must equal K5's; the width-8 walks' (intersect_packet4 /
    occluded_packet4 at width=8) and the staged walks' on those rays and
    the shadow rays, whose t and hit mask must equal K5's and whose
    occlusion K6's (no render path takes either, nor in the reference).
    Every launch counter is set to 0 before each run and read after it:
    the path's kernels must have run, no other kernel (so K12, which no
    path runs, never), and no plain version on a CUDA tensor; F1 runs on
    the textured paths (sponza, sphere_glass, sphere_mirror, test_stereo
    and the random scenes) and on no other; F2 on every path-traced
    frame (its NEE's eval, its scatter's sample); F3 on every frame of
    the stateless sampler and the debug renderer's, and under the
    precomputed sampler only where a shadow cap draws its jitter (the
    uncapped cornell and motion frames draw nothing); the pair
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
 6. the production output path: test_stereo.ecs's strip at its own
    size (one rig at the CLI camera as `-stereo` builds it, 12 faces of
    800^2 at 64 spp, depth 10, the dome cap 120, the b-spline filter)
    through api/output.py render_rig_faces, assembled and written to
    chiprun_out/test_stereo_view.ppm, with its seconds, camera rays and
    Mrays/s, each face's seconds, Mrays/s and peak memory, and its K3/K4
    launches (K3/K4 and F1 alone); the same strip at 32^2 faces, 4 spp with the
    watermark, and test_room.dae as StartRT stages it
    (session.collada_job: toe-in, the cap 120 x scene scale, the sky
    ambient, the billboard committed at the rig; 64^2 faces, 4 spp, depth
    10; K1/K2 alone), each held to the port's CPU strip (>= 40 dB,
    trimmed-1% beside); cli.main's mono mode on cornell_box.ecs at 64^2
    writing chiprun_out/cli_cornell.ppm, held to the CPU CLI's file; and
    a scene of an HDRI light alone (no geometry) through render_mono,
    held to the CPU;
 7. the single-device remainder: the colonnade committed at the three
    BVH qualities ('normal', 'high', 'high-spatial'; leaf 32) with each
    one's CommitStats and references, each timed at colonnade_1024's
    config, K3/K4 bit-equal on the spatial-split tree's 256^2 camera,
    hemisphere and shadow rays; the precomputed sampler: cornell_512 with
    the b-spline filter (and build_tables' host seconds), stereo_face_1536
    with compaction 'off' and 'auto' (films bit-equal), cornell_64 and
    motion_field_64 against the port's CPU render (>= 60 dB); the debug
    renderer on the colonnade at 1024^2, 8 rays a pixel, depth 4 (rays,
    Mrays/s, K3's profiled share of the frame; 64^2 against the CPU);
    the web viewer's interactive_loop on the colonnade at 512^2 driven by
    queued events (a rotate, a pick that re-centres, 'q'; its fps, its
    last PNG decoded equal to the tonemapped film); the display loop
    writing chiprun_out/display.png (read back equal); four random scenes
    at 32^2 against the port's CPU (>= 60 dB, or trimmed-1% >= 60), the
    debug renderer on one; profiling.trace over a cornell_512 frame
    (naming the shade range and the dense kernels); render_progressive
    stopped and resumed, bit-equal to an uninterrupted run.  The
    counters are zeroed before each path and only its kernels may run;
 8. multi-device, TCP and the C ABI: render_frame over a mesh of two
    slots of the card (and of every card where there are several) on
    cornell_64 (K1/K2) and colonnade_64 (K3/K4), bit-equal to the
    one-device films; cornell_64 over 2 px x 2 triangle slots
    (render_frame_sharded, K1/K2 on each shard) within test_parallel.py's
    bar; cornell_64 and colonnade_1024 timed on one slot and on two; two
    RenderServer threads on the card serving cornell 64^2 in 'native'
    (atol 1e-5 against the local film, bit-equality printed), 'rgbe8' and
    'jpeg', and test_stereo's strip at 32^2 faces over the client
    (render_rig_faces, each face >= 60 dB against the local face, the
    equal ones counted); then, after every timed section, so that they
    share the card with no timing, two processes joined by
    init_distributed (gloo, one slot of the card each) whose films equal
    one process's 2-slot film, and the C host examples/rt_test_host.c
    through the port's shim
    (native/build.py: g++ and cc, built beside the kernels) on
    test_room.dae at 64^2, 4 spp on the card, 'done: state=4' with
    lastError 0 and the strip StartRT writes in this process, byte for
    byte;
 9. each kernel's bound: the larger of the bytes it must move (tables,
    rays and ranges read once, results written once) over 3.35 TB/s and
    its pair and box tests (counted by the plain versions in phase 3; K12's
    from its shapes; K1/K2's by stage, as they run the Woop test) times
    their flops over 67 TFLOP/s f32, against its time in phase 3.  K11's
    tests are those K5's plain version counts on the same rays, the tests
    their closest hits need; the tests K11's schedule makes (a lane per
    box of its packet's walk, 8 a row for the rays that hit its leaf) are
    printed beside them as that schedule's waste, and so are the box
    tests of the wide kernels (K3/K4 and width 8), which test every slot
    of a row where the function needs its non-empty ones.  Beside K10's
    bound, the rows its kernel loads (a cell's rows once a round for each
    warp's rays in it, as its plain version counts) in GB, and those one
    ray per thread would load (a 64-byte row for every test).  F1's
    bound is bytes alone: ids and uv read once, the result written once,
    the texture rows, and 16 B a tap of each slot's own filter (4
    bilinear, 1 nearest, none for an id < 0), over its calls on the
    1024^2 atlas.  F2's is bytes too (lobe_bytes): a hit's types, the
    parameters of each slot its kernel evaluates or samples, the per-hit
    vectors and the outputs, each once, over sponza's frame's calls.
    F3's is bytes (rng_bytes): 8 B a lane of each stream that is a
    tensor (the pixel and sample ids), and its outputs once.
The last lines are a JSON summary of the kernels, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'assets', 'golden')
SCENES = os.path.join(ROOT, 'assets', 'scenes')
OUT = os.path.join(ROOT, 'chiprun_out')
SEED = 42
TRI_MISMATCH_MAX = 1e-4      # ties only: equal t, another triangle
MASK_MISMATCH_MAX = 1e-4     # hit/miss and occlusion masks
T_REL_ERR_MAX = 1e-6         # where the triangle agrees
PSNR_MIN = 40.0
# the lobe kernels' wrappers, which every path-traced frame launches (its
# NEE evaluates the lobes, its scatter samples them)
F2 = frozenset({'eval_lobes', 'sample_lobes'})
# the RNG kernel's wrapper (core/rng.py draw), which every frame of the
# stateless sampler launches (its camera samples, each bounce's draws)
F3 = frozenset({'draw'})


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
            # a template's arguments, e.g. <0, 8> for ILb0ELi8EE
            args = re.match(r'I((?:L[a-z]+\d+E)+)E',
                            m.group(2)[int(m.group(1)):])
            if args:
                name += '<' + ', '.join(
                    re.findall(r'L[a-z]+(\d+)E', args.group(1))) + '>'

        elif name and 'stack frame' in line:
            frame = line.strip()
        elif name and 'registers' in line:
            regs = re.search(r'Used (\d+) registers', line).group(1)
            rows.append(f"{name} {regs} registers, {frame}")
            name = None
    return rows


def cuda_ms(fn, reps=5):
    """Median milliseconds of fn() over reps runs (CUDA events), after
    one warm-up run."""
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
    # the plain versions are slow loops of torch ops and no yardstick of
    # speed: the run that is checked is the one timed
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    p = plain(*args) if counts is None else plain(*args, counts=counts)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
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
    r = next(a.shape[0] for a in args if isinstance(a, torch.Tensor)
             and a.dim() == 2 and a.shape[1] == 3)
    phase('kernels', f"{name} on {r} rays: {line}; {labels[0]} {ms:.3f} ms, "
          f"{labels[1]} {plain_ms:.3f} ms")
    if not ok:
        raise AssertionError(f"{name} disagrees with its {labels[1]} "
                             f"version: {line}")
    return {'rays': r, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bytes': moved}


def fetch_bytes(table, tid):
    """(bytes, texel slots) of one call of the fetch kernel F1: the ids
    (int64) and the hits' (R, 2) f32 uv read once, the (..., 4) f32
    result written once, the texture rows, and 16 B a tap of each slot's
    own filter (4 bilinear, 1 nearest, none where the id is < 0)."""
    from yulio_raytracer_tpu_torch.shading.textures import FILTER_BILINEAR
    own = tid >= 0
    bilinear = int((own & (table['filter'][tid.clamp(min=0)]
                           == FILTER_BILINEAR)).sum())
    texel = int(own.sum())
    rows = nbytes(*(table[k] for k in ('off', 'w', 'h', 'filter', 'invert')))
    return (tid.numel() * (8 + 16) + tid.shape[0] * 2 * 4 + rows
            + 16 * (4 * bilinear + texel - bilinear)), texel


def lobe_bytes(kind, a, lb):
    """(bytes, lanes) of one call of the lobe kernel F2 `kind`
    ('eval_lobes' or 'sample_lobes') on the arguments `a` by name: every
    hit's L int64 types; of each slot the kernel evaluates or samples (a
    type of the call's mask; for the eval the cosine family alone) its
    color, eta and exp (20 B), and a conductor's ceta and k (24 B); ns
    and wo; the eval's wi and brdf (12 B each a light and hit); the
    sample's ng, s2 and s1, the tangents of hits with an anisotropic
    slot, and its wi, pdf, weight, type bits, eta and valid (41 B a hit).
    The lanes: hits x lights for an eval, hits for a sample."""
    t = a['lobes']['type'].to(torch.int64)
    r, slots = t.shape
    live = (t != lb.NONE) & ((lb.type_bits(t) & a['type_mask']) != 0)
    if kind == 'eval_lobes':
        nl = a['wi'].numel() // (3 * r)
        live = live & (t <= lb.DIELECTRIC_LAYER_LAMB)
        return r * (8 * slots + 24 + 24 * nl) + 20 * int(live.sum()), r * nl
    cond = live & ((t == lb.CONDUCTOR) | (t == lb.MICROFACET_CONDUCTOR)
                   | (t == lb.MICROFACET_CONDUCTOR_ANISO))
    aniso = (live & (t == lb.MICROFACET_CONDUCTOR_ANISO)).any(dim=1)
    framed = a['tx'] is not None and a['ty'] is not None
    return (r * (8 * slots + 24 + 24 + 41) + 20 * int(live.sum())
            + 24 * int(cond.sum()) + 24 * framed * int(aniso.sum())), r


def rng_bytes(kind, args):
    """(bytes, draws) of one call of the RNG kernel F3 on the key's four
    streams `args` for draws of kind `kind` (0 the key itself, n its n
    floats): 8 B a lane of each stream that is a tensor, read once, and
    the outputs written once (8 B a key, 4 B a float); the draws: the
    dims (a sequence's length, else 1) x the lanes."""
    lanes = next(x for x in args if isinstance(x, torch.Tensor)).numel()
    tensors = sum(isinstance(x, torch.Tensor) for x in args)
    dims = len(args[3]) if isinstance(args[3], (list, tuple)) else 1
    width = 8 if kind == 0 else 4 * kind
    return lanes * (8 * tensors + width * dims), lanes * dims


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


# one rank of the two-process gloo render in phase 8: the port joined by
# init_distributed, one slot on the card each; writes its film and the
# dense kernels' launches
RANK_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.ops import dense
from yulio_raytracer_tpu_torch.parallel import sharding

rank = int(sys.argv[1])
sharding.init_distributed(%(coord)r, num_processes=2, process_id=rank,
                          backend='gloo')
mesh = sharding.make_mesh(devices=['cuda:0'])
scene = bs.cornell_box().commit(device='cuda')
dense.intersect_dense.launches = dense.occluded_dense.launches = 0
film = sharding.render_frame_sharded(scene, bs.cornell_camera(64, 64),
                                     pt.PTParams(max_depth=4), 64, 64, 8,
                                     mesh, seed=%(seed)d)
torch.save(film.rgb_sum.cpu(), %(out)r + '.%%d' %% rank)
print(json.dumps({'rank': rank, 'px': mesh.shape['px'],
                  'intersect_dense': dense.intersect_dense.launches,
                  'occluded_dense': dense.occluded_dense.launches}))
torch.distributed.destroy_process_group()
"""


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def multi_device_phase(dev, card, cornell, colonnade, zero_counters,
                       launched, dense_path, bvh4_path, shim_and_host):
    """Phase 8: the mesh, the TCP servers, two gloo ranks and the C ABI on
    the card (see the module docstring); returns its seconds.  dense_path
    and bvh4_path: the kernels a path-traced frame launches through the
    dense kernels or the BVH4 ones (F2 and F3 with each)."""
    from yulio_raytracer_tpu_torch import renderer
    from yulio_raytracer_tpu_torch.api import cli, output, session
    from yulio_raytracer_tpu_torch.film import accum
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    from yulio_raytracer_tpu_torch.io import ecs
    from yulio_raytracer_tpu_torch.parallel import network, sharding

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='yrt_phase8_')
    ranks, c_host = [], None
    try:
        # the mesh: two slots of the card (and every card where there are
        # several), each film bit-equal to the one-device film
        meshes = [('2 slots of cuda:0', sharding.make_mesh(
            devices=[torch.device('cuda', 0)] * 2))]
        if torch.cuda.device_count() > 1:
            meshes.append((f'{torch.cuda.device_count()} cards',
                           sharding.make_mesh()))
        for label, mesh in meshes:
            for name, scene, cam, depth, spp, want in (
                    ('cornell_64', cornell, bs.cornell_camera(64, 64), 4, 32,
                     dense_path),
                    ('colonnade_64', colonnade, bs.colonnade_camera(64, 64),
                     3, 8, bvh4_path)):
                params = pt.PTParams(max_depth=depth)
                one, st1 = renderer.render_frame(scene, cam, params, 64, 64,
                                                 spp, seed=SEED)
                zero_counters()
                film, st = renderer.render_frame(scene, cam, params, 64, 64,
                                                 spp, seed=SEED, mesh=mesh)
                counts = launched(f'{name} over {label}', want)
                if not torch.equal(film.rgb_sum, one.rgb_sum):
                    raise AssertionError(f"{name} over {label}: the film is "
                                         "not bit-equal to one device's")
                phase('multi', f"{name} (64^2, {spp} spp, depth {depth}) "
                      f"over the mesh of {label}: bit-equal to the one-device"
                      f" film; {st.num_rays:.0f} rays ({st1.num_rays:.0f} on "
                      f"one device); launches {counts}")
        # the triangle axis: cornell's triangles in two shards, K1/K2 each
        tri_mesh = sharding.make_mesh(devices=[torch.device('cuda', 0)] * 4,
                                      tri_parallel=2)
        cam, params = bs.cornell_camera(64, 64), pt.PTParams(max_depth=4)
        one, _ = renderer.render_frame(cornell, cam, params, 64, 64, 32,
                                       seed=SEED)
        zero_counters()
        film = sharding.render_frame_sharded(cornell, cam, params, 64, 64, 32,
                                             tri_mesh, seed=SEED)
        counts = launched('cornell_64 over 2 px x 2 tri slots', dense_path)
        d = (accum.resolve(film) - accum.resolve(one)).abs().amax(-1)
        within = float((d < 1e-4).float().mean())
        if within <= 0.995 or float(d.mean()) >= 1e-3:
            raise AssertionError(f"triangle-sharded cornell_64: {within:.4f}"
                                 f" of pixels within 1e-4, mean "
                                 f"{float(d.mean()):.3g}")
        phase('multi', f"cornell_64 over 2 px x 2 tri slots of cuda:0 "
              f"(render_frame_sharded): {within:.4f} of pixels within 1e-4 "
              f"of the one-device film (gate 0.995), mean {float(d.mean()):.3g}"
              f", bit-equal {torch.equal(film.rgb_sum, one.rgb_sum)}; "
              f"launches {counts}")

        # timed: the mesh's overhead on one card
        def timed(scene, cam, params, res, spp, mesh):
            renderer.render_frame(scene, cam, params, res, res, spp,
                                  seed=SEED, mesh=mesh)
            secs = sorted(renderer.render_frame(
                scene, cam, params, res, res, spp, seed=SEED + i,
                mesh=mesh)[1].seconds for i in (1, 2, 3))
            return secs[1], secs[0], secs[2]
        two = meshes[0][1]
        for name, scene, cam, res, spp, depth in (
                ('cornell_64', cornell, bs.cornell_camera(64, 64), 64, 32, 4),
                ('colonnade_1024', colonnade, bs.colonnade_camera(1024, 1024),
                 1024, 8, 4)):
            params = pt.PTParams(max_depth=depth)
            a = timed(scene, cam, params, res, spp, None)
            b = timed(scene, cam, params, res, spp, two)
            phase('multi', f"{name} frame_s on one slot {a[0]:.4f} (min "
                  f"{a[1]:.4f}, max {a[2]:.4f}), over 2 slots of cuda:0 "
                  f"{b[0]:.4f} (min {b[1]:.4f}, max {b[2]:.4f}): "
                  f"{b[0] / a[0]:.3f}x on {card}")

        # two TCP render servers, threads of this process on the card
        servers = [network.RenderServer(0, device=dev) for _ in range(2)]
        threads = [threading.Thread(target=srv.serve_forever, daemon=True)
                   for srv in servers]
        for t in threads:
            t.start()
        addrs = [('127.0.0.1', srv.port) for srv in servers]
        try:
            sb = bs.cornell_box()
            cam, params = bs.cornell_camera(64, 64), pt.PTParams(max_depth=4)
            local, st_local = renderer.render_frame(cornell, cam, params, 64,
                                                    64, 32, seed=SEED)
            local = local.rgb_sum.cpu().numpy()
            client = network.NetworkClient(addrs)
            client.set_scene(sb)
            lines = []
            zero_counters()
            for enc in ('native', 'native', 'rgbe8', 'jpeg'):
                t0 = time.perf_counter()
                img, w = client.render(cam, params, 64, 64, 32, seed=SEED,
                                       encoding=enc, jpeg_quality=95)
                dt = time.perf_counter() - t0
                if not (w == 32).all():
                    raise AssertionError(f"servers ({enc}): weights {w}")
                err = float(np.abs(img - local).max())
                if enc == 'native':
                    if err > 1e-5:
                        raise AssertionError(f"servers (native): max abs "
                                             f"{err} from the local film")
                    tag = f"bit-equal {np.array_equal(img, local)}"
                elif enc == 'rgbe8':
                    bound = local.max(axis=-1, keepdims=True) / 128 + 1e-6
                    if not (np.abs(img - local) <= bound).all():
                        raise AssertionError("servers (rgbe8): beyond the "
                                             "codec's error")
                    tag = "within the codec's max/128"
                else:
                    de = np.abs(np.power(np.maximum(img, 0) / 32, 1 / 2.2)
                                - np.power(np.clip(local / 32, 0, None),
                                           1 / 2.2))
                    if float(np.median(de)) >= 0.05:
                        raise AssertionError(f"servers (jpeg): median "
                                             f"display error {np.median(de)}")
                    tag = f"median display error {float(np.median(de)):.4f}"
                lines.append(f"{enc} {dt:.4f} s (max abs {err:.3g}, {tag})")
            counts = launched('cornell_64 over two servers', dense_path)
            client.close()
            phase('multi', f"cornell_64 (64^2, 32 spp, depth 4) over two "
                  f"servers on cuda:0 against the local film "
                  f"({st_local.seconds:.4f} s): " + '; '.join(lines)
                  + f" (the first with the servers' commit); launches "
                  f"{counts}")
            # where a round trip's time goes: one server alone, and the
            # two bands rendered directly (as a server renders them) in
            # turn and by two host threads at once, as the two server
            # threads do
            client = network.NetworkClient(addrs[:1])
            client.set_scene(sb)
            one_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                client.render(cam, params, 64, 64, 32, seed=SEED)
                one_s.append(time.perf_counter() - t0)
            client.close()
            bands = [(r[:, None] * 64 + np.arange(64)).reshape(-1)
                     for r in (network.active_rows(64, i, 2) for i in (0, 1))]
            scene2 = sb.commit(device=dev)

            def band(sc, pix):
                renderer._frame(sc, cam, params, 64, 64, 32, seed=SEED,
                                pixels=pix)[0].rgb_sum.cpu()

            def turns():
                band(cornell, bands[0])
                band(scene2, bands[1])

            def at_once():
                ths = [threading.Thread(target=band, args=a)
                       for a in ((cornell, bands[0]), (scene2, bands[1]))]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join()
            direct = []
            for fn in (turns, at_once):
                fn()
                ts = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                direct.append(sorted(ts)[1])
            phase('multi', f"cornell_64 round trip through one server "
                  f"{sorted(one_s)[1]:.4f} s (median of 3, the first with "
                  f"its commit); its two bands rendered directly in turn "
                  f"{direct[0]:.4f} s, by two host threads at once "
                  f"{direct[1]:.4f} s ({direct[1] / direct[0]:.2f}x) on "
                  f"{card}")
            # test_stereo's strip at 32^2 faces over the client, each face
            # against the local render
            st, ssb = ecs.parse_ecs(os.path.join(SCENES, 'test_stereo.ecs'))
            st = dataclasses.replace(st, width=32, height=32, spp=4)
            rig = cli.stereo_rigs(st)[0][1]
            origin = np.asarray(rig[0].local2world[3])
            scene = ssb.commit(device=dev, view_pos=origin, view_up=st.cam_up,
                               accel=st.accel)
            ref, _ = output.render_rig_faces(scene, st, rig)
            client = network.NetworkClient(addrs)
            client.set_scene(ssb)
            zero_counters()
            t0 = time.perf_counter()
            got, _ = output.render_rig_faces(None, st, rig, client=client,
                                             origin=origin, device=dev)
            dt = time.perf_counter() - t0
            counts = launched('test_stereo_32 over two servers',
                              bvh4_path | {'fetch'})
            client.close()
            equal = [np.array_equal(a, b) for a, b in zip(got, ref)]
            worst = min(psnr(a, b) for a, b in zip(got, ref))
            if len(got) != 12 or worst < 60.0:
                raise AssertionError(f"test_stereo_32 over two servers: "
                                     f"{len(got)} faces, worst {worst:.2f} dB")
            phase('multi', f"test_stereo strip (32^2 faces, 4 spp, depth "
                  f"{st.depth}) over two servers: {dt:.3f} s, "
                  f"{sum(equal)} of 12 faces equal to the local ones, the "
                  f"worst {worst:.2f} dB (gate 60); launches {counts}")
        finally:
            for srv in servers:
                srv.stop()
            for t in threads:
                t.join(timeout=30)

        # the subprocesses only now, after every timed section, so that
        # nothing else runs on the card while this process times: two
        # gloo ranks, and the C host through the port's shim, at once
        coord = f'127.0.0.1:{free_port()}'
        rank_out = os.path.join(tmp, 'rank_film.pt')
        script = RANK_CHILD % dict(root=ROOT, coord=coord, out=rank_out,
                                   seed=SEED)
        t_ranks = time.perf_counter()
        ranks = [subprocess.Popen([sys.executable, '-c', script, str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        shim, host = shim_and_host
        room_dir = os.path.join(tmp, 'c_host')
        os.makedirs(room_dir)
        shutil.copy(os.path.join(SCENES, 'test_room.dae'), room_dir)
        env = {k: v for k, v in os.environ.items() if k != 'YRT_DEVICE'}
        env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
        t_host = time.perf_counter()
        c_host = subprocess.Popen(
            [host, os.path.join(room_dir, 'test_room.dae'), shim, '64', '4'],
            cwd=room_dir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        # the two gloo ranks against one process's 2-slot render
        outs = [p.communicate(timeout=300) for p in ranks]
        ranks_s = time.perf_counter() - t_ranks
        for r, (p, (out, err)) in enumerate(zip(ranks, outs)):
            if p.returncode != 0:
                raise AssertionError(f"gloo rank {r} failed:\n{err[-3000:]}")
        info = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        ref = sharding.render_frame_sharded(
            cornell, bs.cornell_camera(64, 64), pt.PTParams(max_depth=4), 64,
            64, 8, sharding.make_mesh(devices=[torch.device('cuda', 0)] * 2),
            seed=SEED)
        for r in range(2):
            got = torch.load(f'{rank_out}.{r}')
            if not torch.equal(got, ref.rgb_sum.cpu()):
                raise AssertionError(f"gloo rank {r}: its film is not the "
                                     "one-process film")
            if not (info[r]['intersect_dense'] and info[r]['occluded_dense']):
                raise AssertionError(f"gloo rank {r}: {info[r]}")
        phase('multi', f"two gloo ranks (one slot of cuda:0 each, px "
              f"{info[0]['px']}), cornell 64^2, 8 spp, depth 4: both films "
              f"bit-equal to one process's 2-slot render; launches "
              f"{[{k: v for k, v in i.items() if k.endswith('dense')} for i in info]}"
              f"; {ranks_s:.1f} s for the two processes")

        # the C host through the port's shim, on the card
        out, err = c_host.communicate(timeout=600)
        host_s = time.perf_counter() - t_host
        strips = sorted(f for f in os.listdir(room_dir) if f.endswith('.jpg'))
        if (c_host.returncode != 0 or 'done: state=4' not in out
                or 'lastError=0' not in out or not strips):
            raise AssertionError(f"C host: rc {c_host.returncode}, {strips}, "
                                 f"{out[-1000:]} {err[-3000:]}")
        py_dir = os.path.join(tmp, 'py')
        os.makedirs(py_dir)
        shutil.copy(os.path.join(SCENES, 'test_room.dae'), py_dir)
        s = session.RenderSession()
        p = session.ParamsRT(size=64, depth=2, t_max_shadow_ray=120.0, spp=4,
                             ambientlight=(0.83, 0.95, 0.98),
                             eye_separation=2.5, toe_in=True,
                             zero_parallax=75.0, jpeg_quality=90,
                             watermark=False)
        zero_counters()
        if not (s.start(os.path.join(py_dir, 'test_room.dae'), p, device=dev)
                and s.wait()):
            raise AssertionError("StartRT from Python failed")
        counts = launched('StartRT of test_room_64', dense_path)
        with open(os.path.join(room_dir, strips[0]), 'rb') as f, \
                open(s.written_files[0], 'rb') as g:
            same = f.read() == g.read()
        if not same:
            raise AssertionError("C host: its strip differs from the one "
                                 "StartRT writes in this process")
        phase('multi', f"C host (examples/rt_test_host.c) through the port's "
              f"shim ({os.path.basename(shim)}) on the card: "
              f"'{out.strip().splitlines()[-1]}', {strips[0]} (test_room.dae"
              f", 64^2 faces, 4 spp) equal to StartRT's in this process "
              f"(launches {counts}); {host_s:.1f} s for the host process")
    finally:
        for p in (*ranks, c_host):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t_phase


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from yulio_raytracer_tpu_torch.api import cli, output, session
    from yulio_raytracer_tpu_torch.core import rng
    from yulio_raytracer_tpu_torch.film import accum, stereo_strip, tonemap
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    from yulio_raytracer_tpu_torch.io import ecs, image
    from yulio_raytracer_tpu_torch.ops import (binning, cuda_build, dense,
                                               grid, pairs, splitleaf,
                                               traverse, treelets, wide)
    from yulio_raytracer_tpu_torch import proto_sublane_sweep as sweep
    from yulio_raytracer_tpu_torch.native import build as native_build
    from yulio_raytracer_tpu_torch import renderer, roofline
    from yulio_raytracer_tpu_torch.roofline import (
        MOTION_FLOPS, PEAK_FLOPS, PROTO_FLOPS, SLAB_FLOPS, WOOP_FLOPS)
    from yulio_raytracer_tpu_torch.shading import lobes as lb
    from yulio_raytracer_tpu_torch.shading import textures
    from yulio_raytracer_tpu_torch.profile_frame import (
        SPHERE_MIRROR, STEREO_PARAMS, sphere_mirror_camera,
        stereo_face_camera)
    from yulio_raytracer_tpu_torch.raysets import (
        camera_rays, dense_entry_rays, frame_binary_calls,
        frame_dense_calls, frame_fetch_calls, frame_lobe_calls,
        frame_motion_calls, frame_pair_calls, frame_rng_calls,
        from_treelet_roots, hemisphere_rays, nodes8, scattered_rays,
        shadow_rays, sweep_sets)

    dev = torch.device('cuda')
    card = smi_line()
    nvcc = subprocess.run([cuda_build._nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    phase('toolchain', f"python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}; card: {card}")

    t0 = time.perf_counter()
    names = ('dense', 'wide', 'binary', 'grid', 'splitleaf', 'sweep',
             'texture', 'lobes', 'rng')
    with ThreadPoolExecutor(len(names) + 2) as pool:  # one nvcc per source
        # and the C ABI's shim (g++) and host (cc) beside them
        shim_and_host = [pool.submit(f) for f in (native_build.shim,
                                                  native_build.host)]
        libs = list(pool.map(cuda_build.build, names))
        shim_and_host = [f.result() for f in shim_and_host]
    for name, lib in zip(names, libs):
        phase('build', f"{name}.cu: "
              f"{'; '.join(ptxas_report(lib[:-3] + '.log'))}")
    phase('build', f"kernels built in {time.perf_counter() - t0:.2f} s; "
          f"the C ABI: {', '.join(map(os.path.basename, shim_and_host))}")

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
        # the same pallas_calls at width=8 (pack_nodes8 rows)
        (wide.intersect_packet8, wide.intersect_wide_plain, 'wide.cu',
         'yulio_raytracer_tpu/ops/pallas_wide.py:507', WOOP_FLOPS),
        (wide.occluded_packet8, wide.occluded_wide_plain, 'wide.cu',
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
        # F1 replaces no TPU kernel (the reference's fetch is jnp
        # gathers) and makes no ray tests: its bytes bound it
        (textures.fetch, textures._fetch, 'texture.cu', None, 0),
        # F2 likewise (the reference's lobes are jnp)
        (lb.eval_lobes, lb._eval_lobes, 'lobes.cu', None, 0),
        (lb.sample_lobes, lb._sample_lobes, 'lobes.cu', None, 0),
        # F3 likewise (the reference's RNG is jnp uint32 arithmetic); its
        # other plain versions follow the list's
        (rng.draw, rng._uniform2_plain, 'rng.cu', None, 0),
    )
    counters = [k[0] for k in kernels]
    plains = [k[1] for k in kernels] + [
        f for f in rng.PLAIN.values() if f is not rng._uniform2_plain]

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
        the tests of the kernel's schedule, is kept beside them.  The wide
        kernels' schedule tests every slot of a row, empty ones too (the
        plain versions' 'slots'), beside the function's pair tests."""
        counted = {} if tests is None or schedule else None
        res = compare(name, f, plains[counters.index(f)], args, counted,
                      exact=exact)
        made = counted if schedule else {}
        if counted and 'slots' in counted:
            made = {'pair': counted['pair'], 'box': counted['slots']}
        record(f, res, tests or counted, made)
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
    # the width-8 kernels (pallas_wide's width=8 form) on the same tree as
    # 8-wide rows, over the same sets: bit-equal to their plain versions,
    # the same t, hit mask and occlusion as K3/K4, timed beside them
    t1 = time.perf_counter()
    tables8 = (nodes8(colonnade), colonnade.tris)
    phase('kernels', f"colonnade as 8-wide rows: {tables8[0].shape[0]} "
          f"(BVH4 {colonnade.nodes4.shape[0]}), read back from its binary "
          f"rows in {time.perf_counter() - t1:.2f} s")
    wide_ms, k8_counts = {}, []
    for what, rays, f4, f8 in (
            ('camera', cam_rays, wide.intersect_packet4,
             wide.intersect_packet8),
            ('hemisphere', hemi, wide.intersect_packet4,
             wide.intersect_packet8),
            ('shadow', shadow, wide.occluded_packet4,
             wide.occluded_packet8)):
        before = results.get(f8.__name__, {}).get('ms', 0.0)
        k8_counts.append(check(f8, f'{f8.__name__} (colonnade {what})',
                               (*tables8, *rays), exact=True))
        out8, out4 = f8(*tables8, *rays), f4(*tables, *rays)
        same = (torch.equal(out8, out4) if f8 is wide.occluded_packet8 else
                torch.equal(out8.t, out4.t)
                and torch.equal(out8.tri >= 0, out4.tri >= 0))
        if not same:
            raise AssertionError(f"width 8 and BVH4 disagree on the "
                                 f"colonnade's {what} rays")
        wide_ms[what] = (results[f8.__name__]['ms'] - before,
                         cuda_ms(lambda: f4(*tables, *rays)))
    stack_depth("BVH8 (the same STACK; a pop pushes up to 7)", (
        ('intersect_packet8 (camera + hemisphere)', k8_counts[:2]),
        ('occluded_packet8 (shadow)', k8_counts[2:])))
    phase('kernels', "width 8 vs BVH4 on the colonnade (median of 5; the "
          "same t, hit mask and occlusion): " + ', '.join(
              f"{what} {a:.3f} vs {b:.3f} ms (BVH4 / width 8 {b / a:.2f})"
              for what, (a, b) in wide_ms.items()) + f"; {card}")
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
    # the staged walks (K5/K6 a stage, caps at 0.07 and 0.3 of the box's
    # diagonal, then uncapped) on the hemisphere and shadow rays: bit-equal
    # to their plain versions (one run each: they are no kernels of their
    # own, so their plain time is not wanted), the same t, hit mask and
    # occlusion as one walk, timed against one K5/K6 walk
    staged_ms = {}
    for what, rays, staged, plain, one in (
            ('hemisphere', hemi, traverse.intersect_packet_staged,
             traverse.intersect_staged_plain, traverse.intersect_packet),
            ('shadow', shadow, traverse.occluded_packet_staged,
             traverse.occluded_staged_plain, traverse.occluded_packet)):
        got = staged(*tables2, *rays, lo, hi)
        ref, single = plain(*tables2, *rays, lo, hi), one(*tables2, *rays)
        torch.cuda.synchronize()
        if staged is traverse.occluded_packet_staged:
            exact, same = torch.equal(got, ref), torch.equal(got, single)
        else:
            exact = all(torch.equal(a, b) for a, b in zip(got, ref))
            same = (torch.equal(got.t, single.t)
                    and torch.equal(got.tri >= 0, single.tri >= 0))
        if not (exact and same):
            raise AssertionError(f"{staged.__name__} on the colonnade's "
                                 f"{what} rays: bit-equal to its plain "
                                 f"version {exact}, equal to one walk {same}")
        staged_ms[what] = (cuda_ms(lambda: staged(*tables2, *rays, lo, hi)),
                           cuda_ms(lambda: one(*tables2, *rays)))
    del got, ref, single
    phase('kernels', "staged walks on the colonnade, bit-equal to their "
          "plain versions, the same t, hit mask and occlusion as one walk "
          "(median of 5): " + ', '.join(
              f"{what} ({rays[0].shape[0]} rays) staged {a:.3f} vs "
              f"{'K5' if what != 'shadow' else 'K6'} {b:.3f} ms"
              for (what, (a, b)), rays in zip(staged_ms.items(),
                                              (hemi, shadow)))
          + f"; {card}")
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
    # accel='bvh2' commits them) under K5/K6, and the tree as 8-wide rows
    # under the width-8 kernels' *_slots forms, on the same rays
    big8 = nodes8(big)
    if float(big8.reshape(-1, 8)[:, 7].max()) < wide.SLOTS_MIN:
        raise AssertionError("the colonnade's 8-wide rows at leaf 512 hold "
                             "no leaf for the *_slots forms")
    for what, rays, fs in (
            ('camera', big_cam, (wide.intersect_packet4,
                                 traverse.intersect_packet,
                                 wide.intersect_packet8)),
            ('hemisphere', big_hemi, (wide.intersect_packet4,
                                      traverse.intersect_packet,
                                      wide.intersect_packet8)),
            ('shadow', shadow_rays(big, dg, eps, big_hit.valid, gen512, dev),
             (wide.occluded_packet4, traverse.occluded_packet,
              wide.occluded_packet8))):
        for f, table in zip(fs, (big.nodes4, big.nodes, big8)):
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
        acc['pass_bound_ms'] = roofline.bound(
            acc['pass_bytes'],
            dense.staged_flops({k: acc[f'pass_{k}_tests'] for k in (
                'pair', 'stage2', 'stage3')}))[0]
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
    k3, k4, k5, k6, k8, k9, fx = (ix[n] for n in (
        'intersect_packet4', 'occluded_packet4', 'intersect_packet',
        'occluded_packet', 'intersect_pairs_raw', 'occluded_pairs',
        'fetch'))
    ran = {counters[k].__name__: counters[k].launches
           for k in (k3, k4, k5, k6, k8, k9)}
    phase('kernels', f"sponza's sets bit-equal to the plain versions "
          f"({s_calls} recorded calls of the grid frame among them); "
          f"launches {ran}")
    if not all(ran.values()):
        raise AssertionError(f"sponza's sets did not launch every kernel "
                             f"of its golden paths: {ran}")
    del s_cam, s_hemi, s_shadow, s_hit, dg, eps
    # F1 on the slots of sponza_like's bounces at the main path's size:
    # the fetch calls of bounces 0 and 1 of a 1024^2, 4 spp frame (2^22
    # hits x 4 lobe slots a call, the hits' (R, 2) uv expanded over the
    # slots), bit-equal to the plain fetch on sponza's own atlas and on
    # one of sponza.frame_1024's size (its 24 maps of 1024^2, 402.7 MB,
    # here random texels, with sponza's filters and inverts); timed on
    # the large atlas, one launch a call
    zero_counters()
    f_calls = frame_fetch_calls(sponza, bs.sponza_like_camera(1024, 1024),
                                1024, 1024, spp=4, seed=SEED)
    if [tuple(c['args'][1].shape) for c in f_calls] != [(2**22, 4)] * 2 or (
            textures.fetch.launches != 2):
        raise AssertionError(f"sponza's fetch calls: "
                             f"{[tuple(c['args'][1].shape) for c in f_calls]}"
                             f", {textures.fetch.launches} launches, not two"
                             f" of 2^22 x 4 slots, one launch each")
    own = f_calls[0]['args'][0]
    n_maps, side = 24, 1024
    if own['off'].numel() > n_maps:
        raise AssertionError(f"sponza_like binds {own['off'].numel()} "
                             f"textures, more than {n_maps}")
    pad = n_maps - own['off'].numel()
    maps = torch.full((n_maps,), side, dtype=torch.int32, device=dev)
    large = {'data': torch.rand((n_maps * side * side, 4), generator=gen,
                                device=dev),
             'off': torch.arange(n_maps, dtype=torch.int32, device=dev)
             * side * side, 'w': maps, 'h': maps.clone(),
             'filter': torch.cat([own['filter'], torch.full(
                 (pad,), textures.FILTER_BILINEAR, dtype=torch.int32,
                 device=dev)]),
             'invert': torch.cat([own['invert'], torch.zeros(
                 pad, dtype=torch.int32, device=dev)])}
    fetch_res = {'calls': 0, 'slots': 0, 'texel_slots': 0, 'ms': 0.0,
                 'plain_ms': 0.0, 'bytes': 0, 'atlas_bytes': nbytes(
                     large['data'])}
    zero_counters()
    for atlas, table in (('its own atlas', own), (
            f"{n_maps} maps of {side}^2", large)):
        for n, c in enumerate(f_calls):
            tid, uv = c['args'][1:]
            launches = textures.fetch.launches
            got = textures.fetch(table, tid, uv)
            if textures.fetch.launches != launches + 1:
                raise AssertionError("F1: a fetch call was not one launch")
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            plain = textures._fetch(table, tid, uv)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            if not torch.equal(got, plain):
                raise AssertionError(f"F1 on sponza's call {n + 1} over "
                                     f"{atlas}: not bit-equal to the plain "
                                     "fetch")
            del got, plain
            ms = cuda_ms(lambda: textures.fetch(table, tid, uv), reps=20)
            moved, texel = fetch_bytes(table, tid)
            bound_ms = roofline.bound(moved, 0)[0]
            phase('kernels', f"fetch (sponza 1024^2 frame, bounce {n}, "
                  f"{atlas}, {nbytes(table['data']) / 1e6:.1f} MB): "
                  f"{tid.numel()} slots, {texel} with an id >= 0, bit-equal "
                  f"to the plain fetch; kernel {ms:.3f} ms (median of 20), "
                  f"plain {plain_ms:.3f} ms; {moved} bytes, bound "
                  f"{bound_ms:.4f} ms: {bound_ms / ms:.2%} of it; {card}")
            if table is large:
                for key, v in (('calls', 1), ('slots', tid.numel()),
                               ('texel_slots', texel), ('ms', ms),
                               ('plain_ms', plain_ms), ('bytes', moved)):
                    fetch_res[key] += v
    ran = {f.__name__: f.launches for f in counters if f.launches}
    if set(ran) != {'fetch'} or any(f.cuda_calls for f in plains
                                    if f is not textures._fetch):
        raise AssertionError(f"sponza's fetch calls launched {ran}, not F1 "
                             f"alone")
    results['fetch'] = fetch_res
    del f_calls, own, large
    # F2 on every lobe call of a sponza_like 1024^2, 8 spp frame of depth
    # 4 (sponza.frame_1024's traffic: one pass of 2^23 hits a bounce, the
    # 6 triangle lights in one group): each bounce's eval and sample
    # through the kernels' wrappers and through the plain versions on the
    # card, bit-equal in every output and to the frame's own result, one
    # launch a call; timed (median of 10), bound by bytes (lobe_bytes)
    zero_counters()
    l_calls = frame_lobe_calls(sponza, bs.sponza_like_camera(1024, 1024),
                               1024, 1024, spp=8, max_depth=4, seed=SEED)
    shapes = [(c['kernel'], c['args']['lobes']['type'].shape[0])
              for c in l_calls]
    if shapes != [('eval_lobes', 2**23), ('sample_lobes', 2**23)] * 4 or (
            lb.eval_lobes.launches, lb.sample_lobes.launches) != (4, 4) or (
            lb._eval_lobes.cuda_calls or lb._sample_lobes.cuda_calls):
        raise AssertionError(f"sponza's lobe calls: {shapes}, launches "
                             f"{lb.eval_lobes.launches} + "
                             f"{lb.sample_lobes.launches}, not an eval and "
                             f"a sample of 2^23 hits a bounce, 4 bounces, "
                             f"one launch each")
    zero_counters()
    for n, c in enumerate(l_calls):
        a, name = c['args'], c['kernel']
        f, plain_f = ((lb.eval_lobes, lb._eval_lobes) if name == 'eval_lobes'
                      else (lb.sample_lobes, lb._sample_lobes))
        launches = f.launches
        got = f(**a)
        if f.launches != launches + 1:
            raise AssertionError(f"F2: a {name} call was not one launch")
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        plain = plain_f(**a)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        outs = [x if isinstance(x, dict) else {'brdf': x}
                for x in (got, c['out'], plain)]
        differ = [k for k in outs[2] if not (
            torch.equal(outs[0][k], outs[2][k])
            and torch.equal(outs[1][k], outs[2][k]))]
        if differ:
            raise AssertionError(f"F2 on sponza's {name} of bounce {n // 2}:"
                                 f" {differ} not bit-equal to the plain "
                                 f"version's")
        del got, plain, outs
        ms = cuda_ms(lambda: f(**a), reps=10)
        moved, lanes = lobe_bytes(name, a, lb)
        bound_ms = roofline.bound(moved, 0)[0]
        phase('kernels', f"{name} (sponza_like 1024^2 frame, bounce "
              f"{n // 2}, {lanes} lanes): bit-equal to the plain version "
              f"and to the frame's own result; kernel {ms:.3f} ms (median "
              f"of 10), plain {plain_ms:.3f} ms; {moved} bytes, bound "
              f"{bound_ms:.4f} ms: {bound_ms / ms:.2%} of it; {card}")
        acc = results.setdefault(name, {'calls': 0, 'lanes': 0, 'ms': 0.0,
                                        'plain_ms': 0.0, 'bytes': 0})
        for key, v in (('calls', 1), ('lanes', lanes), ('ms', ms),
                       ('plain_ms', plain_ms), ('bytes', moved)):
            acc[key] += v
    ran = {f.__name__: f.launches for f in counters if f.launches}
    if set(ran) != F2 or (lb._eval_lobes.cuda_calls,
                          lb._sample_lobes.cuda_calls) != (4, 4) or any(
            f.cuda_calls for f in plains
            if f not in (lb._eval_lobes, lb._sample_lobes)):
        raise AssertionError(f"sponza's lobe calls launched {ran}, not F2 "
                             f"alone, or another plain version ran")
    del l_calls
    # F3 on every draw of the same frame (one pass of 2^23 lanes: the
    # camera samples, then each bounce's one NEE draw over the 6 lights'
    # dims and the scatter's 2D and 1D samples), through the kernel's
    # wrapper and through the plain versions on the card, bit-equal to
    # both and to the frame's own result, one launch a call; timed
    # (median of 10), bound by bytes (rng_bytes)
    zero_counters()
    r_calls = frame_rng_calls(sponza, bs.sponza_like_camera(1024, 1024),
                              1024, 1024, spp=8, max_depth=4, seed=SEED)
    shapes = [(c['args'][0], tuple(c['out'].shape)) for c in r_calls]
    frame = [(0, (2**23,)), (2, (2**23, 2)), (2, (2**23, 2))] + [
        (2, (6, 2**23, 2)), (2, (2**23, 2)), (1, (2**23,))] * 4
    if shapes != frame or rng.draw.launches != len(frame) or any(
            f.cuda_calls for f in plains):
        raise AssertionError(f"sponza's draws: {shapes}, {rng.draw.launches}"
                             f" launches; not the camera samples and 4 "
                             f"bounces of an NEE and a scatter of 2^23 "
                             f"lanes, one launch each")
    zero_counters()
    for n, c in enumerate(r_calls):
        kind, *args = c['args']
        launches = rng.draw.launches
        got = rng.draw(kind, *args)
        if rng.draw.launches != launches + 1:
            raise AssertionError("F3: a draw was not one launch")
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        plain = rng.PLAIN[kind](*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        if not (torch.equal(got, plain) and torch.equal(c['out'], plain)):
            raise AssertionError(f"F3 on sponza's draw {n + 1} (kind {kind}"
                                 f", {tuple(plain.shape)}): not bit-equal to"
                                 f" the plain version's")
        del got, plain
        ms = cuda_ms(lambda: rng.draw(kind, *args), reps=10)
        moved, draws = rng_bytes(kind, args)
        bound_ms = roofline.bound(moved, 0)[0]
        phase('kernels', f"draw {n + 1} of {len(r_calls)} (sponza_like "
              f"1024^2 frame, kind {kind}, out {tuple(c['out'].shape)}, "
              f"{draws} draws): bit-equal to the plain version and to the "
              f"frame's own result; kernel {ms:.3f} ms (median of 10), "
              f"plain {plain_ms:.3f} ms; {moved} bytes, bound "
              f"{bound_ms:.4f} ms: {bound_ms / ms:.2%} of it; {card}")
        acc = results.setdefault('draw', {'calls': 0, 'lanes': 0, 'ms': 0.0,
                                          'plain_ms': 0.0, 'bytes': 0})
        for key, v in (('calls', 1), ('lanes', draws), ('ms', ms),
                       ('plain_ms', plain_ms), ('bytes', moved)):
            acc[key] += v
    ran = {f.__name__: f.launches for f in counters if f.launches}
    if set(ran) != F3 or any(f.cuda_calls for f in plains
                             if f not in rng.PLAIN.values()):
        raise AssertionError(f"sponza's draws launched {ran}, not F3 alone, "
                             f"or another plain version ran")
    del r_calls
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
    # test_stereo.ecs, the production strip's scene (14,704 triangles, the
    # commit's default leaf): K3/K4 on its tables, bit-equal, over the
    # 800^2 camera rays of the CLI rig's face 2 (the back face, left eye:
    # the face with the most hits), the hemisphere rays from their hits
    # and the dome's shadow rays from those hits
    stereo_st, stereo_sb = ecs.parse_ecs(os.path.join(SCENES,
                                                      'test_stereo.ecs'))
    stereo_rig = cli.stereo_rigs(stereo_st)[0][1]
    stereo = stereo_sb.commit(
        device=dev, view_pos=np.asarray(stereo_rig[0].local2world[3]),
        view_up=stereo_st.cam_up, accel=stereo_st.accel)
    gen_s = torch.Generator(device=dev).manual_seed(SEED)
    org, dirn, _ = camera_rays(stereo, stereo_rig[2], stereo_st.width,
                               stereo_st.height, dev, SEED)
    zeros = torch.zeros(org.shape[0], device=dev)
    t_cam = (org, dirn, zeros, torch.full_like(zeros, float('inf')))
    t_hit = wide.intersect_packet4(stereo.nodes4, stereo.tris, *t_cam)
    *t_hemi, dg, eps = hemisphere_rays(stereo, org, dirn, t_hit, gen_s, dev)
    back = (dg['Ng'] * dirn).sum(-1, keepdim=True) > 0
    t_shadow = shadow_rays(stereo, dg, eps, t_hit.valid, gen_s, dev,
                           torch.where(back, -dg['Ns'], dg['Ns']))
    phase('kernels', f"test_stereo: {stereo.num_triangles} triangles, accel "
          f"{stereo.accel}, {stereo.nodes4.shape[0]} BVH4 nodes, lights "
          f"{[l['kind'] for l in stereo.lights]}; "
          f"{int(t_hit.valid.sum())} of {org.shape[0]} camera rays of face "
          "2 hit")
    zero_counters()
    t_stack = []
    for what, rays, f in (('camera', t_cam, wide.intersect_packet4),
                          ('hemisphere', t_hemi, wide.intersect_packet4),
                          ('dome shadow', t_shadow, wide.occluded_packet4)):
        counts = check(f, f'{f.__name__} (test_stereo {what})',
                       (stereo.nodes4, stereo.tris, *rays), exact=True)
        t_stack.append((f'{f.__name__} ({what})', [counts]))
    stack_depth("BVH4 on test_stereo", t_stack)
    ran = {f.__name__: f.launches for f in counters if f.launches}
    phase('kernels', f"test_stereo's sets bit-equal to the plain versions; "
          f"launches {ran}")
    if set(ran) != {'intersect_packet4', 'occluded_packet4'}:
        raise AssertionError(f"test_stereo's sets did not launch K3 and K4 "
                             f"alone: {ran}")
    del t_cam, t_hemi, t_shadow, t_hit, dg, eps
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
         (k3, k4, fx)),
        ('sponza_64', sponza, bs.sponza_like_camera(64, 64), 2, 4, 'grid',
         (k3, k4, k5, k6, k8, k9, fx)),
        # glass and Beer media under the ambient dome, depth 8 past the
        # roulette start ('auto' compacts), at the commit's default leaf
        ('sphere_glass_64', bs.sphere_glass().commit(device=dev),
         bs.sphere_glass_camera(64, 64), 8, 32, 'morton', (k3, k4, fx)),
    )
    le, ls, dr = ix['eval_lobes'], ix['sample_lobes'], ix['draw']
    for name, scene, cam, depth, spp, binning, used in goldens:
        used = (*used, le, ls, dr)  # and F2 and F3: every golden shades
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
            or set(counts) != {'intersect_packet4', 'occluded_packet4',
                               'fetch', *F2, *F3}
            or any(f.cuda_calls for f in plains)):
        raise AssertionError(f"sphere_mirror_64: PSNR {db:.2f}, launches "
                             f"{counts}: not K3/K4, F1, F2 and F3 alone, or "
                             "disagrees with the CPU")
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
    # the 8-wide walks' entry points (intersect_packet4 / occluded_packet4
    # at width=8, as the reference's bench_wide_ab.py calls them) and the
    # staged walks', on the 1M hemisphere and the shadow rays: their hits
    # are K5's, their occlusion K6's
    k6_occ = traverse.occluded_packet(*tables2, *shadow)
    zero_counters()
    outs = (wide.intersect_packet4(*tables8, *hemi, width=8),
            traverse.intersect_packet_staged(*tables2, *hemi, lo, hi),
            wide.occluded_packet4(*tables8, *shadow, width=8),
            traverse.occluded_packet_staged(*tables2, *shadow, lo, hi))
    ran = [f.launches for f in counters]
    counts = {f.__name__: n for f, n in zip(counters, ran) if n}
    same = (all(torch.equal(h.t, k5_hits[0].t)
                and torch.equal(h.tri >= 0, k5_hits[0].tri >= 0)
                for h in outs[:2])
            and all(torch.equal(o, k6_occ) for o in outs[2:]))
    phase('golden', f"width-8 and staged entry points on the colonnade's "
          f"{hemi[0].shape[0]} hemisphere and {shadow[0].shape[0]} shadow "
          f"rays: t and hit mask equal to K5's, occlusion to K6's: {same}, "
          f"kernel launches {counts}")
    if not same or counts != {'intersect_packet8': 1, 'occluded_packet8': 1,
                              'intersect_packet': 3,
                              'occluded_packet': 3} or any(
            f.cuda_calls for f in plains):
        raise AssertionError("the width-8 and staged entry points did not "
                             "run their kernels alone, or disagree with "
                             "K5/K6")
    main_launches = [a + b for a, b in zip(main_launches, ran)]
    del outs, k6_occ

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

    def timed_modes(name, scene, cam, params, res, spp, desc, want):
        """A frame past the roulette start with compaction 'off' and
        'auto', 1 warm-up and 3 frames each: frame_s, Mrays/s, peak
        memory, launches per frame (the kernels `want` alone), the 'auto'
        passes'
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
            if set(per_frame) != want:
                raise AssertionError(f"{name} ({how}) ran other kernels "
                                     f"than {sorted(want)}: {per_frame}")
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
    # 10 past the roulette start, the dome cap 120, one pass of 2 x 1536^2
    # rays
    timed_modes('stereo_face_1536', colonnade, stereo_face_camera(1536, 1536),
                pt.PTParams(**STEREO_PARAMS), 1536, 2,
                "1536^2, 2 spp, depth 10, t_max_shadow_ray 120",
                {'intersect_packet4', 'occluded_packet4', *F2, *F3})
    # sphere_glass at its camera's own size with the golden's spp and
    # depth: the ambient dome's NEE and escaped rays, glass chains past the
    # roulette start; one pass of 2^23 rays
    timed_modes('sphere_glass_512', glass, bs.sphere_glass_camera(512, 512),
                pt.PTParams(max_depth=8), 512, 32,
                "512^2, 32 spp, depth 8, leaf 32",
                {'intersect_packet4', 'occluded_packet4', 'fetch', *F2,
                 *F3})

    # ---- 6. the production output path -----------------------------------
    os.makedirs(OUT, exist_ok=True)

    def launched(what, want):
        """The kernels launched since zero_counters(), held to `want` (the
        path's kernels, each launched); added to the main path's
        launches."""
        ran = [f.launches for f in counters]
        counts = {f.__name__: n for f, n in zip(counters, ran) if n}
        if set(counts) != set(want) or any(f.cuda_calls for f in plains):
            raise AssertionError(f"{what}: launches {counts}, not each of "
                                 f"{sorted(want)} alone, or a plain version "
                                 "ran on CUDA tensors")
        for i, n in enumerate(ran):
            main_launches[i] += n
        return counts

    def held(what, img, ref, gate=PSNR_MIN):
        """img (the card's) against ref (the port's CPU result), finite,
        of ref's shape, >= gate dB; returns its line."""
        if img.shape != ref.shape or not np.isfinite(img).all():
            raise AssertionError(f"{what}: image {img.shape} not finite or "
                                 f"not of the CPU's shape {ref.shape}")
        db = psnr(img, ref)
        if db < gate:
            raise AssertionError(f"{what}: PSNR {db:.2f} < {gate}")
        return (f"PSNR {db:.2f} dB (trimmed-1% {trimmed_psnr(img, ref):.2f})"
                f" vs the port's CPU render (gate {gate})")

    def rig_strip(st, sb, rig, name, device, wm, stage_cb=None):
        """One rig's strip as render_stereo makes it: the scene committed
        at the rig's origin, its 12 faces (render_rig_faces), the strip;
        returns (strip, per-face FrameStats)."""
        scene = sb.commit(device=device,
                          view_pos=np.asarray(rig[0].local2world[3]),
                          view_up=st.cam_up, accel=st.accel)
        faces, fstats = output.render_rig_faces(scene, st, rig, name, wm,
                                                stage_cb=stage_cb)
        if len(faces) != 12:
            raise AssertionError(f"{name}: {len(faces)} faces rendered")
        return stereo_strip.assemble_strip(faces), fstats

    # the production strip at its own size: test_stereo.ecs (800^2 faces,
    # 64 spp, depth 10, the dome cap 120, the ambient dome, the b-spline
    # filter), one rig at the CLI camera as cli._stereo_from_settings
    # builds it, written as .ppm (the card's machine writes no .jpg)
    peaks = []

    def face_peak(stage, total):
        if stage:
            peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    wm = stereo_strip.load_watermark() if stereo_st.watermark else None
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strip, fstats = rig_strip(stereo_st, stereo_sb, stereo_rig, 'view', dev,
                              wm, face_peak)
    strip_s = time.perf_counter() - t0
    peaks.append(torch.cuda.max_memory_allocated())
    counts = launched('test_stereo strip', {'intersect_packet4',
                                            'occluded_packet4', 'fetch',
                                            *F2, *F3})
    strip_path = os.path.join(OUT, 'test_stereo_view.ppm')
    image.store(strip_path, strip)
    size = max(stereo_st.width, stereo_st.height)
    if strip.shape != (size, 12 * size, 3) or not np.isfinite(strip).all():
        raise AssertionError(f"test_stereo strip: {strip.shape}, not a "
                             "finite 12-face strip")
    cam_rays = 12 * size * size * stereo_st.spp
    rays = sum(st.num_rays for st in fstats)
    phase('output', f"test_stereo strip ({size}^2 faces, {stereo_st.spp} "
          f"spp, depth {stereo_st.depth}, t_max_shadow_ray "
          f"{stereo_st.t_max_shadow_ray}, filter {stereo_st.pixel_filter}, "
          f"accel {stereo.accel}): {strip_s:.3f} s for 12 faces, "
          f"{cam_rays} camera rays ({cam_rays / strip_s / 1e6:.2f} M/s), "
          f"{rays / 1e6:.1f} Mrays ({rays / strip_s / 1e6:.2f} Mrays/s); "
          f"launches {counts}; written to {strip_path} on {card}")
    for i, (st, peak) in enumerate(zip(fstats, peaks)):
        phase('output', f"test_stereo face {i} ({stereo_strip.FACE_NAMES[i % 6]}"
              f", {'left' if i < 6 else 'right'} eye): {st.seconds:.3f} s, "
              f"{st.num_rays / 1e6:.1f} Mrays, {st.mrps:.2f} Mrays/s, peak "
              f"mem {peak / 2**30:.2f} GiB")

    # the same strip at reduced faces (32^2, 4 spp, depth 10, the
    # watermark), and test_room.dae as StartRT stages it (session defaults
    # but 64^2 faces and 4 spp: toe-in, the cap 120 x the scene scale, the
    # sky ambient, the billboard committed at the rig), on the card against
    # the port's CPU
    small = (dataclasses.replace(stereo_st, width=32, height=32, spp=4,
                                 watermark=True),
             stereo_sb, stereo_rig, 'view',
             {'intersect_packet4', 'occluded_packet4', 'fetch', *F2, *F3})
    room_st, room_sb, room_rigs = session.collada_job(
        os.path.join(SCENES, 'test_room.dae'), session.ParamsRT(size=64,
                                                                spp=4))
    room = (room_st, room_sb, room_rigs[0][1], room_rigs[0][0],
            {'intersect_dense', 'occluded_dense', *F2, *F3})
    for label, (st, sb, rig, name, want) in (('test_stereo_32', small),
                                             ('test_room_64', room)):
        wm = stereo_strip.load_watermark() if st.watermark else None
        zero_counters()
        got, _ = rig_strip(st, sb, rig, name, dev, wm)
        counts = launched(label, want)
        ref, _ = rig_strip(st, sb, rig, name, 'cpu', wm)
        phase('output', f"{label} strip ({st.width}^2 faces, {st.spp} spp, "
              f"depth {st.depth}, t_max_shadow_ray {st.t_max_shadow_ray}, "
              f"watermark {st.watermark}): " + held(label, got, ref)
              + f", kernel launches {counts}")

    # the CLI's mono mode on the card and on the CPU; .ppm is written
    # natively
    cornell_ecs = os.path.join(SCENES, 'cornell_box.ecs')
    outs = [os.path.join(OUT, n) for n in ('cli_cornell.ppm',
                                           'cli_cornell_cpu.ppm')]
    zero_counters()
    if cli.main(['-c', cornell_ecs, '-size', '64', '64', '-o', outs[0]]):
        raise AssertionError("cli.main on the card failed")
    counts = launched('cli cornell', {'intersect_dense', 'occluded_dense',
                                      *F2, *F3})
    if cli.main(['-c', cornell_ecs, '-size', '64', '64', '-o', outs[1]],
                device='cpu'):
        raise AssertionError("cli.main on the CPU failed")
    phase('output', f"cli.main -c cornell_box.ecs -size 64 64 -o "
          f"{outs[0]}: " + held('cli cornell', image.load(outs[0]),
                               image.load(outs[1]))
          + f" ({outs[1]}), kernel launches {counts}")

    # C6: a scene of sphere_mirror.xml's HDRI light alone, no geometry,
    # through the mono entry point
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(SCENES, 'lines.ppm'), tmp)
        xml = os.path.join(tmp, 'hdri_only.xml')
        with open(xml, 'w') as f:
            f.write('<?xml version="1.0"?>\n<scene><Group><HDRILight>'
                    '<AffineSpace>1 0 0 0 0 1 0 0 0 0 1 0</AffineSpace>'
                    '<L>2.0 1.5 1.2</L><image>"lines.ppm"</image>'
                    '</HDRILight></Group></scene>\n')
        hst, hsb = ecs.parse_ecs(os.path.join(SCENES, 'sphere_view.ecs'))
        ecs.load_scene_file(xml, hst, hsb)
    hst.width = hst.height = 64
    hst.spp, hst.depth = 4, 3
    zero_counters()
    hdri = hsb.commit(device=dev)
    img, hstats = output.render_mono(hdri, hst, '')
    ran = {f.__name__: f.launches for f in counters if f.launches}
    ref, _ = output.render_mono(hsb.commit(device='cpu'), hst, '',
                                device='cpu')
    phase('output', f"hdri_only_64 (no geometry, accel {hdri.accel}, depth "
          f"3, 4 spp): " + held('hdri_only_64', img, ref)
          + f", {hstats.num_rays:.0f} rays, kernel launches {ran}")

    # ---- 7. the single-device remainder ----------------------------------
    from yulio_raytracer_tpu_torch.api import display, viewer
    from yulio_raytracer_tpu_torch.integrator import debugrenderer
    from yulio_raytracer_tpu_torch.profile_frame import kernel_of
    from yulio_raytracer_tpu_torch.sampling import precomputed
    from yulio_raytracer_tpu_torch.utils import profiling, regression
    t_interactive = time.perf_counter()
    # a path-traced frame's kernels: the walk's, F2 and F3
    bvh4_path = {'intersect_packet4', 'occluded_packet4', *F2, *F3}
    dense_path = {'intersect_dense', 'occluded_dense', *F2, *F3}

    def timed_frames(what, scene, cam, params, res, spp, want, **kw):
        """A frame to warm up, then 3 with the counters zeroed; returns
        (median frame_s, median Mrays/s, the line of both with min and
        max, rays and launches a frame, the first timed frame's film)."""
        renderer.render_frame(scene, cam, params, res, res, spp=spp,
                              seed=SEED, **kw)
        zero_counters()
        films, runs = zip(*(renderer.render_frame(
            scene, cam, params, res, res, spp=spp, seed=SEED + i, **kw)
            for i in (1, 2, 3)))
        counts = launched(what, want)
        secs = sorted(s.seconds for s in runs)
        mrps = sorted(s.mrps for s in runs)
        line = (f"frame_s {secs[1]:.4f} (min {secs[0]:.4f}, max "
                f"{secs[2]:.4f}), {mrps[1]:.2f} Mrays/s (min {mrps[0]:.2f}, "
                f"max {mrps[2]:.2f}), {runs[0].num_rays / 1e6:.2f} "
                f"Mrays/frame, launches per frame "
                f"{ {k: n / len(runs) for k, n in counts.items()} }")
        return secs[1], mrps[1], line, films[0]

    # the three quality trees of the colonnade (leaf 32) at colonnade_1024's
    # config; K3/K4 held on the spatial-split tree's duplicated references
    col_cam = bs.colonnade_camera(1024, 1024)
    quality_mrps = {}
    for q in ('normal', 'high', 'high-spatial'):
        scene, cs = profiling.committed_stats(bs.colonnade(), device=dev,
                                              leaf_size=32, quality=q)
        fs, mrps, line, _ = timed_frames(f'colonnade_1024 ({q})', scene,
                                         col_cam, pt.PTParams(max_depth=4),
                                         1024, 8, bvh4_path)
        quality_mrps[q] = mrps
        phase('interactive', f"colonnade_1024 quality {q!r}: "
              f"{cs.triangles} triangles, {scene.bvh_refs} references "
              f"({scene.bvh_refs / cs.triangles:.4f} a triangle), "
              f"{cs.bvh_nodes} binary nodes, {scene.nodes4.shape[0]} BVH4 "
              f"nodes, accel {scene.accel}; BVH built in "
              f"{cs.bvh_seconds:.3f} s, commit {cs.total_seconds:.2f} s; "
              f"1024^2, 8 spp, depth 4: {line} on {card}")
        if q == 'high-spatial':
            org, dirn, _ = camera_rays(scene, bs.colonnade_camera(256, 256),
                                       256, 256, dev, SEED)
            z = torch.zeros(org.shape[0], device=dev)
            cam_rays = (org, dirn, z, torch.full_like(z, float('inf')))
            hit = wide.intersect_packet4(scene.nodes4, scene.tris, *cam_rays)
            *hemi, dg, eps = hemisphere_rays(scene, org, dirn, hit, gen, dev)
            shadow = shadow_rays(scene, dg, eps, hit.valid, gen, dev)
            for what, rays, f in (
                    ('camera', cam_rays, wide.intersect_packet4),
                    ('hemisphere', hemi, wide.intersect_packet4),
                    ('shadow', shadow, wide.occluded_packet4)):
                check(f, f'{f.__name__} (colonnade high-spatial {what})',
                      (scene.nodes4, scene.tris, *rays), exact=True)
            del cam_rays, hemi, shadow, hit, dg, eps
        del scene

    # the precomputed sampler: cornell_512 with the b-spline filter, the
    # host's table build apart; the stereo face's films of compaction off
    # and auto; 64^2 cornell and motion field against the port's CPU
    t0 = time.perf_counter()
    precomputed.build_tables(32, 0, num_1d=4, num_2d=5,
                             pixel_filter='bspline')
    tables_s = time.perf_counter() - t0
    fs, mrps, line, _ = timed_frames(
        'cornell_512 (precomputed)', cornell, bs.cornell_camera(512, 512),
        pt.PTParams(max_depth=4), 512, 32, dense_path - F3,
        sampler='precomputed', pixel_filter='bspline')
    phase('interactive', f"cornell_512 (512^2, 32 spp, depth 4, b-spline, "
          f"sampler precomputed): {line}; build_tables (64 sets x 32 "
          f"samples, 4 1D and 5 2D dims) {tables_s:.3f} s on the host, in "
          f"every frame's seconds, on {card}")
    films = {}
    for how in ('off', 'auto'):
        fs, mrps, line, film = timed_frames(
            f'stereo_face_1536 (precomputed, {how})', colonnade,
            stereo_face_camera(1536, 1536), pt.PTParams(**STEREO_PARAMS),
            1536, 2, bvh4_path, compaction=how, sampler='precomputed')
        films[how] = film.rgb_sum
        phase('interactive', f"stereo_face_1536 (1536^2, 2 spp, depth 10, "
              f"sampler precomputed, compaction {how}): {line} on {card}")
    if not torch.equal(films['off'], films['auto']):
        raise AssertionError("stereo_face_1536 (precomputed): the films of "
                             "compaction off and auto differ")
    phase('interactive', "stereo_face_1536 (precomputed): the films of "
          "compaction off and auto bit-equal")
    del films
    for name, sb, camf, want, spp, depth in (
            ('cornell_64', bs.cornell_box(), bs.cornell_camera,
             dense_path - F3, 2, 3),
            ('motion_field_64', bs.motion_field(), bs.motion_field_camera,
             {'intersect_packet_mb', 'occluded_packet_mb', *F2}, 2, 2)):
        imgs = []
        for device in (dev, 'cpu'):
            zero_counters()
            film, st = renderer.render_frame(
                sb.commit(device=device), camf(64, 64),
                pt.PTParams(max_depth=depth), 64, 64, spp=spp, seed=SEED,
                sampler='precomputed')
            if device == dev:
                counts = launched(f'{name} (precomputed)', want)
            imgs.append(accum.resolve(film).cpu().numpy())
        phase('interactive', f"{name} (sampler precomputed, {spp} spp, "
              f"depth {depth}): " + held(name, *imgs, gate=60.0)
              + f", launches {counts}")

    # the debug renderer on the colonnade, K3's device time in it profiled
    dparams = debugrenderer.DebugParams(max_depth=4, spp=8)
    debugrenderer.render(colonnade, col_cam, dparams, 1024, 1024)
    zero_counters()
    runs = [debugrenderer.render(colonnade, col_cam, dparams, 1024, 1024,
                                 seed=i)[1] for i in (1, 2, 3)]
    counts = launched('debug renderer (colonnade)',
                      {'intersect_packet4', *F3})
    mrps = sorted(s.mrps for s in runs)
    secs = sorted(s.seconds for s in runs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        img, st = debugrenderer.render(colonnade, col_cam, dparams, 1024,
                                       1024, seed=4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    k3_ms = busy_ms = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_ms += evt.self_device_time_total / 1e3
            if kernel_of(evt.key) == 'intersect_wide_kernel':
                k3_ms += evt.self_device_time_total / 1e3
    vals = torch.unique(img * dparams.spp)
    if not (torch.equal(vals, vals.round()) and float(vals.max()) <= 8):
        raise AssertionError("debug renderer: pixels not whole multiples "
                             "of 1/spp")
    ref, _ = debugrenderer.render(colonnade, bs.colonnade_camera(64, 64),
                                  dparams, 64, 64)
    cpu_col = bs.colonnade().commit(device='cpu', leaf_size=32)
    ref_cpu, _ = debugrenderer.render(cpu_col, bs.colonnade_camera(64, 64),
                                      dparams, 64, 64)
    same = float((ref.cpu() == ref_cpu).all(-1).float().mean())
    if same < 0.99:
        raise AssertionError(f"debug renderer: {same:.4f} of 64^2 pixels "
                             "equal to the CPU's")
    phase('interactive', f"debug renderer (colonnade, 1024^2, 8 rays a "
          f"pixel, max_depth 4): {runs[0].num_rays / 1e6:.2f} Mrays traced, "
          f"{mrps[1]:.2f} Mrays/s (min {mrps[0]:.2f}, max {mrps[2]:.2f}), "
          f"frame_s {secs[1]:.4f}; profiled: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, K3 {k3_ms:.1f} ms ({k3_ms / wall_ms:.1%} "
          f"of the frame); launches per frame "
          f"{ {k: n / len(runs) for k, n in counts.items()} }; beside "
          f"colonnade_1024 path traced ('high') {quality_mrps['high']:.2f} "
          f"Mrays/s; 64^2 against the CPU: {same:.4f} of pixels equal; "
          f"on {card}")
    del cpu_col

    # the web viewer: interactive_loop on the colonnade at 512^2, 1 spp a
    # frame, on a server of its own, driven by queued events
    l2w = bs.colonnade_camera(512, 512).local2world.numpy().astype(
        np.float64)
    ctl = viewer.CameraController(pos=l2w[3], lookat=l2w[3] + l2w[2] * 10.0,
                                  up=l2w[1], angle=65.0, aspect=1.0)
    srv = viewer.ViewerServer(port=0)
    script = {1: [{'type': 'rotate', 'dx': 30, 'dy': 10}],
              2: [{'type': 'pick', 'x': 0.5, 'y': 0.55}],
              12: [{'type': 'key', 'k': 'q'}]}
    huds, stamps = [], []
    publish = srv.submit_frame

    def submit(img, hud=''):
        publish(img, hud)
        huds.append(hud)
        stamps.append(time.perf_counter())
        with srv._lock:
            srv._events.extend(script.get(len(huds), []))
    srv.submit_frame = submit
    lookat0 = ctl.lookat.copy()
    zero_counters()
    try:
        film = viewer.interactive_loop(colonnade, ctl,
                                       pt.PTParams(max_depth=4), 512, 512,
                                       spp_per_frame=1, server=srv,
                                       max_frames=20)
        counts = launched('viewer (colonnade)', bvh4_path)
        png = srv._frame[1]
    finally:
        srv.close()
    shown = stereo_strip.decode_png(png)
    want_img = tonemap.to_srgb_u8(tonemap.tonemap(
        accum.resolve(film))).cpu().numpy()
    if len(huds) != 12 or not np.array_equal(shown, want_img):
        raise AssertionError(f"viewer: {len(huds)} frames, or its last PNG "
                             "differs from the tonemapped film")
    if np.allclose(ctl.lookat, lookat0):
        raise AssertionError("viewer: the pick did not re-centre the view")
    fps = (len(stamps) - 3) / (stamps[-1] - stamps[2])
    phase('interactive', f"viewer (colonnade, 512^2, 1 spp a frame, depth "
          f"4): {len(huds)} frames, a rotate, a pick re-centring on "
          f"{np.round(ctl.lookat, 3).tolist()}, then 'q'; {fps:.2f} fps over "
          f"the 9 frames after the pick; last hud '{huds[-1]}'; the last "
          f"PNG ({len(png)} bytes) decodes to the tonemapped film; launches "
          f"{counts} on {card}")

    # the display loop writing display.png (no Pillow on this machine)
    shown_frames = []
    out_png = os.path.join(OUT, 'display.png')

    def keep_frame(i, img, st):
        shown_frames.append(img)
        return None, True
    zero_counters()
    display.display_loop(cornell, bs.cornell_camera(64, 64),
                         pt.PTParams(max_depth=4), 64, 64, spp_per_frame=4,
                         max_frames=4, out_path=out_png, frame_cb=keep_frame,
                         use_matplotlib=False)
    counts = launched('display loop (cornell)', dense_path)
    with open(out_png, 'rb') as f:
        if not np.array_equal(stereo_strip.decode_png(f.read()),
                              shown_frames[-1]) or len(shown_frames) != 4:
            raise AssertionError("display loop: display.png is not the last "
                                 "frame")
    phase('interactive', f"display loop (cornell, 64^2, 4 frames of 4 spp): "
          f"{out_png} read back equal to the last frame; launches {counts}")

    # the random-scene fuzzer against the port's CPU renders
    c_orbit = cli.gecs_default_view(ecs.RenderSettings(width=32, height=32))
    orbit = output.mono_camera(c_orbit)
    for seed in range(4):
        sb = regression.create_random_scene(seed)
        imgs = []
        for device in (dev, 'cpu'):
            zero_counters()
            film, st = renderer.render_frame(
                sb.commit(device=device), orbit, pt.PTParams(max_depth=3),
                32, 32, spp=2, seed=seed)
            if device == dev:
                counts = launched(f'random scene {seed}',
                                  dense_path | {'fetch'})
            imgs.append(accum.resolve(film).cpu().numpy())
        db, tdb = psnr(*imgs), trimmed_psnr(*imgs)
        if db < 60.0 and tdb < 60.0:
            raise AssertionError(f"random scene {seed}: {db:.2f} dB, "
                                 f"trimmed-1% {tdb:.2f} dB")
        line = ''
        if seed == 0:
            scene = sb.commit(device=dev)
            dimg, dst = debugrenderer.render(
                scene, orbit, debugrenderer.DebugParams(4, 2), 32, 32)
            dref, _ = debugrenderer.render(sb.commit(device='cpu'), orbit,
                                           debugrenderer.DebugParams(4, 2),
                                           32, 32)
            line = (f"; its debug render {dst.num_rays:.0f} rays, "
                    f"{float((dimg.cpu() == dref).all(-1).float().mean()):.4f}"
                    " of pixels equal to the CPU's")
        phase('interactive', f"random scene {seed} ({st.num_rays:.0f} rays, "
              f"32^2, 2 spp, depth 3): {db:.2f} dB, trimmed-1% {tdb:.2f} dB "
              f"against the CPU (gate 60, either); launches {counts}{line}")

    # profiling.trace over one cornell_512 frame
    with tempfile.TemporaryDirectory() as tmp:
        zero_counters()
        with profiling.trace(tmp) as prof:
            renderer.render_frame(cornell, bs.cornell_camera(512, 512),
                                  pt.PTParams(max_depth=4), 512, 512, spp=32,
                                  seed=SEED)
            torch.cuda.synchronize()
        counts = launched('profiled cornell_512', dense_path)
        size = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as f:
            names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    kernels_named = sorted({kernel_of(n) for n in names} - {None})
    if (pt.SPAN_SHADE not in names or kernels_named
            != ['intersect_dense_kernel', 'lobes_eval_kernel',
                'lobes_sample_kernel', 'occluded_dense_kernel',
                'rng_uniform_kernel']):
        raise AssertionError(f"profiling.trace: the trace names "
                             f"{kernels_named}, shade range "
                             f"{pt.SPAN_SHADE in names}")
    phase('interactive', f"profiling.trace of cornell_512: {size} bytes of "
          f"Chrome trace naming {pt.SPAN_SHADE} and {kernels_named}; "
          f"launches {counts}")

    # render_progressive: stopped after 2 of 4 iterations, then resumed
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'film.npz')
        calls = []
        args = (cornell, bs.cornell_camera(64, 64), pt.PTParams(max_depth=4),
                64, 64, 4, 4)
        zero_counters()
        _, done = renderer.render_progressive(
            *args, checkpoint_path=ckpt, seed=SEED,
            stop_flag=lambda: calls.append(1) or len(calls) > 2)
        film, done_b = renderer.render_progressive(*args,
                                                   checkpoint_path=ckpt,
                                                   seed=SEED)
        counts = launched('render_progressive (cornell)', dense_path)
    ref = None
    for it in range(4):
        ref, _ = renderer.render_frame(*args[:6], film=ref, iteration=it,
                                       seed=SEED)
    if (done, done_b) != (2, 4) or not torch.equal(film.rgb_sum, ref.rgb_sum):
        raise AssertionError(f"render_progressive: {done}, {done_b} "
                             "iterations, or not bit-equal to an "
                             "uninterrupted run")
    phase('interactive', f"render_progressive (cornell, 64^2, 4 x 4 spp): "
          f"stopped after {done}, resumed to {done_b}, bit-equal to an "
          f"uninterrupted run; launches {counts}")
    phase('interactive', f"phase done in "
          f"{time.perf_counter() - t_interactive:.1f} s")

    # ---- 8. multi-device, TCP and the C ABI --------------------------------
    multi_s = multi_device_phase(dev, card, cornell, colonnade, zero_counters,
                                 launched, dense_path, bvh4_path,
                                 shim_and_host)
    phase('multi', f"phase done in {multi_s:.1f} s")

    # ---- 9. bounds ---------------------------------------------------------
    summary = []
    for (f, _, src, replaces, pair_flops), n in zip(kernels, main_launches):
        res = results[f.__name__]
        if f is textures.fetch:
            bound_ms = roofline.bound(res['bytes'], 0)[0]
            phase('bounds', f"fetch on {res['calls']} calls of sponza's "
                  f"{res['slots']} slots, {res['texel_slots']} with an id "
                  f">= 0, over {res['atlas_bytes'] / 1e6:.1f} MB of texels: "
                  f"{res['bytes']} bytes; bound {bound_ms:.4f} ms by bytes, "
                  f"kernel {res['ms']:.3f} ms: {bound_ms / res['ms']:.2%} of "
                  f"the bound's rate; the plain fetch {res['plain_ms']:.3f} "
                  f"ms")
            summary.append({
                'name': f.__name__, 'route': 'cuda',
                'source': 'yulio_raytracer_tpu_torch/csrc/' + src,
                'replaces': replaces, 'launches': n, 'max_abs_err': 0.0,
                'ms': res['ms'], 'plain_ms': res['plain_ms'],
                'bound_ms': bound_ms, 'bound_by': 'bytes',
                'library_ms': None, 'slots': res['slots'],
                'texel_slots': res['texel_slots'], 'bytes': res['bytes']})
            continue
        if f in (lb.eval_lobes, lb.sample_lobes, rng.draw):
            bound_ms = roofline.bound(res['bytes'], 0)[0]
            phase('bounds', f"{f.__name__} on {res['calls']} calls of "
                  f"sponza's frame, {res['lanes']} lanes: {res['bytes']} "
                  f"bytes; bound {bound_ms:.4f} ms by bytes, kernel "
                  f"{res['ms']:.3f} ms: {bound_ms / res['ms']:.2%} of the "
                  f"bound's rate; the plain version {res['plain_ms']:.3f} "
                  f"ms")
            summary.append({
                'name': f.__name__, 'route': 'cuda',
                'source': 'yulio_raytracer_tpu_torch/csrc/' + src,
                'replaces': replaces, 'launches': n, 'max_abs_err': 0.0,
                'ms': res['ms'], 'plain_ms': res['plain_ms'],
                'bound_ms': bound_ms, 'bound_by': 'bytes',
                'library_ms': None, 'calls': res['calls'],
                'lanes': res['lanes'], 'bytes': res['bytes']})
            continue
        flops = (res['pair'] * pair_flops + res['box'] * SLAB_FLOPS
                 + res['stage2'] * dense.INSIDE_FLOPS
                 + res['stage3'] * dense.CULL_FLOPS)
        staged = (f" + {res['stage2']} past stage 1 x {dense.INSIDE_FLOPS} "
                  f"+ {res['stage3']} to stage 3 x {dense.CULL_FLOPS}"
                  if f in (dense.intersect_dense, dense.occluded_dense)
                  else '')
        bytes_ms, flops_ms = roofline.times(res['bytes'], flops)
        bound_ms, bound_by = roofline.bound(res['bytes'], flops)
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
