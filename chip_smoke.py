#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yulio_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failure raises and the exit code is nonzero):
 1. toolchain: torch / CUDA / nvcc versions, the card's name and power limit;
 2. build: the CUDA kernels from yulio_raytracer_tpu_torch/csrc, one nvcc
    per source, all started together;
 3. every kernel against its plain torch version on the card, at the main
    paths' shapes: the dense pair on cornell (64^2 camera rays plus
    hemisphere rays from their hits; shadow rays to its lights), the BVH4
    pair and the binary pair on the full colonnade (1024^2 camera rays, 1M
    scattered rays, the shadow rays to its 4 triangle lights), the motion
    kernel on the motion field (512^2 camera rays with their times, 1M
    scattered rays at random times);
 4. the pinned CPU goldens rendered through render_frame on the card, one
    path each, PSNR >= 40 dB: cornell_64 through the dense kernels,
    colonnade_64 through the BVH4 kernels and again with accel='bvh2'
    through the binary kernels, motion_64 through the motion kernel.  Every
    launch counter is set to 0 before each render and read after it: the
    path's kernels must have run, no other kernel, and no plain version on
    a CUDA tensor;
 5. timed full-size frames (cornell_512, colonnade_1024,
    colonnade_1024_bvh2, motion_field_512).
The last lines are a JSON summary of the kernels, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""
import json
import os
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


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def psnr(img, ref):
    mse = float(((img - ref) ** 2).mean())
    return 10 * np.log10(max(float(img.max()), 1e-9) ** 2 / max(mse, 1e-20))


def camera_rays(renderer, scene, cam, width, height, dev):
    """One camera sample per pixel in tile order (sample 0, seed SEED):
    (org, dir, time), time None unless the scene moves."""
    order = torch.as_tensor(renderer._tile_order(width, height), device=dev)
    sid = torch.zeros_like(order)
    from yulio_raytracer_tpu_torch.sampling import patterns
    return renderer._gen_rays(scene, cam, width, height,
                              patterns.grid_scalars(1), order, sid, SEED)


def scattered_rays(scene, n, gen, dev):
    """n rays from uniform points of the scene's box in uniform
    directions, at uniform times."""
    lo = torch.tensor(scene.bbox_lo, device=dev)
    hi = torch.tensor(scene.bbox_hi, device=dev)
    org = lo + (hi - lo) * torch.rand(n, 3, generator=gen, device=dev)
    d = torch.randn(n, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    return (org, d, torch.zeros(n, device=dev),
            torch.full((n,), float('inf'), device=dev),
            torch.rand(n, generator=gen, device=dev))


def hemisphere_rays(scene, org, dirn, hit, gen, dev):
    """Cosine-distributed rays leaving every hit point on the side facing
    the incoming ray (the bounce's scattering geometry); missed rays
    become dead lanes (tfar = -1).  Also returns the hit points' records."""
    from yulio_raytracer_tpu_torch.ops import intersect as ops_i
    from yulio_raytracer_tpu_torch.sampling import shapesampler as ss
    dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
    back = (dg['Ng'] * dirn).sum(-1) > 0
    n = torch.where(back[:, None], -dg['Ng'], dg['Ng'])
    u = torch.rand(org.shape[0], 2, generator=gen, device=dev)
    wi, _ = ss.cosine_sample_hemisphere(u[:, 0], u[:, 1], n)
    eps = dg['error'] * 32.0 * 1.1920929e-7
    o = dg['P'] + wi * eps[:, None]
    tf = torch.where(hit.valid, float('inf'), -1.0)
    return o, wi, torch.zeros_like(tf), tf, dg, eps


def shadow_rays(scene, dg, eps, valid, gen, dev):
    """Rays from every hit point to a random point on every light, as the
    NEE batch lays them out (light-major); missed rays are dead lanes."""
    from yulio_raytracer_tpu_torch.sampling import shapesampler as ss
    os_, ds, tns, tfs = [], [], [], []
    for l in scene.lights:
        u = torch.rand(dg['P'].shape[0], 2, generator=gen, device=dev)
        p = ss.uniform_sample_triangle(u[:, 0], u[:, 1], l['v0'], l['v1'],
                                       l['v2'])
        d = p - dg['P']
        dist = d.norm(dim=-1)
        os_.append(dg['P'])
        ds.append(d / dist.clamp(min=1e-20)[:, None])
        tns.append(eps)
        tfs.append(torch.where(valid, dist - eps, -1.0))
    return (torch.cat(os_), torch.cat(ds), torch.cat(tns), torch.cat(tfs))


def compare(name, kernel, plain, args):
    """Hold a kernel against its plain version; returns a result dict."""
    k = kernel(*args)
    p = plain(*args)
    torch.cuda.synchronize()
    if isinstance(k, torch.Tensor):
        mism = float((k != p).float().mean())
        err = float((k.float() - p.float()).abs().max()) if k.numel() else 0.0
        line = f"occlusion mismatch {mism:.3g}"
        ok = mism <= MASK_MISMATCH_MAX
    else:
        hk, hp = k.tri >= 0, p.tri >= 0
        mask_mism = float((hk != hp).float().mean())
        tri_mism = float((k.tri != p.tri).float().mean())
        same = (k.tri == p.tri) & hk
        dt = (k.t[same] - p.t[same]).abs()
        err = float(dt.max()) if dt.numel() else 0.0
        rel = float((dt / p.t[same].abs().clamp(min=1e-30)).max()) \
            if dt.numel() else 0.0
        line = (f"hit-mask mismatch {mask_mism:.3g}, tri mismatch "
                f"{tri_mism:.3g}, max rel t err {rel:.3g}")
        ok = (mask_mism <= MASK_MISMATCH_MAX and tri_mism <= TRI_MISMATCH_MAX
              and rel <= T_REL_ERR_MAX)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    r = args[2].shape[0]
    phase('kernels', f"{name} on {r} rays: {line}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{line}")
    return {'rays': r, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from yulio_raytracer_tpu_torch.film import accum
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    from yulio_raytracer_tpu_torch.ops import cuda_build, dense, traverse, wide
    from yulio_raytracer_tpu_torch import renderer

    dev = torch.device('cuda')
    card = smi_line()
    nvcc = subprocess.run([cuda_build._nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    phase('toolchain', f"python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}; card: {card}")

    t0 = time.perf_counter()
    names = ('dense', 'wide', 'binary')
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc per source
        libs = list(pool.map(cuda_build.build, names))
    for name, lib in zip(names, libs):
        regs = [l.split(':', 1)[1].strip() for l in open(lib[:-3] + '.log')
                if 'registers' in l]
        phase('build', f"{name}.cu: {'; '.join(regs)}")
    phase('build', f"kernels built in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def record(key, res):
        acc = results.setdefault(key, {'rays': 0, 'max_abs_err': 0.0,
                                       'ms': 0.0, 'plain_ms': 0.0})
        acc['rays'] += res['rays']
        acc['max_abs_err'] = max(acc['max_abs_err'], res['max_abs_err'])
        acc['ms'] += res['ms']
        acc['plain_ms'] += res['plain_ms']

    t0 = time.perf_counter()
    cornell = bs.cornell_box().commit(device=dev)
    org, dirn, _ = camera_rays(renderer, cornell, bs.cornell_camera(64, 64),
                               64, 64, dev)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    hit = dense.intersect_dense_plain(cornell.tris, org, dirn, zeros, inf)
    ho, hd, htn, htf, dg, eps = hemisphere_rays(cornell, org, dirn, hit, gen,
                                                dev)
    args = (cornell.tris, torch.cat([org, ho]), torch.cat([dirn, hd]),
            torch.cat([zeros, htn]), torch.cat([inf, htf]))
    record('intersect_dense', compare(
        'intersect_dense (cornell)', dense.intersect_dense,
        dense.intersect_dense_plain, args))
    so, sd, stn, stf = shadow_rays(cornell, dg, eps, hit.valid, gen, dev)
    record('occluded_dense', compare(
        'occluded_dense (cornell)', dense.occluded_dense,
        dense.occluded_dense_plain, (cornell.tris, so, sd, stn, stf)))

    t1 = time.perf_counter()
    colonnade = bs.colonnade().commit(device=dev, leaf_size=32)
    t2 = time.perf_counter()
    colonnade2 = bs.colonnade().commit(device=dev, leaf_size=32,
                                       accel='bvh2')
    phase('kernels', f"colonnade: {colonnade.num_triangles} triangles, "
          f"{colonnade.nodes4.shape[0]} BVH4 nodes, leaf 32, committed in "
          f"{t2 - t1:.2f} s; with accel='bvh2': "
          f"{colonnade2.nodes.shape[0]} binary nodes, committed in "
          f"{time.perf_counter() - t2:.2f} s")
    if not torch.equal(colonnade.tris, colonnade2.tris):
        raise AssertionError("the bvh2 and bvh4 commits differ in their "
                             "triangle rows")
    tables = (colonnade.nodes4, colonnade.tris)
    tables2 = (colonnade2.nodes, colonnade2.tris)
    org, dirn, _ = camera_rays(renderer, colonnade,
                               bs.colonnade_camera(1024, 1024), 1024, 1024,
                               dev)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    cam_rays = (org, dirn, zeros, inf)
    hit = wide.intersect_packet4(*tables, *cam_rays)
    ho, hd, htn, htf, dg, eps = hemisphere_rays(colonnade, org, dirn, hit,
                                                gen, dev)
    so, sd, stn, stf = shadow_rays(colonnade, dg, eps, hit.valid, gen, dev)
    for what, rays in (('camera', cam_rays), ('scattered', (ho, hd, htn,
                                                              htf))):
        record('intersect_packet4', compare(
            f'intersect_packet4 (colonnade {what})', wide.intersect_packet4,
            wide.intersect_wide_plain, (*tables, *rays)))
        record('intersect_packet', compare(
            f'intersect_packet (colonnade bvh2 {what})',
            traverse.intersect_packet, traverse.intersect_binary_plain,
            (*tables2, *rays)))
    record('occluded_packet4', compare(
        'occluded_packet4 (colonnade shadow)', wide.occluded_packet4,
        wide.occluded_wide_plain, (*tables, so, sd, stn, stf)))
    record('occluded_packet', compare(
        'occluded_packet (colonnade bvh2 shadow)', traverse.occluded_packet,
        traverse.occluded_binary_plain, (*tables2, so, sd, stn, stf)))

    t1 = time.perf_counter()
    motion = bs.motion_field().commit(device=dev)
    phase('kernels', f"motion_field: {motion.num_triangles} triangles, "
          f"{motion.nodes.shape[0]} binary nodes over union bounds, "
          f"accel {motion.accel}, committed in "
          f"{time.perf_counter() - t1:.2f} s")
    org, dirn, tm = camera_rays(renderer, motion,
                                bs.motion_field_camera(512, 512), 512, 512,
                                dev)
    zeros = torch.zeros(org.shape[0], device=dev)
    inf = torch.full_like(zeros, float('inf'))
    for what, rays in (('camera', (org, dirn, zeros, inf, tm)),
                       ('scattered', scattered_rays(motion, 1 << 20, gen,
                                                    dev))):
        record('intersect_packet_mb', compare(
            f'intersect_packet_mb (motion_field {what})',
            traverse.intersect_packet_mb, traverse.intersect_motion_plain,
            (motion.nodes, motion.tris_mb, *rays)))
    phase('kernels', f"all kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 4. goldens, one path each ----------------------------------------
    counters = [dense.intersect_dense, dense.occluded_dense,
                wide.intersect_packet4, wide.occluded_packet4,
                traverse.intersect_packet, traverse.occluded_packet,
                traverse.intersect_packet_mb]
    plains = [dense.intersect_dense_plain, dense.occluded_dense_plain,
              wide.intersect_wide_plain, wide.occluded_wide_plain,
              traverse.intersect_binary_plain,
              traverse.occluded_binary_plain,
              traverse.intersect_motion_plain]
    main_launches = [0] * len(counters)
    goldens = (
        ('cornell_64', cornell, bs.cornell_camera(64, 64), 4, 32, (0, 1)),
        ('colonnade_64', colonnade, bs.colonnade_camera(64, 64), 3, 8,
         (2, 3)),
        ('colonnade_64', colonnade2, bs.colonnade_camera(64, 64), 3, 8,
         (4, 5)),
        ('motion_64', motion, bs.motion_field_camera(64, 64), 2, 16, (6,)),
    )
    for name, scene, cam, depth, spp, used in goldens:
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_calls = 0
        film, stats = renderer.render_frame(
            scene, cam, pt.PTParams(max_depth=depth), 64, 64, spp=spp,
            seed=SEED)
        img = accum.resolve(film).cpu().numpy()
        ran = [f.launches for f in counters]
        ref = np.load(os.path.join(GOLDEN, name + '_cpu.npz'))['img']
        if img.shape != ref.shape or not np.isfinite(img).all():
            raise AssertionError(f"{name}: image {img.shape} not finite or "
                                 f"not of the golden's shape {ref.shape}")
        db = psnr(img, ref)
        counts = dict(zip([f.__name__ for f in counters], ran))
        phase('golden', f"{name} (accel {scene.accel}): PSNR {db:.2f} dB vs "
              f"{name}_cpu.npz (gate {PSNR_MIN}), {stats.num_rays:.0f} rays, "
              f"kernel launches {counts}")
        if db < PSNR_MIN:
            raise AssertionError(f"{name}: PSNR {db:.2f} < {PSNR_MIN}")
        if any((ran[i] > 0) != (i in used) for i in range(len(counters))):
            raise AssertionError(f"{name} (accel {scene.accel}): its path's "
                                 "kernels did not run, or others did")
        if any(f.cuda_calls for f in plains):
            raise AssertionError(f"{name}: a plain version ran on CUDA "
                                 "tensors in the main path")
        main_launches = [a + b for a, b in zip(main_launches, ran)]

    # ---- 5. timed full-size frames ----------------------------------------
    frames = (
        ('cornell_512', cornell, bs.cornell_camera(512, 512), 512, 32, 4),
        ('colonnade_1024', colonnade, bs.colonnade_camera(1024, 1024), 1024,
         8, 4),
        ('colonnade_1024_bvh2', colonnade2, bs.colonnade_camera(1024, 1024),
         1024, 8, 4),
        ('motion_field_512', motion, bs.motion_field_camera(512, 512), 512,
         16, 4),
    )
    for name, scene, cam, res, spp, depth in frames:
        params = pt.PTParams(max_depth=depth)
        torch.cuda.reset_peak_memory_stats()
        renderer.render_frame(scene, cam, params, res, res, spp=spp,
                              seed=SEED)
        runs = [renderer.render_frame(scene, cam, params, res, res, spp=spp,
                                      seed=SEED + i)[1] for i in (1, 2, 3)]
        mrps = sorted(s.mrps for s in runs)
        secs = sorted(s.seconds for s in runs)
        phase('frame', f"{name} ({res}^2, {spp} spp, depth {depth}, accel "
              f"{scene.accel}): "
              f"{mrps[1]:.2f} Mrays/s (min {mrps[0]:.2f}, max {mrps[2]:.2f}),"
              f" frame_s {secs[1]:.3f} (min {secs[0]:.3f}, max "
              f"{secs[2]:.3f}), {runs[0].num_rays / 1e6:.1f} Mrays/frame, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
              f" on {card}")

    sources = {
        'intersect_dense': ('dense.cu', 'yulio_raytracer_tpu/ops/'
                            'pallas_dense.py:94'),
        'occluded_dense': ('dense.cu', 'yulio_raytracer_tpu/ops/'
                           'pallas_dense.py:167'),
        'intersect_packet4': ('wide.cu', 'yulio_raytracer_tpu/ops/'
                              'pallas_wide.py:507'),
        'occluded_packet4': ('wide.cu', 'yulio_raytracer_tpu/ops/'
                             'pallas_wide.py:676'),
        'intersect_packet': ('binary.cu', 'yulio_raytracer_tpu/ops/'
                             'pallas_traverse.py:514'),
        'occluded_packet': ('binary.cu', 'yulio_raytracer_tpu/ops/'
                            'pallas_traverse.py:820'),
        'intersect_packet_mb': ('binary.cu', 'yulio_raytracer_tpu/ops/'
                                'pallas_traverse.py:1570'),
    }
    kernels = []
    for f, n in zip(counters, main_launches):
        src, replaces = sources[f.__name__]
        res = results[f.__name__]
        kernels.append({
            'name': f.__name__, 'route': 'cuda',
            'source': 'yulio_raytracer_tpu_torch/csrc/' + src,
            'replaces': replaces, 'launches': n,
            'max_abs_err': res['max_abs_err'], 'ms': res['ms'],
            'plain_ms': res['plain_ms'], 'rays': res['rays']})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
