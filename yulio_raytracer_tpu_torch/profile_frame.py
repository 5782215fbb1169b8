"""Where a frame's device time goes: one frame of a timed cell under
torch.profiler on the card.

    python -m yulio_raytracer_tpu_torch.profile_frame [cell ...]
        [--compaction auto|on|off]

The cells are the frames chip_smoke.py times and sphere_mirror_512, the
HDRI light's (default: all of them), each under render_frame's
`compaction` (default 'auto', which compacts only stereo_face_1536 and
sphere_glass_512, the cells past the roulette start).  Each is
committed on the card and rendered once to warm up, three times with
the clock alone, then once under the profiler.  One line per cell:
the commit's seconds and the device bytes the committed scene holds, the
median wall time of the three frames, the wall time of the profiled
frame, the device's busy time (the sum of the device activities' time;
the port runs one stream, so they do not overlap) and its share of the
wall, the device launches, each port kernel's calls and device time,
the rest of the device time (the torch glue of the bounce), the device
time of the glue's ranges (SPANS: the shade context, its texture
fetches, the lobes, the light samples, the environment lookups), the glue's largest device activities by name, and
the frames' peak device memory.  The last line is the same as one JSON
object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import torch

from . import renderer
from .cameras import cameras as cam
from .integrator import pathtracer as pt
from .io import builtin_scenes as bs
from .io import ecs
from .shading import textures as gtex

SPHERE_MIRROR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'scenes', 'sphere_mirror.ecs')


def stereo_face_camera(width: int = 1536, height: int = 1536):
    """The production stereo face (bench.py bench_stereo_face): face 1
    (the right face, left eye) of the rig down the colonnade's hall at
    scene scale 0.05.  Every face is square; the size is the frame's."""
    l2w = cam.look_at((-9.0, 2.2, 0.0), (10.0, 1.6, 0.0), (0.0, 1.0, 0.0))
    return cam.make_stereo_rig(l2w, scene_scale=0.05)[1]


def sphere_mirror_camera(width: int, height: int):
    """The camera sphere_mirror.ecs names, made as the reference's
    api/output.py mono_camera makes it."""
    st, _ = ecs.parse_ecs(SPHERE_MIRROR)
    return cam.Pinhole(cam.look_at(st.cam_pos, st.cam_look_at, st.cam_up),
                       angle=st.fov, aspect=width / height)


# the production config: depth 10 past rr_depth 5, the dome cap 120
STEREO_PARAMS = dict(max_depth=10, t_max_shadow_ray=120.0)

# name: (commit, camera, resolution, spp, PTParams fields)
CELLS = {
    'cornell_512': (lambda: bs.cornell_box().commit(), bs.cornell_camera,
                    512, 32, dict(max_depth=4)),
    'colonnade_1024': (lambda: bs.colonnade().commit(leaf_size=32),
                       bs.colonnade_camera, 1024, 8, dict(max_depth=4)),
    'colonnade_1024_bvh2': (
        lambda: bs.colonnade().commit(leaf_size=32, accel='bvh2'),
        bs.colonnade_camera, 1024, 8, dict(max_depth=4)),
    'colonnade_1024_grid': (lambda: bs.colonnade().commit(leaf_size=32),
                            bs.colonnade_camera, 1024, 8,
                            dict(max_depth=4, ray_binning='grid')),
    'colonnade_1024_treelet': (lambda: bs.colonnade().commit(leaf_size=32),
                               bs.colonnade_camera, 1024, 8,
                               dict(max_depth=4, ray_binning='treelet')),
    'colonnade_1024_dense': (lambda: bs.colonnade().commit(leaf_size=32),
                             bs.colonnade_camera, 1024, 8,
                             dict(max_depth=4, ray_binning='dense')),
    'motion_field_512': (lambda: bs.motion_field().commit(),
                         bs.motion_field_camera, 512, 16, dict(max_depth=4)),
    'stereo_face_1536': (lambda: bs.colonnade().commit(leaf_size=32),
                         stereo_face_camera, 1536, 2, STEREO_PARAMS),
    'sponza_like_1024': (lambda: bs.sponza_like().commit(leaf_size=32),
                         bs.sponza_like_camera, 1024, 8, dict(max_depth=4)),
    # the sphere_glass golden's spp and depth at its camera's own size:
    # the dome's NEE and escaped rays, glass chains past the roulette
    'sphere_glass_512': (lambda: bs.sphere_glass().commit(leaf_size=32),
                         bs.sphere_glass_camera, 512, 32, dict(max_depth=8)),
    # the HDRI light (lines.ppm) over a mirror ball: its NEE samples the
    # map's distribution, its escaped rays read the map
    'sphere_mirror_512': (lambda: ecs.parse_ecs(SPHERE_MIRROR)[1].commit(),
                          sphere_mirror_camera, 512, 8, dict(max_depth=3)),
}
# the bounce's profiler ranges: the shade context (its texture fetches
# included), the texture fetches, the lobes' eval and sampling, the NEE's
# light samples and the escaped rays' environment and backplate lookups
SPANS = (pt.SPAN_SHADE, gtex.SPAN_FETCH, pt.SPAN_LOBES, pt.SPAN_LIGHTS,
         pt.SPAN_ENV)
# the glue's device activities reported by name, largest first
TOP_GLUE = 6
# the port's kernels by their __global__ names (csrc/*.cu)
KERNELS = ('intersect_dense_kernel', 'occluded_dense_kernel',
           'intersect_wide_kernel', 'occluded_wide_kernel',
           'intersect_binary_kernel', 'occluded_binary_kernel',
           'intersect_motion_kernel', 'occluded_motion_kernel',
           'closest_pairs_kernel', 'occluded_pairs_kernel',
           'bin_count_kernel', 'bin_scan_kernel', 'bin_scatter_kernel',
           'march_kernel', 'split_kernel')


def kernel_of(event_name: str):
    """The port kernel a profiler event names (mangled or demangled), or
    None."""
    m = re.match(r'_Z(\d+)', event_name)
    ident = (event_name[m.end():m.end() + int(m.group(1))] if m else
             event_name.removeprefix('void ').split('(')[0].split('<')[0])
    return ident if ident in KERNELS else None


def profile_cell(name: str, compaction: str = 'auto') -> dict:
    commit, camera, res, spp, fields = CELLS[name]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scene = commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    scene_bytes = torch.cuda.memory_allocated() - held
    view = camera(res, res)
    params = pt.PTParams(**fields)

    def frame(seed):
        return renderer.render_frame(scene, view, params, res, res, spp=spp,
                                     seed=seed, compaction=compaction)

    torch.cuda.reset_peak_memory_stats()
    frame(42)
    frames = sorted(frame(44 + i)[1].seconds for i in range(3))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, stats = frame(43)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches, kernels, spans, glue = 0.0, 0, {}, {}, []
    for evt in prof.key_averages():
        if evt.key in SPANS:
            # a range's host event holds the device time of the kernels
            # launched inside it; its device-side marker is no launch
            if evt.device_type == torch.autograd.DeviceType.CPU:
                spans[evt.key] = {'calls': evt.count,
                                  'ms': evt.device_time_total / 1e3}
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        busy_us += us
        launches += evt.count
        k = kernel_of(evt.key)
        if k is not None:
            calls, k_us = kernels.get(k, (0, 0.0))
            kernels[k] = (calls + evt.count, k_us + us)
        else:
            glue.append((us, evt.count, evt.key))
    kernel_us = sum(us for _, us in kernels.values())
    return {'cell': name, 'compaction': compaction,
            'compacted': renderer.compacts(scene, params, compaction),
            'commit_s': commit_s, 'scene_bytes': scene_bytes,
            'frame_s': frames[1], 'wall_ms': wall * 1e3, 'busy_ms': busy_us / 1e3,
            'busy_share': busy_us / 1e3 / (wall * 1e3),
            'peak_gib': peak / 2**30,
            'device_launches': launches, 'num_rays': stats.num_rays,
            'kernels': {k: {'calls': c, 'ms': us / 1e3}
                        for k, (c, us) in sorted(kernels.items())},
            'glue_ms': (busy_us - kernel_us) / 1e3, 'spans': spans,
            'top_glue': [{'op': name[:80], 'calls': n, 'ms': us / 1e3}
                         for us, n, name in sorted(glue, reverse=True)[
                             :TOP_GLUE]]}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog='profile_frame')
    ap.add_argument('cells', nargs='*', metavar='cell',
                    help=f"default: all of {', '.join(CELLS)}")
    ap.add_argument('--compaction', default='auto',
                    choices=renderer.COMPACTIONS)
    args = ap.parse_args(argv)
    unknown = [c for c in args.cells if c not in CELLS]
    if unknown:
        print(f"profile_frame: unknown cells {unknown}; known: "
              f"{', '.join(CELLS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    rows = []
    for name in args.cells or CELLS:
        r = profile_cell(name, args.compaction)
        rows.append(r)
        ks = ', '.join(f"{k} {v['calls']} calls {v['ms']:.1f} ms"
                       for k, v in r['kernels'].items())
        sp = ', '.join(f"{k} {v['calls']} calls {v['ms']:.1f} ms "
                       f"({v['ms'] / max(r['glue_ms'], 1e-9):.1%} of the glue)"
                       for k, v in r['spans'].items())
        print(f"[profile] {name} (compaction {args.compaction}, "
              f"compacted {r['compacted']}): commit {r['commit_s']:.3f} s, scene "
              f"{r['scene_bytes']} device bytes, frame_s {r['frame_s']:.4f} "
              f"(median of 3); profiled wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['busy_ms']:.1f} ms ({r['busy_share']:.1%}), "
              f"{r['device_launches']} device launches; {ks}; glue "
              f"{r['glue_ms']:.1f} ms; of it {sp or 'no span'}; largest "
              "glue activities " + ', '.join(
                  f"{g['op']} {g['calls']} calls {g['ms']:.1f} ms"
                  for g in r['top_glue'])
              + f"; peak mem {r['peak_gib']:.2f} GiB; on {card}", flush=True)
    print(json.dumps({'card': card, 'cells': rows}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
