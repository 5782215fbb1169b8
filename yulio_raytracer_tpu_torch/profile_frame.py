"""Where a frame's device time goes: one frame of a timed cell under
torch.profiler on the card.

    python -m yulio_raytracer_tpu_torch.profile_frame [cell ...]
        [--compaction auto|on|off]

The cells are the frames chip_smoke.py times, sphere_mirror_512 (the
HDRI light's), and two faces of the production strip
(test_stereo_back_800, test_stereo_front_800) (default: all of them),
each under render_frame's `compaction` (default 'auto', which compacts
the cells past the roulette start: stereo_face_1536, sphere_glass_512
and the strip's faces).  Each is
committed on the card and rendered once to warm up, three times with
the clock alone, then once under the profiler.  One line per cell:
the commit's seconds and the device bytes the committed scene holds, the
median wall time of the three frames, the wall time of the profiled
frame, the device's busy time (the sum of the device activities' time;
the port runs one stream, so they do not overlap) and its share of the
wall, the device launches, each port kernel's calls and device time,
the rest of the device time (the torch glue of the bounce), the device
time of each span of the render path (utils/profiling.py SPANS; a span
holds the time of the spans inside it), the glue's largest device
activities by name, and the frames' peak device memory; then what the
port's tracer reads over three more frames (profiling.tracing(), no
profiler: span_summary, with the share of traced rays that escaped to
the environment) and the profiled frame's device idle time by
the span open on the host (idle_by_span); and the RNG's device ms a
frame (its yrt.rng spans), its calls a frame and the share of them that
ran its kernel F3.  The last line is the same as one JSON object.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import statistics
import sys
import time

import torch

from . import renderer
from .cameras import cameras as cam
from .core import rng
from .integrator import pathtracer as pt
from .io import builtin_scenes as bs
from .io import ecs
from .ops import cuda_build as cb
from .shading import lobes as lb
from .utils import profiling

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
TEST_STEREO = os.path.join(os.path.dirname(SPHERE_MIRROR), 'test_stereo.ecs')


def _test_stereo():
    """test_stereo.ecs's settings, builder and the rig `-stereo` builds at
    its camera (api/cli.py stereo_rigs)."""
    from .api import cli
    settings, sb = ecs.parse_ecs(TEST_STEREO)
    return settings, sb, cli.stereo_rigs(settings)[0][1]


def _test_stereo_cell(face: int):
    """One face of the production strip at the strip's settings: 800^2,
    64 spp, depth 10, the cap 120, the b-spline filter."""
    def commit():
        settings, sb, _ = _test_stereo()
        return sb.commit(accel=settings.accel)
    return (commit, lambda width, height: _test_stereo()[2][face], 800, 64,
            dict(STEREO_PARAMS, pixel_filter='bspline'))


# name: (commit, camera, resolution, spp, PTParams fields and, for the
# strip's faces, render_frame's pixel_filter)
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
    # two faces of the production strip (test_stereo.ecs): the back face,
    # whose camera rays hit most, and the front face, whose camera rays
    # all escape
    'test_stereo_back_800': _test_stereo_cell(2),
    'test_stereo_front_800': _test_stereo_cell(0),
}
SPANS = profiling.SPANS
# idle_by_span's classes, by the spans that hold a gap's middle: a
# compaction, else a bounce, else any other span of a frame, else none
IDLE_CLASSES = ('compact', 'bounce', 'frame', 'outside')
# the glue's device activities reported by name, largest first
TOP_GLUE = 6


def kernel_of(event_name: str):
    """The port kernel a profiler event names (mangled or demangled), or
    None."""
    m = re.match(r'_Z(\d+)', event_name)
    ident = (event_name[m.end():m.end() + int(m.group(1))] if m else
             event_name.removeprefix('void ').split('(')[0].split('<')[0])
    return ident if ident in cb.kernel_names() else None


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _covers(intervals):
    """A test of whether a time lies in the union of intervals [(start,
    end)]: the union as sorted disjoint intervals, found by bisection."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and merged[i][1] >= t
    return inside


def idle_by_span(prof) -> dict:
    """The device's idle seconds in a profiled window (the gaps between
    its activities, first to last), by the port's spans open on the host
    (any thread) at each gap's middle: 'compact' inside a yrt.compact,
    'bounce' inside a yrt.bounce and no yrt.compact, 'frame' inside any
    other span, 'outside' in none (IDLE_CLASSES); 'total' their sum.  A
    span also shows on the device under its own name; that marker is no
    activity."""
    dev, spans = [], {}
    for e in prof.events():
        tr = e.time_range
        if not _is_device(e):
            if e.name in SPANS:
                spans.setdefault(e.name, []).append((tr.start, tr.end))
        elif e.name not in SPANS:
            dev.append((tr.start, tr.end))
    tests = (('compact', _covers(spans.get(profiling.COMPACT, []))),
             ('bounce', _covers(spans.get(profiling.BOUNCE, []))),
             ('frame', _covers([iv for ivs in spans.values() for iv in ivs])))
    out = dict.fromkeys(IDLE_CLASSES, 0.0)
    dev.sort()
    end = dev[0][1] if dev else 0
    for s, e in dev[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            cls = next((c for c, inside in tests if inside(mid)), 'outside')
            out[cls] += (s - end) * 1e-6
        end = max(end, e)
    out['total'] = sum(out[c] for c in IDLE_CLASSES)
    return out


def span_summary(spans, frames: int) -> dict:
    """What the tracer's records (Tracer.spans()) of `frames` frames
    say, a frame: enqueue_ms, the host ms inside yrt.bounce spans;
    live_pct, 100 x the rays the bounces traced over their lanes;
    escaped_pct, 100 x the rays that missed (the yrt.env records'
    `escaped`) over the rays traced, None without an environment;
    bounces, the yrt.bounce spans; lobe_calls, the yrt.lobes spans (the
    lobes' evals and samples), and lobe_lanes, their `lanes` summed;
    rng_calls, the yrt.rng spans (the RNG's draws), and rng_lanes, their
    `lanes` summed."""
    b = [s for s in spans if s.name == profiling.BOUNCE]
    lanes = sum(s.attrs['width'] for s in b)
    rays = sum(s.attrs['rays'] for s in b)
    env = [s for s in spans if s.name == profiling.ENV]
    lobes = [s for s in spans if s.name == profiling.LOBES]
    draws = [s for s in spans if s.name == profiling.RNG]
    return {'enqueue_ms': sum(s.end - s.start for s in b) / 1e6 / frames,
            'live_pct': 100.0 * rays / lanes if lanes else None,
            'escaped_pct': (100.0 * sum(s.attrs['escaped'] for s in env)
                            / rays if env and rays else None),
            'bounces': len(b) / frames,
            'lobe_calls': len(lobes) / frames,
            'lobe_lanes': sum(s.attrs['lanes'] for s in lobes) / frames,
            'rng_calls': len(draws) / frames,
            'rng_lanes': sum(s.attrs['lanes'] for s in draws) / frames}


def profile_cell(name: str, compaction: str = 'auto') -> dict:
    commit, camera, res, spp, fields = CELLS[name]
    fields = dict(fields)
    pixel_filter = fields.pop('pixel_filter', 'box')
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
                                     seed=seed, compaction=compaction,
                                     pixel_filter=pixel_filter)

    torch.cuda.reset_peak_memory_stats()
    frame(42)
    frames = sorted(frame(44 + i)[1].seconds for i in range(3))
    peak = torch.cuda.max_memory_allocated()
    launched = lb.eval_lobes.launches + lb.sample_lobes.launches
    drawn = rng.draw.launches
    with profiling.tracing() as tracer:
        traced = statistics.median(frame(47 + i)[1].seconds
                                   for i in range(3))
    launched = lb.eval_lobes.launches + lb.sample_lobes.launches - launched
    drawn = rng.draw.launches - drawn
    summary = span_summary(tracer.spans(), 3)
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
            # a span's host event holds the device time of the kernels
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
                             :TOP_GLUE]],
            'rng_ms': spans.get(profiling.RNG, {}).get('ms'),
            'traced': dict(summary, frame_s=traced,
                           lobe_kernel_share=(launched / 3
                                              / summary['lobe_calls']
                                              if summary['lobe_calls']
                                              else None),
                           rng_kernel_share=(drawn / 3 / summary['rng_calls']
                                             if summary['rng_calls']
                                             else None)),
            'idle_s': idle_by_span(prof)}


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
        sp = ', '.join(f"{k} {v['calls']} calls {v['ms']:.1f} ms"
                       for k, v in r['spans'].items())
        tr, idle = r['traced'], r['idle_s']
        print(f"[profile] {name} (compaction {args.compaction}, "
              f"compacted {r['compacted']}): commit {r['commit_s']:.3f} s, scene "
              f"{r['scene_bytes']} device bytes, frame_s {r['frame_s']:.4f} "
              f"(median of 3); profiled wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['busy_ms']:.1f} ms ({r['busy_share']:.1%}), "
              f"{r['device_launches']} device launches; {ks}; glue "
              f"{r['glue_ms']:.1f} ms; spans {sp or 'none'}; largest "
              "glue activities " + ', '.join(
                  f"{g['op']} {g['calls']} calls {g['ms']:.1f} ms"
                  for g in r['top_glue'])
              + f"; peak mem {r['peak_gib']:.2f} GiB; traced frame_s "
              f"{tr['frame_s']:.4f} (median of 3), enqueue "
              f"{tr['enqueue_ms']:.1f} ms, live {tr['live_pct']:.1f}%, "
              + ('escaped n/a' if tr['escaped_pct'] is None else
                 f"escaped {tr['escaped_pct']:.2f}%")
              + f", {tr['bounces']:.0f} bounces, lobes "
              + ('n/a' if tr['lobe_kernel_share'] is None else
                 f"{tr['lobe_calls']:.0f} calls, "
                 f"{tr['lobe_kernel_share']:.0%} by the kernels, "
                 f"{tr['lobe_lanes']:.0f} lanes")
              + ", rng " + ('n/a' if tr['rng_kernel_share'] is None else
                           f"{tr['rng_calls']:.0f} calls, "
                           f"{tr['rng_kernel_share']:.0%} by F3, "
                           f"{tr['rng_lanes']:.0f} lanes, device "
                           + ('n/a' if r['rng_ms'] is None else
                              f"{r['rng_ms']:.2f} ms"))
              + "; idle ms " + ', '.join(
                  f"{c} {idle[c] * 1e3:.1f}"
                  for c in IDLE_CLASSES + ('total',))
              + f"; on {card}", flush=True)
    print(json.dumps({'card': card, 'cells': rows}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
