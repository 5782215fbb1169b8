"""One run of one cell: set-up, the measured window, the traced frames,
the check against the plain reference, and the result line.

The scene is the configuration's, drawn by its generator from the
configuration's own scene_seed, so that every run renders the same
deployment and a seed does not change the work.  Everything else comes
from --seed through one numpy generator: the render seeds (camera
jitter, scatter, roulette and light samples) and the checked pixels
and frames.  Two modes of traffic:
  frames       whole frames back to back (render_frame, a new film
               each); frame_s, or face_s for a stereo face, = the
               window's seconds over its frames
  progressive  one viewer, closed loop: each refinement adds spp
               samples to one film (iteration rising) and ends with the
               tonemapped 8-bit image on the host; refine_ms_p95 = the
               95th percentile of every refinement's latency
A cell reports the end-to-end metrics of BENCHMARK.json whose workloads
hold it (setup_s in every one).
The configuration names its generator and, where its scene needs them,
its own plain reference and adapter to the program (parts, spec.py).
The window runs at least the traffic's min_frames (default 1) frames
or refinements; with --trace 1 its trace_frames more follow it under
torch.profiler (after a profiler the host runs slower a while, so the
window goes first).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import check, scenes, spec, tracing

SETUP_T0 = time.perf_counter()
# the keys of a scene description that port.py and reference/ read
DEFAULT_KEYS = frozenset({'meshes', 'materials', 'textures', 'quad_lights',
                          'ambient'})


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _merge(base: dict, extra) -> dict:
    out = dict(base)
    out.update(extra or {})
    return out


def load(workload: str, overrides=None) -> dict:
    """The cell's files merged: {'config', 'traffic', 'limits'};
    overrides (tests) may replace keys of each."""
    ov = overrides or {}
    c = spec.cell(workload)
    return {'config': _merge(spec.config(c['config']), ov.get('config')),
            'traffic': _merge(spec.traffic(c['traffic']), ov.get('traffic')),
            'limits': _merge(c['limits'], ov.get('limits'))}


def parts(cfg: dict):
    """(generator, description, reference, adapter) of a configuration,
    each found by name: its scene drawn from its scene_seed, its plain
    reference and its adapter to the program.  A description with a key
    beyond DEFAULT_KEYS raises unless the configuration names both a
    reference and an adapter of its own, which the defaults would
    ignore and so render another scene."""
    gen = scenes.generator(cfg['generator'])
    desc = gen.generate(cfg['scene_seed'], **cfg.get('generator_params', {}))
    extra = sorted(set(desc) - DEFAULT_KEYS)
    if extra and not ('port' in cfg and 'reference' in cfg):
        raise ValueError(
            f"generator {cfg['generator']!r} describes {extra}, which "
            "port.py and reference/ do not read: the configuration names "
            "a \"port\" and a \"reference\" of its own")
    return (gen, desc, spec.reference(cfg.get('reference')),
            spec.port(cfg.get('port')))


def reference_traffic(cfg: dict, traffic: dict) -> dict:
    """The traffic as the plain reference reads it: with the
    configuration's shadow cap, and for a reference of the
    configuration's own the whole configuration under 'config'."""
    tr = dict(traffic, t_max_shadow_ray=cfg.get('t_max_shadow_ray'))
    if 'reference' in cfg:
        tr['config'] = cfg
    return tr


def draws(seed: int, tr: dict, npix: int) -> dict:
    """Everything a run draws from its seed."""
    rs = np.random.default_rng(int(seed) % (1 << 64))
    p = tr['check']['pixels']
    return {'render_seed': int(rs.integers(2 ** 31)),
            'pixels': [np.sort(rs.choice(npix, size=p, replace=False))
                       for _ in range(tr['check'].get('pixel_sets', 1))],
            'rs': rs}


def frame_seed(render_seed: int, frame: int) -> int:
    return (render_seed + 7919 * frame) & 0xFFFFFFFF


def run(workload: str, seed: int, seconds: float, trace: bool,
        device='cuda', overrides=None, fault=None, control=False,
        t0=None) -> dict:
    """One run.  fault(render) -> render wraps the timed path's render
    call (the tests' broken runs); control=True puts the reference in
    bfloat16 in the program's place at the checked pixels; t0: the
    process's start on the clock, where set-up begins.  Returns the
    result dict: the result line's keys, the check's seconds, each
    frame's or refinement's latency ('latencies_s'), and 'compared'
    last."""
    cs = load(workload, overrides)
    cfg, tr = cs['config'], cs['traffic']
    w, h = tr['width'], tr['height']
    d = draws(seed, tr, w * h)
    gen, desc, ref, port = parts(cfg)
    cam_spec = cfg['cameras'][tr['camera']]
    scene = port.commit(desc, device, cfg['leaf_size'])
    cam = port.camera(cam_spec, w, h)
    prm = port.params(cfg, tr)
    render = port.render if fault is None else fault(port.render)
    progressive = tr['mode'] == 'progressive'
    idx = [torch.as_tensor(p, device=device) for p in d['pixels']]
    if progressive:
        ys, xs = d['pixels'][0] // w, d['pixels'][0] % w
    # warm-up: the cell's own shapes, once
    film, _ = port.render(scene, cam, prm, tr, d['render_seed'])
    if progressive:
        port.present(film, tr['gamma'])
    del film
    _sync(device)
    setup_s = time.perf_counter() - (SETUP_T0 if t0 is None else t0)
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats()

    n_traced = tr['trace_frames'] if trace else 0
    kept, images, lat, pres = [], [], [], []
    rays = [0.0, 0.0]                       # the window's, the traced
    prof, n_window, film, n = None, 0, None, 0
    t_start = t_now = time.perf_counter()
    while True:
        if (n_traced and prof is None and t_now - t_start >= seconds
                and n >= tr.get('min_frames', 1)):
            # the window has closed: the traced frames follow it
            n_window, t_window = n, t_now
            prof = profiler(device)
            prof.__enter__()
            t_traced = time.perf_counter()
        t_req = time.perf_counter()
        if progressive:
            film, stats = render(scene, cam, prm, tr, d['render_seed'],
                                 film=film, iteration=n)
            t1 = time.perf_counter()
            images.append(port.present(film, tr['gamma'])[ys, xs])
            t_now = time.perf_counter()
            lat.append(t_now - t_req)
            pres.append(t_now - t1)
        else:
            film, stats = render(scene, cam, prm, tr,
                                 frame_seed(d['render_seed'], n))
            kept.append(film.rgb_sum.reshape(-1, 3)[idx[n % len(idx)]])
            film = None
            _sync(device)
            t_now = time.perf_counter()
            lat.append(t_now - t_req)
        rays[prof is not None] += stats.num_rays
        n += 1
        if prof is not None and n - n_window == n_traced:
            traced_wall = t_now - t_traced
            prof.__exit__(None, None, None)
            break
        if (not n_traced and t_now - t_start >= seconds
                and n >= tr.get('min_frames', 1)):
            break
    window = t_now - t_start if not trace else t_window - t_start
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == 'cuda' else 0)

    # the check, with the program's state freed
    if progressive:
        last = film.rgb_sum.reshape(-1, 3)[idx[0]].cpu()
        program = {'images': np.stack(images), 'film': last}
    else:
        program = {'frames': torch.stack(kept).cpu()}
    del scene, film, kept
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(cs, d, desc, cam_spec, n, program, device, control,
                      ref)
    check_s = time.perf_counter() - t_check
    correct, shown = check.verdict(numbers, cs['limits'])

    out = {'correct': correct, 'attempted': n,
           'failed': 0 if correct else n,
           'metrics': {}, 'device': device_info(device, peak)}
    if not trace:
        values = {'frame_s': window / n, 'face_s': window / n,
                  'refine_ms_p95': float(np.percentile(lat, 95)) * 1e3,
                  'setup_s': setup_s}
        for m in spec.benchmark()['end_to_end']:
            if workload in m.get('workloads', [workload]):
                out['metrics'][m['name']] = {'value': values[m['name']],
                                             'unit': m['unit']}
    else:
        red = tracing.reduce(prof, set(port.span_names().values()))
        ctx = dict(red, mode=tr['mode'], frames=n_traced, wall_s=traced_wall,
                   num_rays=rays[1], num_triangles=gen.num_triangles(desc),
                   window_frames=n_window, window_rays=rays[0],
                   window_wall_s=window, present_s=pres,
                   spans=port.span_names())
        out['metrics'] = layer_metrics(workload, ctx)
        out['device']['busy_s'] = red['busy_us'] * 1e-6
        out['device']['window_s'] = traced_wall
        out['breakdown'] = {'device_ops': red['device_ops'],
                            'idle_gaps': tracing.idle_gaps(prof)}
    out['check_s'] = check_s
    out['latencies_s'] = lat
    out['compared'] = shown
    return out


def compare(cs, d, desc, cam_spec, n, program, device, control,
            reference) -> dict:
    """The reference at the checked pixels of the checked frames (or of
    every refinement), and the numbers against what the program made.
    control=True replaces the program's answers by the reference's own
    in bfloat16."""
    tr = reference_traffic(cs['config'], cs['traffic'])
    prep = reference.prepare(desc, device)
    low = reference.prepare(desc, device, torch.bfloat16) if control else None
    if tr['mode'] == 'progressive':
        pids = torch.as_tensor(d['pixels'][0], device=device)
        seeds = torch.full_like(pids, d['render_seed'])
        ref = reference.pixels(prep, tr, cam_spec, seeds, pids, n * tr['spp'])
        if control:
            lo = reference.pixels(low, tr, cam_spec, seeds, pids,
                                  n * tr['spp'])
            sums = torch.cumsum(lo, dim=1)
            program = {'images': torch.stack(
                [check.present_u8(sums[:, k], k + 1, tr['gamma'])
                 for k in range(n)]).cpu().numpy(),
                'film': sums[:, -1].cpu()}
        return check.refinements(program['images'], program['film'].numpy(),
                                 ref, tr['gamma'])
    nf = min(n, tr['check']['frames'])
    picks = np.sort(d['rs'].choice(n, size=nf, replace=False))
    sets = d['pixels']
    pids = torch.cat([torch.as_tensor(sets[f % len(sets)]) for f in picks])
    seeds = torch.cat([torch.full((len(sets[f % len(sets)]),),
                                  frame_seed(d['render_seed'], int(f)),
                                  dtype=torch.int64) for f in picks])
    ref = reference.pixels(prep, tr, cam_spec, seeds.to(device),
                           pids.to(device), tr['spp']).sum(dim=1)
    got = program['frames'][torch.as_tensor(picks)].reshape(-1, 3)
    if control:
        got = reference.pixels(low, tr, cam_spec, seeds.to(device),
                               pids.to(device), tr['spp']).sum(dim=1)
    return check.frames(got.cpu().numpy(), ref.cpu().numpy())


def profiler(device):
    """torch.profiler over the host and, on the card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def layer_metrics(workload: str, ctx: dict) -> dict:
    """Every per-layer metric of BENCHMARK.json whose cells hold this
    one, read by metrics/<base>.py of its name; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in spec.benchmark()['per_layer']:
        if workload not in m.get('workloads', [workload]):
            continue
        value = spec.metric(m['name']).read(ctx)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def device_info(device, peak: int) -> dict:
    if torch.device(device).type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': 1, 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': 0}
