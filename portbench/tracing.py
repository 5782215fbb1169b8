"""Reduction of a torch.profiler trace of whole frames to what the
per-layer metrics read (the arithmetic of the port's profile_frame.py,
frozen here), and the published peaks of one NVIDIA H100.

Device activities are the CUDA events of the trace; the port runs one
stream, so their times add up to the busy time.  A port kernel is one
whose __global__ name is in KERNELS; every other device activity is the
torch glue around them.  A profiler range's device time is that of the
kernels launched inside it.
"""
from __future__ import annotations

import bisect
import re

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor) rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
# the port's kernels by their __global__ names (csrc/*.cu)
KERNELS = ('intersect_dense_kernel', 'occluded_dense_kernel',
           'intersect_wide_kernel', 'occluded_wide_kernel',
           'intersect_binary_kernel', 'occluded_binary_kernel',
           'intersect_motion_kernel', 'occluded_motion_kernel',
           'closest_pairs_kernel', 'occluded_pairs_kernel',
           'bin_count_kernel', 'bin_scan_kernel', 'bin_scatter_kernel',
           'march_kernel', 'split_kernel')
TOP = 10


def kernel_of(event_name: str):
    """The port kernel a profiler event names (mangled or demangled), or
    None."""
    m = re.match(r'_Z(\d+)', event_name)
    ident = (event_name[m.end():m.end() + int(m.group(1))] if m else
             event_name.removeprefix('void ').split('(')[0].split('<')[0])
    return ident if ident in KERNELS else None


def span_ms(ctx, what):
    """Device ms a frame inside the port's profiler range `what` (a key
    of ctx['spans']), or None where the range ran nothing."""
    us = ctx['span_us'].get(ctx['spans'][what], 0.0)
    return us / 1e3 / ctx['frames'] if us > 0 else None


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def reduce(prof, spans) -> dict:
    """Sums over the profiled frames: busy_us, launches, kernel_us and
    kernel_calls (the port's kernels), span_us {range name: device us}
    for the ranges in `spans`, and the ten device operations that took
    most time (device_ops: [name, seconds]).  A profiler range also
    shows on the device under its own name; that marker is no launch."""
    events = prof.key_averages()
    host = {e.key for e in events if not _is_device(e)}
    busy = kernel = 0.0
    launches = kernel_calls = 0
    span_us, ops = {}, []
    for evt in events:
        if not _is_device(evt):
            if evt.key in spans:
                span_us[evt.key] = evt.device_time_total
            continue
        if evt.key in host:
            continue
        us = evt.self_device_time_total
        busy += us
        launches += evt.count
        ops.append((us, evt.key))
        if kernel_of(evt.key) is not None:
            kernel += us
            kernel_calls += evt.count
    ops.sort(reverse=True)
    return {'busy_us': busy, 'launches': launches, 'kernel_us': kernel,
            'kernel_calls': kernel_calls, 'span_us': span_us,
            'device_ops': [[k[:80], us * 1e-6] for us, k in ops[:TOP]]}


def idle_gaps(prof) -> list:
    """The device's idle gaps inside the profiled window, summed by what
    the host was doing: the innermost host event open at each gap's
    middle.  [[name, seconds]], the ten largest."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        (dev if _is_device(e) else host).append((tr.start, tr.end, e.name))
    names = {h[2] for h in host}
    dev = [d for d in dev if d[2] not in names]      # range markers
    if len(dev) < 2:
        return []
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    by_name = {}
    end = dev[0][1]
    for s, e, _ in dev[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid) - 1
            name = 'host'
            # the innermost open event is the latest started one still
            # open; look back a bounded way
            for j in range(i, max(i - 256, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            by_name[name] = by_name.get(name, 0.0) + (s - end) * 1e-6
        end = max(end, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k[:80], v] for k, v in top]
