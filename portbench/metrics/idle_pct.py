"""The device's idle share of a frame, in %: 100 x (1 - device busy
time a profiled frame / wall time a frame of the measured window).
The port runs one stream, so the trace's activity times add up; the
wall time is the unprofiled window's, since the profiler slows the
host."""


def read(ctx):
    if ctx['busy_us'] <= 0 or ctx['window_wall_s'] <= 0:
        return None
    busy = ctx['busy_us'] * 1e-6 / ctx['frames']
    wall = ctx['window_wall_s'] / ctx['window_frames']
    return 100.0 * (1.0 - busy / wall)
