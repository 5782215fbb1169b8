"""Rays traced a second, in millions: FrameStats.num_rays (closest-hit
rays and shadow candidates) over the wall seconds of the measured
window, which runs before the profiled frames."""


def read(ctx):
    rays, wall = ctx['window_rays'], ctx['window_wall_s']
    return rays / wall / 1e6 if wall > 0 and rays > 0 else None
