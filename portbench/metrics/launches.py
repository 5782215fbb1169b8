"""Device launches a frame (kernels, copies and fills), from the
profiler."""


def read(ctx):
    return ctx['launches'] / ctx['frames'] if ctx['launches'] > 0 else None
