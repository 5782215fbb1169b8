"""Device ms a frame outside the port's kernels: the torch glue of the
bounce (shading, lights, roulette, compaction, raygen, film)."""


def read(ctx):
    if ctx['busy_us'] <= 0:
        return None
    return (ctx['busy_us'] - ctx['kernel_us']) / 1e3 / ctx['frames']
