"""Device ms a frame in the port's traversal kernels (K3/K4 and any
other csrc/ kernel a path reaches), told apart by __global__ name."""


def read(ctx):
    if ctx['kernel_us'] <= 0:
        return None
    return ctx['kernel_us'] / 1e3 / ctx['frames']
