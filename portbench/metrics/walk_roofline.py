"""The traversal kernels' share of their bound, in %, bound by bytes:
each counted ray read once (32 B) and its result written once (16 B),
the scene's triangles once a frame (36 B each), at the card's peak
bandwidth, over the kernels' device time."""
from portbench import tracing


def read(ctx):
    if ctx['kernel_us'] <= 0 or ctx['num_rays'] <= 0:
        return None
    nbytes = (ctx['num_rays'] * (32 + 16)
              + ctx['num_triangles'] * 36 * ctx['frames'])
    return 100.0 * nbytes / tracing.PEAK_BYTES_S / (ctx['kernel_us'] * 1e-6)
