"""Host ms a refinement presenting: tonemap, to_srgb_u8 and the copy
of the image to the host (the benchmark's own span; the median over
every refinement of the run)."""
import numpy as np


def read(ctx):
    if not ctx['present_s']:
        return None
    return float(np.median(ctx['present_s'])) * 1e3
