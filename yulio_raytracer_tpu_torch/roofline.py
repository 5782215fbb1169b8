"""The least time the card could take for a kernel's work, from which
`chip_smoke.py`, `wide_ab` and the `turns` tool state every bound: the
larger of the bytes the function must move (each input read once, each
output written once) over the card's memory rate, and the operations it
does over its peak f32 rate.  The rates are the H100 SXM's published
peaks; the flops of one test are counted from the kernels' sources.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12   # HBM3 bytes/s
PEAK_FLOPS = 67e12     # f32 flops/s outside the tensor cores
# flops of one test, counted from the sources: every multiply, add,
# subtract, negate, divide, abs and compare (selects are free)
WOOP_FLOPS = 55     # csrc/woop.cuh woop_test: six 3-term dot products
#                     (33), |dwp| test (2), 1/dwp (1), th (2), u and v (4),
#                     ng.d (5), cull (2), window tests (6); the dense
#                     kernels run it in stages, counted per stage by their
#                     plain versions (ops/dense.py staged_flops)
MOTION_FLOPS = 87   # csrc/motion.cuh motion_test: edges at time s (12),
#                     p, ng, q crosses (27), det, ng.d, u, v, th (28), tv (9),
#                     |det| test and 1/det (3), cull (2), window tests (6)
SLAB_FLOPS = 25     # csrc/bvh.cuh slab: 6 subtracts, 6 multiplies, 12
#                     min/max, 1 compare
PROTO_FLOPS = 48    # csrc/sweep.cu proto_test: six dot products (33), |dwp|
#                     and its test (2), 1/dwp (1), th (2), u and v (4),
#                     u + v and five compares (6)


def times(moved, flops):
    """(bytes_ms, flops_ms): the least time to move `moved` bytes, and
    to do `flops` f32 operations, each at the card's peak."""
    return moved / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3


def bound(moved, flops):
    """(bound_ms, bound_by): the larger of times(moved, flops), and
    'bytes' or 'operations', whichever it is."""
    bytes_ms, flops_ms = times(moved, flops)
    return (max(bytes_ms, flops_ms),
            'bytes' if bytes_ms >= flops_ms else 'operations')
