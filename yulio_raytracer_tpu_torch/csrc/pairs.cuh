// Shared device code of the port's grid kernels (grid.cu): the slot layout
// and the closest-hit update rule.
//
// Triangles sit in tiles of PAIR_TILE slots; slot s is the 64-byte row
// [woop.T (12) | ng (3) | cull] of one triangle (ops/pairs.py pack_planes,
// ops/grid.py build_grid), read as four float4 loads.  The reference's
// kernels read the same constants lane-major (`planes`), the layout of the
// TPU's vector unit; a thread that tests one triangle reads its row.
//
// The pair test is woop_test (woop.cuh): it is the operation order of the
// reference's `_pair_tile` (yulio_raytracer_tpu/ops/pallas_pairs.py) as
// well, |dwp| > 1e-12, th = -owp * (1 / dwp), the inclusive BARY_EPS
// window, tnear < th < tfar, and the cull flag 1.0 rejecting
// dot(ng, dir) >= 0; with --fmad=false, t is bit-equal to the plain torch
// version's (ops/intersect.py woop_test).
#pragma once

#include "bvh.cuh"

#define PAIR_TILE 128

// Let a hit (hit, th) at slot s replace (best_t, best_slot), slots taken
// in ascending order.  Ties follow the TPU kernel, which keeps a best t
// per lane (slot % PAIR_TILE), updated on a strictly nearer hit, then
// takes the least lane among the minima: among equal t the least lane
// wins, then the earliest slot.
__device__ __forceinline__ void take_closer(bool hit, float th, int s,
                                            float& best_t, int& best_slot) {
    if (hit && (th < best_t
                || (th == best_t
                    && s % PAIR_TILE < best_slot % PAIR_TILE))) {
        best_t = th;
        best_slot = s;
    }
}
