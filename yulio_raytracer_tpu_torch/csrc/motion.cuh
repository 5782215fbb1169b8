// The motion-blur triangle test of the port's motion kernel K7
// (binary.cu), and its lane test for the warp's leaf schedule.
//
// A motion triangle is a packed row of 32 floats
// [v0 (3) e1 (3) e2 (3) mv0 (3) me1 (3) me2 (3) cull | pad]
// (ops/traverse.py pack_tris_mb); at time s the triangle is
// (v0 + s mv0, e1 + s me1, e2 + s me2).  The test below is the
// reference's time-interpolated Moller-Trumbore with the cull test
// (yulio_raytracer_tpu/ops/pallas_traverse.py _mb_tri_test) and the plain
// torch version's (ops/traverse.py mb_test), operation for operation; the
// sources are compiled with --fmad=false, so both round alike.  Zero rows
// (invalid triangles, padding) give det == 0 and never hit.
#pragma once

#include "bvh.cuh"

// w: the first 19 floats of a motion row; hit strictly inside
// (tnear, tfar).  th/uh/vh receive the hit distance and barycentrics.
__device__ __forceinline__ bool motion_test(const float* w, const Ray& r,
                                            float time, float tnear,
                                            float tfar, float& th,
                                            float& uh, float& vh) {
    const float e1x = w[3] + time * w[12];
    const float e1y = w[4] + time * w[13];
    const float e1z = w[5] + time * w[14];
    const float e2x = w[6] + time * w[15];
    const float e2y = w[7] + time * w[16];
    const float e2z = w[8] + time * w[17];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float ngx = e1y * e2z - e1z * e2y;
    const float ngy = e1z * e2x - e1x * e2z;
    const float ngz = e1x * e2y - e1y * e2x;
    const float ngd = r.dx * ngx + r.dy * ngy + r.dz * ngz;
    const bool cull_ok = (w[18] != 1.0f) || (ngd < 0.0f);
    const bool nz = fabsf(det) > 1e-12f;
    const float inv_det = nz ? 1.0f / det : 0.0f;
    const float tvx = r.ox - (w[0] + time * w[9]);
    const float tvy = r.oy - (w[1] + time * w[10]);
    const float tvz = r.oz - (w[2] + time * w[11]);
    uh = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    vh = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    th = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return nz && (uh >= -YRT_BARY_EPS) && (vh >= -YRT_BARY_EPS)
        && (uh + vh <= YRT_ONE_PLUS_BARY_EPS) && cull_ok
        && (th > tnear) && (th < tfar);
}

// Lane j's test of motion row a + j0 + j of a leaf of c rows against ray
// q at time tm over (q.tnear, tfar); false past the leaf's end (bvh.cuh
// lane_test over the motion rows, 8 float4s wide).
__device__ __forceinline__ bool lane_test_mb(const float4* __restrict__ tris,
                                             const Ray& q, float tm,
                                             float tfar, int a, int c, int j0,
                                             float& th, float& uh,
                                             float& vh) {
    const int j = j0 + static_cast<int>(threadIdx.x & 31);
    if (j >= c) return false;
    float w[20];
    load_row<5>(tris, 8, a + j, w);
    return motion_test(w, q, tm, q.tnear, tfar, th, uh, vh);
}
