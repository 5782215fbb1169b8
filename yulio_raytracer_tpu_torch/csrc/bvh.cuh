// Shared device code of the port's BVH traversal kernels (wide.cu,
// binary.cu, splitleaf.cu): the per-ray stack size, the slab test of one
// node box (read from global memory, or held as two float4s) and the load
// of one packed triangle row.
//
// A node box is 8 floats [lo.x lo.y lo.z hi.x hi.y hi.z A tag] (a BVH4
// slot of ops/wide.py pack_nodes4, or a binary node row of
// ops/traverse.py pack_nodes).  The slab test copies the operation order
// of the reference kernels (yulio_raytracer_tpu/ops/pallas_traverse.py
// _kernel slab) and of the plain torch version (ops/wide.py _slab).
#pragma once

#include "woop.cuh"

// per-ray stack entries: pack_nodes4 / pack_nodes check that the tree's
// worst-case occupancy fits
#define STACK 128

struct Slab {
    float ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (fabsf(d) > 1e-30f ? d : (d >= 0.0f ? 1e-30f : -1e-30f));
}

// slab test of the box lo/hi in the reference's order; returns
// tmin <= tmax and the entry distance tmin.
__device__ __forceinline__ bool slab_box(float lox, float loy, float loz,
                                         float hix, float hiy, float hiz,
                                         const Ray& r, const Slab& inv,
                                         float tnear, float tfar,
                                         float& tmin) {
    float t0x = (lox - r.ox) * inv.ix;
    float t1x = (hix - r.ox) * inv.ix;
    float t0y = (loy - r.oy) * inv.iy;
    float t1y = (hiy - r.oy) * inv.iy;
    float t0z = (loz - r.oz) * inv.iz;
    float t1z = (hiz - r.oz) * inv.iz;
    tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                 fmaxf(fminf(t0z, t1z), tnear));
    float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                       fminf(fmaxf(t0z, t1z), tfar));
    return tmin <= tmax;
}

// the slab test of one node box (8 floats at s, in global memory)
__device__ __forceinline__ bool slab(const float* __restrict__ s,
                                     const Ray& r, const Slab& inv,
                                     float tnear, float tfar, float& tmin) {
    return slab_box(__ldg(s + 0), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
                    __ldg(s + 4), __ldg(s + 5), r, inv, tnear, tfar, tmin);
}

// the same test of a BVH4 slot held as two float4s,
// (lo.x lo.y lo.z hi.x) and (hi.y hi.z A tag)
__device__ __forceinline__ bool slab4(float4 p, float4 q, const Ray& r,
                                      const Slab& inv, float tnear,
                                      float tfar, float& tmin) {
    return slab_box(p.x, p.y, p.z, p.w, q.x, q.y, r, inv, tnear, tfar, tmin);
}

// the first 4 * Q floats of packed triangle j, whose rows are `stride`
// float4s wide (4 for the Woop rows, 8 for the motion rows)
template <int Q>
__device__ __forceinline__ void load_row(const float4* __restrict__ tris,
                                         int stride, int j, float* w) {
    #pragma unroll
    for (int q = 0; q < Q; ++q) {
        float4 x = __ldg(tris + static_cast<size_t>(stride) * j + q);
        w[4 * q + 0] = x.x;
        w[4 * q + 1] = x.y;
        w[4 * q + 2] = x.z;
        w[4 * q + 3] = x.w;
    }
}
