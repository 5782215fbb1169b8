// Shared device code of the port's BVH traversal kernels (wide.cu,
// binary.cu, splitleaf.cu): the per-ray stack size, the slab test of one
// node box (read from global memory, or held as two float4s), the load
// of one packed triangle row, and the warp's leaf schedule of K3-K6: a
// leaf's triangles tested across the warp's lanes against one lane's ray
// (lane_test, shfl_ray), the closest of those tests taken in the order a
// sequential strictly-nearer loop keeps (order_key, Best, take_closest).
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
// every lane of a warp
#define FULL_MASK 0xffffffffu

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

// Lane j's test of triangle a + j0 + j of a leaf of c triangles against
// ray q over (q.tnear, tfar); false past the leaf's end.
__device__ __forceinline__ bool lane_test(const float4* __restrict__ tris,
                                          const Ray& q, float tfar, int a,
                                          int c, int j0, float& th,
                                          float& uh, float& vh) {
    const int j = j0 + static_cast<int>(threadIdx.x & 31);
    if (j >= c) return false;
    float s[16];
    load_row<4>(tris, 4, a + j, s);
    return woop_test(s, q, q.tnear, tfar, th, uh, vh);
}

__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
    Ray q;
    q.ox = __shfl_sync(FULL_MASK, r.ox, src);
    q.oy = __shfl_sync(FULL_MASK, r.oy, src);
    q.oz = __shfl_sync(FULL_MASK, r.oz, src);
    q.dx = __shfl_sync(FULL_MASK, r.dx, src);
    q.dy = __shfl_sync(FULL_MASK, r.dy, src);
    q.dz = __shfl_sync(FULL_MASK, r.dz, src);
    q.tnear = __shfl_sync(FULL_MASK, r.tnear, src);
    q.tfar = __shfl_sync(FULL_MASK, r.tfar, src);
    return q;
}

// t's bits as an unsigned that orders as t does (-0 taken as +0)
__device__ __forceinline__ unsigned order_key(float t) {
    const unsigned u = __float_as_uint(t + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a ray's closest hit so far: tri -1 and t its tfar before the first
struct Best {
    float t, u, v;
    int tri;
};

// The closest of the warp's lane tests (lane j testing triangle first + j,
// a hit h at th, uh, vh): the least t, ties to the lowest lane, as a
// sequential strictly-nearer loop in ascending order keeps it.  tb (the
// same on every lane) becomes that t, and lane src's best that hit.
__device__ __forceinline__ void take_closest(bool h, float th, float uh,
                                             float vh, int first, int src,
                                             float& tb, Best& best) {
    const unsigned key = h ? order_key(th) : FULL_MASK;
    const unsigned least = __reduce_min_sync(FULL_MASK, key);
    if (least == FULL_MASK) return;
    const int win = __ffs(__ballot_sync(FULL_MASK, key == least)) - 1;
    tb = __shfl_sync(FULL_MASK, th, win);
    const float ub = __shfl_sync(FULL_MASK, uh, win);
    const float vb = __shfl_sync(FULL_MASK, vh, win);
    if (static_cast<int>(threadIdx.x & 31) == src) {
        best = {tb, ub, vb, first + win};
    }
}
