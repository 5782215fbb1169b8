// Shared device code of the port's intersection kernels (dense.cu, wide.cu).
//
// Triangles are packed rows of 16 floats [woop (12) | ng (3) | cull]
// (ops/wide.py pack_tris).  The Woop test below copies the operation
// order of the reference kernels (yulio_raytracer_tpu/ops/pallas_dense.py
// _tri8) and of the plain torch version (ops/intersect.py woop_test); the
// sources are compiled with --fmad=false so no product is fused into a
// sum and both sides round the same way, op for op.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// 32 f32-ulps-at-1.0, inclusive (ops/intersect.py BARY_EPS = 2^-18)
#define YRT_BARY_EPS 3.814697265625e-06f
#define YRT_ONE_PLUS_BARY_EPS 1.000003814697265625f

struct Ray {
    float ox, oy, oz, dx, dy, dz, tnear, tfar;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        const float* __restrict__ tnear,
                                        const float* __restrict__ tfar,
                                        int i) {
    // 3 * i overflows an int from i = 2^31 / 3 on; the wrappers allow
    // up to 2^30 rays (ops/cuda_build.py MAX_RAYS)
    const size_t k = 3 * static_cast<size_t>(i);
    Ray r;
    r.ox = __ldg(org + k + 0);
    r.oy = __ldg(org + k + 1);
    r.oz = __ldg(org + k + 2);
    r.dx = __ldg(dir + k + 0);
    r.dy = __ldg(dir + k + 1);
    r.dz = __ldg(dir + k + 2);
    r.tnear = __ldg(tnear + i);
    r.tfar = __ldg(tfar + i);
    return r;
}

// One packed triangle row s[0..16) against one ray segment (tnear, tfar).
// Returns whether it hits; th/uh/vh receive the hit distance and
// barycentrics.
__device__ __forceinline__ bool woop_test(const float* s, const Ray& r,
                                          float tnear, float tfar,
                                          float& th, float& uh, float& vh) {
    float oup = r.ox * s[0] + r.oy * s[3] + r.oz * s[6] + s[9];
    float ovp = r.ox * s[1] + r.oy * s[4] + r.oz * s[7] + s[10];
    float owp = r.ox * s[2] + r.oy * s[5] + r.oz * s[8] + s[11];
    float dup = r.dx * s[0] + r.dy * s[3] + r.dz * s[6];
    float dvp = r.dx * s[1] + r.dy * s[4] + r.dz * s[7];
    float dwp = r.dx * s[2] + r.dy * s[5] + r.dz * s[8];
    bool nz = fabsf(dwp) > 1e-12f;
    float inv_dw = nz ? 1.0f / dwp : 0.0f;
    th = -owp * inv_dw;
    uh = oup + th * dup;
    vh = ovp + th * dvp;
    float ngd = r.dx * s[12] + r.dy * s[13] + r.dz * s[14];
    bool cull_ok = (s[15] != 1.0f) || (ngd < 0.0f);
    return nz && (uh >= -YRT_BARY_EPS) && (vh >= -YRT_BARY_EPS)
        && (uh + vh <= YRT_ONE_PLUS_BARY_EPS)
        && (th > tnear) && (th < tfar) && cull_ok;
}
