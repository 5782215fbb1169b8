// Dense ray-triangle kernels: every ray against every triangle.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_dense.py:
//   yrt_intersect_dense <- _kernel     (intersect_dense, closest hit)
//   yrt_occluded_dense  <- _kernel_occ (occluded_dense, any hit)
// The reference runs them for scenes of at most 2048 triangles
// (scene.py BRUTE_FORCE_MAX_TRIS), e.g. the cornell box.
//
// Design: one thread per ray; each block of 128 rays stages tiles of
// packed triangle rows in shared memory and every thread loops over the
// whole tile.  Triangles are visited in ascending index order and a hit
// replaces the best only when strictly nearer, so ties keep the lowest
// index, as the reference does.  The any-hit kernel leaves the tile loop
// once every ray of the block is occluded.
//
// What bounds it on the H100: the Woop test is ~40 f32 operations per
// (ray, triangle) pair with no reuse beyond the shared tile, so the
// kernel is bound by the SMs' f32 issue rate (fused multiply-adds are
// disabled, --fmad=false, to keep rounding equal to the torch version).
// Making it fast (fmad, wider tiles, several rays per thread) is later
// work.
#include "woop.cuh"

#define DENSE_BLOCK 128
#define DENSE_TILE 128   // triangles per shared-memory tile (8 KB)

__global__ void __launch_bounds__(DENSE_BLOCK)
intersect_dense_kernel(const float4* __restrict__ tris, int n_tris,
                       const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar, int n_rays,
                       float* __restrict__ t_out, int* __restrict__ tri_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ float4 tile[DENSE_TILE * 4];
    const int i = blockIdx.x * DENSE_BLOCK + threadIdx.x;
    const bool live = i < n_rays;
    Ray r = {};
    if (live) r = load_ray(org, dir, tnear, tfar, i);
    float t_b = CUDART_INF_F, u_b = 0.0f, v_b = 0.0f;
    int tri_b = -1;
    for (int base = 0; base < n_tris; base += DENSE_TILE) {
        const int cnt = min(DENSE_TILE, n_tris - base);
        __syncthreads();
        for (int k = threadIdx.x; k < 4 * cnt; k += DENSE_BLOCK)
            tile[k] = tris[4 * base + k];
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < cnt; ++j) {
            float th, uh, vh;
            const float* s = reinterpret_cast<const float*>(&tile[4 * j]);
            if (woop_test(s, r, r.tnear, r.tfar, th, uh, vh) && th < t_b) {
                t_b = th;
                tri_b = base + j;
                u_b = uh;
                v_b = vh;
            }
        }
    }
    if (live) {
        t_out[i] = t_b;
        tri_out[i] = tri_b;
        u_out[i] = u_b;
        v_out[i] = v_b;
    }
}

__global__ void __launch_bounds__(DENSE_BLOCK)
occluded_dense_kernel(const float4* __restrict__ tris, int n_tris,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar, int n_rays,
                      bool* __restrict__ occ_out) {
    __shared__ float4 tile[DENSE_TILE * 4];
    const int i = blockIdx.x * DENSE_BLOCK + threadIdx.x;
    const bool live = i < n_rays;
    Ray r = {};
    if (live) r = load_ray(org, dir, tnear, tfar, i);
    bool occ = false;
    for (int base = 0; base < n_tris; base += DENSE_TILE) {
        // block-wide early exit: every ray done (uniform branch)
        if (__syncthreads_and(!live || occ)) break;
        const int cnt = min(DENSE_TILE, n_tris - base);
        for (int k = threadIdx.x; k < 4 * cnt; k += DENSE_BLOCK)
            tile[k] = tris[4 * base + k];
        __syncthreads();
        if (!live || occ) continue;
        for (int j = 0; j < cnt; ++j) {
            float th, uh, vh;
            const float* s = reinterpret_cast<const float*>(&tile[4 * j]);
            if (woop_test(s, r, r.tnear, r.tfar, th, uh, vh)) {
                occ = true;
                break;
            }
        }
    }
    if (live) occ_out[i] = occ;
}

extern "C" int yrt_intersect_dense(const void* tris, int n_tris,
                                   const void* org, const void* dir,
                                   const void* tnear, const void* tfar,
                                   int n_rays, void* t_out, void* tri_out,
                                   void* u_out, void* v_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + DENSE_BLOCK - 1) / DENSE_BLOCK;
        intersect_dense_kernel<<<grid, DENSE_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tris), n_tris,
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_occluded_dense(const void* tris, int n_tris,
                                  const void* org, const void* dir,
                                  const void* tnear, const void* tfar,
                                  int n_rays, void* occ_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + DENSE_BLOCK - 1) / DENSE_BLOCK;
        occluded_dense_kernel<<<grid, DENSE_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(tris), n_tris,
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}
