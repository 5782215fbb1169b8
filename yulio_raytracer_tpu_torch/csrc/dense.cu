// Dense ray-triangle kernels: every ray against every live triangle row.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_dense.py:
//   yrt_intersect_dense <- _kernel     (intersect_dense, closest hit)
//   yrt_occluded_dense  <- _kernel_occ (occluded_dense, any hit)
// The reference runs them for scenes of at most 2048 triangles
// (scene.py BRUTE_FORCE_MAX_TRIS), e.g. the cornell box.
//
// What bounds it on the H100: the Woop test has no reuse beyond the
// shared tile, so the kernels are bound by the SMs' f32 issue rate.
// Fused multiply-adds are disabled (--fmad=false) and 1/d'_w is the IEEE
// reciprocal, to keep rounding equal to the plain torch version op for
// op.  So the design cuts the instructions a pair issues, never the
// operations a value is made of:
// - Live rows only.  The packed table is padded to a multiple of 128
//   triangles with zero rows, which never hit (d'_w is 0, or NaN for a
//   non-finite direction, so the |d'_w| test fails).  The wrapper passes
//   as n_tris the count of rows up to the last non-zero one
//   (ops/dense.py live_rows); cornell holds 32 live rows of 128.
// - The test in stages (dense_plane, dense_inside).  Stage 1 computes
//   d'_w, o'_w and the plane distance th (18 flops), and stops the pair
//   unless th lies in (tnear, limit): the closest-hit kernel's limit is
//   its best t so far (tfar before the first hit), the any-hit kernel's
//   tfar.  Stage 2, only where stage 1 passes, computes u and v and
//   their tests (31 flops with the cull flag's); stage 3, only for a row
//   whose cull flag is 1 (the same row for every lane of a warp, so a
//   uniform branch), ng.d (6).  A one-pass test costs all 55.  Every
//   value that is computed keeps woop_test's operation order (woop.cuh),
//   so t, u and v are bit-equal to the plain version's.  The plain
//   versions count each stage's tests for the bound (ops/dense.py
//   staged_flops).
// - The loop.  Each block of 128 threads stages tiles of up to 128 rows
//   (8 KB) in shared memory, read as float4 (every lane of a warp reads
//   the same row: a broadcast) and visited in ascending order; a hit
//   replaces the best only when strictly nearer, so ties keep the lowest
//   index, as the reference does.  A table of up to 2048 rows (128 KB)
//   is read in 16 bounded tiles.  The closest-hit kernel runs two rays
//   per thread (DENSE_RAYS): each row is read once for both, the two
//   stage-1 tests overlap, and there is a barrier only where another
//   tile follows.  The any-hit kernel runs one ray per thread, stops a
//   ray at its first hit and the block once all its rays are done
//   (__syncthreads_and before each tile).  Timed in turns on the
//   cornell_512 frame's own calls (dense_turns.py; PERF.md): one ray per
//   thread was ~7% slower for the closest-hit kernel, four level with
//   two; two rays per thread lost for the any-hit kernel (a pair of rays
//   stops at the later of their first hits).  Per-warp tiles with a warp
//   vote were 2-3% faster for the any-hit kernel on cornell's one-tile
//   table and rows read from global memory with no staging 4-6% faster;
//   K2 is under 2% of cornell_512's frame time (PERF.md), so neither gain
//   is worth a second loop design: both kernels keep one bounded tile
//   loop.
#include "woop.cuh"

#define DENSE_BLOCK 128      // threads per block
#define DENSE_TILE 128       // rows per block tile (8 KB)
#define DENSE_RAYS 2         // rays per thread of the closest-hit kernel

// Stage 1 of the Woop test on row s (4 float4: s[0..16)): th receives
// the plane distance -o'_w / d'_w; returns whether |d'_w| > 1e-12 and
// tnear < th < limit.  th is only defined where d'_w passes, as woop_test
// uses it.
__device__ __forceinline__ bool dense_plane(const float4* s, const Ray& r,
                                            float limit, float& th) {
    const float4 a = s[0], b = s[1], c = s[2];
    const float owp = r.ox * a.z + r.oy * b.y + r.oz * c.x + c.w;
    const float dwp = r.dx * a.z + r.dy * b.y + r.dz * c.x;
    th = -owp * (1.0f / dwp);
    return fabsf(dwp) > 1e-12f && th > r.tnear && th < limit;
}

// Stages 2 and 3 on a pair that passed stage 1: the barycentrics at th,
// accepted inclusively by BARY_EPS, and for a culled row (flag 1)
// ng.d < 0.
__device__ __forceinline__ bool dense_inside(const float4* s, const Ray& r,
                                             float th, float& uh,
                                             float& vh) {
    const float4 a = s[0], b = s[1], c = s[2];
    const float oup = r.ox * a.x + r.oy * a.w + r.oz * b.z + c.y;
    const float ovp = r.ox * a.y + r.oy * b.x + r.oz * b.w + c.z;
    const float dup = r.dx * a.x + r.dy * a.w + r.dz * b.z;
    const float dvp = r.dx * a.y + r.dy * b.x + r.dz * b.w;
    uh = oup + th * dup;
    vh = ovp + th * dvp;
    if (!((uh >= -YRT_BARY_EPS) && (vh >= -YRT_BARY_EPS)
          && (uh + vh <= YRT_ONE_PLUS_BARY_EPS)))
        return false;
    const float4 d = s[3];
    if (d.w != 1.0f) return true;
    const float ngd = r.dx * d.x + r.dy * d.y + r.dz * d.z;
    return ngd < 0.0f;
}

__global__ void __launch_bounds__(DENSE_BLOCK)
intersect_dense_kernel(const float4* __restrict__ tris, int n_tris,
                       const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar, int n_rays,
                       float* __restrict__ t_out, int* __restrict__ tri_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ float4 tile[DENSE_TILE * 4];
    // rays i0 + q * DENSE_BLOCK; a ray past n_rays stays zero, and a zero
    // direction never passes stage 1
    const int i0 = blockIdx.x * DENSE_BLOCK * DENSE_RAYS + threadIdx.x;
    Ray r[DENSE_RAYS];
    // a hit must lie before tfar and strictly before the best so far:
    // one limit, tfar until the first hit, then the best t
    float limit[DENSE_RAYS], u_b[DENSE_RAYS], v_b[DENSE_RAYS];
    int tri_b[DENSE_RAYS];
#pragma unroll
    for (int q = 0; q < DENSE_RAYS; ++q) {
        const int i = i0 + q * DENSE_BLOCK;
        r[q] = Ray{};
        if (i < n_rays) r[q] = load_ray(org, dir, tnear, tfar, i);
        limit[q] = r[q].tfar;
        u_b[q] = v_b[q] = 0.0f;
        tri_b[q] = -1;
    }
    for (int base = 0; base < n_tris; base += DENSE_TILE) {
        const int cnt = min(DENSE_TILE, n_tris - base);
        if (base > 0) __syncthreads();   // every thread done with the last
        for (int k = threadIdx.x; k < 4 * cnt; k += DENSE_BLOCK)
            tile[k] = tris[4 * base + k];
        __syncthreads();
        if (i0 >= n_rays) continue;
        for (int j = 0; j < cnt; ++j) {
            const float4* s = tile + 4 * j;
            float th[DENSE_RAYS];
            bool pass[DENSE_RAYS];
#pragma unroll
            for (int q = 0; q < DENSE_RAYS; ++q)
                pass[q] = dense_plane(s, r[q], limit[q], th[q]);
#pragma unroll
            for (int q = 0; q < DENSE_RAYS; ++q) {
                float uh, vh;
                if (pass[q] && dense_inside(s, r[q], th[q], uh, vh)) {
                    limit[q] = th[q];
                    tri_b[q] = base + j;
                    u_b[q] = uh;
                    v_b[q] = vh;
                }
            }
        }
    }
#pragma unroll
    for (int q = 0; q < DENSE_RAYS; ++q) {
        const int i = i0 + q * DENSE_BLOCK;
        if (i < n_rays) {
            t_out[i] = tri_b[q] >= 0 ? limit[q] : CUDART_INF_F;
            tri_out[i] = tri_b[q];
            u_out[i] = u_b[q];
            v_out[i] = v_b[q];
        }
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
        const int cnt = min(DENSE_TILE, n_tris - base);
        // every thread done with the last tile; the block leaves once
        // all its rays are
        if (__syncthreads_and(occ || !live)) break;
        for (int k = threadIdx.x; k < 4 * cnt; k += DENSE_BLOCK)
            tile[k] = tris[4 * base + k];
        __syncthreads();
        if (occ || !live) continue;
        for (int j = 0; j < cnt; ++j) {
            const float4* s = tile + 4 * j;
            float th, uh, vh;
            if (dense_plane(s, r, r.tfar, th)
                && dense_inside(s, r, th, uh, vh)) {
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
        const int grid = (n_rays + DENSE_BLOCK * DENSE_RAYS - 1)
                         / (DENSE_BLOCK * DENSE_RAYS);
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
