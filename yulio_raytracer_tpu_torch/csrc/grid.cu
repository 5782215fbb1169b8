// Uniform-grid kernels: the ranged closest hit, the ranged any hit, and
// the whole-DDA grid march.
//
// Replaces the TPU kernels of yulio_raytracer_tpu:
//   yrt_intersect_pairs <- ops/pallas_pairs.py _kernel
//                          (intersect_pairs_raw, K8)
//   yrt_occluded_pairs  <- ops/pallas_pairs.py _kernel_any
//                          (occluded_pairs, K9)
//   yrt_grid_march      <- ops/grid.py _kernel_march
//                          (_march_raw / intersect_march, K10)
// The reference runs K8 and K9 in the DDA rounds of ray_binning='grid'
// (ops/grid.py intersect_grid / occluded_grid), each round sweeping every
// active ray's current cell; K10 is the same march in one kernel, reached
// by the reference's scripts and tests.
//
// Triangle rows: (Tp, 16) f32, Tp a multiple of 128 (pairs.cuh).  K8 and
// K9 take per-ray tile ranges [gs, ge) (null: the whole table); K8
// returns the best t (inf on a miss) and its slot (-1), K9 whether any
// slot hits, false for rays with tfar <= tnear.  K10 takes the cells'
// tile ranges cell_tile_lo/hi (res^3,) and the grid box, and returns
// (t, slot) like K8; the caller maps slots to triangles (tri_orig) and
// rebuilds u/v (ops/pairs.py recompute_uv), as the reference does.
//
// Design: one thread per ray, sweeping its slots in ascending order with
// the TPU kernel's tie rule (pairs.cuh).  K10 marches each ray through its
// own cells (Amanatides-Woo) with the constants of _kernel_march: the
// entry cell holds the point at the box entry plus an absolute 1e-6; a
// tie in the next crossing steps x before y before z; the ray stays live
// while the next cell's entry is <= min(tfar, best t).  The TPU's 16-ray
// groups, visited-cell mask and entry-cell sort are packet machinery that
// a single ray does not need: it visits each of its cells once, near to
// far.
//
// What bounds it on the H100: pair-test flops.  A ray sweeps whole cells
// (a mean of 2.3 tiles of 128 slots on the colonnade at res 8), 55 f32
// operations per slot (woop_test), and the rows of one cell are read by
// every ray in it, so the loads broadcast within a warp whose rays share
// a cell.  Divergent ranges across a warp run at the longest range; K10's
// rays march different numbers of cells, so its warps diverge most.  On
// an H100 (700 W) K8 and K9 ran at 22-25% of the f32 peak on their
// counted tests and K10 at 7% (PERF.md, chip_smoke.py).  Later work:
// staging a cell's rows in shared memory for the warp, sorting rays by
// cell (ROADMAP B7), --fmad=true once bit-equality with the torch version
// is no longer the contract.
#include "pairs.cuh"

#define GRID_BLOCK 128

__global__ void __launch_bounds__(GRID_BLOCK)
closest_pairs_kernel(const float4* __restrict__ rows,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar,
                     const int* __restrict__ gs, const int* __restrict__ ge,
                     int n_tiles, int n_rays, float* __restrict__ t_out,
                     int* __restrict__ slot_out) {
    const int i = blockIdx.x * GRID_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    const int s0 = gs ? __ldg(gs + i) * PAIR_TILE : 0;
    const int s1 = ge ? __ldg(ge + i) * PAIR_TILE : n_tiles * PAIR_TILE;
    float best_t = CUDART_INF_F;
    int best_slot = -1;
    sweep_closest(rows, s0, s1, r, best_t, best_slot);
    t_out[i] = best_t;
    slot_out[i] = best_slot;
}

__global__ void __launch_bounds__(GRID_BLOCK)
occluded_pairs_kernel(const float4* __restrict__ rows,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar,
                      const int* __restrict__ gs,
                      const int* __restrict__ ge, int n_tiles, int n_rays,
                      bool* __restrict__ occ_out) {
    const int i = blockIdx.x * GRID_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    const int s0 = gs ? __ldg(gs + i) * PAIR_TILE : 0;
    const int s1 = ge ? __ldg(ge + i) * PAIR_TILE : n_tiles * PAIR_TILE;
    occ_out[i] = r.tfar > r.tnear && sweep_any(rows, s0, s1, r);
}

__global__ void __launch_bounds__(GRID_BLOCK)
march_kernel(const float4* __restrict__ rows,
             const int* __restrict__ cell_lo, const int* __restrict__ cell_hi,
             const float* __restrict__ grid_lo,
             const float* __restrict__ grid_hi, int res,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tnear, const float* __restrict__ tfar,
             int n_rays, float* __restrict__ t_out,
             int* __restrict__ slot_out) {
    const int i = blockIdx.x * GRID_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    const float o[3] = {r.ox, r.oy, r.oz};
    const float d[3] = {r.dx, r.dy, r.dz};
    // the box as the reference kernel holds it: lo and the cell size in
    // f32, the far corner lo + res * cellsz rounded once from doubles
    float lo[3], hi[3], cs[3], inv[3];
    float tmin = -CUDART_INF_F, tmax = CUDART_INF_F;
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
        lo[k] = __ldg(grid_lo + k);
        cs[k] = (__ldg(grid_hi + k) - lo[k]) / static_cast<float>(res);
        hi[k] = static_cast<float>(static_cast<double>(lo[k])
                                   + static_cast<double>(res)
                                   * static_cast<double>(cs[k]));
        inv[k] = safe_inv(d[k]);
        const float t0a = (lo[k] - o[k]) * inv[k];
        const float t1a = (hi[k] - o[k]) * inv[k];
        tmin = k == 0 ? fminf(t0a, t1a) : fmaxf(tmin, fminf(t0a, t1a));
        tmax = k == 0 ? fmaxf(t0a, t1a) : fminf(tmax, fmaxf(t0a, t1a));
    }
    const float t0 = fmaxf(tmin, r.tnear);
    bool live = t0 <= tmax && r.tfar > r.tnear && t0 <= r.tfar;
    int ci[3], st[3];
    float tn[3], td[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p = o[k] + d[k] * (t0 + 1e-6f);
        const float c = (p - lo[k]) / cs[k];
        ci[k] = static_cast<int>(fminf(fmaxf(c, 0.0f),
                                       static_cast<float>(res - 1)));
        st[k] = d[k] >= 0.0f ? 1 : -1;
        const float nxt = lo[k] + static_cast<float>(ci[k] + (st[k] > 0))
                                  * cs[k];
        const bool moving = fabsf(d[k]) > 1e-30f;
        tn[k] = moving ? (nxt - o[k]) * inv[k] : CUDART_INF_F;
        td[k] = moving ? fabsf(cs[k] * inv[k]) : CUDART_INF_F;
    }
    float best_t = CUDART_INF_F;
    int best_slot = -1;
    while (live) {
        const int c = (ci[0] * res + ci[1]) * res + ci[2];
        sweep_closest(rows, __ldg(cell_lo + c) * PAIR_TILE,
                      __ldg(cell_hi + c) * PAIR_TILE, r, best_t, best_slot);
        const float entry = fminf(tn[0], fminf(tn[1], tn[2]));
        const int a = tn[0] <= entry ? 0 : (tn[1] <= entry ? 1 : 2);
        ci[a] += st[a];
        tn[a] += td[a];
        live = ci[a] >= 0 && ci[a] < res && entry <= fminf(r.tfar, best_t);
    }
    t_out[i] = best_t;
    slot_out[i] = best_slot;
}

static int grid_of(int n_rays) {
    return (n_rays + GRID_BLOCK - 1) / GRID_BLOCK;
}

extern "C" int yrt_intersect_pairs(const void* rows, const void* org,
                                   const void* dir, const void* tnear,
                                   const void* tfar, const void* gs,
                                   const void* ge, int n_tiles, int n_rays,
                                   void* t_out, void* slot_out,
                                   void* stream) {
    if (n_rays > 0) {
        closest_pairs_kernel<<<grid_of(n_rays), GRID_BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rows),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), static_cast<const int*>(gs),
            static_cast<const int*>(ge), n_tiles, n_rays,
            static_cast<float*>(t_out), static_cast<int*>(slot_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_occluded_pairs(const void* rows, const void* org,
                                  const void* dir, const void* tnear,
                                  const void* tfar, const void* gs,
                                  const void* ge, int n_tiles, int n_rays,
                                  void* occ_out, void* stream) {
    if (n_rays > 0) {
        occluded_pairs_kernel<<<grid_of(n_rays), GRID_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rows),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), static_cast<const int*>(gs),
            static_cast<const int*>(ge), n_tiles, n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_grid_march(const void* rows, const void* cell_lo,
                              const void* cell_hi, const void* grid_lo,
                              const void* grid_hi, const void* org,
                              const void* dir, const void* tnear,
                              const void* tfar, int res, int n_rays,
                              void* t_out, void* slot_out, void* stream) {
    if (n_rays > 0) {
        march_kernel<<<grid_of(n_rays), GRID_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rows),
            static_cast<const int*>(cell_lo),
            static_cast<const int*>(cell_hi),
            static_cast<const float*>(grid_lo),
            static_cast<const float*>(grid_hi), res,
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(slot_out));
    }
    return static_cast<int>(cudaGetLastError());
}
