// Uniform-grid kernels: the ranged closest hit, the ranged any hit, and
// the whole-DDA grid march.
//
// Replaces the TPU kernels of yulio_raytracer_tpu:
//   yrt_intersect_pairs <- ops/pallas_pairs.py:248 intersect_pairs_raw's
//                          pallas_call, _kernel :113 (K8)
//   yrt_occluded_pairs  <- ops/pallas_pairs.py:320 occluded_pairs's
//                          pallas_call, _kernel_any :158 (K9)
//   yrt_grid_march      <- ops/grid.py _kernel_march
//                          (_march_raw / intersect_march, K10)
// The reference runs K8 and K9 in the DDA rounds of ray_binning='grid'
// (ops/grid.py intersect_grid / occluded_grid) and in the 'dense' rounds
// (ops/pallas_traverse.py intersect_dense_binned), each round sweeping
// every active ray's current cell or treelet; K10 is the same march in one
// kernel, reached by the reference's scripts and tests.
//
// Triangle rows: (Tp, 16) f32, Tp a multiple of 128 (pairs.cuh).  K8 and
// K9 take per-ray tile ranges [gs, ge) (null: the whole table); K8
// returns the best t (inf on a miss) and its slot (-1), K9 whether any
// slot hits, false for rays with tfar <= tnear.  K10 takes the cells'
// tile ranges cell_tile_lo/hi (res^3,) and the grid box, and returns
// (t, slot) like K8; the caller maps slots to triangles (tri_orig) and
// rebuilds u/v (ops/pairs.py recompute_uv), as the reference does.
//
// What bounds K8/K9 on the H100: pair-test flops (55 f32 operations per
// slot, woop_test) and the instructions around them.  The rounds hand the
// kernels every ray of a pass, incoherent bounce rays each with its own
// cell's or treelet's range (2.3 tiles of 128 slots on average on the
// colonnade's grid, 13 over its treelets): with one ray per thread over
// the rays in call order a warp holds up to 32 ranges, runs as long as
// its longest, and fetches 32 different rows from global memory per step.
//
// Design of K8/K9, the reference's grouping made for this card:
// - Binning (yrt_bin_pairs, three kernels): the active rays (ge > gs and
//   tfar > tnear; the others get inf / -1 or false at once) are keyed by
//   gs in a counting sort: a histogram over the n_tiles bins, privatised
//   in shared memory for the first BIN_SMEM bins; an exclusive scan of
//   the bins in one block, which also lays out the work list, one chunk
//   of up to PAIR_BLOCK rays of one bin per sweep block; and a scatter of
//   ray indices into the permutation, whose first ray of each chunk
//   writes the chunk's bin.  The order within a bin is free: each ray's
//   result depends only on its own sweep.
// - Sweep (128 threads, one ray each): a block takes one chunk, so its
//   rays share gs; it sweeps the tiles [gs, max ge) of its rays, each
//   tile staged once in shared memory (8 KB, double-buffered with
//   cp.async) and read by all threads one row at a time (a broadcast), and
//   each thread tests only the tiles of its own range, in ascending slot
//   order with pairs.cuh's test and tie rule, so the results are
//   bit-equal to the one-ray sweep.  K9's thread stops at its first hit,
//   and its block leaves the tile loop once every thread is done
//   (__syncthreads_and: the reference's per-block early exit).  Without
//   ranges no binning runs: each block takes 128 consecutive rays over the
//   whole table.
// On an H100 (700 W) this runs K8/K9 at 23-30% of their f32 bound on the
// calls of a frame's rounds, where one ray per thread in call order ran
// at 5-18%, and the binning takes 2-8% of a call; two rays per thread,
// and blocks of 64 or 256 rays, were slower (PERF.md, pairs_turns).
// K10 marches each ray through its own cells (Amanatides-Woo) with the
// constants of _kernel_march: the entry cell holds the point at the box
// entry plus an absolute 1e-6; a tie in the next crossing steps x before y
// before z; the ray stays live while the next cell's entry is <= min(tfar,
// best t).  What bounds it on the H100: a ray makes ~2,000 pair tests in
// ~6 cells, and one ray per thread reads every slot's 64-byte row for
// every ray (~134 GB from L2 for 1M hemisphere rays over a 9.73 MB table)
// while its lanes wait on the warp's longest cell range (27% lane use).
// Design (march_kernel): a warp holds 32 rays and marches them in
// lockstep rounds, one cell per live ray a round; the rays in one cell
// share that cell's tiles, each loaded once for the warp and staged in
// shared memory, and the cell's (ray, slot) pairs are spread over all 32
// lanes.  A ray still tests only its own cells, so the tests are the
// one-ray march's and so are the results, bit for bit.  The caller
// (ops/grid.py intersect_march) sorts the rays by entry cell and origin,
// as the reference's _march_sorted does, so that a warp's rays share
// cells; the reference's group-wide sweep of every visited cell for every
// ray of its 16 is not ported (4-10x the tests).
#include "pairs.cuh"

#define MARCH_WARPS 4         // warps of a march block
#define MARCH_RAYS 32         // rays a march warp holds (at most 32)
#define PAIR_BLOCK 128        // threads of a sweep block: one chunk of
                              // up to 128 rays of one bin
#define BIN_THREADS 256       // threads of a binning block
#define BIN_RAYS 16           // rays per binning thread
#define BIN_SMEM 4096         // bins counted in shared memory (16 KB)
#define SCAN_THREADS 1024

// The binning's scratch, carved from one int32 buffer of
// yrt_pairs_scratch(n_tiles, n_rays) ints: each bin's cursor (its count,
// then its next free position), its first ray (n_tiles + 1) and its first
// chunk (n_tiles + 1), the chunk count, the permutation, and each chunk's
// bin.
struct Bins {
    int* cursor;
    int* offs;
    int* cstart;
    int* total;
    int* perm;
    int* chunk;
};

static int max_chunks(int n_tiles, int n_rays) {
    return (n_rays + PAIR_BLOCK - 1) / PAIR_BLOCK
        + (n_tiles < n_rays ? n_tiles : n_rays);
}

static Bins carve(void* scratch, int n_tiles, int n_rays) {
    int* p = static_cast<int*>(scratch);
    Bins b;
    b.cursor = p;
    b.offs = b.cursor + n_tiles;
    b.cstart = b.offs + n_tiles + 1;
    b.total = b.cstart + n_tiles + 1;
    b.perm = b.total + 1;
    b.chunk = b.perm + n_rays;
    return b;
}

// ------------------------------------------------------------- binning

// ray i's bin (its gs), or -1 for a ray that sweeps nothing (and for a
// gs outside the table, which keeps the counters in bounds)
__device__ __forceinline__ int ray_bin(const int* __restrict__ gs,
                                       const int* __restrict__ ge,
                                       const float* __restrict__ tnear,
                                       const float* __restrict__ tfar,
                                       int n_tiles, int i) {
    const int s = __ldg(gs + i);
    const bool in_table = static_cast<unsigned>(s)
        < static_cast<unsigned>(n_tiles);
    return __ldg(ge + i) > s && in_table
        && __ldg(tfar + i) > __ldg(tnear + i) ? s : -1;
}

__device__ __forceinline__ int local_bins(int n_tiles, int* local) {
    const int nb = n_tiles < BIN_SMEM ? n_tiles : BIN_SMEM;
    for (int k = threadIdx.x; k < nb; k += BIN_THREADS) local[k] = 0;
    __syncthreads();
    return nb;
}

// each block counts BIN_THREADS * BIN_RAYS rays into the bins' cursors,
// and writes the result of every inactive ray (occ_out for K9, else
// t_out / slot_out)
__global__ void __launch_bounds__(BIN_THREADS)
bin_count_kernel(const int* __restrict__ gs, const int* __restrict__ ge,
                 const float* __restrict__ tnear,
                 const float* __restrict__ tfar, int n_tiles, int n_rays,
                 int* __restrict__ cursor, float* __restrict__ t_out,
                 int* __restrict__ slot_out, bool* __restrict__ occ_out) {
    __shared__ int local[BIN_SMEM];
    const int nb = local_bins(n_tiles, local);
    const int base = blockIdx.x * (BIN_THREADS * BIN_RAYS) + threadIdx.x;
    #pragma unroll 4
    for (int j = 0; j < BIN_RAYS; ++j) {
        const int i = base + j * BIN_THREADS;
        if (i >= n_rays) break;
        const int bin = ray_bin(gs, ge, tnear, tfar, n_tiles, i);
        if (bin < 0) {
            if (occ_out) {
                occ_out[i] = false;
            } else {
                t_out[i] = CUDART_INF_F;
                slot_out[i] = -1;
            }
        } else if (bin < nb) {
            atomicAdd(local + bin, 1);
        } else {
            atomicAdd(cursor + bin, 1);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += BIN_THREADS) {
        if (local[k]) atomicAdd(cursor + k, local[k]);
    }
}

// one block: the exclusive scans of the bins' ray counts (offs) and chunk
// counts (cstart); each cursor becomes its bin's first position
__global__ void __launch_bounds__(SCAN_THREADS)
bin_scan_kernel(int n_tiles, Bins b) {
    __shared__ int warp_r[32], warp_c[32];
    __shared__ int carry_r, carry_c;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry_r = carry_c = 0;
    __syncthreads();
    for (int base = 0; base < n_tiles; base += SCAN_THREADS) {
        const int k = base + threadIdx.x;
        const int c = k < n_tiles ? b.cursor[k] : 0;
        const int ch = (c + PAIR_BLOCK - 1) / PAIR_BLOCK;
        int r = c, q = ch;
        #pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int a = __shfl_up_sync(FULL_MASK, r, o);
            const int d = __shfl_up_sync(FULL_MASK, q, o);
            if (lane >= o) {
                r += a;
                q += d;
            }
        }
        if (lane == 31) {
            warp_r[w] = r;
            warp_c[w] = q;
        }
        __syncthreads();
        if (w == 0) {
            int a = warp_r[lane], d = warp_c[lane];
            #pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(FULL_MASK, a, o);
                const int y = __shfl_up_sync(FULL_MASK, d, o);
                if (lane >= o) {
                    a += x;
                    d += y;
                }
            }
            warp_r[lane] = a;
            warp_c[lane] = d;
        }
        __syncthreads();
        const int pre_r = carry_r + (w ? warp_r[w - 1] : 0) + r - c;
        const int pre_c = carry_c + (w ? warp_c[w - 1] : 0) + q - ch;
        if (k < n_tiles) {
            b.offs[k] = pre_r;
            b.cstart[k] = pre_c;
            b.cursor[k] = pre_r;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            carry_r += warp_r[31];
            carry_c += warp_c[31];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        b.offs[n_tiles] = carry_r;
        b.cstart[n_tiles] = carry_c;
        *b.total = carry_c;
    }
}

// each block places its rays in the permutation: ranks within the block
// from shared counters, one reservation per bin and block; the ray at the
// start of a chunk writes the chunk's bin
__global__ void __launch_bounds__(BIN_THREADS)
bin_scatter_kernel(const int* __restrict__ gs, const int* __restrict__ ge,
                   const float* __restrict__ tnear,
                   const float* __restrict__ tfar, int n_tiles, int n_rays,
                   Bins b) {
    __shared__ int local[BIN_SMEM];
    const int nb = local_bins(n_tiles, local);
    const int base = blockIdx.x * (BIN_THREADS * BIN_RAYS) + threadIdx.x;
    int bin[BIN_RAYS], pos[BIN_RAYS];
    #pragma unroll
    for (int j = 0; j < BIN_RAYS; ++j) {
        const int i = base + j * BIN_THREADS;
        bin[j] = i < n_rays ? ray_bin(gs, ge, tnear, tfar, n_tiles, i)
                            : -1;
        pos[j] = bin[j] < 0 ? -1
            : bin[j] < nb ? atomicAdd(local + bin[j], 1)
                          : atomicAdd(b.cursor + bin[j], 1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += BIN_THREADS) {
        if (local[k]) local[k] = atomicAdd(b.cursor + k, local[k]);
    }
    __syncthreads();
    #pragma unroll
    for (int j = 0; j < BIN_RAYS; ++j) {
        if (bin[j] < 0) continue;
        const int p = bin[j] < nb ? local[bin[j]] + pos[j] : pos[j];
        b.perm[p] = base + j * BIN_THREADS;
        const int r = p - b.offs[bin[j]];
        if (r % PAIR_BLOCK == 0) {
            b.chunk[b.cstart[bin[j]] + r / PAIR_BLOCK] = bin[j];
        }
    }
}

// --------------------------------------------------------------- sweep

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// start copying tile g (128 rows, 512 float4s) into dst, the block's
// threads taking consecutive float4s, as one cp.async group
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ rows,
                                           int g) {
    const float4* src = rows + static_cast<size_t>(g) * (PAIR_TILE * 4);
    #pragma unroll
    for (int q = threadIdx.x; q < PAIR_TILE * 4; q += PAIR_BLOCK) {
        cp_async16(dst + q, src + q);
    }
    cp_async_commit();
}

// K8 (ANY false) and K9 (ANY true).  With ge null: no ranges, block c
// takes rays [128 c, 128 c + 128) over the whole table.  Otherwise block
// c takes chunk c of the binning's work list (blocks past its end leave
// at once).  Outputs are written at each ray's own index.
template <bool ANY>
__device__ __forceinline__ void sweep_pairs(
        const float4* __restrict__ rows, const float* __restrict__ org,
        const float* __restrict__ dir, const float* __restrict__ tnear,
        const float* __restrict__ tfar, const int* __restrict__ ge,
        const Bins& b, int n_tiles, int n_rays, float* __restrict__ t_out,
        int* __restrict__ slot_out, bool* __restrict__ occ_out) {
    __shared__ float4 tile[2][PAIR_TILE * 4];
    __shared__ int warp_end[PAIR_BLOCK / 32];
    const int c = blockIdx.x;
    int i, g0, end;
    if (ge) {
        if (c >= *b.total) return;
        const int bin = b.chunk[c];
        const int j = b.offs[bin] + (c - b.cstart[bin]) * PAIR_BLOCK
            + threadIdx.x;
        i = j < b.offs[bin + 1] ? b.perm[j] : -1;
        g0 = bin;
        end = i >= 0 ? __ldg(ge + i) : g0;
    } else {
        i = c * PAIR_BLOCK + threadIdx.x;
        i = i < n_rays ? i : -1;
        g0 = 0;
        end = i >= 0 ? n_tiles : 0;
    }
    Ray r = {};
    if (i >= 0) r = load_ray(org, dir, tnear, tfar, i);
    if (!(r.tfar > r.tnear)) end = g0;    // dead (unbinned calls only)
    int g1 = __reduce_max_sync(FULL_MASK, end);
    if ((threadIdx.x & 31) == 0) warp_end[threadIdx.x >> 5] = g1;
    __syncthreads();
    #pragma unroll
    for (int w = 0; w < PAIR_BLOCK / 32; ++w) g1 = max(g1, warp_end[w]);

    float best_t = CUDART_INF_F;
    int best_slot = -1;
    bool occ = false;
    if (g0 < g1) stage_tile(tile[0], rows, g0);
    for (int g = g0; g < g1; ++g) {
        const int cur = (g - g0) & 1;
        if (g + 1 < g1) {
            stage_tile(tile[cur ^ 1], rows, g + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float4* t4 = tile[cur];
        if (g < end) {
            for (int k = 0; k < PAIR_TILE; ++k) {
                float w[16];
                #pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4 x = t4[4 * k + q];
                    w[4 * q + 0] = x.x;
                    w[4 * q + 1] = x.y;
                    w[4 * q + 2] = x.z;
                    w[4 * q + 3] = x.w;
                }
                float th, uh, vh;
                const bool hit = woop_test(w, r, r.tnear, r.tfar, th, uh, vh);
                if (ANY) {
                    if (hit) {
                        occ = true;
                        break;
                    }
                } else {
                    take_closer(hit, th, g * PAIR_TILE + k, best_t,
                                best_slot);
                }
            }
        }
        if (ANY) {
            if (__syncthreads_and(occ || g + 1 >= end)) break;
        } else {
            __syncthreads();
        }
    }
    cp_async_wait<0>();
    if (i < 0) return;
    if (ANY) {
        occ_out[i] = occ;
    } else {
        t_out[i] = best_t;
        slot_out[i] = best_slot;
    }
}

__global__ void __launch_bounds__(PAIR_BLOCK)
closest_pairs_kernel(const float4* __restrict__ rows,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar,
                     const int* __restrict__ ge, Bins b, int n_tiles,
                     int n_rays, float* __restrict__ t_out,
                     int* __restrict__ slot_out) {
    sweep_pairs<false>(rows, org, dir, tnear, tfar, ge, b, n_tiles, n_rays,
                       t_out, slot_out, nullptr);
}

__global__ void __launch_bounds__(PAIR_BLOCK)
occluded_pairs_kernel(const float4* __restrict__ rows,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar,
                      const int* __restrict__ ge, Bins b, int n_tiles,
                      int n_rays, bool* __restrict__ occ_out) {
    sweep_pairs<true>(rows, org, dir, tnear, tfar, ge, b, n_tiles, n_rays,
                      nullptr, nullptr, occ_out);
}

// ---------------------------------------------------------------- march

// What one warp of the march keeps in shared memory: the tile being swept
// (its rows swizzled, swz), and the rays of the cell being swept with
// their best (t, slot) key so far, both by rank among those rays.
struct MarchWarp {
    float4 tile[PAIR_TILE * 4];
    float4 ray_a[32];         // ox, oy, oz, tnear
    float4 ray_b[32];         // dx, dy, dz, tfar
    unsigned long long key[32];
};

// float4 q of row s of a staged tile: each row's quarters permuted by
// (s / 2) % 4, so that the rows of 8 consecutive slots (a quarter warp's
// 16-byte loads) fall in 8 different bank groups
__device__ __forceinline__ int swz(int s, int q) {
    return 4 * s + (q ^ ((s >> 1) & 3));
}

// slot s of the staged tile
__device__ __forceinline__ void march_row(const MarchWarp& w, int s,
                                          float* v) {
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 x = w.tile[swz(s, q)];
        v[4 * q + 0] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
    }
}

// ray r of the cell being swept
__device__ __forceinline__ Ray cell_ray(const MarchWarp& w, int r) {
    const float4 a = w.ray_a[r], b = w.ray_b[r];
    return {a.x, a.y, a.z, b.x, b.y, b.z, a.w, b.w};
}

// ray r (q) against slot s of tile g: a hit lowers the ray's key
__device__ __forceinline__ void march_pair(MarchWarp& w, int g, int s, int r,
                                           const Ray& q) {
    float v[16];
    march_row(w, s, v);
    float th, uh, vh;
    if (woop_test(v, q, q.tnear, q.tfar, th, uh, vh)) {
        atomicMin(&w.key[r],
                  static_cast<unsigned long long>(order_key(th)) << 32
                  | static_cast<unsigned>(s) << 24
                  | static_cast<unsigned>(g));
    }
}

// The warp's sweep of one cell, tiles [lo, hi), for its nr rays (whose
// ray_a / ray_b / key entries are set): the nr x 128 (ray, slot)
// pairs of a tile spread over the 32 lanes, pair p = ray p % nr, slot
// p / nr, 4 nr pairs a lane; where nr divides 32 a lane keeps one ray.
// A hit lowers its ray's key to (t, slot % 128, tile): the least key is
// the hit the parent's ascending take_closer sweep keeps within the cell.
__device__ __forceinline__ void march_cell(MarchWarp& w,
                                           const float4* __restrict__ rows,
                                           int lo, int hi, int nr) {
    const int lane = threadIdx.x & 31;
    const int dr = 32 % nr, ds = 32 / nr;
    const Ray mine = cell_ray(w, lane % nr);
    for (int g = lo; g < hi; ++g) {
        __syncwarp();             // every lane is done with the last tile
        const float4* src = rows + static_cast<size_t>(g) * (PAIR_TILE * 4);
        #pragma unroll
        for (int k = 0; k < PAIR_TILE * 4 / 32; ++k) {
            const int j = lane + 32 * k;
            cp_async16(&w.tile[swz(j >> 2, j & 3)], src + j);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        if (dr == 0) {
            for (int s = lane / nr; s < PAIR_TILE; s += ds) {
                march_pair(w, g, s, lane % nr, mine);
            }
            continue;
        }
        int r = lane % nr, s = lane / nr;
        for (int it = 0; it < 4 * nr; ++it) {
            march_pair(w, g, s, r, cell_ray(w, r));
            r += dr;
            s += ds;
            if (r >= nr) {
                r -= nr;
                ++s;
            }
        }
    }
}

// K10.  Each warp marches MARCH_RAYS consecutive rays in lockstep rounds,
// one cell per live ray a round.  The lanes are grouped by their current
// cell (__match_any_sync); each distinct cell's tiles are loaded once for
// the warp and its pairs spread over all 32 lanes (march_cell); each ray's
// lane then recomputes its cell's winning test from the rows (for t's
// bits) and merges it with take_closer, in march order, as the one-ray
// march did.
__global__ void __launch_bounds__(MARCH_WARPS * 32)
march_kernel(const float4* __restrict__ rows,
             const int* __restrict__ cell_lo, const int* __restrict__ cell_hi,
             const float* __restrict__ grid_lo,
             const float* __restrict__ grid_hi, int res,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tnear, const float* __restrict__ tfar,
             int n_rays, float* __restrict__ t_out,
             int* __restrict__ slot_out) {
    __shared__ MarchWarp warps[MARCH_WARPS];
    MarchWarp& w = warps[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * MARCH_WARPS + (threadIdx.x >> 5))
        * MARCH_RAYS + lane;
    const bool own = lane < MARCH_RAYS && i < n_rays;
    Ray r = {};
    if (own) r = load_ray(org, dir, tnear, tfar, i);
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
    bool live = own && t0 <= tmax && r.tfar > r.tnear && t0 <= r.tfar;
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
    while (__any_sync(FULL_MASK, live)) {
        const int c = live ? (ci[0] * res + ci[1]) * res + ci[2] : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, c);
        const int c_lo = live ? __ldg(cell_lo + c) : 0;
        const int c_hi = live ? __ldg(cell_hi + c) : 0;
        unsigned todo = __ballot_sync(FULL_MASK,
                                      live && __ffs(peers) - 1 == lane);
        while (todo) {
            const int lead = __ffs(todo) - 1;
            todo &= todo - 1;
            const unsigned m = __shfl_sync(FULL_MASK, peers, lead);
            const int g0 = __shfl_sync(FULL_MASK, c_lo, lead);
            const int g1 = __shfl_sync(FULL_MASK, c_hi, lead);
            const bool mine = (m >> lane) & 1;
            const int rank = __popc(m & ((1u << lane) - 1));
            __syncwarp();         // the last cell's entries are read
            if (mine) {
                w.ray_a[rank] = make_float4(r.ox, r.oy, r.oz, r.tnear);
                w.ray_b[rank] = make_float4(r.dx, r.dy, r.dz, r.tfar);
                w.key[rank] = ~0ull;
            }
            __syncwarp();
            march_cell(w, rows, g0, g1, __popc(m));
            __syncwarp();
            const unsigned long long key = mine ? w.key[rank] : ~0ull;
            if (key != ~0ull) {
                const int slot = static_cast<int>(key & 0xFFFFFFu) * PAIR_TILE
                    + static_cast<int>((key >> 24) & (PAIR_TILE - 1));
                float v[16];
                load_row<4>(rows, 4, slot, v);
                float th, uh, vh;
                take_closer(woop_test(v, r, r.tnear, r.tfar, th, uh, vh), th,
                            slot, best_t, best_slot);
            }
        }
        if (live) {
            const float entry = fminf(tn[0], fminf(tn[1], tn[2]));
            const int a = tn[0] <= entry ? 0 : (tn[1] <= entry ? 1 : 2);
            ci[a] += st[a];
            tn[a] += td[a];
            live = ci[a] >= 0 && ci[a] < res
                && entry <= fminf(r.tfar, best_t);
        }
    }
    if (own) {
        t_out[i] = best_t;
        slot_out[i] = best_slot;
    }
}

// ------------------------------------------------------------ entry points

static int blocks(long long n, int per_block) {
    return static_cast<int>((n + per_block - 1) / per_block);
}

// ints of the binning's scratch for n_rays rays over n_tiles tiles
extern "C" int yrt_pairs_scratch(int n_tiles, int n_rays) {
    return 3 * n_tiles + 3 + n_rays + max_chunks(n_tiles, n_rays);
}

// Bin the rays with a range of K8 (occ_out null) or K9 (t_out and
// slot_out null) into scratch, and write the results of the rays that
// sweep nothing.
extern "C" int yrt_bin_pairs(const void* gs, const void* ge,
                             const void* tnear, const void* tfar, int n_tiles,
                             int n_rays, void* scratch, void* t_out,
                             void* slot_out, void* occ_out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Bins b = carve(scratch, n_tiles, n_rays);
    cudaMemsetAsync(b.cursor, 0, sizeof(int) * n_tiles, s);
    const int nb = blocks(n_rays, BIN_THREADS * BIN_RAYS);
    const int* gsi = static_cast<const int*>(gs);
    const int* gei = static_cast<const int*>(ge);
    const float* tn = static_cast<const float*>(tnear);
    const float* tf = static_cast<const float*>(tfar);
    if (nb > 0) {
        bin_count_kernel<<<nb, BIN_THREADS, 0, s>>>(
            gsi, gei, tn, tf, n_tiles, n_rays, b.cursor,
            static_cast<float*>(t_out), static_cast<int*>(slot_out),
            static_cast<bool*>(occ_out));
    }
    bin_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(n_tiles, b);
    if (nb > 0) {
        bin_scatter_kernel<<<nb, BIN_THREADS, 0, s>>>(gsi, gei, tn, tf,
                                                      n_tiles, n_rays, b);
    }
    return static_cast<int>(cudaGetLastError());
}

// the sweep's blocks, and the binning's scratch (ge null: none)
static int sweep_blocks(const void* ge, int n_tiles, int n_rays) {
    return ge ? max_chunks(n_tiles, n_rays) : blocks(n_rays, PAIR_BLOCK);
}

static Bins sweep_bins(const void* ge, void* scratch, int n_tiles,
                       int n_rays) {
    return ge ? carve(scratch, n_tiles, n_rays) : Bins{};
}

// K8: ge and scratch (yrt_bin_pairs' on the same rays) both null, or both
// given
extern "C" int yrt_intersect_pairs(const void* rows, const void* org,
                                   const void* dir, const void* tnear,
                                   const void* tfar, const void* ge,
                                   void* scratch, int n_tiles, int n_rays,
                                   void* t_out, void* slot_out,
                                   void* stream) {
    const int nb = sweep_blocks(ge, n_tiles, n_rays);
    if (nb > 0) {
        closest_pairs_kernel<<<nb, PAIR_BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rows),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), static_cast<const int*>(ge),
            sweep_bins(ge, scratch, n_tiles, n_rays), n_tiles, n_rays,
            static_cast<float*>(t_out), static_cast<int*>(slot_out));
    }
    return static_cast<int>(cudaGetLastError());
}

// K9: as K8
extern "C" int yrt_occluded_pairs(const void* rows, const void* org,
                                  const void* dir, const void* tnear,
                                  const void* tfar, const void* ge,
                                  void* scratch, int n_tiles, int n_rays,
                                  void* occ_out, void* stream) {
    const int nb = sweep_blocks(ge, n_tiles, n_rays);
    if (nb > 0) {
        occluded_pairs_kernel<<<nb, PAIR_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(rows),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), static_cast<const int*>(ge),
            sweep_bins(ge, scratch, n_tiles, n_rays), n_tiles, n_rays,
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
        march_kernel<<<blocks(n_rays, MARCH_WARPS * MARCH_RAYS),
                       MARCH_WARPS * 32, 0,
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
