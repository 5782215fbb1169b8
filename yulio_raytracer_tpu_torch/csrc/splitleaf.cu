// Split-leaf traversal (K11): closest hit with a packet-shared node walk
// and deferred, lane-masked leaf rows.
//
// Replaces the TPU kernel of yulio_raytracer_tpu/ops/pallas_splitleaf.py
// (`_kernel`, reached by intersect_packet_split and its _sorted form): the
// reference's ablation of its packet kernel for incoherent bounce rays,
// run on sorted bounce-1 rays by scripts/bench_incoherent.py.
//
// Tables: binary node rows (ops/traverse.py pack_nodes), (N, 8) f32
// [lo.x lo.y lo.z hi.x hi.y hi.z A tag], and the Woop rows of
// ops/wide.py pack_tris, 8 triangles of 16 floats to a 128-float row.
//
// What bounds it on the H100.  A 256-ray packet of 8 warps met at a block
// barrier on every interior pop, every leaf and every flush, and every
// lane tested every row of its warp's list, hit or not: 11.4x the pair
// tests and 10.3x the box tests of K5 on the same rays, at 1.1% of the
// f32 bound of K5's count (NVIDIA H100, 700 W; PERF.md).  So the levers
// are the barriers and the wasted lanes, not the flop rate.
//
// Design (the reference's, with one warp per packet, SPLIT_WARPS packets
// a block, no block barrier):
// - Node phase, shared by the warp.  The packet walks one stack of
//   (node, entry t) in shared memory (lane 0 pushes, __syncwarp).  Every
//   lane slab-tests both children of an interior pop against its own ray
//   and best t; warp votes and min-reductions give whether any ray hits
//   each child and the least entry t of those that do.  The children hit
//   are pushed far first; near is the side of the packet's summed
//   direction (a butterfly over the lanes) along the node's axis.  A pop
//   whose entry t exceeds t_allmax, the packet's largest best t as of the
//   last flush, is culled.
// - Leaf phase, deferred and masked.  Each lane slab-tests the leaf box;
//   where any lane hits it, the leaf's rows [A/8, (A+tag+7)/8) go to the
//   packet's list (LISTCAP rows), each with the ballot of the lanes that
//   hit.  At min(FLUSH_ROWS, LISTCAP - max_groups) rows, and at the end,
//   the list is flushed: the (lane, triangle) pairs of those masks, 8 triangles a
//   row, are spread over the 32 lanes, each reading its pair's ray from
//   shared memory.  A ray's best becomes the least (t, position in the
//   list * 8 + triangle in its row) among its pairs strictly nearer than
//   its best at the flush's start (an atomicMin on a 64-bit key): the
//   winner a sequential strictly-nearer sweep of its rows keeps.  Its
//   lane recomputes that test for t, u and v.
// - Exactness.  Built with --fmad=false; the slab (bvh.cuh) and Woop
//   (woop.cuh) tests are the other kernels' and the plain version's, op
//   for op, so t, u and v are bit-equal to ops/splitleaf.py.
#include "bvh.cuh"

#define SPLIT_WARPS 4           // packets (warps) of a block
#define LISTCAP 48              // rows a packet's list holds
#define FLUSH_ROWS 3            // rows that start a flush: a short list keeps
                                // the rays' best t fresh for the walk's culls

__device__ __forceinline__ float warp_sum(float v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = v + __shfl_xor_sync(FULL_MASK, v, off);
    return v;
}

__device__ __forceinline__ float warp_min(float v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
    return v;
}

// What one packet keeps in shared memory.
struct Packet {
    int st_n[STACK];
    float st_t[STACK];
    int row[LISTCAP];                   // the list: a row ...
    unsigned mask[LISTCAP];             // ... and the lanes that test it
    unsigned short pair[LISTCAP * 32];  // a flush's (entry << 5 | lane)
    float4 ray_a[32];                   // ox, oy, oz, tnear
    float4 ray_b[32];                   // dx, dy, dz, best t
    unsigned long long key[32];         // the least (t, entry * 8 + m)
};

// Sweep the packet's list of cnt rows: each lane's ray against the 8
// triangles of each row whose mask holds it, strictly nearer than its best
// at the start.
__device__ __forceinline__ void flush(Packet& p,
                                      const float4* __restrict__ tris,
                                      int cnt, const Ray& r, float& t_b,
                                      int& tri_b, float& u_b, float& v_b) {
    const int lane = threadIdx.x & 31;
    p.ray_a[lane] = make_float4(r.ox, r.oy, r.oz, r.tnear);
    p.ray_b[lane] = make_float4(r.dx, r.dy, r.dz, t_b);
    p.key[lane] = ~0ull;
    int n = 0;
    for (int k = 0; k < cnt; ++k) {
        const unsigned m = p.mask[k];
        if ((m >> lane) & 1) {
            p.pair[n + __popc(m & ((1u << lane) - 1))] =
                static_cast<unsigned short>(k << 5 | lane);
        }
        n += __popc(m);
    }
    __syncwarp();
    for (int q = lane; q < 8 * n; q += 32) {
        const int e = p.pair[q >> 3];
        const int k = e >> 5, src = e & 31, m = q & 7;
        const float4 a = p.ray_a[src], b = p.ray_b[src];
        const Ray s = {a.x, a.y, a.z, b.x, b.y, b.z, a.w, b.w};
        float w[16];
        load_row<4>(tris, 4, 8 * p.row[k] + m, w);
        float th, uh, vh;
        if (woop_test(w, s, s.tnear, b.w, th, uh, vh)) {
            atomicMin(&p.key[src],
                      static_cast<unsigned long long>(order_key(th)) << 32
                      | static_cast<unsigned>(8 * k + m));
        }
    }
    __syncwarp();
    const unsigned long long key = p.key[lane];
    if (key != ~0ull) {
        const int pos = static_cast<int>(key & 0xFFFFFFFFu);
        const int tri = 8 * p.row[pos >> 3] + (pos & 7);
        float w[16];
        load_row<4>(tris, 4, tri, w);
        float th, uh, vh;
        woop_test(w, r, r.tnear, t_b, th, uh, vh);
        t_b = th;
        tri_b = tri;
        u_b = uh;
        v_b = vh;
    }
    __syncwarp();               // the list and the pairs are read
}

__global__ void __launch_bounds__(SPLIT_WARPS * 32)
split_kernel(const float* __restrict__ nodes,
             const float4* __restrict__ tris,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tnear,
             const float* __restrict__ tfar, int n_rays, int max_groups,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ Packet packets[SPLIT_WARPS];
    Packet& p = packets[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * (SPLIT_WARPS * 32) + threadIdx.x;
    // a missing ray of the tail packet is dead (tfar < tnear) and has no
    // direction to add to the packet's sum
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1.0f};
    if (i < n_rays) r = load_ray(org, dir, tnear, tfar, i);
    const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    float t_b = r.tfar, u_b = 0.0f, v_b = 0.0f;
    int tri_b = -1;

    // the packet's near sides and its largest best t
    const bool ln_x = warp_sum(r.dx) >= 0.0f;
    const bool ln_y = warp_sum(r.dy) >= 0.0f;
    const bool ln_z = warp_sum(r.dz) >= 0.0f;
    float cur_max = warp_max(t_b);

    if (lane == 0) {
        p.st_n[0] = 0;
        p.st_t[0] = 0.0f;
    }
    __syncwarp();
    int sp = 0, cnt = 0;
    float t_allmax = CUDART_INF_F;
    const int limit = min(FLUSH_ROWS, LISTCAP - max_groups);
    // sp, the node, t_allmax and cnt are the same in every lane
    while (sp >= 0) {
        const int node = p.st_n[sp];
        const float tpop = p.st_t[sp];
        --sp;
        if (!(tpop <= t_allmax)) continue;
        const float* nd = nodes + 8 * static_cast<size_t>(node);
        const int a = static_cast<int>(__ldg(nd + 6));
        const int tag = static_cast<int>(__ldg(nd + 7));
        if (tag > 0) {                                  // leaf: defer
            float tl;
            const unsigned hit = __ballot_sync(
                FULL_MASK, slab(nd, r, inv, r.tnear, t_b, tl));
            const int g0 = a >> 3;
            const int gc = ((a + tag + 7) >> 3) - g0;
            if (hit) {
                if (lane < gc) {
                    p.row[cnt + lane] = g0 + lane;
                    p.mask[cnt + lane] = hit;
                }
                cnt += gc;
                __syncwarp();
                if (cnt >= limit) {
                    flush(p, tris, cnt, r, t_b, tri_b, u_b, v_b);
                    cnt = 0;
                    cur_max = warp_max(t_b);
                }
            }
            t_allmax = cur_max;
            continue;
        }
        if (tag == 0) continue;                         // empty
        const int left = node + 1;
        float tl, tr;
        const bool hl = slab(nodes + 8 * static_cast<size_t>(left), r, inv,
                             r.tnear, t_b, tl);
        const bool hr = slab(nodes + 8 * static_cast<size_t>(a), r, inv,
                             r.tnear, t_b, tr);
        const float ml = warp_min(hl ? tl : CUDART_INF_F);
        const float mr = warp_min(hr ? tr : CUDART_INF_F);
        const bool any_l = __any_sync(FULL_MASK, hl);
        const bool any_r = __any_sync(FULL_MASK, hr);
        const int axis = -tag - 1;
        const bool left_near = axis == 0 ? ln_x : (axis == 1 ? ln_y : ln_z);
        __syncwarp();                   // every lane has read the top
        if (left_near ? any_r : any_l) {                // far child first
            ++sp;
            if (lane == 0) {
                p.st_n[sp] = left_near ? a : left;
                p.st_t[sp] = left_near ? mr : ml;
            }
        }
        if (left_near ? any_l : any_r) {
            ++sp;
            if (lane == 0) {
                p.st_n[sp] = left_near ? left : a;
                p.st_t[sp] = left_near ? ml : mr;
            }
        }
        __syncwarp();
    }
    if (cnt) flush(p, tris, cnt, r, t_b, tri_b, u_b, v_b);
    if (i < n_rays) {
        t_out[i] = tri_b >= 0 ? t_b : CUDART_INF_F;
        tri_out[i] = tri_b;
        u_out[i] = u_b;
        v_out[i] = v_b;
    }
}

// max_groups: rows one leaf can span, (max_leaf + 7) / 8 + 1, at most 32
// (one warp appends them) and below LISTCAP; the wrapper checks both
extern "C" int yrt_intersect_split(const void* nodes, const void* tris,
                                   const void* org, const void* dir,
                                   const void* tnear, const void* tfar,
                                   int n_rays, int max_groups, void* t_out,
                                   void* tri_out, void* u_out, void* v_out,
                                   void* stream) {
    if (n_rays > 0) {
        split_kernel<<<(n_rays + SPLIT_WARPS * 32 - 1) / (SPLIT_WARPS * 32),
                       SPLIT_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays, max_groups,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}
