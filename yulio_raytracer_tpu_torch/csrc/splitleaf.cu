// Split-leaf traversal (K11): closest hit with a packet-shared node walk
// and per-warp deferred leaf rows.
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
// Design.  A packet is one block of SPLIT_WARPS warps, one ray per
// thread; a sub-block is one warp (the reference: 1024 rays in 8
// sub-blocks of 128).
// - Node phase, shared.  The packet walks one stack of (node, entry t),
//   kept as one copy per warp in shared memory so that a warp reads what
//   its lane 0 pushed after a __syncwarp, and the block meets only in its
//   reductions.  Every thread slab-tests both children of an interior pop
//   against its own ray and best t; one block reduction (warp shuffles,
//   then shared memory; one __syncthreads) gives whether any ray hits
//   each child and the least entry t of those that do.  The children hit
//   are pushed far first; near is the side of the packet's summed
//   direction along the node's axis, summed once in a fixed order (a
//   butterfly within each warp, then the warps in turn), which
//   ops/splitleaf.py replays bit for bit.  A pop whose entry t exceeds
//   t_allmax, the packet's largest best t as of the last flush, is culled.
// - Leaf phase, deferred.  Each warp slab-tests the leaf box; where a lane
//   hits it, the warp appends the leaf's rows [A/8, (A+tag+7)/8) to its
//   own list (LISTCAP rows).  `since` counts the rows appended by the
//   packet since the last flush (where any warp appended); at
//   LISTCAP - max_groups every warp sweeps its list: lane i tests ray i
//   against the 8 triangles of each row, whose address is the same for
//   the whole warp, so the 512-byte row is a broadcast read.  Rows are
//   bounded by each list's count: the packed triangles have no zero row
//   after them to pad a list with.  A triangle replaces a ray's best only
//   when strictly nearer.  One more flush ends the walk.
// - Exactness.  Built with --fmad=false; the slab (bvh.cuh) and Woop
//   (woop.cuh) tests are the other kernels' and the plain version's, op
//   for op, so t, u and v are bit-equal to ops/splitleaf.py.
//
// What bounds it on the H100: every pop costs the whole block a
// reduction and a barrier, and a culled-or-not decision that waits on the
// slowest warp, so the node phase runs at the pace of the block's
// barriers; the leaf sweeps are f32 issue on broadcast rows.  The
// reference's own measurement found this schedule slower than its packet
// kernel on the TPU; here it is held against K5, which walks one ray per
// thread with no barrier at all.
#include "bvh.cuh"

#define SPLIT_WARPS 8
#define SPLIT_BLOCK (32 * SPLIT_WARPS)
#define LISTCAP 48

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

// one warp's sweep of its list: each lane against the 8 triangles of
// every row, in list order
__device__ __forceinline__ void flush(const float4* __restrict__ tris,
                                      const int* lst, int cnt, const Ray& r,
                                      float& t_b, int& tri_b, float& u_b,
                                      float& v_b) {
    for (int k = 0; k < cnt; ++k) {
        const int row = lst[k];
        for (int m = 0; m < 8; ++m) {
            float w[16];
            load_row<4>(tris, 4, 8 * row + m, w);
            float th, uh, vh;
            if (woop_test(w, r, r.tnear, t_b, th, uh, vh)) {
                t_b = th;
                tri_b = 8 * row + m;
                u_b = uh;
                v_b = vh;
            }
        }
    }
}

__global__ void __launch_bounds__(SPLIT_BLOCK)
split_kernel(const float* __restrict__ nodes,
             const float4* __restrict__ tris,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ tnear,
             const float* __restrict__ tfar, int n_rays, int max_groups,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ int st_n[SPLIT_WARPS][STACK];
    __shared__ float st_t[SPLIT_WARPS][STACK];
    __shared__ int lists[SPLIT_WARPS][LISTCAP];
    // block reductions, double-buffered: a buffer is written again only
    // after every thread has passed the next reduction's barrier
    __shared__ float red[2][SPLIT_WARPS][4];
    __shared__ int red_any[2][SPLIT_WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i = blockIdx.x * SPLIT_BLOCK + threadIdx.x;
    // a missing ray of the tail packet is dead (tfar < tnear) and has no
    // direction to add to the packet's sum
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1.0f};
    if (i < n_rays) r = load_ray(org, dir, tnear, tfar, i);
    const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    float t_b = r.tfar, u_b = 0.0f, v_b = 0.0f;
    int tri_b = -1;

    // the packet's direction sum (its near sides) and its largest best t
    {
        const float sx = warp_sum(r.dx), sy = warp_sum(r.dy);
        const float sz = warp_sum(r.dz), mt = warp_max(t_b);
        if (lane == 0) {
            red[0][warp][0] = sx;
            red[0][warp][1] = sy;
            red[0][warp][2] = sz;
            red[0][warp][3] = mt;
        }
    }
    __syncthreads();
    float sx = red[0][0][0], sy = red[0][0][1], sz = red[0][0][2];
    float cur_max = red[0][0][3];
    for (int w = 1; w < SPLIT_WARPS; ++w) {
        sx = sx + red[0][w][0];
        sy = sy + red[0][w][1];
        sz = sz + red[0][w][2];
        cur_max = fmaxf(cur_max, red[0][w][3]);
    }
    const bool ln_x = sx >= 0.0f, ln_y = sy >= 0.0f, ln_z = sz >= 0.0f;
    int buf = 1;

    if (lane == 0) {
        st_n[warp][0] = 0;
        st_t[warp][0] = 0.0f;
    }
    __syncwarp();
    int sp = 0, cnt = 0, since = 0;
    float t_allmax = CUDART_INF_F;
    const int limit = LISTCAP - max_groups;
    // every value that steers the loop (sp, the node, t_allmax, since) is
    // the same in every thread, so each __syncthreads is met by all
    while (sp >= 0) {
        const int node = st_n[warp][sp];
        const float tpop = st_t[warp][sp];
        --sp;
        if (!(tpop <= t_allmax)) continue;
        const float* nd = nodes + 8 * static_cast<size_t>(node);
        const int a = static_cast<int>(__ldg(nd + 6));
        const int tag = static_cast<int>(__ldg(nd + 7));
        if (tag > 0) {                                  // leaf: defer
            float tl;
            const bool h = slab(nd, r, inv, r.tnear, t_b, tl);
            const int g0 = a >> 3;
            const int gc = ((a + tag + 7) >> 3) - g0;
            if (__any_sync(FULL_MASK, h)) {
                if (lane < gc) lists[warp][cnt + lane] = g0 + lane;
                cnt += gc;
            }
            __syncwarp();
            if (__syncthreads_or(h)) since += gc;
            if (since >= limit) {
                flush(tris, lists[warp], cnt, r, t_b, tri_b, u_b, v_b);
                cnt = 0;
                since = 0;
                const float mt = warp_max(t_b);
                if (lane == 0) red[buf][warp][3] = mt;
                __syncthreads();
                cur_max = red[buf][0][3];
                for (int w = 1; w < SPLIT_WARPS; ++w)
                    cur_max = fmaxf(cur_max, red[buf][w][3]);
                buf ^= 1;
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
        {
            const float ml = warp_min(hl ? tl : CUDART_INF_F);
            const float mr = warp_min(hr ? tr : CUDART_INF_F);
            const int any = (__any_sync(FULL_MASK, hl) ? 1 : 0)
                | (__any_sync(FULL_MASK, hr) ? 2 : 0);
            if (lane == 0) {
                red[buf][warp][0] = ml;
                red[buf][warp][1] = mr;
                red_any[buf][warp] = any;
            }
        }
        __syncthreads();
        float ml = red[buf][0][0], mr = red[buf][0][1];
        int any = red_any[buf][0];
        for (int w = 1; w < SPLIT_WARPS; ++w) {
            ml = fminf(ml, red[buf][w][0]);
            mr = fminf(mr, red[buf][w][1]);
            any |= red_any[buf][w];
        }
        buf ^= 1;
        const int axis = -tag - 1;
        const bool left_near = axis == 0 ? ln_x : (axis == 1 ? ln_y : ln_z);
        const bool any_l = any & 1, any_r = any & 2;
        if (left_near ? any_r : any_l) {                // far child first
            ++sp;
            if (lane == 0) {
                st_n[warp][sp] = left_near ? a : left;
                st_t[warp][sp] = left_near ? mr : ml;
            }
        }
        if (left_near ? any_l : any_r) {
            ++sp;
            if (lane == 0) {
                st_n[warp][sp] = left_near ? left : a;
                st_t[warp][sp] = left_near ? ml : mr;
            }
        }
        __syncwarp();
    }
    flush(tris, lists[warp], cnt, r, t_b, tri_b, u_b, v_b);
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
        split_kernel<<<(n_rays + SPLIT_BLOCK - 1) / SPLIT_BLOCK, SPLIT_BLOCK,
                       0, static_cast<cudaStream_t>(stream)>>>(
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
