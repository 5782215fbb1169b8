// Wide-BVH traversal kernels: closest hit and any hit, at width 4 (BVH4)
// and 8.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_wide.py:
//   yrt_intersect_wide  <- _kernel4     (intersect_packet4, closest hit)
//   yrt_occluded_wide   <- _kernel4_any (occluded_packet4, any hit)
//   yrt_intersect_wide8 <- _kernel4     at width=8 (pallas_call at :507)
//   yrt_occluded_wide8  <- _kernel4_any at width=8 (pallas_call at :676)
// The reference runs width 4 as the default accel for scenes of more than
// 2048 triangles, e.g. the 92k-triangle colonnade; width 8 is its wide-BVH
// ablation (no render path takes it), reached through the ops.
//
// Node rows (ops/wide.py pack_nodes4 / pack_nodes8): (Nw, 8 W) f32, W
// slots of [lo.x lo.y lo.z hi.x hi.y hi.z A tag]; tag > 0 is a leaf of
// `tag` triangles starting at packed triangle A, tag == -1 an interior
// slot whose A is the child row, tag == 0 an empty slot.  A slot is
// decided by its tag alone: an empty slot's +inf/-inf box still passes
// the min/max slab test.
//
// What bounds them on the H100.  A colonnade ray visits ~12 nodes and two
// or three leaves of up to 32 triangles (22 on average), a few percent of
// the f32 peak in tests.  With one ray per thread, a lane in a leaf runs a
// serial loop of up to 32 Woop tests while the warp's other lanes wait,
// and nearly every step of the warp has some lane in a leaf: that
// divergence is what the design below takes on.  The kernels run at about
// a tenth of their f32 bound (PERF.md section 6); no profiler on the card
// shows whether load latency or issue is what remains.
//
// Design (one ray per lane, 256-thread blocks):
// - The warp steps together.  In each step every lane at an interior node
//   does that node (two float4 loads per slot), then the warp tests the
//   leaves its lanes hold.  When at least WIDE_SERIAL_MIN lanes hold one
//   (rays that move together, such as camera rays), each lane tests its
//   own leaf.  When fewer do, the warp takes those leaves one at a time
//   across all 32 lanes: lane j tests triangle A + j against the owning
//   lane's ray (shuffled to every lane), a coalesced read of the leaf's
//   rows.  The any-hit test then ends with one vote; the closest hit takes
//   the least t with one __reduce_min_sync on an order-preserving key,
//   ties to the lowest triangle, which is what the sequential
//   strictly-nearer loop in ascending order keeps.
// - Each ray still visits its nodes and leaves in its own order, so the
//   closest hit's t, tri, u and v stay bit-equal to the plain version
//   (ops/wide.py): far-first sort network, pops skipped when their entry
//   t exceeds the best t; the nearest hit child, which would pop next, is
//   taken at once without a push.  The any-hit walk, whose result does not
//   depend on the order, visits nearest first too (the plain version
//   goes in slot order) and stops at the first hit.
// - A stack entry is one 32-bit word, with its entry t beside it for the
//   closest hit: 2 x 128 and 128 words a thread in local memory.  The
//   plain versions reach 11 entries on the colonnade (chip_smoke.py prints
//   the distribution), so a thread only touches the first lines of its
//   stack.  The word is the child row of an interior slot, or A | count
//   << 24 for a leaf of count triangles from A.  A leaf of 256 or more
//   does not fit: for a table that holds one, the wrapper (ops/wide.py)
//   launches the SLOTS form of each kernel (the *_slots entry points),
//   whose word for a leaf of 128 or more is 1 << 31 | k << 24 | row, slot
//   k of node row `row`, whose A and count are read from the row when
//   the leaf is tested.  Either way a leaf takes one entry, tested in the
//   plain version's order.  Each word tried that carries such leaves in
//   one walk (a compare and a select a slot, or a test a node, with a
//   branch a leaf) made K3 and K4 2-11% slower at leaf 32 on an NVIDIA
//   H100 80GB HBM3 at 700 W (PERF.md section 6, wide_turns against the
//   walk without them), so a table without such a leaf keeps the walk
//   without them.  ops/wide.py _check_packed guards what the words need:
//   node rows, and A + count, below 2^24.
// The node and Woop arithmetic is bvh.cuh's slab_box and woop.cuh's
// woop_test, compiled with --fmad=false like every source here.
//
// Width 8 is the same walk templated on W, with nothing of its own but
// its sizes: a node is 16 float4 loads a lane, its slots ordered by the
// reference's 19-comparator network (pallas_wide._SORT_NETS[8]), a pop
// may push up to 7 entries (pack_nodes8's _check_packed holds 7 x depth +
// 1 to STACK), and a slot word's k takes 3 bits (bits 24-26, under bit
// 31).  The width-4 instances compile to the code they had before the
// template.
#include "bvh.cuh"

#define WIDE_BLOCK 256
#define WIDE_COUNT_SHIFT 24
#define WIDE_A_MASK 0xffffffu
// under SLOTS, leaves of this many triangles or more are named by their slot
#define WIDE_SLOT_MIN 128
#define WIDE_SLOT_BIT 0x80000000u
// the lanes of a warp holding a leaf from which on each lane tests its own
// leaf (fewer: the warp tests them one at a time across its lanes)
#define WIDE_SERIAL_MIN 16

template <typename T>
__device__ __forceinline__ void cswap(bool c, T& a, T& b) {
    T x = c ? b : a;
    T y = c ? a : b;
    a = x;
    b = y;
}

// slot k of node row `row`, whose (A, tag) is q.zw, as one stack word;
// interior and empty slots count 0
template <bool SLOTS>
__device__ __forceinline__ unsigned slot_word(float4 q, unsigned row,
                                              int k) {
    const int tag = static_cast<int>(q.w);
    if (SLOTS && tag >= WIDE_SLOT_MIN) {
        return WIDE_SLOT_BIT | (static_cast<unsigned>(k) << WIDE_COUNT_SHIFT)
            | row;
    }
    return static_cast<unsigned>(q.z)
        | (static_cast<unsigned>(max(tag, 0)) << WIDE_COUNT_SHIFT);
}

__device__ __forceinline__ bool is_leaf(unsigned w) {
    return (w >> WIDE_COUNT_SHIFT) != 0;
}

// a leaf word's first triangle a and count c (under SLOTS, from its
// slot's row of W slots for a leaf of WIDE_SLOT_MIN or more)
template <bool SLOTS, int W>
__device__ __forceinline__ void leaf_range(const float4* __restrict__ nodes,
                                           unsigned w, int& a, int& c) {
    if (SLOTS && (w & WIDE_SLOT_BIT)) {
        const float4 q = __ldg(nodes
                               + 2 * W * static_cast<size_t>(w & WIDE_A_MASK)
                               + 2 * ((w >> WIDE_COUNT_SHIFT) & (W - 1)) + 1);
        a = static_cast<int>(q.z);
        c = static_cast<int>(q.w);
    } else {
        a = static_cast<int>(w & WIDE_A_MASK);
        c = static_cast<int>(w >> WIDE_COUNT_SHIFT);
    }
}

// node row `row` of W slots as 2 W float4s: slot k is q[2k] (lo.x lo.y
// lo.z hi.x) and q[2k + 1] (hi.y hi.z A tag)
template <int W>
__device__ __forceinline__ void load_node(const float4* __restrict__ nodes,
                                          unsigned row, float4 (&q)[2 * W]) {
    #pragma unroll
    for (int k = 0; k < 2 * W; ++k) {
        q[k] = __ldg(nodes + 2 * W * static_cast<size_t>(row) + k);
    }
}

// the compare-exchanges net of a descending sort network over W slots
template <int N, int W>
__device__ __forceinline__ void sort_net(const int (&net)[N][2],
                                         bool (&has)[W], float (&m)[W],
                                         unsigned (&w)[W]) {
    #pragma unroll
    for (int s = 0; s < N; ++s) {
        const int x = net[s][0], y = net[s][1];
        const bool lt = m[x] < m[y];
        cswap(lt, m[x], m[y]);
        cswap(lt, w[x], w[y]);
        cswap(lt, has[x], has[y]);
    }
}

// The W slots of node q (row `row`) against the segment (r.tnear, tfar),
// far first: each slot's hit flag (a slab hit of a non-empty slot), entry
// t (-inf where not hit) and stack word, in the order of the reference's
// descending sort network (pallas_wide._SORT_NETS[W]).
template <bool SLOTS, int W>
__device__ __forceinline__ void sort_slots(const float4 (&q)[2 * W],
                                           unsigned row, const Ray& r,
                                           const Slab& inv, float tfar,
                                           bool (&has)[W], float (&m)[W],
                                           unsigned (&w)[W]) {
    static_assert(W == 4 || W == 8, "wide nodes hold 4 or 8 slots");
    #pragma unroll
    for (int k = 0; k < W; ++k) {
        float tmin;
        has[k] = slab4(q[2 * k], q[2 * k + 1], r, inv, r.tnear, tfar, tmin)
            && q[2 * k + 1].w != 0.0f;
        m[k] = has[k] ? tmin : -CUDART_INF_F;
        w[k] = slot_word<SLOTS>(q[2 * k + 1], row, k);
    }
    if constexpr (W == 4) {
        const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
        sort_net(net, has, m, w);
    } else {
        const int net[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7},
                                {0, 2}, {1, 3}, {4, 6}, {5, 7},
                                {1, 2}, {5, 6},
                                {0, 4}, {1, 5}, {2, 6}, {3, 7},
                                {2, 4}, {3, 5},
                                {1, 2}, {3, 4}, {5, 6}};
        sort_net(net, has, m, w);
    }
}

template <bool SLOTS, int W>
__global__ void __launch_bounds__(WIDE_BLOCK)
intersect_wide_kernel(const float4* __restrict__ nodes,
                      const float4* __restrict__ tris,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar, int n_rays,
                      float* __restrict__ t_out,
                      int* __restrict__ tri_out, float* __restrict__ u_out,
                      float* __restrict__ v_out) {
    int ray = blockIdx.x * WIDE_BLOCK + threadIdx.x;
    Ray r = {};
    Slab inv = {};
    Best b = {0.0f, 0.0f, 0.0f, -1};
    unsigned cur = 0;                           // the root, entry t 0
    unsigned st_w[STACK];
    float st_t[STACK];
    int sp = -1;

    auto finish = [&]() {
        t_out[ray] = b.tri >= 0 ? b.t : CUDART_INF_F;
        tri_out[ray] = b.tri;
        u_out[ray] = b.u;
        v_out[ray] = b.v;
        ray = -1;
    };
    // the next entry whose entry t does not exceed the best t, or finish
    auto next_entry = [&]() {
        for (; sp >= 0; --sp) {
            if (st_t[sp] <= b.t) {
                cur = st_w[sp--];
                return;
            }
        }
        finish();
    };

    if (ray < n_rays) {
        r = load_ray(org, dir, tnear, tfar, ray);
        inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        b.t = r.tfar;
        if (!(0.0f <= b.t)) finish();
    } else {
        ray = -1;
    }
    while (__ballot_sync(FULL_MASK, ray >= 0)) {
        if (ray >= 0 && !is_leaf(cur)) {
            float4 q[2 * W];
            load_node<W>(nodes, cur, q);
            bool has[W];
            float m[W];
            unsigned w[W];
            sort_slots<SLOTS, W>(q, cur, r, inv, b.t, has, m, w);
            // push the hit slots in order; the last one pushed would pop
            // next (its entry t passed the slab test against b.t), so it
            // is taken at once
            bool any = false;
            unsigned nw = 0;
            float nt = 0.0f;
            #pragma unroll
            for (int k = 0; k < W; ++k) {
                if (has[k]) {
                    if (any) {
                        ++sp;
                        st_w[sp] = nw;
                        st_t[sp] = nt;
                    }
                    nw = w[k];
                    nt = m[k];
                    any = true;
                }
            }
            if (any) cur = nw;
            else next_entry();
        }
        // the leaves the lanes hold: each lane its own when many hold one,
        // else one at a time across the warp
        const bool leaf = ray >= 0 && is_leaf(cur);
        unsigned leaves = __ballot_sync(FULL_MASK, leaf);
        if (__popc(leaves) >= WIDE_SERIAL_MIN) {
            if (leaf) {
                int a, c;
                leaf_range<SLOTS, W>(nodes, cur, a, c);
                for (int j = a; j < a + c; ++j) {
                    float s[16], th, uh, vh;
                    load_row<4>(tris, 4, j, s);
                    if (woop_test(s, r, r.tnear, b.t, th, uh, vh)) {
                        b = {th, uh, vh, j};
                    }
                }
            }
            leaves = 0;
        }
        while (leaves) {
            const int src = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            const Ray q = shfl_ray(r, src);
            const unsigned w = __shfl_sync(FULL_MASK, cur, src);
            float tb = __shfl_sync(FULL_MASK, b.t, src);
            int a, c;
            leaf_range<SLOTS, W>(nodes, w, a, c);
            for (int j0 = 0; j0 < c; j0 += 32) {
                float th = 0.0f, uh = 0.0f, vh = 0.0f;
                const bool h = lane_test(tris, q, tb, a, c, j0, th, uh, vh);
                take_closest(h, th, uh, vh, a + j0, src, tb, b);
            }
        }
        if (leaf) next_entry();
    }
}

template <bool SLOTS, int W>
__global__ void __launch_bounds__(WIDE_BLOCK)
occluded_wide_kernel(const float4* __restrict__ nodes,
                     const float4* __restrict__ tris,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar, int n_rays,
                     bool* __restrict__ occ_out) {
    const int lane = threadIdx.x & 31;
    int ray = blockIdx.x * WIDE_BLOCK + threadIdx.x;
    Ray r = {};
    Slab inv = {};
    unsigned cur = 0;                           // the root
    unsigned st_w[STACK];
    int sp = -1;

    auto finish = [&](bool occ) {
        occ_out[ray] = occ;
        ray = -1;
    };
    auto next_entry = [&]() {
        if (sp >= 0) cur = st_w[sp--];
        else finish(false);
    };

    if (ray < n_rays) {
        r = load_ray(org, dir, tnear, tfar, ray);
        inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        if (!(r.tfar > r.tnear)) finish(false);
    } else {
        ray = -1;
    }
    while (__ballot_sync(FULL_MASK, ray >= 0)) {
        if (ray >= 0 && !is_leaf(cur)) {
            float4 q[2 * W];
            load_node<W>(nodes, cur, q);
            // the nearest hit slot next, the others pushed far first
            bool has[W];
            float m[W];
            unsigned w[W];
            sort_slots<SLOTS, W>(q, cur, r, inv, r.tfar, has, m, w);
            bool any = false;
            unsigned nw = 0;
            #pragma unroll
            for (int k = 0; k < W; ++k) {
                if (has[k]) {
                    if (any) st_w[++sp] = nw;
                    nw = w[k];
                    any = true;
                }
            }
            if (any) cur = nw;
            else next_entry();
        }
        // the leaves the lanes hold: each lane its own (up to its first
        // hit) when many hold one, else one at a time across the warp
        const bool leaf = ray >= 0 && is_leaf(cur);
        unsigned leaves = __ballot_sync(FULL_MASK, leaf);
        bool occ = false;
        if (__popc(leaves) >= WIDE_SERIAL_MIN) {
            if (leaf) {
                int a, c;
                leaf_range<SLOTS, W>(nodes, cur, a, c);
                for (int j = a; j < a + c && !occ; ++j) {
                    float s[16], th, uh, vh;
                    load_row<4>(tris, 4, j, s);
                    occ = woop_test(s, r, r.tnear, r.tfar, th, uh, vh);
                }
            }
            leaves = 0;
        }
        while (leaves) {
            const int src = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            const Ray q = shfl_ray(r, src);
            const unsigned w = __shfl_sync(FULL_MASK, cur, src);
            int a, c;
            leaf_range<SLOTS, W>(nodes, w, a, c);
            bool hit = false;
            for (int j0 = 0; j0 < c && !hit; j0 += 32) {
                float th, uh, vh;
                hit = __any_sync(FULL_MASK, lane_test(tris, q, q.tfar, a, c,
                                                      j0, th, uh, vh));
            }
            if (lane == src) occ = hit;
        }
        if (leaf) {
            if (occ) finish(true);
            else next_entry();
        }
    }
}

template <bool SLOTS, int W>
int intersect_wide(const void* nodes, const void* tris, const void* org,
                   const void* dir, const void* tnear, const void* tfar,
                   int n_rays, void* t_out, void* tri_out, void* u_out,
                   void* v_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + WIDE_BLOCK - 1) / WIDE_BLOCK;
        intersect_wide_kernel<SLOTS, W><<<grid, WIDE_BLOCK, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}

template <bool SLOTS, int W>
int occluded_wide(const void* nodes, const void* tris, const void* org,
                  const void* dir, const void* tnear, const void* tfar,
                  int n_rays, void* occ_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + WIDE_BLOCK - 1) / WIDE_BLOCK;
        occluded_wide_kernel<SLOTS, W><<<grid, WIDE_BLOCK, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}

// one C entry point a kernel: name, the slot form, the width
#define WIDE_ENTRIES(NAME, SLOTS, W)                                        \
    extern "C" int yrt_intersect_##NAME(                                  \
        const void* nodes, const void* tris, const void* org,             \
        const void* dir, const void* tnear, const void* tfar, int n_rays, \
        void* t_out, void* tri_out, void* u_out, void* v_out,             \
        void* stream) {                                                   \
        return intersect_wide<SLOTS, W>(nodes, tris, org, dir, tnear,     \
                                        tfar, n_rays, t_out, tri_out,     \
                                        u_out, v_out, stream);            \
    }                                                                     \
    extern "C" int yrt_occluded_##NAME(                                   \
        const void* nodes, const void* tris, const void* org,             \
        const void* dir, const void* tnear, const void* tfar, int n_rays, \
        void* occ_out, void* stream) {                                    \
        return occluded_wide<SLOTS, W>(nodes, tris, org, dir, tnear,      \
                                       tfar, n_rays, occ_out, stream);    \
    }

WIDE_ENTRIES(wide, false, 4)
WIDE_ENTRIES(wide_slots, true, 4)
WIDE_ENTRIES(wide8, false, 8)
WIDE_ENTRIES(wide8_slots, true, 8)
