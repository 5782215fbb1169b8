// Binary-BVH traversal kernels: closest hit, any hit, and the
// motion-blur closest and any hit.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_traverse.py:
//   yrt_intersect_binary <- _kernel    (intersect_packet, closest hit)
//   yrt_occluded_binary  <- _kernel_any (occluded_packet, any hit)
//   yrt_intersect_motion <- _kernel_mb (intersect_packet_mb, motion blur)
//   yrt_occluded_motion  <- _kernel_mb (occluded_packet_mb, its hit mask)
// The first two take an optional start node per ray (the reference's
// `roots`, one per 1024-ray packet), which the treelet binning's rounds
// give.  The reference runs them where the BVH4 collapse fails its
// guards or accel='bvh2' asks for them, under the 'treelet' and 'dense'
// binnings on bounces >= 1, and the last two on motion scenes.  Its
// occluded_packet_mb is the closest kernel's hit mask (tri >= 0); the
// port's any-hit form computes that mask with an early exit.  In the
// port the first two are also the fallback of the 'grid' binning, and
// the whole 'bvh2' path.
//
// Node rows (ops/traverse.py pack_nodes): (N, 8) f32
// [lo.x lo.y lo.z hi.x hi.y hi.z A tag] in depth-first order; tag > 0 is
// a leaf of `tag` triangles from packed triangle A, tag = -(axis + 1) an
// interior node with left child at the next row and right child at row A.
// Triangles: the Woop rows of ops/wide.py pack_tris (16 floats), or the
// motion rows of pack_tris_mb (32 floats, tested at the ray's time).
//
// The walk each ray makes, which fixes the results bit for bit (the plain
// torch versions of ops/traverse.py make it too): the root (node 0, or
// the ray's own start node where `roots` is given) is taken untested
// with entry t 0.  A popped entry whose entry t exceeds the ray's best t
// is skipped; an interior node slab-tests both children against
// (tnear, best t); the hit ones go on a private stack far child first,
// so the near one pops first.  Near is the side the ray's own direction
// points to along the node's axis (the TPU kernel shares one order per
// 1024-ray packet, from the packet's summed direction).  A leaf tests its
// triangles [A, A + count) in ascending order and keeps a hit only when
// strictly nearer.  The any-hit walk, whose mask does not depend on the
// order, takes the hit child of least entry t first (the near one on a
// tie) and stops at the first hit; rays with tfar <= tnear report not
// occluded without traversing.
//
// What bounds K5 and K6 on the H100.  A colonnade ray slab-tests ~45
// child boxes (~22 interior nodes) and ~50 triangles in two or three
// leaves of up to 32 (the plain versions' counts); the calls of the
// binnings' rounds and fallbacks carry few live rays (the others marked
// dead with tfar -1: 23-61% of a fallback's rays are live), so a warp
// holds a few live lanes.  Walking alone, one ray per thread, a lane in a
// leaf ran a serial loop of up to 32 Woop tests while the warp's other
// lanes waited, and each pop was a chain of dependent scalar loads: 2-12%
// of the f32 bound (PERF.md section 6).
//
// Design of K5 and K6 (one ray per lane, BINARY_BLOCK-thread blocks), the
// warp leaf schedule of K3/K4 (wide.cu) carried over to the binary tree:
// - The warp steps together.  In each step every lane at an interior node
//   does that node: both children's boxes as two float4 pairs, the
//   (A, tag) of each child with them.  Then the warp tests the leaves its
//   lanes hold.  When at least BINARY_SERIAL_MIN lanes hold one, each
//   lane tests its own leaf; when fewer do, the warp takes those leaves
//   one at a time across all 32 lanes (lane j tests triangle A + j
//   against the owning lane's ray, a coalesced read of the leaf's rows).
//   The any-hit test ends a leaf with one vote and a ray at its first
//   hit; the closest hit takes the least t with one __reduce_min_sync on
//   an order-preserving key, ties to the lowest triangle, which is what
//   the strictly-nearer loop in ascending order keeps (bvh.cuh
//   take_closest).
// - K5 keeps the walk above exactly: the child that would pop next (the
//   near one if hit, else the far one) is taken at once without a push;
//   it passes the pop test unchanged, since its entry t passed the slab
//   test against the same best t.  Only a far child below a hit near one
//   is pushed, with its entry t.  K6 visits the hit child of least entry
//   t first, as the walk above says.
// - A stack entry is the node's row; popping one reads that row's
//   (A, tag) again (8 bytes).  No word packs a leaf's count, so a leaf
//   of any size walks as any other.
// The node and Woop arithmetic is bvh.cuh's slab_box and woop.cuh's
// woop_test, compiled with --fmad=false like every source here.
//
// What the turns showed (binary_turns against the one-ray-per-thread
// walk, in one process on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 6): K5 about 1.9x and K6 about 2.4x faster on the bvh2 frame's
// calls, 2.3-2.9x on the binnings' sparse calls, 1.2-2.3x on full-width
// ray sets.  Slower, and not kept: a threshold of 8, 24 or 32 lanes and
// 256-thread blocks (each slower on 10 to 12 of the 13 sets); lanes that
// take the next ray from a global counter as they finish, a compaction
// inside the kernel (1.2-1.8x slower on every set); and the live rays
// compacted before the launch in torch ops (slower on 11 of 13 sets,
// 1.03-1.07x faster only on the grid's and dense's any-hit calls).
//
// K7 (motion_walk below, the kernels intersect_motion_kernel and
// occluded_motion_kernel) is K5's and K6's design over the motion rows of
// the motion field's tree (173 nodes, leaves of up to 64 rows), each
// test the 87-flop motion test at the owning lane's ray and time: a leaf
// of 33-64 rows tested across the warp takes two rounds of 32.  Before,
// it walked one ray per thread with scalar loads and both children
// pushed, each leaf a serial loop while the warp's other lanes waited
// (2.1% of its f32 bound), and the shadow rays of a motion scene walked
// to their closest hit, as the reference's occluded_packet_mb does; the
// any-hit form stops at the first.  On the motion frame's own calls
// (binary_turns against the one-ray-per-thread walk, NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md section 6) the closest form is 1.8x and the
// any-hit form 2.2x faster (the early exit alone 1.09x), at 9.7% and
// 10.8% of the bound.  The threshold is 8 lanes: every other one tried
// (1, 4, 12, 16, 24, 32) was slower on both frame sets, by 3% (12) to
// 95% (1).  Not kept either: node rows staged in shared memory (within
// 2.2% of __ldg on the frame's calls), blocks of 64 (level) or 256
// threads (1-7% slower).
#include "bvh.cuh"
#include "motion.cuh"

#define BINARY_BLOCK 128
// the lanes of a warp holding a leaf from which on each lane tests its own
// leaf (fewer: the warp tests them one at a time across its lanes)
#define BINARY_SERIAL_MIN 16
// the same for K7's two forms, whose leaves hold up to 64 motion rows
#define MOTION_SERIAL_MIN 8

// the current node of a lane's walk: its row, and that row's A and tag
struct Cur {
    int node, a, tag;
};

// node `node`'s (A, tag), the last two floats of its row
__device__ __forceinline__ Cur node_at(const float4* __restrict__ nodes,
                                       int node) {
    const float4 q = __ldg(nodes + 2 * static_cast<size_t>(node) + 1);
    return {node, static_cast<int>(q.z), static_cast<int>(q.w)};
}

// The two children of interior node c against the segment (r.tnear, tfar):
// near (the side r's direction points to along c's axis) and far, each
// with its slab hit flag and entry t.
__device__ __forceinline__ void children(const float4* __restrict__ nodes,
                                         const Cur& c, const Ray& r,
                                         const Slab& inv, float tfar,
                                         Cur& near, bool& hn, float& tn,
                                         Cur& far, bool& hf, float& tf) {
    const float4 l0 = __ldg(nodes + 2 * static_cast<size_t>(c.node + 1));
    const float4 l1 = __ldg(nodes + 2 * static_cast<size_t>(c.node + 1) + 1);
    const float4 r0 = __ldg(nodes + 2 * static_cast<size_t>(c.a));
    const float4 r1 = __ldg(nodes + 2 * static_cast<size_t>(c.a) + 1);
    float tl, tr;
    const bool hl = slab4(l0, l1, r, inv, r.tnear, tfar, tl);
    const bool hr = slab4(r0, r1, r, inv, r.tnear, tfar, tr);
    const int axis = -c.tag - 1;
    const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const Cur left = {c.node + 1, static_cast<int>(l1.z),
                      static_cast<int>(l1.w)};
    const Cur right = {c.a, static_cast<int>(r1.z), static_cast<int>(r1.w)};
    if (d >= 0.0f) {
        near = left; hn = hl; tn = tl;
        far = right; hf = hr; tf = tr;
    } else {
        near = right; hn = hr; tn = tr;
        far = left; hf = hl; tf = tl;
    }
}

__global__ void __launch_bounds__(BINARY_BLOCK)
intersect_binary_kernel(const float4* __restrict__ nodes,
                        const float4* __restrict__ tris,
                        const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar,
                        const int* __restrict__ roots, int n_rays,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
    int ray = blockIdx.x * BINARY_BLOCK + threadIdx.x;
    Ray r = {};
    Slab inv = {};
    Best b = {0.0f, 0.0f, 0.0f, -1};
    Cur cur = {0, 0, 0};
    int st_n[STACK];
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
                cur = node_at(nodes, st_n[sp--]);
                return;
            }
        }
        finish();
    };

    if (ray < n_rays) {
        r = load_ray(org, dir, tnear, tfar, ray);
        inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        b.t = r.tfar;
        // the root, entry t 0
        if (0.0f <= b.t) {
            cur = node_at(nodes, roots ? __ldg(roots + ray) : 0);
        } else {
            finish();
        }
    } else {
        ray = -1;
    }
    while (__ballot_sync(FULL_MASK, ray >= 0)) {
        if (ray >= 0 && cur.tag < 0) {
            Cur near, far;
            bool hn, hf;
            float tn, tf;
            children(nodes, cur, r, inv, b.t, near, hn, tn, far, hf, tf);
            if (hn) {
                if (hf) {
                    ++sp;
                    st_n[sp] = far.node;
                    st_t[sp] = tf;
                }
                cur = near;
            } else if (hf) {
                cur = far;
            } else {
                next_entry();
            }
        }
        // the leaves the lanes hold: each lane its own when many hold one,
        // else one at a time across the warp
        const bool leaf = ray >= 0 && cur.tag >= 0;
        unsigned leaves = __ballot_sync(FULL_MASK, leaf);
        if (__popc(leaves) >= BINARY_SERIAL_MIN) {
            if (leaf) {
                for (int j = cur.a; j < cur.a + cur.tag; ++j) {
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
            const int a = __shfl_sync(FULL_MASK, cur.a, src);
            const int c = __shfl_sync(FULL_MASK, cur.tag, src);
            float tb = __shfl_sync(FULL_MASK, b.t, src);
            for (int j0 = 0; j0 < c; j0 += 32) {
                float th = 0.0f, uh = 0.0f, vh = 0.0f;
                const bool h = lane_test(tris, q, tb, a, c, j0, th, uh, vh);
                take_closest(h, th, uh, vh, a + j0, src, tb, b);
            }
        }
        if (leaf) next_entry();
    }
}

__global__ void __launch_bounds__(BINARY_BLOCK)
occluded_binary_kernel(const float4* __restrict__ nodes,
                       const float4* __restrict__ tris,
                       const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar,
                       const int* __restrict__ roots, int n_rays,
                       bool* __restrict__ occ_out) {
    const int lane = threadIdx.x & 31;
    int ray = blockIdx.x * BINARY_BLOCK + threadIdx.x;
    Ray r = {};
    Slab inv = {};
    Cur cur = {0, 0, 0};
    int st_n[STACK];
    int sp = -1;

    auto finish = [&](bool occ) {
        occ_out[ray] = occ;
        ray = -1;
    };
    auto next_entry = [&]() {
        if (sp >= 0) cur = node_at(nodes, st_n[sp--]);
        else finish(false);
    };

    if (ray < n_rays) {
        r = load_ray(org, dir, tnear, tfar, ray);
        inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        if (r.tfar > r.tnear) {
            cur = node_at(nodes, roots ? __ldg(roots + ray) : 0);
        } else {
            finish(false);
        }
    } else {
        ray = -1;
    }
    while (__ballot_sync(FULL_MASK, ray >= 0)) {
        if (ray >= 0 && cur.tag < 0) {
            // the hit child of least entry t next, the other pushed
            Cur near, far;
            bool hn, hf;
            float tn, tf;
            children(nodes, cur, r, inv, r.tfar, near, hn, tn, far, hf, tf);
            if (hn && hf) {
                const bool far_first = tf < tn;
                st_n[++sp] = far_first ? near.node : far.node;
                cur = far_first ? far : near;
            } else if (hn || hf) {
                cur = hn ? near : far;
            } else {
                next_entry();
            }
        }
        // the leaves the lanes hold: each lane its own (up to its first
        // hit) when many hold one, else one at a time across the warp
        const bool leaf = ray >= 0 && cur.tag >= 0;
        unsigned leaves = __ballot_sync(FULL_MASK, leaf);
        bool occ = false;
        if (__popc(leaves) >= BINARY_SERIAL_MIN) {
            if (leaf) {
                for (int j = cur.a; j < cur.a + cur.tag && !occ; ++j) {
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
            const int a = __shfl_sync(FULL_MASK, cur.a, src);
            const int c = __shfl_sync(FULL_MASK, cur.tag, src);
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

// K7, the motion-blur walk: K5's and K6's design over the motion rows,
// each lane's ray tested at its own time.  ANY selects the any-hit form
// (K6's order, up to the first hit); else the closest form (K5's walk,
// bit for bit).  The closest form's root is taken when its entry t 0
// does not exceed tfar; the any-hit form also needs tfar > tnear, so its
// mask is the closest form's tri >= 0 on every ray.  The best t starts
// at tfar, so a motion test's window th < best is th < min(tfar, best).
template <bool ANY>
__device__ __forceinline__ void motion_walk(
    const float4* __restrict__ nodes, const float4* __restrict__ tris,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tnear, const float* __restrict__ tfar,
    const float* __restrict__ time, int n_rays, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, bool* __restrict__ occ_out) {
    const int lane = threadIdx.x & 31;
    int ray = blockIdx.x * BINARY_BLOCK + threadIdx.x;
    Ray r = {};
    Slab inv = {};
    float tm = 0.0f;
    Best b = {0.0f, 0.0f, 0.0f, -1};
    Cur cur = {0, 0, 0};
    int st_n[STACK];
    float st_t[STACK];
    int sp = -1;

    auto finish = [&](bool occ) {
        if constexpr (ANY) {
            occ_out[ray] = occ;
        } else {
            t_out[ray] = b.tri >= 0 ? b.t : CUDART_INF_F;
            tri_out[ray] = b.tri;
            u_out[ray] = b.u;
            v_out[ray] = b.v;
        }
        ray = -1;
    };
    // the next entry whose entry t does not exceed the best t (any entry
    // for the any-hit form, whose best t stays tfar), or finish
    auto next_entry = [&]() {
        for (; sp >= 0; --sp) {
            if (ANY || st_t[sp] <= b.t) {
                cur = node_at(nodes, st_n[sp--]);
                return;
            }
        }
        finish(false);
    };

    if (ray < n_rays) {
        r = load_ray(org, dir, tnear, tfar, ray);
        tm = __ldg(time + ray);
        inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        b.t = r.tfar;
        // the root, entry t 0
        if (0.0f <= b.t && (!ANY || r.tfar > r.tnear)) {
            cur = node_at(nodes, 0);
        } else {
            finish(false);
        }
    } else {
        ray = -1;
    }
    while (__ballot_sync(FULL_MASK, ray >= 0)) {
        if (ray >= 0 && cur.tag < 0) {
            // the child that would pop next, the other (if hit) pushed:
            // the near one (closest), the one of least entry t (any hit)
            Cur near, far;
            bool hn, hf;
            float tn, tf;
            children(nodes, cur, r, inv, b.t, near, hn, tn, far, hf, tf);
            if (hn && hf) {
                const bool far_first = ANY && tf < tn;
                ++sp;
                st_n[sp] = far_first ? near.node : far.node;
                if constexpr (!ANY) st_t[sp] = tf;
                cur = far_first ? far : near;
            } else if (hn || hf) {
                cur = hn ? near : far;
            } else {
                next_entry();
            }
        }
        // the leaves the lanes hold: each lane its own when many hold one,
        // else one at a time across the warp, each of its rows at the
        // owning lane's ray and time
        const bool leaf = ray >= 0 && cur.tag >= 0;
        unsigned leaves = __ballot_sync(FULL_MASK, leaf);
        bool occ = false;
        if (__popc(leaves) >= MOTION_SERIAL_MIN) {
            if (leaf) {
                for (int j = cur.a; j < cur.a + cur.tag && !occ; ++j) {
                    float w[20], th, uh, vh;
                    load_row<5>(tris, 8, j, w);
                    if (motion_test(w, r, tm, r.tnear, b.t, th, uh, vh)) {
                        if constexpr (ANY) occ = true;
                        else b = {th, uh, vh, j};
                    }
                }
            }
            leaves = 0;
        }
        while (leaves) {
            const int src = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            const Ray q = shfl_ray(r, src);
            const float qt = __shfl_sync(FULL_MASK, tm, src);
            const int a = __shfl_sync(FULL_MASK, cur.a, src);
            const int c = __shfl_sync(FULL_MASK, cur.tag, src);
            float tb = __shfl_sync(FULL_MASK, b.t, src);
            bool hit = false;
            for (int j0 = 0; j0 < c && !hit; j0 += 32) {
                float th = 0.0f, uh = 0.0f, vh = 0.0f;
                const bool h = lane_test_mb(tris, q, qt, tb, a, c, j0, th,
                                            uh, vh);
                if constexpr (ANY) {
                    hit = __any_sync(FULL_MASK, h);
                } else {
                    take_closest(h, th, uh, vh, a + j0, src, tb, b);
                }
            }
            if (lane == src) occ = hit;
        }
        if (leaf) {
            if (occ) finish(true);
            else next_entry();
        }
    }
}

__global__ void __launch_bounds__(BINARY_BLOCK)
intersect_motion_kernel(const float4* __restrict__ nodes,
                        const float4* __restrict__ tris,
                        const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ tnear,
                        const float* __restrict__ tfar,
                        const float* __restrict__ time, int n_rays,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
    motion_walk<false>(nodes, tris, org, dir, tnear, tfar, time, n_rays,
                       t_out, tri_out, u_out, v_out, nullptr);
}

__global__ void __launch_bounds__(BINARY_BLOCK)
occluded_motion_kernel(const float4* __restrict__ nodes,
                       const float4* __restrict__ tris,
                       const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar,
                       const float* __restrict__ time, int n_rays,
                       bool* __restrict__ occ_out) {
    motion_walk<true>(nodes, tris, org, dir, tnear, tfar, time, n_rays,
                      nullptr, nullptr, nullptr, nullptr, occ_out);
}

static int grid_of(int n_rays) {
    return (n_rays + BINARY_BLOCK - 1) / BINARY_BLOCK;
}

// roots: (n_rays,) int32 start nodes, or null for node 0
extern "C" int yrt_intersect_binary(const void* nodes, const void* tris,
                                    const void* org, const void* dir,
                                    const void* tnear, const void* tfar,
                                    const void* roots, int n_rays,
                                    void* t_out, void* tri_out, void* u_out,
                                    void* v_out, void* stream) {
    if (n_rays > 0) {
        intersect_binary_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar),
            static_cast<const int*>(roots), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_occluded_binary(const void* nodes, const void* tris,
                                   const void* org, const void* dir,
                                   const void* tnear, const void* tfar,
                                   const void* roots, int n_rays,
                                   void* occ_out, void* stream) {
    if (n_rays > 0) {
        occluded_binary_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar),
            static_cast<const int*>(roots), n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_intersect_motion(const void* nodes, const void* tris_mb,
                                    const void* org, const void* dir,
                                    const void* tnear, const void* tfar,
                                    const void* time, int n_rays,
                                    void* t_out, void* tri_out, void* u_out,
                                    void* v_out, void* stream) {
    if (n_rays > 0) {
        intersect_motion_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris_mb),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar),
            static_cast<const float*>(time), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_occluded_motion(const void* nodes, const void* tris_mb,
                                   const void* org, const void* dir,
                                   const void* tnear, const void* tfar,
                                   const void* time, int n_rays,
                                   void* occ_out, void* stream) {
    if (n_rays > 0) {
        occluded_motion_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(nodes),
            static_cast<const float4*>(tris_mb),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar),
            static_cast<const float*>(time), n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}
