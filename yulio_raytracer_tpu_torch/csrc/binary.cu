// Binary-BVH traversal kernels: closest hit, any hit, and the
// motion-blur closest hit.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_traverse.py:
//   yrt_intersect_binary <- _kernel    (intersect_packet, closest hit)
//   yrt_occluded_binary  <- _kernel_any (occluded_packet, any hit)
//   yrt_intersect_motion <- _kernel_mb (intersect_packet_mb, motion blur)
// The first two take an optional start node per ray (the reference's
// `roots`, one per 1024-ray packet), which the treelet binning's rounds
// give.  The reference runs them where the BVH4 collapse fails its
// guards or accel='bvh2' asks for them, under the 'treelet' and 'dense'
// binnings on bounces >= 1, and the third on motion scenes
// (its occluded_packet_mb is this kernel's hit mask, and so is the
// port's: there is no motion any-hit kernel).  In the port the first two
// are also the fallback of the 'grid' binning, and the whole 'bvh2' path.
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
// K7 (motion_kernel below) keeps the one-ray-per-thread walk of the
// earlier port: its motion test (87 flops against the Woop test's 55) and
// its leaves of up to 64 triangles change what a warp schedule would buy,
// and it is timed on its own cell, so its redesign is separate work.
#include "bvh.cuh"
#include "motion.cuh"

#define BINARY_BLOCK 128
// the lanes of a warp holding a leaf from which on each lane tests its own
// leaf (fewer: the warp tests them one at a time across its lanes)
#define BINARY_SERIAL_MIN 16

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

// K7: the earlier port's walk, one thread per ray with a private stack of
// STACK (node, entry t) pairs, nodes and triangles read with scalar loads
// through the read-only cache, each leaf a serial loop of motion tests at
// the ray's time.  The best t starts at tfar, so the motion test's window
// th < min(tfar, best) is th < best.  `roots` is always null (node 0):
// it stays so that K7 compiles to the earlier port's instructions (424;
// without it 416) until K7 is redesigned.
__global__ void __launch_bounds__(BINARY_BLOCK)
motion_kernel(const float* __restrict__ nodes,
              const float4* __restrict__ tris,
              const float* __restrict__ org,
              const float* __restrict__ dir,
              const float* __restrict__ tnear,
              const float* __restrict__ tfar,
              const float* __restrict__ time,
              const int* __restrict__ roots, int n_rays,
              float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ u_out, float* __restrict__ v_out) {
    const int i = blockIdx.x * BINARY_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    const float tm = __ldg(time + i);
    const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    int st_n[STACK];
    float st_t[STACK];
    int sp = 0;
    st_n[0] = roots ? __ldg(roots + i) : 0;
    st_t[0] = 0.0f;
    float t_b = r.tfar, u_b = 0.0f, v_b = 0.0f;
    int tri_b = -1;
    while (sp >= 0) {
        const int node = st_n[sp];
        const float tpop = st_t[sp];
        --sp;
        if (!(tpop <= t_b)) continue;
        const float* nd = nodes + 8 * static_cast<size_t>(node);
        const int a = static_cast<int>(__ldg(nd + 6));
        const int tag = static_cast<int>(__ldg(nd + 7));
        if (tag >= 0) {
            for (int j = a; j < a + tag; ++j) {
                float w[20], th, uh, vh;
                load_row<5>(tris, 8, j, w);
                if (motion_test(w, r, tm, r.tnear, t_b, th, uh, vh)) {
                    t_b = th;
                    tri_b = j;
                    u_b = uh;
                    v_b = vh;
                }
            }
            continue;
        }
        const int left = node + 1;
        float tl, tr;
        const bool hl = slab(nodes + 8 * static_cast<size_t>(left), r, inv,
                             r.tnear, t_b, tl);
        const bool hr = slab(nodes + 8 * static_cast<size_t>(a), r, inv,
                             r.tnear, t_b, tr);
        const int axis = -tag - 1;
        const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        const bool left_near = d >= 0.0f;
        if (left_near ? hr : hl) {              // far child first
            ++sp;
            st_n[sp] = left_near ? a : left;
            st_t[sp] = left_near ? tr : tl;
        }
        if (left_near ? hl : hr) {
            ++sp;
            st_n[sp] = left_near ? left : a;
            st_t[sp] = left_near ? tl : tr;
        }
    }
    t_out[i] = tri_b >= 0 ? t_b : CUDART_INF_F;
    tri_out[i] = tri_b;
    u_out[i] = u_b;
    v_out[i] = v_b;
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
        motion_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
            static_cast<const float4*>(tris_mb),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar),
            static_cast<const float*>(time), nullptr, n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}
