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
// port's: there is no motion any-hit kernel).
//
// Node rows (ops/traverse.py pack_nodes): (N, 8) f32
// [lo.x lo.y lo.z hi.x hi.y hi.z A tag] in depth-first order; tag > 0 is
// a leaf of `tag` triangles from packed triangle A, tag = -(axis + 1) an
// interior node with left child at the next row and right child at row A.
// Triangles: the Woop rows of ops/wide.py pack_tris (16 floats), or the
// motion rows of pack_tris_mb (32 floats, tested at the ray's time).
//
// Design: one thread per ray with a private stack of STACK (node, entry
// t) pairs (pack_nodes checks that depth + 1 <= STACK).  Nodes and
// triangles stay in global memory and are read through the read-only
// cache.  The root (node 0, or the ray's own start node where `roots` is
// given) is pushed untested with entry t 0.  A pop whose entry t
// exceeds the ray's best t is skipped; an interior pop slab-tests both
// children against (tnear, best t) and pushes the hit ones far child
// first, so the near one pops first.  Near is the side the ray's own
// direction points to along the node's axis (the TPU kernel shares one
// order per 1024-ray packet, from the packet's summed direction).  A leaf
// pop tests its triangles [A, A + count) in ascending order and keeps a
// hit only when strictly nearer.  The best t starts at tfar, so the
// motion test's window th < min(tfar, best) is th < best.  The any-hit
// kernel walks the same order without entry t and stops at the first
// hit; rays with tfar <= tnear report not occluded without traversing.
//
// What bounds it on the H100: each pop is a dependent chain of global
// loads (two 32-byte child boxes, or up to `leaf` 64- or 80-byte
// triangle rows) followed by control flow that diverges across the warp,
// so the kernels are bound by memory latency and divergence rather than
// by f32 issue; the per-thread stack lives in local memory.  Later work:
// caching the top of the tree in shared memory, wider node loads (both
// children in one 64-byte read), a short register stack, and
// --fmad=true once bit-equality with the torch version is no longer the
// contract.
#include "bvh.cuh"
#include "motion.cuh"

#define BINARY_BLOCK 128

// triangle j of a leaf against the ray segment (tnear, tfar): the Woop
// test, or the motion test at `time`
template <bool MOTION>
__device__ __forceinline__ bool leaf_tri(const float4* __restrict__ tris,
                                         int j, const Ray& r, float time,
                                         float tfar, float& th, float& uh,
                                         float& vh) {
    if constexpr (MOTION) {
        float w[20];
        load_row<5>(tris, 8, j, w);
        return motion_test(w, r, time, r.tnear, tfar, th, uh, vh);
    } else {
        float w[16];
        load_row<4>(tris, 4, j, w);
        return woop_test(w, r, r.tnear, tfar, th, uh, vh);
    }
}

template <bool MOTION>
__global__ void __launch_bounds__(BINARY_BLOCK)
closest_kernel(const float* __restrict__ nodes,
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
    const float tm = MOTION ? __ldg(time + i) : 0.0f;
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
                float th, uh, vh;
                if (leaf_tri<MOTION>(tris, j, r, tm, t_b, th, uh, vh)) {
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

__global__ void __launch_bounds__(BINARY_BLOCK)
occluded_kernel(const float* __restrict__ nodes,
                const float4* __restrict__ tris,
                const float* __restrict__ org,
                const float* __restrict__ dir,
                const float* __restrict__ tnear,
                const float* __restrict__ tfar,
                const int* __restrict__ roots, int n_rays,
                bool* __restrict__ occ_out) {
    const int i = blockIdx.x * BINARY_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    bool occ = false;
    if (r.tfar > r.tnear) {
        const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        int st_n[STACK];
        int sp = 0;
        st_n[0] = roots ? __ldg(roots + i) : 0;
        while (sp >= 0 && !occ) {
            const int node = st_n[sp];
            --sp;
            const float* nd = nodes + 8 * static_cast<size_t>(node);
            const int a = static_cast<int>(__ldg(nd + 6));
            const int tag = static_cast<int>(__ldg(nd + 7));
            if (tag >= 0) {
                for (int j = a; j < a + tag; ++j) {
                    float th, uh, vh;
                    if (leaf_tri<false>(tris, j, r, 0.0f, r.tfar, th, uh,
                                        vh)) {
                        occ = true;
                        break;
                    }
                }
                continue;
            }
            const int left = node + 1;
            float tl, tr;
            const bool hl = slab(nodes + 8 * static_cast<size_t>(left), r,
                                 inv, r.tnear, r.tfar, tl);
            const bool hr = slab(nodes + 8 * static_cast<size_t>(a), r, inv,
                                 r.tnear, r.tfar, tr);
            const int axis = -tag - 1;
            const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
            const bool left_near = d >= 0.0f;
            if (left_near ? hr : hl) st_n[++sp] = left_near ? a : left;
            if (left_near ? hl : hr) st_n[++sp] = left_near ? left : a;
        }
    }
    occ_out[i] = occ;
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
        closest_kernel<false><<<grid_of(n_rays), BINARY_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), nullptr,
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
        occluded_kernel<<<grid_of(n_rays), BINARY_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
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
        closest_kernel<true><<<grid_of(n_rays), BINARY_BLOCK, 0,
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
