// BVH4 traversal kernels: closest hit and any hit.
//
// Replaces the TPU kernels of yulio_raytracer_tpu/ops/pallas_wide.py:
//   yrt_intersect_wide <- _kernel4     (intersect_packet4, closest hit)
//   yrt_occluded_wide  <- _kernel4_any (occluded_packet4, any hit)
// The reference runs them as the default accel for scenes of more than
// 2048 triangles, e.g. the 92k-triangle colonnade.
//
// Node rows (ops/wide.py pack_nodes4): (N4, 32) f32, 4 slots of
// [lo.x lo.y lo.z hi.x hi.y hi.z A tag]; tag > 0 is a leaf of `tag`
// triangles starting at packed triangle A, tag == -1 an interior slot
// whose A is the child row, tag == 0 an empty slot.  A slot is decided by
// its tag alone: an empty slot's +inf/-inf box still passes the min/max
// slab test.
//
// Design: one thread per ray with a private stack of STACK entries
// (pack_nodes4 checks that (4 - 1) * depth + 1 <= STACK).  Nodes and
// triangles stay in global memory and are read through the read-only
// cache.  The closest-hit kernel stores (payload, entry t, count) per
// entry: a pop whose entry t exceeds the ray's best t is skipped; an
// interior pop slab-tests its 4 slots against (tnear, best t) and pushes
// the hit ones far to near (the reference's 4-element sort network), so
// the nearest pops first; a leaf pop tests its triangles [A, A + count) in
// ascending order with a strictly-nearer update.  The any-hit kernel
// pushes in slot order and stops at the first hit; rays with
// tfar <= tnear report not occluded without traversing.
//
// What bounds it on the H100: each pop is a dependent chain of global
// loads (one 128-byte node row or up to `leaf` 64-byte triangle rows)
// followed by divergent control flow across the warp, so the kernel is
// bound by memory latency and warp divergence rather than by f32 issue;
// the per-thread stack lives in local memory.  Making it fast (caching the
// top of the tree in shared memory, sorting rays for coherence, wide
// loads, a short register stack) is later work.
#include "bvh.cuh"

#define WIDE_BLOCK 128

template <typename T>
__device__ __forceinline__ void cswap(bool c, T& a, T& b) {
    T x = c ? b : a;
    T y = c ? a : b;
    a = x;
    b = y;
}

__global__ void __launch_bounds__(WIDE_BLOCK)
intersect_wide_kernel(const float* __restrict__ nodes,
                      const float4* __restrict__ tris,
                      const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar, int n_rays,
                      float* __restrict__ t_out, int* __restrict__ tri_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
    const int i = blockIdx.x * WIDE_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
    int st_a[STACK];
    float st_t[STACK];
    int st_c[STACK];
    int sp = 0;
    st_a[0] = 0;
    st_t[0] = 0.0f;
    st_c[0] = 0;
    float t_b = r.tfar, u_b = 0.0f, v_b = 0.0f;
    int tri_b = -1;
    while (sp >= 0) {
        const int a = st_a[sp];
        const float tpop = st_t[sp];
        const int c = st_c[sp];
        --sp;
        if (!(tpop <= t_b)) continue;
        if (c > 0) {
            for (int j = a; j < a + c; ++j) {
                float w[16], th, uh, vh;
                load_row<4>(tris, 4, j, w);
                if (woop_test(w, r, r.tnear, t_b, th, uh, vh)) {
                    t_b = th;
                    tri_b = j;
                    u_b = uh;
                    v_b = vh;
                }
            }
            continue;
        }
        float m[4];
        int ca[4], cc[4];
        bool has[4];
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float* s = nodes + 32 * a + 8 * k;
            const int tag = static_cast<int>(__ldg(s + 7));
            float tmin;
            has[k] = slab(s, r, inv, r.tnear, t_b, tmin) && tag != 0;
            m[k] = has[k] ? tmin : -CUDART_INF_F;
            ca[k] = static_cast<int>(__ldg(s + 6));
            cc[k] = max(tag, 0);
        }
        // descending sort network (pallas_wide._SORT_NETS[4]): far first
        const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
        #pragma unroll
        for (int q = 0; q < 5; ++q) {
            const int x = net[q][0], y = net[q][1];
            const bool lt = m[x] < m[y];
            cswap(lt, m[x], m[y]);
            cswap(lt, ca[x], ca[y]);
            cswap(lt, cc[x], cc[y]);
            cswap(lt, has[x], has[y]);
        }
        #pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (has[k]) {
                ++sp;
                st_a[sp] = ca[k];
                st_t[sp] = m[k];
                st_c[sp] = cc[k];
            }
        }
    }
    t_out[i] = tri_b >= 0 ? t_b : CUDART_INF_F;
    tri_out[i] = tri_b;
    u_out[i] = u_b;
    v_out[i] = v_b;
}

__global__ void __launch_bounds__(WIDE_BLOCK)
occluded_wide_kernel(const float* __restrict__ nodes,
                     const float4* __restrict__ tris,
                     const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ tnear,
                     const float* __restrict__ tfar, int n_rays,
                     bool* __restrict__ occ_out) {
    const int i = blockIdx.x * WIDE_BLOCK + threadIdx.x;
    if (i >= n_rays) return;
    const Ray r = load_ray(org, dir, tnear, tfar, i);
    bool occ = false;
    if (r.tfar > r.tnear) {
        const Slab inv = {safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz)};
        int st_a[STACK];
        int st_c[STACK];
        int sp = 0;
        st_a[0] = 0;
        st_c[0] = 0;
        while (sp >= 0 && !occ) {
            const int a = st_a[sp];
            const int c = st_c[sp];
            --sp;
            if (c > 0) {
                for (int j = a; j < a + c; ++j) {
                    float w[16], th, uh, vh;
                    load_row<4>(tris, 4, j, w);
                    if (woop_test(w, r, r.tnear, r.tfar, th, uh, vh)) {
                        occ = true;
                        break;
                    }
                }
                continue;
            }
            #pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float* s = nodes + 32 * a + 8 * k;
                const int tag = static_cast<int>(__ldg(s + 7));
                float tmin;
                if (slab(s, r, inv, r.tnear, r.tfar, tmin) && tag != 0) {
                    ++sp;
                    st_a[sp] = static_cast<int>(__ldg(s + 6));
                    st_c[sp] = max(tag, 0);
                }
            }
        }
    }
    occ_out[i] = occ;
}

extern "C" int yrt_intersect_wide(const void* nodes, const void* tris,
                                  const void* org, const void* dir,
                                  const void* tnear, const void* tfar,
                                  int n_rays, void* t_out, void* tri_out,
                                  void* u_out, void* v_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + WIDE_BLOCK - 1) / WIDE_BLOCK;
        intersect_wide_kernel<<<grid, WIDE_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<float*>(t_out), static_cast<int*>(tri_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_occluded_wide(const void* nodes, const void* tris,
                                 const void* org, const void* dir,
                                 const void* tnear, const void* tfar,
                                 int n_rays, void* occ_out, void* stream) {
    if (n_rays > 0) {
        const int grid = (n_rays + WIDE_BLOCK - 1) / WIDE_BLOCK;
        occluded_wide_kernel<<<grid, WIDE_BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(nodes),
            static_cast<const float4*>(tris),
            static_cast<const float*>(org), static_cast<const float*>(dir),
            static_cast<const float*>(tnear),
            static_cast<const float*>(tfar), n_rays,
            static_cast<bool*>(occ_out));
    }
    return static_cast<int>(cudaGetLastError());
}
