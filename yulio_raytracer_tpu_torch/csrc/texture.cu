// Gathered texel fetch: one RGBA texel a (hit, slot) from the texture
// atlas, each slot filtered by its own texture's filter.
//
// Replaces no TPU kernel: the reference's fetch
// (yulio_raytracer_tpu/shading/textures.py `fetch`) is jnp gathers with no
// pallas_call, left to XLA to fuse.  Run op by op in torch it was ~90
// launches and five full-width texel gathers a call (four bilinear taps and
// one nearest tap for every slot, textured or not), so this kernel was
// added to do the same function in one pass.
//
// Tables (shading/textures.py TextureTableBuilder): the atlas `data`,
// (P, 4) f32, and per texture `off`, `w`, `h`, `filter`, `invert` (int32,
// a few hundred bytes: they stay in L1/L2).
//
// What bounds it on the H100: bytes.  A slot reads its texture id (8 B),
// its uv once a hit (the (R, 4, 2) view of the caller is read through its
// strides, so the 4 slots of a hit share one 8-byte read), writes 16 B,
// and reads 16 B a tap: 4 taps for a bilinear slot, 1 for a nearest one,
// none for a slot whose id is < 0.  The taps are random over the atlas
// (hundreds of MB in a textured interior), a 32-byte sector each at best.
//
// Design: one thread a slot.  A slot with id < 0 writes opaque white and
// reads nothing more; an id past the table traps, as the plain version's
// gather fails there; otherwise it reads its texture's row and does only
// its own filter, each tap one float4 load through the read-only path (x0
// and x1 are neighbours in memory), applies invert and writes once.
//
// Exactness: built with --fmad=false, and every operation is the plain
// version's (shading/textures.py `_fetch`) in its order: s = u - floor(u);
// u = s*W - .5, x0 = floor(u) as int64 clamped to [0, max(W-2, 0)],
// x1 = min(x0+1, W-1); the blend (t00 (1-ur) + t10 ur)(1-vr)
// + (t01 (1-ur) + t11 ur) vr; nearest by a truncating int32 cast; invert
// as 1 - c.  So the result is bit-equal to it.  Texel addresses are int64.
#include <cuda_runtime.h>

#define FETCH_THREADS 256
#define FILTER_BILINEAR 1

__device__ __forceinline__ float4 blend(float4 a, float4 b, float wa,
                                        float wb) {
    return make_float4(a.x * wa + b.x * wb, a.y * wa + b.y * wb,
                       a.z * wa + b.z * wb, a.w * wa + b.w * wb);
}

__global__ void __launch_bounds__(FETCH_THREADS)
texture_fetch_kernel(const float4* __restrict__ data,
                     const int* __restrict__ off, const int* __restrict__ w,
                     const int* __restrict__ h,
                     const int* __restrict__ filt,
                     const int* __restrict__ inv,
                     const long long* __restrict__ tid,
                     const float* __restrict__ uv, long long n_tex,
                     long long n, long long k, long long s_r, long long s_k,
                     long long s_c, float4* __restrict__ out) {
    const long long i = static_cast<long long>(blockIdx.x) * FETCH_THREADS
                        + threadIdx.x;
    if (i >= n) return;
    const long long t = tid[i];
    float4 c = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (t >= n_tex) __trap();
    if (t >= 0) {
        const long long r = i / k;
        const float* p = uv + r * s_r + (i - r * k) * s_k;
        const float pu = __ldg(p), pv = __ldg(p + s_c);
        const long long base = __ldg(off + t);
        const long long W = __ldg(w + t), H = __ldg(h + t);
        const float s = pu - floorf(pu);
        const float tt = pv - floorf(pv);
        const float wf = static_cast<float>(W), hf = static_cast<float>(H);
        if (__ldg(filt + t) == FILTER_BILINEAR) {
            const float u = s * wf - 0.5f;
            const float v = tt * hf - 0.5f;
            const long long x0 = min(max(static_cast<long long>(floorf(u)),
                                         0LL), max(W - 2, 0LL));
            const long long y0 = min(max(static_cast<long long>(floorf(v)),
                                         0LL), max(H - 2, 0LL));
            const float ur = u - static_cast<float>(x0);
            const float vr = v - static_cast<float>(y0);
            const long long x1 = min(x0 + 1, W - 1);
            const long long y1 = min(y0 + 1, H - 1);
            const float4 t00 = __ldg(data + (base + y0 * W + x0));
            const float4 t10 = __ldg(data + (base + y0 * W + x1));
            const float4 t01 = __ldg(data + (base + y1 * W + x0));
            const float4 t11 = __ldg(data + (base + y1 * W + x1));
            c = blend(blend(t00, t10, 1.0f - ur, ur),
                      blend(t01, t11, 1.0f - ur, ur), 1.0f - vr, vr);
        } else {
            const long long xn = min(max(static_cast<long long>(
                static_cast<int>(s * wf)), 0LL), W - 1);
            const long long yn = min(max(static_cast<long long>(
                static_cast<int>(tt * hf)), 0LL), H - 1);
            c = __ldg(data + (base + yn * W + xn));
        }
        if (__ldg(inv + t) != 0)
            c = make_float4(1.0f - c.x, 1.0f - c.y, 1.0f - c.z, 1.0f - c.w);
    }
    out[i] = c;
}

// n_tex textures; n slots, k slots a row of uv: slot i reads
// uv[(i / k) * s_r + (i % k) * s_k] and the element s_c after it (strides
// in floats).
extern "C" int yrt_texture_fetch(const void* data, const void* off,
                                 const void* w, const void* h,
                                 const void* filt, const void* inv,
                                 const void* tid, const void* uv,
                                 long long n_tex, long long n, long long k,
                                 long long s_r, long long s_k, long long s_c,
                                 void* out,
                                 void* stream) {
    if (n > 0) {
        texture_fetch_kernel<<<(n + FETCH_THREADS - 1) / FETCH_THREADS,
                               FETCH_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(data), static_cast<const int*>(off),
            static_cast<const int*>(w), static_cast<const int*>(h),
            static_cast<const int*>(filt), static_cast<const int*>(inv),
            static_cast<const long long*>(tid),
            static_cast<const float*>(uv), n_tex, n, k, s_r, s_k, s_c,
            static_cast<float4*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
