// The counter-based RNG's draws (core/rng.py uniform1/2/3 and hash_u32):
// the lowbias32 key of (seed, pixel, sample, dim) and its uniform floats,
// one thread a lane.
//
// Replaces no TPU kernel: the reference's RNG
// (yulio_raytracer_tpu/core/rng.py) is jnp uint32 arithmetic with no
// pallas_call, left to XLA to fuse.  Run op by op in torch it carried u32
// in int64 tensors (torch on the CPU has no right shift for uint32) and
// split every 32x32-bit product into 16-bit halves: ~50-100 launches a
// draw, every intermediate a full-width int64 tensor, up to 6.7 KB of
// device traffic a lane for a group of six lights.  So this kernel was
// added to do the same function in one pass.
//
// Inputs: the key's four streams (seed, pixel, sample, dim), each either
// a lane tensor (int64, read as its low 32 bits, as core/rng.py _u32 masks
// it) or a host value, and k host terms passed as kernel arguments: for
// each dim of the call, the XOR of the host streams' products (a null
// pointer is a stream folded in there).  A call of k dims is k draws a
// lane.
//
// What bounds it on the H100: bytes.  A lane reads its streams once (8 B
// each) and writes 4n B a dim (8 B for the key itself); the mixing is a
// few dozen integer operations a value.
//
// Design: one thread a lane; the lane's part of the key is made once in
// native uint32 registers, then the loop over the call's dims mixes it
// with each dim's term and stores that dim's row (k, R, n): coalesced
// across a warp, a float2 a lane for n = 2.
//
// Exactness: u32 arithmetic is exact, and the float is made as
// _to_unit_float makes it: a round-to-nearest conversion, then an exact
// scale by 2^-32 (built with --fmad=false, as every kernel here).  So the
// results are bit-equal to the int64 torch version, 0xFFFFFFFF giving 1.0.
#include <cuda_runtime.h>
#include <stdint.h>

#define RNG_THREADS 256
// terms a launch takes as its arguments; a call of more dims launches
// once for each MAX_TERMS of them
#define MAX_TERMS 64

struct Terms {
    uint32_t t[MAX_TERMS];
};

// lowbias32 finalizer (core/rng.py _mix)
__device__ __forceinline__ uint32_t mix(uint32_t h) {
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    h *= 0x846CA68Bu;
    h ^= h >> 16;
    return h;
}

// u32 -> float32 in [0, 1] (core/rng.py _to_unit_float)
__device__ __forceinline__ float unit(uint32_t u) {
    return __fmul_rn(__uint2float_rn(u), 2.3283064365386963e-10f);
}

// N = 0: the key itself as int64 (hash_u32); N = 1, 2, 3: uniform1/2/3
template <int N>
__global__ void __launch_bounds__(RNG_THREADS)
rng_uniform_kernel(const long long* __restrict__ a,
                   const long long* __restrict__ b,
                   const long long* __restrict__ c,
                   const long long* __restrict__ d, long long r,
                   Terms terms, int k, void* __restrict__ out) {
    const long long i = blockIdx.x * static_cast<long long>(RNG_THREADS)
                        + threadIdx.x;
    if (i >= r) return;
    // the lane's streams (core/rng.py _key's multipliers)
    uint32_t h = 0;
    if (a) h ^= static_cast<uint32_t>(a[i]) * 0x9E3779B1u;
    if (b) h ^= static_cast<uint32_t>(b[i]) * 0x85EBCA77u;
    if (c) h ^= static_cast<uint32_t>(c[i]) * 0xC2B2AE3Du;
    if (d) h ^= static_cast<uint32_t>(d[i]) * 0x27D4EB2Fu;
    for (int j = 0; j < k; ++j) {
        const uint32_t key = mix(h ^ terms.t[j]);
        const long long row = j * r + i;
        if (N == 0) {
            static_cast<long long*>(out)[row] = key;
        } else if (N == 1) {
            static_cast<float*>(out)[row] = unit(key);
        } else if (N == 2) {
            static_cast<float2*>(out)[row] = make_float2(
                unit(mix(key ^ 0x632BE59Bu)), unit(mix(key ^ 0x85EBCA6Bu)));
        } else {
            float* o = static_cast<float*>(out) + 3 * row;
            o[0] = unit(mix(key ^ 0x632BE59Bu));
            o[1] = unit(mix(key ^ 0x85EBCA6Bu));
            o[2] = unit(mix(key ^ 0xC2B2AE35u));
        }
    }
}

// a, b, c, d: the key's four streams, (r,) int64 or null; terms: k host
// values (the low 32 bits of each are read); n: 0 for the key, else the
// floats a draw; out: (k, r) int64 for n = 0, else (k, r, n) f32,
// contiguous.
extern "C" int yrt_rng_uniform(const void* a, const void* b, const void* c,
                               const void* d, long long r,
                               const long long* terms,
                               long long k, long long n, void* out,
                               void* stream) {
    const long long bytes = n == 0 ? 8 : 4 * n;
    const unsigned blocks = static_cast<unsigned>(
        (r + RNG_THREADS - 1) / RNG_THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long* pa = static_cast<const long long*>(a);
    const long long* pb = static_cast<const long long*>(b);
    const long long* pc = static_cast<const long long*>(c);
    const long long* pd = static_cast<const long long*>(d);
    for (long long j0 = 0; r > 0 && j0 < k; j0 += MAX_TERMS) {
        Terms t;
        const int kk = static_cast<int>(k - j0 < MAX_TERMS ? k - j0
                                                            : MAX_TERMS);
        for (int j = 0; j < kk; ++j)
            t.t[j] = static_cast<uint32_t>(terms[j0 + j]);
        void* o = static_cast<char*>(out) + j0 * r * bytes;
        switch (n) {
        case 0:
            rng_uniform_kernel<0><<<blocks, RNG_THREADS, 0, s>>>(
                pa, pb, pc, pd, r, t, kk, o);
            break;
        case 1:
            rng_uniform_kernel<1><<<blocks, RNG_THREADS, 0, s>>>(
                pa, pb, pc, pd, r, t, kk, o);
            break;
        case 2:
            rng_uniform_kernel<2><<<blocks, RNG_THREADS, 0, s>>>(
                pa, pb, pc, pd, r, t, kk, o);
            break;
        default:
            rng_uniform_kernel<3><<<blocks, RNG_THREADS, 0, s>>>(
                pa, pb, pc, pd, r, t, kk, o);
            break;
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}
