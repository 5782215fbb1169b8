// Lobe-table BSDFs: the lobes' eval (CompositedBRDF::eval, the light
// samples' brdf) and sample (CompositedBRDF::sample, the scatter's next
// direction) of shading/lobes.py, one thread a hit.
//
// Replaces no TPU kernel: the reference's lobes
// (yulio_raytracer_tpu/shading/lobes.py) are jnp with no pallas_call, left
// to XLA to fuse.  Run op by op in torch they were ~150-200 launches a
// bounce, every intermediate a full (lights, hits, slots) or (hits, slots,
// 3) tensor written to device memory and read back, and every lobe family
// evaluated for every slot before a select: half of the device time of the
// textured and production frames.  So these kernels were added to do the
// same function in one pass each.
//
// A hit's lobe record (shading/materials.py shade_context): up to 4 slots
// of type (int64), color (3), eta, exp, and the conductor's ceta and k
// (3 each), every array read through its strides (the record's exp, ceta
// and ck are views into the material rows).
//
// What bounds it on the H100: bytes.  The eval reads a hit's types,
// colors, eta, exp, ns and wo once and a light's wi, and writes its brdf;
// the sample reads the record, ns, ng, wo, s2, s1 (and tx, ty) once and
// writes wi, pdf, weight, type bits, eta and valid.  The arithmetic is a
// few hundred flops a live slot.
//
// Design: one thread a hit; everything between the reads and the writes
// stays in registers.
// * lobes_eval loops over the call's lights (the leading axis of wi); a
//   slot's term is a switch on its type over the cosine family (the only
//   one whose eval is not zero), the light-independent parts (the
//   layer's outgoing Fresnel, the velvety power) made once a hit.
// * lobes_sample runs each live slot's own family alone (a type no slot
//   holds costs nothing), keeps its luminance/pdf weight, picks a slot by
//   the same slot-by-slot cdf, then samples the picked slot once more and
//   writes it.  A picked slot that is not live (every slot dead, or the cdf
//   short of s1 by rounding) is sampled as the torch version's selects
//   leave it: a NONE slot falls through to the microfacet dielectric.
//
// Exactness: built with --fmad=false, and every operation is the torch
// version's (shading/lobes.py _eval_lobes, _sample_lobes and the helpers
// they call) in its order, with torch's CUDA semantics: clamp, minimum and
// maximum pass NaN through; `x ** 2` is x * x; powf, sinf, cosf, sqrtf and
// IEEE division as torch's kernels call them; `1 / x` as torch's reciprocal.
// Three things follow torch's CUDA kernels rather than the Python text:
// torch.sum over an innermost axis of 3 (tsum3) and of 4 (tsum4) adds in
// its reduce kernel's order, a sum over the slot axis of (.., 4, 3) adds
// in order, and torch.linalg.cross's kernel, built with contraction,
// computes a*b - c*d as one fused multiply-add (cross_term).  So the
// results are bit-equal to the torch version run on the card.
#include <cuda_runtime.h>

#define LOBES_THREADS 128
#define MAX_SLOTS 4
#define EVAL_INPUTS 7
#define SAMPLE_INPUTS 13

enum LobeType {
    NONE = 0, LAMBERTIAN = 1, MINNAERT = 2, VELVETY = 3,
    DIELECTRIC_LAYER_LAMB = 4, SPECULAR_REFLECT = 5, DIELECTRIC_REFLECT = 6,
    CONDUCTOR = 7, DIELECTRIC_TRANSMIT = 8, THIN_DIELECTRIC_TRANSMIT = 9,
    CONST_TRANSMIT = 10, TRANSMISSION = 11, MICROFACET_DIELECTRIC = 12,
    MICROFACET_CONDUCTOR = 13, SPECULAR_PHONG = 14,
    MICROFACET_CONDUCTOR_ANISO = 15, NUM_LOBE_TYPES = 16
};

// the constants as torch multiplies by them: Python's doubles, rounded
// once to float
static constexpr double PI_D = 3.14159265358979323846;
static constexpr float ONE_OVER_PI = static_cast<float>(1.0 / PI_D);
static constexpr float TWO_PI = static_cast<float>(2.0 * PI_D);
static constexpr float ONE_OVER_TWO_PI =
    static_cast<float>(1.0 / (2.0 * PI_D));
static constexpr float EPS6 = static_cast<float>(1e-6);
static constexpr float EPS12 = static_cast<float>(1e-12);
static constexpr float EPS20 = static_cast<float>(1e-20);
static constexpr float EPS30 = static_cast<float>(1e-30);

// BRDF type bits of a lobe type (brdf.h)
__device__ __forceinline__ long long type_bits(int t) {
    switch (t) {
    case LAMBERTIAN: case MINNAERT: case VELVETY: case DIELECTRIC_LAYER_LAMB:
        return 0x00000001LL;
    case SPECULAR_REFLECT: case DIELECTRIC_REFLECT: case CONDUCTOR:
        return 0x00000100LL;
    case DIELECTRIC_TRANSMIT: case THIN_DIELECTRIC_TRANSMIT:
    case CONST_TRANSMIT: case TRANSMISSION:
        return 0x01000000LL;
    case MICROFACET_DIELECTRIC: case MICROFACET_CONDUCTOR:
    case SPECULAR_PHONG: case MICROFACET_CONDUCTOR_ANISO:
        return 0x00000010LL;
    default:
        return 0;
    }
}

// torch.clamp(x, min=lo), clamp(x, max=hi), clamp(x, 0, 1), minimum
__device__ __forceinline__ float cmax(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float cmin(float x, float hi) {
    return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp01(float x) {
    return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float tminimum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// torch.sum over an innermost axis of 3: the reduce kernel gives the axis
// two threads, one summing elements 0 and 2, the other element 1, then
// adds the two
__device__ __forceinline__ float tsum3(float a, float b, float c) {
    return (a + c) + b;
}
// ... of 4: the same two threads, one summing elements 0 and 2, the other
// 1 and 3
__device__ __forceinline__ float tsum4(float a, float b, float c, float d) {
    return (a + c) + (b + d);
}
// a * b - c * d as torch.linalg.cross's kernel computes it
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fmaf_rn(a, b, -(c * d));
}

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
    return tsum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
            cross_term(a.x, b.y, a.y, b.x)};
}
// v reflected about n: 2 cos_i n - v (core/math.py reflect)
__device__ __forceinline__ V3 reflect(V3 v, V3 n, float cos_i) {
    const float c = 2.0f * cos_i;
    return {c * n.x - v.x, c * n.y - v.y, c * n.z - v.z};
}
// l in the frame (dx, dy, n): l.x dx + l.y dy + l.z n
__device__ __forceinline__ V3 to_world(V3 l, V3 dx, V3 dy, V3 n) {
    return {(l.x * dx.x + l.y * dy.x) + l.z * n.x,
            (l.x * dx.y + l.y * dy.y) + l.z * n.y,
            (l.x * dx.z + l.y * dy.z) + l.z * n.z};
}

// core/math.py frame: the helper axis is n's smallest |component| (the
// first on ties, as argmin), dx = normalize(cross(helper, n)),
// dy = cross(n, dx)
__device__ __forceinline__ void frame(V3 n, V3& dx, V3& dy) {
    const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
    const int s = ay < ax ? (az < ay ? 2 : 1) : (az < ax ? 2 : 0);
    const V3 h = {s == 0 ? 1.0f : 0.0f, s == 1 ? 1.0f : 0.0f,
                  s == 2 ? 1.0f : 0.0f};
    const V3 c = cross(h, n);
    const float len = cmax(sqrtf(cmax(dot(c, c), 0.0f)), EPS20);
    dx = {c.x / len, c.y / len, c.z / len};
    dy = cross(n, dx);
}

struct Fresnel {
    float f, cost;
};

// optics.h:114-121 (lobes.py _fresnel_dielectric): F = 1 on total
// internal reflection
__device__ __forceinline__ Fresnel fresnel_dielectric(float cosi,
                                                      float eta) {
    const float k = 1.0f - (eta * eta) * (1.0f - cosi * cosi);
    const bool tir = k < 0.0f;
    const float cost = sqrtf(cmax(k, 0.0f));
    const float rper = (eta * cosi - cost) / cmax(eta * cosi + cost, EPS20);
    const float rpar = (cosi - eta * cost) / cmax(cosi + eta * cost, EPS20);
    const float f = 0.5f * (rpar * rpar + rper * rper);
    return {tir ? 1.0f : f, tir ? 0.0f : cost};
}

// optics.h:123-131, one channel
__device__ __forceinline__ float fresnel_conductor(float c, float eta,
                                                   float k) {
    const float tmp = eta * eta + k * k;
    const float e2 = 2.0f * eta;
    const float rpar = ((tmp * c) * c - e2 * c + 1.0f)
                       / cmax((tmp * c) * c + e2 * c + 1.0f, EPS20);
    const float rper = (tmp - e2 * c + c * c)
                       / cmax(tmp + e2 * c + c * c, EPS20);
    return 0.5f * (rpar + rper);
}

// one input array: element (i, j, k) at p + i*s0 + j*s1 + k*s2 (elements)
struct Ref {
    const void* p;
    long long s0, s1, s2;

    __device__ __forceinline__ float f(long long i, long long j = 0,
                                       long long k = 0) const {
        return __ldg(static_cast<const float*>(p) + (i * s0 + j * s1
                                                     + k * s2));
    }
    __device__ __forceinline__ long long l(long long i, long long j) const {
        return __ldg(static_cast<const long long*>(p) + (i * s0 + j * s1));
    }
    // row i of an (n, 3) array, or (l, i) of an (m, n, 3) one
    __device__ __forceinline__ V3 v(long long i) const {
        return {f(i, 0), f(i, 1), f(i, 2)};
    }
    __device__ __forceinline__ V3 v(long long l, long long i) const {
        return {f(l, i, 0), f(l, i, 1), f(l, i, 2)};
    }
    // slot k of hit i of an (n, L, 3) array
    __device__ __forceinline__ V3 slot3(long long i, int k) const {
        return {f(i, k, 0), f(i, k, 1), f(i, k, 2)};
    }
};

__device__ __forceinline__ int lobe_type(const Ref& t, long long r, int k) {
    const long long x = t.l(r, k);
    // ids are checked where the material table is built
    // (materials.build_table); one past the table reads as NONE, a dead
    // slot, and does not stop the kernel
    return x < 0 || x >= NUM_LOBE_TYPES ? 0 : static_cast<int>(x);
}

// inputs: type, color, eta, exp, ns, wo, wi (nl, n, 3)
struct EvalArgs {
    Ref in[EVAL_INPUTS];
    float* out;
    long long n, nl, mask;
    int slots;
};

__global__ void __launch_bounds__(LOBES_THREADS)
lobes_eval_kernel(const EvalArgs a) {
    const long long r = static_cast<long long>(blockIdx.x) * LOBES_THREADS
                        + threadIdx.x;
    if (r >= a.n) return;
    const Ref &T = a.in[0], &C = a.in[1], &E = a.in[2], &X = a.in[3];
    const V3 ns = a.in[4].v(r), wo = a.in[5].v(r);
    const float cos_o = dot(wo, ns);
    // a slot's type (NONE where its term is zero: no cosine-family type,
    // or one the mask leaves out), color, eta, exp, and what of its term
    // no light changes: the layer's outgoing Fresnel, the velvety power
    int type[MAX_SLOTS];
    V3 color[MAX_SLOTS];
    float eta[MAX_SLOTS], ex[MAX_SLOTS], pre[MAX_SLOTS];
#pragma unroll
    for (int k = 0; k < MAX_SLOTS; ++k) {
        type[k] = NONE;
        if (k >= a.slots) continue;
        const int t = lobe_type(T, r, k);
        if (t < LAMBERTIAN || t > DIELECTRIC_LAYER_LAMB
            || !(type_bits(t) & a.mask))
            continue;
        type[k] = t;
        color[k] = C.slot3(r, k);
        eta[k] = E.f(r, k);
        ex[k] = X.f(r, k);
        if (t == VELVETY) {
            const float cc = clamp01(cos_o);
            const float sin_o = sqrtf(cmax(1.0f - cc * cc, 0.0f));
            pre[k] = powf(cmax(sin_o, EPS20), ex[k]);
        } else if (t == DIELECTRIC_LAYER_LAMB) {
            pre[k] = fresnel_dielectric(clamp01(cos_o), eta[k]).f;
        }
    }
    for (long long l = 0; l < a.nl; ++l) {
        const V3 wi = a.in[6].v(l, r);
        const float cos_i = dot(wi, ns);
        const float f_lam = ONE_OVER_PI * clamp01(cos_i);
        // the sum over the slots, in order (a zero term adds nothing)
        float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
        for (int k = 0; k < MAX_SLOTS; ++k) {
            float f;
            switch (type[k]) {
            case LAMBERTIAN:
                f = f_lam;
                break;
            case MINNAERT:
                f = f_lam * powf(cmax(clamp01(dot(wo, wi)), EPS20), ex[k]);
                break;
            case VELVETY:
                f = f_lam * pre[k];
                break;
            case DIELECTRIC_LAYER_LAMB: {
                const Fresnel fi = fresnel_dielectric(clamp01(cos_i), eta[k]);
                f = (((1.0f - pre[k]) * (1.0f - fi.f)) * ONE_OVER_PI)
                    * fi.cost;
                f = cos_i > 0.0f && cos_o > 0.0f ? f : 0.0f;
                break;
            }
            default:
                continue;
            }
            ox = ox + color[k].x * f;
            oy = oy + color[k].y * f;
            oz = oz + color[k].z * f;
        }
        float* o = a.out + (l * a.n + r) * 3;
        o[0] = ox;
        o[1] = oy;
        o[2] = oz;
    }
}

// inputs: type, color, eta, exp, ceta, ck, ns, ng, wo, s2, s1, tx, ty (tx,
// ty null: the frame around ns)
struct SampleArgs {
    Ref in[SAMPLE_INPUTS];
    float *wi, *pdf, *weight;
    long long* bits;
    float* eta;
    bool* valid;
    long long n, mask;
    int slots;
};

// what every slot of a hit shares
struct Hit {
    V3 ns, ng, wo, tx, ty, fx, fy;   // fx, fy: the frame around ns
    float u, v, cos_o, cos_o_c, cphi, sphi;
    V3 wi_cos;                       // the cosine hemisphere sample
    float pdf_cos;
};

struct Sample {
    V3 wi, c;
    float pdf;
};

// shapesampler.h:119-136 around the frame (dx, dy, n): (direction, pdf)
__device__ __forceinline__ Sample power_cosine(const Hit& h, float e, V3 dx,
                                               V3 dy, V3 n) {
    const float cos_t = powf(cmax(h.v, EPS30), 1.0f / (e + 1.0f));
    const float sin_t = sqrtf(cmax(1.0f - cos_t * cos_t, 0.0f));
    const V3 local = {h.cphi * sin_t, h.sphi * sin_t, cos_t};
    return {to_world(local, dx, dy, n), {},
            ((e + 1.0f) * powf(cos_t, e)) * ONE_OVER_TWO_PI};
}

// the microfacet (and glossy) families' shadowing term
__device__ __forceinline__ float shadowing(float cos_h, float cos_o_c,
                                           float cos_i, float cos_oh) {
    const float d = cmax(cos_oh, EPS12);
    return cmin(tminimum(((2.0f * cos_h) * cos_o_c) / d,
                         ((2.0f * cos_h) * clamp01(cos_i)) / d), 1.0f);
}

// slot k of hit r: (wi, pdf, color weight) as its own family samples it
__device__ __forceinline__ Sample sample_slot(const SampleArgs& a,
                                              const Hit& h, long long r,
                                              int k, int t) {
    const V3 color = a.in[1].slot3(r, k);
    const float eta = a.in[2].f(r, k), ex = a.in[3].f(r, k);
    Sample s;
    switch (t) {
    case LAMBERTIAN: case MINNAERT: case VELVETY:
    case DIELECTRIC_LAYER_LAMB: {
        // the cosine hemisphere around ns; the weight is eval()
        const float cos_i1 = dot(h.wi_cos, h.ns);
        const float f_lam = ONE_OVER_PI * clamp01(cos_i1);
        float w = f_lam;
        s.wi = h.wi_cos;
        if (t == MINNAERT) {
            w = f_lam * powf(cmax(clamp01(dot(h.wo, h.wi_cos)), EPS20), ex);
        } else if (t == VELVETY) {
            const float sin_o = sqrtf(cmax(1.0f - h.cos_o_c * h.cos_o_c,
                                           0.0f));
            w = f_lam * powf(cmax(sin_o, EPS20), ex);
        } else if (t == DIELECTRIC_LAYER_LAMB) {
            // the ground's sample inside the layer, refracted out
            // (dielectriclayer.h:49-70)
            const float fo = fresnel_dielectric(h.cos_o_c, eta).f;
            const float etati = 1.0f / cmax(eta, EPS6);
            const float c = clamp01(cos_i1);
            const float kk = 1.0f - (etati * etati) * (1.0f - c * c);
            const bool ok = kk >= 0.0f;
            const float cos_t = sqrtf(cmax(kk, 0.0f));
            const V3 n = {-h.ns.x, -h.ns.y, -h.ns.z};
            s.wi = ok ? V3{etati * (c * n.x - h.wi_cos.x) - cos_t * n.x,
                           etati * (c * n.y - h.wi_cos.y) - cos_t * n.y,
                           etati * (c * n.z - h.wi_cos.z) - cos_t * n.z}
                      : V3{0.0f, 0.0f, 0.0f};
            const float fi = fresnel_dielectric(clamp01(cos_t), eta).f;
            w = (((1.0f - fo) * (1.0f - fi)) * ONE_OVER_PI) * c;
            w = ok && h.cos_o > 0.0f ? w : 0.0f;
        }
        s.pdf = h.pdf_cos;
        s.c = {color.x * w, color.y * w, color.z * w};
        break;
    }
    case SPECULAR_REFLECT: case DIELECTRIC_REFLECT: case CONDUCTOR: {
        s.wi = reflect(h.wo, h.ns, h.cos_o_c);
        s.pdf = 1.0f;
        if (t == CONDUCTOR) {
            const V3 ce = a.in[4].slot3(r, k), ck = a.in[5].slot3(r, k);
            s.c = {color.x * fresnel_conductor(h.cos_o_c, ce.x, ck.x),
                   color.y * fresnel_conductor(h.cos_o_c, ce.y, ck.y),
                   color.z * fresnel_conductor(h.cos_o_c, ce.z, ck.z)};
        } else {
            const float w = t == DIELECTRIC_REFLECT
                            ? fresnel_dielectric(h.cos_o_c, eta).f : 1.0f;
            s.c = {color.x * w, color.y * w, color.z * w};
        }
        break;
    }
    case THIN_DIELECTRIC_TRANSMIT: case CONST_TRANSMIT: case TRANSMISSION: {
        s.wi = {-h.wo.x, -h.wo.y, -h.wo.z};
        s.pdf = 1.0f;
        if (t == THIN_DIELECTRIC_TRANSMIT) {
            // exp(logT thickness/cosO) (1 - F); color holds T
            // (dielectric.h:128-138)
            float w = 1.0f - fresnel_dielectric(h.cos_o_c, eta).f;
            w = h.cos_o <= 0.0f ? 0.0f : w;
            const float alpha = ex / cmax(h.cos_o_c, EPS6);
            s.c = {powf(cmax(color.x, EPS12), alpha) * w,
                   powf(cmax(color.y, EPS12), alpha) * w,
                   powf(cmax(color.z, EPS12), alpha) * w};
        } else {
            s.c = {color.x * 1.0f, color.y * 1.0f, color.z * 1.0f};
        }
        break;
    }
    case DIELECTRIC_TRANSMIT: {
        // dielectric.h:82-89
        const float c = h.cos_o_c;
        const float kk = 1.0f - (eta * eta) * (1.0f - c * c);
        const bool ok = kk >= 0.0f;
        const float cos_t = sqrtf(cmax(kk, 0.0f));
        s.wi = ok ? V3{eta * (c * h.ns.x - h.wo.x) - cos_t * h.ns.x,
                       eta * (c * h.ns.y - h.wo.y) - cos_t * h.ns.y,
                       eta * (c * h.ns.z - h.wo.z) - cos_t * h.ns.z}
                  : V3{0.0f, 0.0f, 0.0f};
        const float w = ok ? 1.0f - fresnel_dielectric(c, eta).f : 0.0f;
        s.pdf = ok ? eta * eta : 0.0f;
        s.c = {color.x * w, color.y * w, color.z * w};
        break;
    }
    case SPECULAR_PHONG: {
        // specular.h: a power cosine around the reflected direction
        const V3 rdir = reflect(h.wo, h.ns, h.cos_o);
        V3 rx, ry;
        frame(rdir, rx, ry);
        const Sample p = power_cosine(h, ex, rx, ry, rdir);
        const float cos_ri = dot(rdir, p.wi);
        float w = (((ex + 2.0f) * ONE_OVER_TWO_PI)
                   * powf(cmax(cos_ri, EPS20), ex))
                  * clamp01(dot(p.wi, h.ns));
        w = cos_ri >= 0.0f ? w : 0.0f;
        s.wi = p.wi;
        s.pdf = p.pdf;
        s.c = {color.x * w, color.y * w, color.z * w};
        break;
    }
    case MICROFACET_CONDUCTOR_ANISO: {
        // anisotropic_power_cosine_distribution.h:56-73 on (tx, ty, ns);
        // exp = nx, the eta field = ny
        const float nx = ex, ny = eta;
        const float sin0 = sqrtf(cmax(nx + 1.0f, 0.0f)) * h.sphi;
        const float cos0 = sqrtf(cmax(ny + 1.0f, 0.0f)) * h.cphi;
        const float inv_n0 = 1.0f / sqrtf(cmax(sin0 * sin0 + cos0 * cos0,
                                               EPS20));
        const float sin_p = sin0 * inv_n0, cos_p = cos0 * inv_n0;
        const float n_eff = nx * (cos_p * cos_p) + ny * (sin_p * sin_p);
        const float cos_ta = powf(cmax(h.v, EPS30), 1.0f / (n_eff + 1.0f));
        const float sin_ta = sqrtf(cmax(1.0f - cos_ta * cos_ta, 0.0f));
        const float norm1 = sqrtf(cmax((nx + 1.0f) * (ny + 1.0f), 0.0f))
                            * ONE_OVER_TWO_PI;
        const float norm2 = sqrtf(cmax((nx + 2.0f) * (ny + 2.0f), 0.0f))
                            * ONE_OVER_TWO_PI;
        const float pdf_h = norm1 * powf(cos_ta, n_eff);
        const float a1 = cos_p * sin_ta, a2 = sin_p * sin_ta;
        const V3 wh = {(a1 * h.tx.x + a2 * h.ty.x) + cos_ta * h.ns.x,
                       (a1 * h.tx.y + a2 * h.ty.y) + cos_ta * h.ns.y,
                       (a1 * h.tx.z + a2 * h.ty.z) + cos_ta * h.ns.z};
        const float cos_oh = dot(h.wo, wh);
        s.wi = reflect(h.wo, wh, cos_oh);
        s.pdf = pdf_h / cmax(4.0f * fabsf(cos_oh), EPS12);
        const float cos_i = dot(s.wi, h.ns);
        const float d = norm2 * powf(cmax(cos_ta, EPS20), n_eff);
        const float g = shadowing(cos_ta, h.cos_o_c, cos_i, cos_oh);
        const float dg = (d * g) / cmax(4.0f * h.cos_o_c, EPS12);
        const bool ok = cos_i > 0.0f && h.cos_o > 0.0f
                        && dot(s.wi, h.ng) > 0.0f;
        const V3 ce = a.in[4].slot3(r, k), ck = a.in[5].slot3(r, k);
        const float c_oh = clamp01(cos_oh);
        const V3 w = ok ? V3{fresnel_conductor(c_oh, ce.x, ck.x) * dg,
                             fresnel_conductor(c_oh, ce.y, ck.y) * dg,
                             fresnel_conductor(c_oh, ce.z, ck.z) * dg}
                        : V3{0.0f, 0.0f, 0.0f};
        s.c = {color.x * w.x, color.y * w.y, color.z * w.z};
        break;
    }
    default: {
        // MICROFACET_DIELECTRIC, MICROFACET_CONDUCTOR, and NONE, which the
        // torch version's selects leave in the microfacet dielectric
        // (microfacet.h:43-67): wh ~ power cosine around ns, wi = reflect(wo,
        // wh), pdf = pdf_h / (4 |dot(wo, wh)|)
        const Sample p = power_cosine(h, ex, h.fx, h.fy, h.ns);
        const V3 wh = p.wi;
        const float cos_oh = dot(h.wo, wh);
        s.wi = reflect(h.wo, wh, cos_oh);
        s.pdf = p.pdf / cmax(4.0f * fabsf(cos_oh), EPS12);
        const float cos_i = dot(s.wi, h.ns);
        const float cos_h = dot(wh, h.ns);
        const float d = ((ex + 2.0f) * ONE_OVER_TWO_PI)
                        * powf(cmax(fabsf(cos_h), EPS20), ex);
        const float g = shadowing(cos_h, h.cos_o_c, cos_i, cos_oh);
        const float dg = (d * g) / cmax(4.0f * h.cos_o_c, EPS12);
        const float c_oh = clamp01(cos_oh);
        V3 w;
        if (t == MICROFACET_CONDUCTOR) {
            const V3 ce = a.in[4].slot3(r, k), ck = a.in[5].slot3(r, k);
            w = {fresnel_conductor(c_oh, ce.x, ck.x) * dg,
                 fresnel_conductor(c_oh, ce.y, ck.y) * dg,
                 fresnel_conductor(c_oh, ce.z, ck.z) * dg};
            // MetallicPaint's flakes under the paint's dielectric layer
            // (metallicpaint.h:37-40): eta != 1 takes (1 - Fo)(1 - Fi)
            if (fabsf(eta - 1.0f) > EPS6) {
                const float fo = fresnel_dielectric(h.cos_o_c, eta).f;
                const float fi = fresnel_dielectric(clamp01(cos_i), eta).f;
                const float layer = (1.0f - fo) * (1.0f - fi);
                w = {w.x * layer, w.y * layer, w.z * layer};
            }
        } else {
            const float fr = fresnel_dielectric(c_oh, eta).f * dg;
            w = {fr, fr, fr};
        }
        const bool ok = cos_i > 0.0f && h.cos_o > 0.0f
                        && dot(s.wi, h.ng) > 0.0f;
        if (!ok) w = {0.0f, 0.0f, 0.0f};
        s.c = {color.x * w.x, color.y * w.y, color.z * w.z};
        break;
    }
    }
    return s;
}

__device__ __forceinline__ float pick4(float a, float b, float c, float d,
                                       int k) {
    return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

__global__ void __launch_bounds__(LOBES_THREADS)
lobes_sample_kernel(const SampleArgs a) {
    const long long r = static_cast<long long>(blockIdx.x) * LOBES_THREADS
                        + threadIdx.x;
    if (r >= a.n) return;
    Hit h;
    h.ns = a.in[6].v(r);
    h.ng = a.in[7].v(r);
    h.wo = a.in[8].v(r);
    h.u = a.in[9].f(r, 0);
    h.v = a.in[9].f(r, 1);
    const float s1 = a.in[10].f(r);
    h.cos_o = dot(h.wo, h.ns);
    h.cos_o_c = clamp01(h.cos_o);
    const float phi = TWO_PI * h.u;
    h.cphi = cosf(phi);
    h.sphi = sinf(phi);
    frame(h.ns, h.fx, h.fy);
    if (a.in[11].p != nullptr && a.in[12].p != nullptr) {
        h.tx = a.in[11].v(r);
        h.ty = a.in[12].v(r);
    } else {
        h.tx = h.fx;
        h.ty = h.fy;
    }
    {
        // shapesampler.h cosine_sample_hemisphere around ns
        const float cos_t = sqrtf(cmax(h.v, 0.0f));
        const float sin_t = sqrtf(cmax(1.0f - h.v, 0.0f));
        const V3 local = {h.cphi * sin_t, h.sphi * sin_t, cos_t};
        h.wi_cos = to_world(local, h.fx, h.fy, h.ns);
        h.pdf_cos = cos_t * ONE_OVER_PI;
    }
    const Ref& T = a.in[0];
    const int n = a.slots;
    // each live slot's luminance over pdf (0 for a slot that is not good),
    // and whether it is good
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
    int good = 0;
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
        const int t = lobe_type(T, r, k);
        if (t == NONE || !(type_bits(t) & a.mask)) continue;
        const Sample s = sample_slot(a, h, r, k, t);
        const float lum = tsum3(s.c.x, s.c.y, s.c.z);
        if (!(lum > 0.0f && s.pdf > 0.0f)) continue;
        const float w = lum / cmax(s.pdf, EPS20);
        good |= 1 << k;
        w0 = k == 0 ? w : w0;
        w1 = k == 1 ? w : w1;
        w2 = k == 2 ? w : w2;
        w3 = k == 3 ? w : w3;
    }
    // the luminance/pdf-weighted pick (compositedbrdf.h:138-174): the sum
    // over the slots as torch's reduce kernel adds them, then pick =
    // #{k : cdf_k < s1}, the cdf summed slot by slot
    const float total = n == 4 ? tsum4(w0, w1, w2, w3)
                        : n == 3 ? tsum3(w0, w1, w2)
                        : n == 2 ? w0 + w1 : w0;
    const float den = cmax(total, EPS30);
    const float p0 = w0 / den, p1 = w1 / den, p2 = w2 / den, p3 = w3 / den;
    float cdf = p0;
    int pick = cdf < s1;
    if (n > 1) { cdf = cdf + p1; pick += cdf < s1; }
    if (n > 2) { cdf = cdf + p2; pick += cdf < s1; }
    if (n > 3) { cdf = cdf + p3; pick += cdf < s1; }
    pick = min(pick, n - 1);
    const int t = lobe_type(T, r, pick);
    const Sample s = sample_slot(a, h, r, pick, t);
    const float sel_prob = pick4(p0, p1, p2, p3, pick);
    const float eta = a.in[2].f(r, pick);
    a.wi[r * 3] = s.wi.x;
    a.wi[r * 3 + 1] = s.wi.y;
    a.wi[r * 3 + 2] = s.wi.z;
    a.pdf[r] = s.pdf * sel_prob;
    a.weight[r * 3] = s.c.x;
    a.weight[r * 3 + 1] = s.c.y;
    a.weight[r * 3 + 2] = s.c.z;
    a.bits[r] = type_bits(t);
    // the roulette's eta factor: refraction-type lobes report rcp(eta)
    a.eta[r] = t == DIELECTRIC_TRANSMIT || t == THIN_DIELECTRIC_TRANSMIT
               ? 1.0f / cmax(eta, EPS6) : 1.0f;
    a.valid[r] = total > 0.0f && ((good >> pick) & 1);
}

static void fill_refs(Ref* in, const void* const* ptrs,
                      const long long* strides, int count) {
    for (int i = 0; i < count; ++i)
        in[i] = {ptrs[i], strides[3 * i], strides[3 * i + 1],
                 strides[3 * i + 2]};
}

// ptrs: the EVAL_INPUTS inputs (type, color, eta, exp, ns, wo, wi), their
// strides 3 an input in elements (unused ones 0): type, eta, exp (n, slots);
// color (n, slots, 3); ns, wo (n, 3); wi (nl, n, 3).  out: (nl, n, 3)
// contiguous.
extern "C" int yrt_lobes_eval(const void* const* ptrs,
                              const long long* strides, long long n,
                              long long nl, long long slots,
                              long long type_mask, void* out,
                              void* stream) {
    if (n > 0 && nl > 0) {
        EvalArgs a;
        fill_refs(a.in, ptrs, strides, EVAL_INPUTS);
        a.out = static_cast<float*>(out);
        a.n = n;
        a.nl = nl;
        a.mask = type_mask;
        a.slots = static_cast<int>(slots);
        lobes_eval_kernel<<<(n + LOBES_THREADS - 1) / LOBES_THREADS,
                            LOBES_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

// ptrs: the SAMPLE_INPUTS inputs (type, color, eta, exp, ceta, ck, ns, ng,
// wo, s2, s1, tx, ty; tx and ty may be null), strides as for the eval
// (ceta, ck (n, slots, 3); ng (n, 3); s2 (n, 2); s1 (n,)); outs: wi (n, 3),
// pdf (n,), weight (n, 3), type bits (n,) int64, eta (n,), valid (n,) bool,
// contiguous.
extern "C" int yrt_lobes_sample(const void* const* ptrs,
                                const long long* strides, long long n,
                                long long slots, long long type_mask,
                                void* const* outs, void* stream) {
    if (n > 0) {
        SampleArgs a;
        fill_refs(a.in, ptrs, strides, SAMPLE_INPUTS);
        a.wi = static_cast<float*>(outs[0]);
        a.pdf = static_cast<float*>(outs[1]);
        a.weight = static_cast<float*>(outs[2]);
        a.bits = static_cast<long long*>(outs[3]);
        a.eta = static_cast<float*>(outs[4]);
        a.valid = static_cast<bool*>(outs[5]);
        a.n = n;
        a.mask = type_mask;
        a.slots = static_cast<int>(slots);
        lobes_sample_kernel<<<(n + LOBES_THREADS - 1) / LOBES_THREADS,
                              LOBES_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
