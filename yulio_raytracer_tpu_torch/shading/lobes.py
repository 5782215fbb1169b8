"""Lobe-table BSDFs: CompositedBRDF as masked tensor ops.

Counterpart of `yulio_raytracer_tpu/shading/lobes.py`.  A material is up
to MAX_LOBES lobe records (type id + parameters); `sample_lobes` samples
every lobe with the same 2D sample and picks one by a luminance/pdf
weighted discrete distribution, `eval_lobes` sums the diffuse evals.
All 16 lobe types of the reference are here, with its formulas and pdf
conventions.

A lobe record (tensors shaped (..., L) or (..., L, 3)):
  type   int   lobe id (NONE=0 slots are dead lanes)
  color  f32x3 reflectance/transmittance scale
  eta    f32   relative IOR etai/etat
  exp    f32   exponent (microfacet/phong n, minnaert b, velvety falloff,
               thin-dielectric thickness)
  ceta   f32x3 conductor complex IOR (real)
  ck     f32x3 conductor complex IOR (imag)

On CUDA tensors `eval_lobes` and `sample_lobes` launch the kernels of
csrc/lobes.cu, one thread a hit, which run each slot's own family alone
(an absent family costs nothing there); on CPU tensors they run
`_eval_lobes` and `_sample_lobes`, the plain versions, whose arithmetic
the kernels repeat op for op (bit-equal on the card).  In the plain
versions `types_present`, the scene's static set of lobe types
(`lobe_types` of a committed scene), leaves out every family that no
material uses, so a Lambertian scene runs the Lambertian ops alone; None
means every type.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import math as vm
from ..ops import cuda_build as cb
from ..sampling import shapesampler as ss

# lobe ids (the reference's numbering, so lobe tables are shared)
NONE = 0
LAMBERTIAN = 1
MINNAERT = 2
VELVETY = 3
DIELECTRIC_LAYER_LAMB = 4
SPECULAR_REFLECT = 5
DIELECTRIC_REFLECT = 6
CONDUCTOR = 7
DIELECTRIC_TRANSMIT = 8
THIN_DIELECTRIC_TRANSMIT = 9
CONST_TRANSMIT = 10
TRANSMISSION = 11
MICROFACET_DIELECTRIC = 12
MICROFACET_CONDUCTOR = 13
SPECULAR_PHONG = 14
# BrushedMetal: anisotropic power-cosine microfacet conductor; exp = nx,
# the eta field = ny
MICROFACET_CONDUCTOR_ANISO = 15
NUM_LOBE_TYPES = 16

# BRDF type bits (brdf.h)
DIFFUSE_REFLECTION = 0x00000001
GLOSSY_REFLECTION = 0x00000010
SPECULAR_REFLECTION = 0x00000100
DIFFUSE_TRANSMISSION = 0x00010000
GLOSSY_TRANSMISSION = 0x00100000
SPECULAR_TRANSMISSION = 0x01000000
DIFFUSE = 0x000F000F
GLOSSY = 0x00F000F0
SPECULAR = 0x0F000F00
TRANSMISSION_BITS = 0x0FFF0000
ALL = 0xFFFFFFFF

_TYPE_BITS = np.zeros(NUM_LOBE_TYPES, np.int64)
_TYPE_BITS[[LAMBERTIAN, MINNAERT, VELVETY,
            DIELECTRIC_LAYER_LAMB]] = DIFFUSE_REFLECTION
_TYPE_BITS[[SPECULAR_REFLECT, DIELECTRIC_REFLECT,
            CONDUCTOR]] = SPECULAR_REFLECTION
_TYPE_BITS[[DIELECTRIC_TRANSMIT, THIN_DIELECTRIC_TRANSMIT, CONST_TRANSMIT,
            TRANSMISSION]] = SPECULAR_TRANSMISSION
_TYPE_BITS[[MICROFACET_DIELECTRIC, MICROFACET_CONDUCTOR, SPECULAR_PHONG,
            MICROFACET_CONDUCTOR_ANISO]] = GLOSSY_REFLECTION

# the sampling families, each the lobe types it serves
FAM_COS = (LAMBERTIAN, MINNAERT, VELVETY, DIELECTRIC_LAYER_LAMB)
FAM_REFL = (SPECULAR_REFLECT, DIELECTRIC_REFLECT, CONDUCTOR)
FAM_STR = (THIN_DIELECTRIC_TRANSMIT, CONST_TRANSMIT, TRANSMISSION)
FAM_REFR = (DIELECTRIC_TRANSMIT,)
FAM_GL = (MICROFACET_DIELECTRIC, MICROFACET_CONDUCTOR, SPECULAR_PHONG,
          MICROFACET_CONDUCTOR_ANISO)

ONE_OVER_PI = float(1.0 / np.pi)
ONE_OVER_TWO_PI = float(1.0 / (2.0 * np.pi))


def type_bits(lobe_type):
    """BRDF type bitmask (int64 holding u32) of a lobe-type tensor."""
    return torch.as_tensor(_TYPE_BITS, device=lobe_type.device)[lobe_type]


def _cdot(a, b):
    return torch.sum(a * b, dim=-1)


def _clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def _is_any(t, types):
    """t == types[0] | t == types[1] | ..."""
    m = t == types[0]
    for x in types[1:]:
        m = m | (t == x)
    return m


def _select(chain, fallback, vec=False):
    """where(m0, v0, where(m1, v1, ... fallback)) over (mask, value)
    pairs; vec: the values are (..., 3) vectors of the masks' (...)."""
    out = fallback
    for mask, val in reversed(chain):
        out = torch.where(mask[..., None] if vec else mask, val, out)
    return out


def _fresnel_dielectric(cosi, eta):
    """optics.h:114-121: relative eta = etai/etat, cosi >= 0.  Returns
    (F, cost); F = 1 on total internal reflection."""
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    cost = torch.sqrt(torch.clamp(k, min=0.0))
    rper = (eta * cosi - cost) / torch.clamp(eta * cosi + cost, min=1e-20)
    rpar = (cosi - eta * cost) / torch.clamp(cosi + eta * cost, min=1e-20)
    f = 0.5 * (rpar * rpar + rper * rper)
    return torch.where(tir, 1.0, f), torch.where(tir, 0.0, cost)


def _fresnel_conductor(cosi, eta, k):
    """optics.h:123-131: complex-IOR conductor fresnel, per channel."""
    c = cosi[..., None]
    tmp = eta * eta + k * k
    rpar = ((tmp * c * c - 2.0 * eta * c + 1.0)
            / torch.clamp(tmp * c * c + 2.0 * eta * c + 1.0, min=1e-20))
    rper = ((tmp - 2.0 * eta * c + c * c)
            / torch.clamp(tmp + 2.0 * eta * c + c * c, min=1e-20))
    return 0.5 * (rpar + rper)


def _present_fn(types_present):
    def present(*tys):
        return types_present is None or any(x in types_present for x in tys)
    return present


def eval_lobes(lobes, ns, ng, wo, wi, type_mask: int = DIFFUSE,
               types_present=None):
    """Sum of the lobes' evals (CompositedBRDF::eval, compositedbrdf.h:
    74-80); of the lobe set only the cosine family evaluates non-zero.
    lobes: dict of (..., L[, 3]) tensors; ns/ng/wo/wi: (..., 3) ->
    (..., 3); wi may lead with axes of its own (the lights of a call).
    On CUDA tensors the kernel, which takes the pathtracer's shapes: an
    (R, L) record, ns and wo (R, 3), wi (R, 3) or (nl, R, 3)
    (types_present is not needed there); on CPU tensors `_eval_lobes`."""
    if lobes['type'].is_cuda:
        return _eval_kernel(lobes, ns, wo, wi, type_mask)
    return _eval_lobes(lobes, ns, ng, wo, wi, type_mask, types_present)


def _eval_lobes(lobes, ns, ng, wo, wi, type_mask: int = DIFFUSE,
                types_present=None):
    """The plain eval: torch ops over every slot, the families of
    types_present."""
    if lobes['type'].is_cuda:
        _eval_lobes.cuda_calls += 1
    present = _present_fn(types_present)
    t = lobes['type']
    sel = (type_bits(t) & type_mask) != 0
    cos_i = _cdot(wi[..., None, :], ns[..., None, :])
    # LAMBERTIAN (lambertian.h:36-38): R/pi * clamp(dot(wi, Ns))
    f_lam = ONE_OVER_PI * _clamp01(cos_i)
    chain = []
    if present(LAMBERTIAN):
        chain.append((t == LAMBERTIAN, f_lam))
    if present(MINNAERT, VELVETY, DIELECTRIC_LAYER_LAMB):
        cos_o = _cdot(wo[..., None, :], ns[..., None, :])
    if present(MINNAERT):
        # minnaert.h: R/pi clamp(dot(wi,Ns)) clamp(dot(wo,wi))^b
        back = _clamp01(_cdot(wo[..., None, :], wi[..., None, :]))
        chain.append((t == MINNAERT, f_lam * torch.pow(
            torch.clamp(back, min=1e-20), lobes['exp'])))
    if present(VELVETY):
        # velvety.h: R/pi clamp(dot(wi,Ns)) sin(thetaO)^f
        sin_o = torch.sqrt(torch.clamp(1.0 - _clamp01(cos_o) ** 2, min=0.0))
        chain.append((t == VELVETY, f_lam * torch.pow(
            torch.clamp(sin_o, min=1e-20), lobes['exp'])))
    if present(DIELECTRIC_LAYER_LAMB):
        # dielectriclayer.h:36-47: Fo T (R/pi cosThetaI1) T Fi
        eta = lobes['eta']
        fo, _ = _fresnel_dielectric(_clamp01(cos_o), eta)
        fi, cos_i1 = _fresnel_dielectric(_clamp01(cos_i), eta)
        f_layer = (1.0 - fo) * (1.0 - fi) * ONE_OVER_PI * cos_i1
        f_layer = torch.where((cos_i > 0.0) & (cos_o > 0.0), f_layer, 0.0)
        chain.append((t == DIELECTRIC_LAYER_LAMB, f_layer))
    f = _select(chain, 0.0) if chain else torch.zeros_like(cos_i)
    f = torch.where(sel, f, 0.0)
    return torch.sum(lobes['color'] * f[..., None], dim=-2)


def sample_lobes(lobes, ns, ng, wo, s2, s1, type_mask: int = ALL,
                 tx=None, ty=None, types_present=None):
    """CompositedBRDF::sample (compositedbrdf.h:119-181): every lobe is
    sampled with the same 2D sample s2 and one is picked with s1.
    tx/ty: the surface tangent frame (the anisotropic conductor's; None
    builds one around ns).  Returns a dict of (...,)-shaped wi (.., 3),
    pdf, weight (.., 3) (the sampled lobe's color term), type_bits, eta
    (the relative IOR factor for roulette) and valid.  On CUDA tensors
    the kernel, which takes an (R, L) record and (R,)-led per-hit arrays;
    on CPU tensors `_sample_lobes`."""
    if lobes['type'].is_cuda:
        return _sample_kernel(lobes, ns, ng, wo, s2, s1, type_mask, tx, ty)
    return _sample_lobes(lobes, ns, ng, wo, s2, s1, type_mask, tx, ty,
                         types_present)


def _sample_lobes(lobes, ns, ng, wo, s2, s1, type_mask: int = ALL,
                  tx=None, ty=None, types_present=None):
    """The plain sample: torch ops over every slot, each family of
    types_present sampled for every slot, then the selects."""
    if lobes['type'].is_cuda:
        _sample_lobes.cuda_calls += 1
    present = _present_fn(types_present)
    t = lobes['type']                               # (..., L)
    color = lobes['color']                          # (..., L, 3)
    eta, exp = lobes['eta'], lobes['exp']
    n_slots = t.shape[-1]
    vshape = t.shape + (3,)
    nsb = ns[..., None, :]                          # (..., 1, 3)
    u = s2[..., None, 0].expand(t.shape)
    v = s2[..., None, 1].expand(t.shape)
    if present(*FAM_COS[1:], *FAM_REFL, *FAM_STR, *FAM_REFR, *FAM_GL):
        wob = wo[..., None, :]
        cos_o = _cdot(wob, nsb)                     # (..., L)
        cos_o_c = _clamp01(cos_o)

    # (mask, value) chains in the reference's family order; a family no
    # material uses is left out (its lanes are never picked)
    wi_ch, pdf_ch, c_ch = [], [], []
    fam = {}

    # ---- cosine hemisphere around Ns; the Lambertian weight is eval()
    if present(*FAM_COS):
        wi_cos, pdf_cos = ss.cosine_sample_hemisphere(u, v, nsb.expand(vshape))
        f_lam = ONE_OVER_PI * _clamp01(_cdot(wi_cos, nsb))
        w_by_type = []
        if present(LAMBERTIAN):
            w_by_type.append((LAMBERTIAN, f_lam))
        if present(MINNAERT):
            back = _clamp01(_cdot(wob, wi_cos))
            w_by_type.append((MINNAERT, f_lam * torch.pow(
                torch.clamp(back, min=1e-20), exp)))
        if present(VELVETY):
            sin_o = torch.sqrt(torch.clamp(1.0 - cos_o_c ** 2, min=0.0))
            w_by_type.append((VELVETY, f_lam * torch.pow(
                torch.clamp(sin_o, min=1e-20), exp)))
        if present(DIELECTRIC_LAYER_LAMB):
            # the ground's cosine sample inside the layer, refracted out
            # (dielectriclayer.h:49-70)
            fo, _ = _fresnel_dielectric(cos_o_c, eta)
            cos_i1_l = _cdot(wi_cos, nsb)
            etati = 1.0 / torch.clamp(eta, min=1e-6)
            wi_out, ok_out, cos_out = vm.refract(
                wi_cos, -nsb.expand(vshape), etati, _clamp01(cos_i1_l))
            fi_l, _ = _fresnel_dielectric(_clamp01(cos_out), eta)
            f_layer_w = ((1.0 - fo) * (1.0 - fi_l) * ONE_OVER_PI
                         * _clamp01(cos_i1_l))
            f_layer_w = torch.where(ok_out & (cos_o > 0.0), f_layer_w, 0.0)
            wi_cos = torch.where((t == DIELECTRIC_LAYER_LAMB)[..., None],
                                 wi_out, wi_cos)
            w_by_type.append((DIELECTRIC_LAYER_LAMB, f_layer_w))
        # the last present type needs no test of its own
        w_cos = _select([(t == ty, w) for ty, w in w_by_type[:-1]],
                        w_by_type[-1][1])
        fam['cos'] = _is_any(t, [x for x in FAM_COS if present(x)])
        wi_ch.append((fam['cos'], wi_cos))
        pdf_ch.append((fam['cos'], pdf_cos))
        c_ch.append((fam['cos'], color * w_cos[..., None]))

    # ---- delta reflection
    if present(*FAM_REFL):
        wi_refl = vm.reflect(wob.expand(vshape), nsb.expand(vshape), cos_o_c)
        f_diel, _ = _fresnel_dielectric(cos_o_c, eta)
        f_cond = (_fresnel_conductor(cos_o_c, lobes['ceta'], lobes['ck'])
                  if present(CONDUCTOR) else 1.0)
        w_refl = torch.where((t == DIELECTRIC_REFLECT)[..., None],
                             f_diel[..., None],
                             torch.where((t == CONDUCTOR)[..., None], f_cond,
                                         1.0))
        fam['refl'] = _is_any(t, FAM_REFL)
        wi_ch.append((fam['refl'], wi_refl))
        c_ch.append((fam['refl'], color * w_refl))

    # ---- delta straight transmission
    if present(*FAM_STR):
        wi_str = -wob.expand(vshape)
        # thin dielectric (dielectric.h:128-138):
        # exp(logT * thickness/cosO) * (1 - F); color holds T
        f_thin, _ = _fresnel_dielectric(cos_o_c, eta)
        alpha_thin = exp / torch.clamp(cos_o_c, min=1e-6)
        is_thin = t == THIN_DIELECTRIC_TRANSMIT
        w_str = torch.where(is_thin[..., None], (1.0 - f_thin)[..., None],
                            1.0)
        # the reference writes this test `t == THIN | (t == CONST)`, which
        # its operator precedence makes `t == THIN` alone: a constant
        # transmission from the back keeps its weight there, and here
        w_str = torch.where((is_thin & (cos_o <= 0.0))[..., None], 0.0,
                            w_str)
        fam['str'] = _is_any(t, FAM_STR)
        wi_ch.append((fam['str'], wi_str))
        thin_pow = torch.pow(torch.clamp(color, min=1e-12),
                             alpha_thin[..., None])
        c_ch.append((is_thin, thin_pow * w_str))
        c_ch.append((fam['str'], color * w_str))
    delta = [fam[k] for k in ('refl', 'str') if k in fam]
    if delta:
        pdf_ch.append((delta[0] | delta[1] if len(delta) == 2 else delta[0],
                       1.0))

    # ---- refraction (dielectric.h:82-89)
    if present(*FAM_REFR):
        wi_refr, ok_refr, _ = vm.refract(
            wob.expand(vshape), nsb.expand(vshape), eta, cos_o_c)
        f_refr, _ = _fresnel_dielectric(cos_o_c, eta)
        w_refr = torch.where(ok_refr, 1.0 - f_refr, 0.0)
        pdf_refr = torch.where(ok_refr, eta * eta, 0.0)
        fam['refr'] = t == DIELECTRIC_TRANSMIT
        wi_ch.append((fam['refr'], wi_refr))
        pdf_ch.append((fam['refr'], pdf_refr))
        c_ch.append((fam['refr'], color * w_refr[..., None]))

    # ---- glossy: microfacet, Phong, the anisotropic conductor
    if present(*FAM_GL):
        wi_gl, pdf_gl, w_gl = _sample_glossy(
            lobes, present, t, nsb, wob, ng, cos_o, cos_o_c, u, v, ns, tx,
            ty)
        c_gl = color * w_gl
    elif pdf_ch:
        # no glossy lobe: slots of no family (NONE) read zeros
        wi_gl, pdf_gl, c_gl = 0.0, 0.0, 0.0
    else:
        # no lobe family at all (a scene without materials): zero lanes,
        # as tensors, since no chain gives the selects one
        pdf_gl = torch.zeros(t.shape, dtype=color.dtype, device=color.device)
        wi_gl = c_gl = torch.zeros(vshape, dtype=color.dtype,
                                   device=color.device)
    wi = _select(wi_ch, wi_gl, vec=True)
    pdf = _select(pdf_ch, pdf_gl)
    c = _select(c_ch, c_gl, vec=True)

    # RR eta factor (sample.eta): refraction-type lobes report rcp(eta)
    if present(DIELECTRIC_TRANSMIT, THIN_DIELECTRIC_TRANSMIT):
        eta_out = torch.where(
            (t == DIELECTRIC_TRANSMIT) | (t == THIN_DIELECTRIC_TRANSMIT),
            1.0 / torch.clamp(eta, min=1e-6), 1.0)
    else:
        eta_out = torch.ones_like(pdf)

    bits = type_bits(t)
    live = (t != NONE) & ((bits & type_mask) != 0)
    lum = torch.sum(c, dim=-1)
    good = live & (lum > 0.0) & (pdf > 0.0)

    # luminance/pdf-weighted component pick (compositedbrdf.h:138-174)
    f_w = torch.where(good, lum / torch.clamp(pdf, min=1e-20), 0.0)
    total = torch.sum(f_w, dim=-1, keepdim=True)
    probs = f_w / torch.clamp(total, min=1e-30)
    # pick = #{k : cdf_k < s1}, the cdf summed slot by slot in order (as a
    # CPU cumsum does); torch's CUDA scan over a 4-wide innermost axis
    # took ~24 ms per 4M rays on the H100
    cdf = probs[..., 0]
    pick = (cdf < s1).to(torch.int64)
    for k in range(1, n_slots):
        cdf = cdf + probs[..., k]
        pick = pick + (cdf < s1)
    pick = torch.clamp(pick, max=n_slots - 1)
    onehot = (torch.arange(n_slots, device=t.device) == pick[..., None])

    def take(a):
        return torch.sum(torch.where(onehot, a, torch.zeros_like(a)), dim=-1)

    def take3(a):
        return torch.sum(torch.where(onehot[..., None], a, 0.0), dim=-2)

    sel_prob = take(probs)
    return {
        'wi': take3(wi),
        'pdf': take(pdf) * sel_prob,
        'weight': take3(c),
        'type_bits': take(bits),
        'eta': take(eta_out),
        'valid': (total[..., 0] > 0.0) & torch.any(onehot & good, dim=-1),
    }


def _sample_glossy(lobes, present, t, nsb, wob, ng, cos_o, cos_o_c, u, v,
                   ns, tx, ty):
    """The glossy family's (wi, pdf, weight (..., L, 3)): the microfacet
    lobes (microfacet.h), Phong (specular.h) and the anisotropic conductor
    (anisotropic_power_cosine_distribution.h), each where present."""
    eta, exp = lobes['eta'], lobes['exp']
    vshape = t.shape + (3,)
    wo_l = wob.expand(vshape)
    zero_v = torch.zeros(vshape, device=t.device)
    zero_s = torch.zeros(t.shape, device=t.device)
    if present(MICROFACET_DIELECTRIC, MICROFACET_CONDUCTOR):
        # microfacet.h:59-67: wh ~ power cosine around Ns, wi = reflect(wo,
        # wh), pdf = pdf_h / (4 |dot(wo, wh)|)
        wh, pdf_h = ss.power_cosine_sample_hemisphere(u, v, exp,
                                                      nsb.expand(vshape))
        cos_owh = _cdot(wo_l, wh)
        wi_mf = vm.reflect(wo_l, wh, cos_owh)
        pdf_mf = pdf_h / torch.clamp(4.0 * torch.abs(cos_owh), min=1e-12)
        # microfacet.h:43-56 eval at the sampled wi
        cos_i_mf = _cdot(wi_mf, nsb)
        cos_h = _cdot(wh, nsb)
        d_mf = (exp + 2.0) * ONE_OVER_TWO_PI * torch.pow(
            torch.clamp(torch.abs(cos_h), min=1e-20), exp)
        g_mf = torch.clamp(torch.minimum(
            2.0 * cos_h * cos_o_c / torch.clamp(cos_owh, min=1e-12),
            2.0 * cos_h * _clamp01(cos_i_mf)
            / torch.clamp(cos_owh, min=1e-12)), max=1.0)
        fr_d, _ = _fresnel_dielectric(_clamp01(cos_owh), eta)
        fr = fr_d[..., None]
        if present(MICROFACET_CONDUCTOR):
            fr_c = _fresnel_conductor(_clamp01(cos_owh), lobes['ceta'],
                                      lobes['ck'])
            fr = torch.where((t == MICROFACET_CONDUCTOR)[..., None], fr_c, fr)
        w_mf = fr * (d_mf * g_mf
                     / torch.clamp(4.0 * cos_o_c, min=1e-12))[..., None]
        # MetallicPaint's glitter flakes under the paint's dielectric
        # layer (metallicpaint.h:37-40): conductor microfacet lobes with
        # eta != 1 take (1 - Fo)(1 - Fi)
        layered = (t == MICROFACET_CONDUCTOR) & (torch.abs(eta - 1.0) > 1e-6)
        fo_l, _ = _fresnel_dielectric(cos_o_c, eta)
        fi_l2, _ = _fresnel_dielectric(_clamp01(cos_i_mf), eta)
        w_mf = torch.where(layered[..., None],
                           w_mf * ((1.0 - fo_l) * (1.0 - fi_l2))[..., None],
                           w_mf)
        mf_ok = ((cos_i_mf > 0.0) & (cos_o > 0.0)
                 & (_cdot(wi_mf, ng[..., None, :]) > 0.0))
        w_mf = torch.where(mf_ok[..., None], w_mf, 0.0)
    else:
        wi_mf, pdf_mf, w_mf = zero_v, zero_s, zero_v

    if present(SPECULAR_PHONG):
        # specular.h: power cosine around the reflected direction
        rdir = vm.reflect(wo_l, nsb.expand(vshape), cos_o)
        wi_ph, pdf_ph = ss.power_cosine_sample_hemisphere(u, v, exp, rdir)
        cos_ri = _cdot(rdir, wi_ph)
        w_ph = ((exp + 2.0) * ONE_OVER_TWO_PI
                * torch.pow(torch.clamp(cos_ri, min=1e-20), exp)
                * _clamp01(_cdot(wi_ph, nsb)))
        w_ph = torch.where(cos_ri >= 0.0, w_ph, 0.0)
    else:
        wi_ph, pdf_ph, w_ph = zero_v, zero_s, zero_s

    if present(MICROFACET_CONDUCTOR_ANISO):
        # anisotropic_power_cosine_distribution.h:56-73, oriented by the
        # surface tangent frame
        if tx is None or ty is None:
            txb, tyb, _ = vm.frame(ns)
        else:
            txb, tyb = tx, ty
        nx, ny_a = exp, eta
        phi_a = 2.0 * np.pi * u
        sin0 = torch.sqrt(torch.clamp(nx + 1.0, min=0.0)) * torch.sin(phi_a)
        cos0 = torch.sqrt(torch.clamp(ny_a + 1.0, min=0.0)) * torch.cos(phi_a)
        inv_n0 = 1.0 / torch.sqrt(torch.clamp(sin0 ** 2 + cos0 ** 2,
                                              min=1e-20))
        sin_p = sin0 * inv_n0
        cos_p = cos0 * inv_n0
        n_eff = nx * cos_p ** 2 + ny_a * sin_p ** 2
        cos_ta = torch.pow(torch.clamp(v, min=1e-30), 1.0 / (n_eff + 1.0))
        sin_ta = torch.sqrt(torch.clamp(1.0 - cos_ta ** 2, min=0.0))
        norm1_a = torch.sqrt(torch.clamp((nx + 1.0) * (ny_a + 1.0),
                                         min=0.0)) * ONE_OVER_TWO_PI
        norm2_a = torch.sqrt(torch.clamp((nx + 2.0) * (ny_a + 2.0),
                                         min=0.0)) * ONE_OVER_TWO_PI
        pdf_ha = norm1_a * torch.pow(cos_ta, n_eff)
        wh_a = ((cos_p * sin_ta)[..., None] * txb[..., None, :]
                + (sin_p * sin_ta)[..., None] * tyb[..., None, :]
                + cos_ta[..., None] * nsb)
        cos_owha = _cdot(wo_l, wh_a)
        wi_a = vm.reflect(wo_l, wh_a, cos_owha)
        pdf_a = pdf_ha / torch.clamp(4.0 * torch.abs(cos_owha), min=1e-12)
        cos_i_a = _cdot(wi_a, nsb)
        d_a = norm2_a * torch.pow(torch.clamp(cos_ta, min=1e-20), n_eff)
        g_a = torch.clamp(torch.minimum(
            2.0 * cos_ta * cos_o_c / torch.clamp(cos_owha, min=1e-12),
            2.0 * cos_ta * _clamp01(cos_i_a)
            / torch.clamp(cos_owha, min=1e-12)), max=1.0)
        fr_a = _fresnel_conductor(_clamp01(cos_owha), lobes['ceta'],
                                  lobes['ck'])
        w_a = fr_a * (d_a * g_a
                      / torch.clamp(4.0 * cos_o_c, min=1e-12))[..., None]
        a_ok = ((cos_i_a > 0.0) & (cos_o > 0.0)
                & (_cdot(wi_a, ng[..., None, :]) > 0.0))
        w_a = torch.where(a_ok[..., None], w_a, 0.0)
    else:
        wi_a, pdf_a, w_a = zero_v, zero_s, zero_v

    is_ph = t == SPECULAR_PHONG
    is_aniso = t == MICROFACET_CONDUCTOR_ANISO
    wi_gl = torch.where(is_aniso[..., None], wi_a,
                        torch.where(is_ph[..., None], wi_ph, wi_mf))
    pdf_gl = torch.where(is_aniso, pdf_a, torch.where(is_ph, pdf_ph, pdf_mf))
    w_gl = torch.where(is_aniso[..., None], w_a,
                       torch.where(is_ph[..., None], w_ph[..., None], w_mf))
    return wi_gl, pdf_gl, w_gl


# ---------------------------------------------------------------- kernels

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_L = ctypes.c_longlong
_SIGNATURES = {
    'yrt_lobes_eval': [_PTRS, _STRIDES, _L, _L, _L, _L, ctypes.c_void_p],
    'yrt_lobes_sample': [_PTRS, _STRIDES, _L, _L, _L, _PTRS],
}
_RECORD = ('type', 'color', 'eta', 'exp')
_CONDUCTOR = ('ceta', 'ck')
_WIDE = ('color', 'ceta', 'ck')


def _check(name, x, dev, shape):
    if x.dtype != torch.float32 or x.device != dev or x.shape != shape:
        raise ValueError(f"{name}: expected float32 {tuple(shape)} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _record(lobes, names):
    """The lobe record's arrays as the kernels read them, each through its
    own strides: int64 types (R, L), f32 parameters (R, L) or, color,
    ceta and ck, (R, L, 3) on the types' device."""
    t = lobes['type']
    if t.dim() != 2 or not 1 <= t.shape[1] <= 4:
        raise ValueError(f"the lobe kernels take an (R, L) record of 1 to 4 "
                         f"slots a hit, got types {tuple(t.shape)}")
    out = [t.to(torch.int64)]
    for name in names[1:]:
        shape = t.shape + ((3,) if name in _WIDE else ())
        _check(name, lobes[name], t.device, shape)
        out.append(lobes[name])
    return out


def _eval_kernel(lobes, ns, wo, wi, type_mask):
    """eval_lobes on the card: csrc/lobes.cu over the record's R hits,
    ns and wo (R, 3), each thread looping over wi's lights ((nl, R, 3),
    or one light as (R, 3))."""
    record = _record(lobes, _RECORD)
    r, dev = record[0].shape[0], record[0].device
    lights = wi if wi.dim() == 3 else wi[None]
    for name, x in (('ns', ns), ('wo', wo)):
        _check(name, x, dev, torch.Size((r, 3)))
    _check('wi', lights, dev, torch.Size((lights.shape[0], r, 3)))
    out = torch.empty(wi.shape, dtype=torch.float32, device=dev)
    if out.numel():
        _eval_op(*record, ns, wo, lights, int(type_mask), out)
    return out


def _sample_kernel(lobes, ns, ng, wo, s2, s1, type_mask, tx, ty):
    """sample_lobes on the card: csrc/lobes.cu, one thread a hit of the
    record's R: ns, ng, wo, tx, ty (R, 3), s2 (R, 2), s1 (R,)."""
    record = _record(lobes, _RECORD + _CONDUCTOR)
    r, dev = record[0].shape[0], record[0].device
    frame = (None, None) if tx is None or ty is None else (tx, ty)
    for name, x, width in (('ns', ns, (3,)), ('ng', ng, (3,)),
                           ('wo', wo, (3,)), ('s2', s2, (2,)), ('s1', s1, ()),
                           ('tx', frame[0], (3,)), ('ty', frame[1], (3,))):
        if x is not None:
            _check(name, x, dev, torch.Size((r,) + width))
    f32 = dict(dtype=torch.float32, device=dev)
    out = {'wi': torch.empty((r, 3), **f32), 'pdf': torch.empty(r, **f32),
           'weight': torch.empty((r, 3), **f32),
           'type_bits': torch.empty(r, dtype=torch.int64, device=dev),
           'eta': torch.empty(r, **f32),
           'valid': torch.empty(r, dtype=torch.bool, device=dev)}
    if r:
        _sample_op(*record, ns, ng, wo, s2, s1, *frame, int(type_mask),
                   *out.values())
    return out


def _args(xs):
    """Pointers and (3 an array) strides in elements of the kernel's
    inputs; None is a null pointer."""
    ptrs, strides = [], []
    for x in xs:
        ptrs.append(None if x is None else x.data_ptr())
        st = () if x is None else x.stride()
        strides += list(st) + [0] * (3 - len(st))
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides))


def launch_eval(lib, entry, ltype, color, eta, exp, ns, wo, wi, type_mask,
                out):
    """F2's eval (yrt_lobes_eval) of lib over the (R, L) record's hits
    and wi's (nl, R, 3) lights, out (nl, R, 3)."""
    ptrs, strides = _args((ltype, color, eta, exp, ns, wo, wi))
    cb.launch(getattr(lib, entry), entry, out.device, ptrs, strides,
              wi.shape[1], wi.shape[0], ltype.shape[1], type_mask, out)


def launch_sample(lib, entry, ltype, color, eta, exp, ceta, ck, ns, ng, wo,
                  s2, s1, tx, ty, type_mask, *outs):
    """F2's sample (yrt_lobes_sample) of lib over the (R, L) record's
    hits into the (R,)-shaped outputs (wi, pdf, weight, type_bits, eta,
    valid)."""
    ptrs, strides = _args((ltype, color, eta, exp, ceta, ck, ns, ng, wo, s2,
                           s1, tx, ty))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    cb.launch(getattr(lib, entry), entry, outs[0].device, ptrs, strides,
              ltype.shape[0], ltype.shape[1], type_mask, out_ptrs)


def _lib():
    return cb.library('lobes', _SIGNATURES)


_eval_op = cb.operator(
    'lobes_eval', '(Tensor ltype, Tensor color, Tensor eta, Tensor exp, '
    'Tensor ns, Tensor wo, Tensor wi, int type_mask, Tensor(a!) out) -> ()',
    launch_eval, _lib, eval_lobes)
_sample_op = cb.operator(
    'lobes_sample', '(Tensor ltype, Tensor color, Tensor eta, Tensor exp, '
    'Tensor ceta, Tensor ck, Tensor ns, Tensor ng, Tensor wo, Tensor s2, '
    'Tensor s1, Tensor? tx, Tensor? ty, int type_mask, Tensor(a!) wi, '
    'Tensor(b!) pdf, Tensor(c!) weight, Tensor(d!) type_bits, '
    'Tensor(e!) eta_out, Tensor(f!) valid) -> ()', launch_sample, _lib,
    sample_lobes)

# launch counts: the kernels launched, and the plain versions run on CUDA
# tensors
eval_lobes.launches = sample_lobes.launches = 0
_eval_lobes.cuda_calls = _sample_lobes.cuda_calls = 0


def has_type(lobes, type_mask: int):
    """Any live lobe matching the mask (CompositedBRDF::has)."""
    bits = type_bits(lobes['type'])
    return torch.any((lobes['type'] != NONE) & ((bits & type_mask) != 0),
                     dim=-1)
