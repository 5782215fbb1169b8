"""Lobe-table BSDFs: CompositedBRDF as masked tensor ops.

Counterpart of `yulio_raytracer_tpu/shading/lobes.py`.  A material is up
to MAX_LOBES lobe records (type id + parameters); `sample_lobes` samples
every lobe with the same 2D sample and picks one by a luminance/pdf
weighted discrete distribution, `eval_lobes` sums the diffuse evals.
This slice ports the LAMBERTIAN family and the shared dispatch; a lobe
of any other family raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sampling import shapesampler as ss

# lobe ids (the reference's numbering, so lobe tables are shared)
NONE = 0
LAMBERTIAN = 1
NUM_LOBE_TYPES = 16
_FAMILY = {2: 'MINNAERT', 3: 'VELVETY', 4: 'DIELECTRIC_LAYER_LAMB',
           5: 'SPECULAR_REFLECT', 6: 'DIELECTRIC_REFLECT', 7: 'CONDUCTOR',
           8: 'DIELECTRIC_TRANSMIT', 9: 'THIN_DIELECTRIC_TRANSMIT',
           10: 'CONST_TRANSMIT', 11: 'TRANSMISSION',
           12: 'MICROFACET_DIELECTRIC', 13: 'MICROFACET_CONDUCTOR',
           14: 'SPECULAR_PHONG', 15: 'MICROFACET_CONDUCTOR_ANISO'}

# BRDF type bits (brdf.h)
DIFFUSE_REFLECTION = 0x00000001
DIFFUSE = 0x000F000F
TRANSMISSION_BITS = 0x0FFF0000
ALL = 0xFFFFFFFF

_TYPE_BITS = np.zeros(NUM_LOBE_TYPES, np.int64)
_TYPE_BITS[LAMBERTIAN] = DIFFUSE_REFLECTION

ONE_OVER_PI = float(1.0 / np.pi)


def check_types(types):
    """Raise for a lobe type this port does not implement yet."""
    for t in types:
        if t not in (NONE, LAMBERTIAN):
            raise NotImplementedError(
                f"lobe family {_FAMILY.get(int(t), int(t))} is not ported "
                "to the torch package yet (LAMBERTIAN only)")


def type_bits(lobe_type):
    """BRDF type bitmask (int64 holding u32) of a lobe-type tensor."""
    return torch.as_tensor(_TYPE_BITS, device=lobe_type.device)[lobe_type]


def _cdot(a, b):
    return torch.sum(a * b, dim=-1)


def _clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def eval_lobes(lobes, ns, ng, wo, wi, type_mask: int = DIFFUSE):
    """Sum of the lobes' evals (CompositedBRDF::eval).  lobes: dict of
    (..., L[, 3]) tensors; ns/ng/wo/wi: (..., 3) -> (..., 3)."""
    t = lobes['type']
    sel = (type_bits(t) & type_mask) != 0
    cos_i = _cdot(wi[..., None, :], ns[..., None, :])
    f_lam = ONE_OVER_PI * _clamp01(cos_i)
    f = torch.where(t == LAMBERTIAN, f_lam, 0.0)
    f = torch.where(sel, f, 0.0)
    return torch.sum(lobes['color'] * f[..., None], dim=-2)


def sample_lobes(lobes, ns, ng, wo, s2, s1, type_mask: int = ALL,
                 types_present=None):
    """CompositedBRDF::sample.  types_present: the scene's static set of
    lobe types (scene.lobe_types); None means LAMBERTIAN only.  Returns a
    dict of wi (.., 3), pdf, weight (.., 3), type_bits, eta, valid."""
    if types_present is not None:
        check_types(types_present)
    t = lobes['type']                               # (..., L)
    color = lobes['color']                          # (..., L, 3)
    n_slots = t.shape[-1]
    nsb = ns[..., None, :]
    u = s2[..., None, 0].expand(t.shape)
    v = s2[..., None, 1].expand(t.shape)

    # cosine hemisphere around Ns; the Lambertian weight is eval()
    wi_cos, pdf_cos = ss.cosine_sample_hemisphere(
        u, v, nsb.expand(t.shape + (3,)))
    w_cos = ONE_OVER_PI * _clamp01(_cdot(wi_cos, nsb))

    fam_cos = t == LAMBERTIAN
    wi = torch.where(fam_cos[..., None], wi_cos, 0.0)
    pdf = torch.where(fam_cos, pdf_cos, 0.0)
    c = torch.where(fam_cos[..., None], color * w_cos[..., None], 0.0)
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


def has_type(lobes, type_mask: int):
    """Any live lobe matching the mask (CompositedBRDF::has)."""
    bits = type_bits(lobes['type'])
    return torch.any((lobes['type'] != NONE) & ((bits & type_mask) != 0),
                     dim=-1)
