"""The stereo field's tables, worked out from its plain description
(portbench/scenes/test_stereo.py): the triangles, their clusters and the
texture atlas as portbench/reference/scene.py makes them, and of this
scene's own

  lobe slots   a material's up to four lobes, as the presets define
               them: MetallicPaint a delta dielectric reflection (eta
               1 / eta) and a dielectric layer over a Lambertian of its
               shade colour; Uber a Lambertian of the map's rgb times
               its alpha, a straight transmission of 1 - alpha and a
               microfacet dielectric (eta 1 / 1.4, exponent 1 / 0.9)
               scaled by alpha; MatteTextured a Lambertian of the map's
               rgb.  Texture coordinates are ds * st + s0.
  lights       in order: the HDRI (its image, L, both affines and its
               2D distribution over texels weighted by sin(theta) and
               the texel's rgb sum, built in float64) and the ambient
               dome.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import scene as plain

# lobe ids and BRDF type bits, the renderer's numbering
NONE, LAMB, LAYER, DIEL_REFLECT, CONST_TRANSMIT, MICROFACET = (
    0, 1, 4, 6, 10, 12)
DIFFUSE_REFLECTION = 0x1
GLOSSY_REFLECTION = 0x10
SPECULAR_REFLECTION = 0x100
SPECULAR_TRANSMISSION = 0x1000000
# the colour of a slot from the texel at its coordinates
TEX_NONE = 0          # the slot's colour
TEX_UBER_DIFFUSE = 1  # the map's rgb (the colour without a map) x alpha
TEX_UBER_OPACITY = 2  # 1 - alpha
TEX_UBER_ALPHA = 3    # the colour x alpha
TEX_MUL_RGB = 4       # the colour x the map's rgb
SLOTS = 4
UBER_ETA = 1.4
UBER_ROUGHNESS = 0.9


def _f32(x):
    return float(np.float32(x))


def _slots(m):
    """[(type, colour, texture, mode, eta, exp)] of one material."""
    t = m['type']
    tex = m.get('texture', -1)
    if t == 'metallicpaint':
        eta = _f32(1.0 / m['eta'])
        return [(DIEL_REFLECT, (1.0, 1.0, 1.0), -1, TEX_NONE, eta, 0.0),
                (LAYER, tuple(m['shadeColor']), -1, TEX_NONE, eta, 0.0)]
    if t == 'uber':
        eta = _f32(1.0 / UBER_ETA)
        return [(LAMB, (0.0, 0.0, 0.0), tex, TEX_UBER_DIFFUSE, 1.0, 0.0),
                (CONST_TRANSMIT, (1.0, 1.0, 1.0), tex, TEX_UBER_OPACITY, 1.0,
                 0.0),
                (MICROFACET, (1.0, 1.0, 1.0), tex, TEX_UBER_ALPHA, eta,
                 _f32(1.0 / UBER_ROUGHNESS))]
    if t == 'mattetextured':
        return [(LAMB, (1.0, 1.0, 1.0), tex, TEX_MUL_RGB, 1.0, 0.0)]
    raise ValueError(f"the stereo field's reference has no material {t!r}")


def _distribution(image):
    """The HDRI's 2D distribution in float64: the marginal over rows and
    each row's conditional, as (cdf, pdf) pairs; a cdf starts at 0 and
    ends at exactly 1, a pdf is in units of one bucket."""
    img = np.asarray(image, np.float32)
    h = img.shape[0]
    ys = (np.arange(h) + 0.5) / h
    f = np.sin(np.pi * ys)[:, None] * img.sum(axis=-1)

    def one(g):
        n = g.shape[-1]
        total = g.sum(axis=-1, keepdims=True)
        total = np.where(total <= 0, 1.0, total)
        cdf = np.concatenate([np.zeros(g.shape[:-1] + (1,)),
                              np.cumsum(g / total, axis=-1)], axis=-1)
        cdf[..., -1] = 1.0
        return cdf, g / total * n

    marg_cdf, marg_pdf = one(f.sum(axis=1))
    cond_cdf, cond_pdf = one(f)
    return marg_cdf, marg_pdf, cond_cdf, cond_pdf


def prepare(desc: dict, device, dtype=torch.float32) -> dict:
    """The reference's tables for the stereo field on `device`, floats
    in `dtype`."""
    mats = desc['materials']
    # the geometry, the clusters and the atlas as reference/ makes them;
    # its material table is replaced below
    stand_in = {'meshes': desc['meshes'], 'textures': desc['textures'],
                'materials': [{'type': 'matte', 'reflectance': (1, 1, 1)}
                              for _ in mats],
                'quad_lights': [], 'ambient': None}
    sc = plain.prepare(stand_in, device, dtype)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).to(dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    m = len(mats)
    types = np.zeros((m, SLOTS), np.int64)
    color = np.zeros((m, SLOTS, 3), np.float32)
    tex = np.full((m, SLOTS), -1, np.int64)
    mode = np.zeros((m, SLOTS), np.int64)
    eta = np.ones((m, SLOTS), np.float32)
    exp = np.zeros((m, SLOTS), np.float32)
    for k, mat in enumerate(mats):
        for j, (ty, c, tx, md, e, x) in enumerate(_slots(mat)):
            types[k, j], color[k, j], tex[k, j] = ty, c, tx
            mode[k, j], eta[k, j], exp[k, j] = md, e, x
    sc.update({'lobe_type': i(types), 'lobe_color': f(color),
               'lobe_tex': i(tex), 'lobe_mode': i(mode), 'lobe_eta': f(eta),
               'lobe_exp': f(exp),
               'mat_s0': f([m_.get('s0', (0.0, 0.0)) for m_ in mats]),
               'mat_ds': f([m_.get('ds', (1.0, 1.0)) for m_ in mats])})
    lights = []
    for light in desc['lights']:
        if light['kind'] == 'ambient':
            lights.append({'kind': 'ambient', 'L': f(light['L'])})
            continue
        if light['kind'] != 'hdri':
            raise ValueError(f"the stereo field's reference has no light "
                             f"{light['kind']!r}")
        l2w = np.asarray(light['local2world'], np.float32)
        linv = np.linalg.inv(l2w[:3, :]).astype(np.float32)
        w2l = np.concatenate([linv, (-l2w[3, :] @ linv)[None, :]])
        marg_cdf, marg_pdf, cond_cdf, cond_pdf = _distribution(
            light['image'])
        image = np.asarray(light['image'], np.float32)
        lights.append({'kind': 'hdri', 'L': f(light['L']), 'image': f(image),
                       'width': image.shape[1], 'height': image.shape[0],
                       'local2world': f(l2w), 'world2local': f(w2l),
                       'marg_cdf': f(marg_cdf), 'marg_pdf': f(marg_pdf),
                       'cond_cdf': f(cond_cdf), 'cond_pdf': f(cond_pdf)})
    sc['lights'] = lights
    return sc
