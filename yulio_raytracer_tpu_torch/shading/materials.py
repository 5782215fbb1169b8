"""Material presets -> lobe tables, and the per-hit shade context.

Counterpart of `yulio_raytracer_tpu/shading/materials.py`: the host-side
compiler `make_material` turns (type, params) into lobe records,
`build_table` stacks them into the material table (the same arrays as the
reference, including the fused (M, 78) `mat_tab`), and `shade_context`
gathers each hit's row into the lobe arrays that shading/lobes.py reads.
This slice ports the 'matte' preset and a textureless atlas; any other
material type raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import lobes as lb

MAX_LOBES = 4

TEX_NONE = 0


@dataclass
class LobeSpec:
    type: int = lb.NONE
    color: tuple = (0.0, 0.0, 0.0)
    cscale: float = 1.0
    eta: float = 1.0
    exp: float = 0.0
    ceta: tuple = (1.0, 1.0, 1.0)
    ck: tuple = (0.0, 0.0, 0.0)
    tex: int = -1
    texmode: int = TEX_NONE
    medium_sensitive: bool = False


@dataclass
class MaterialSpec:
    lobes: list          # list[LobeSpec], len <= MAX_LOBES
    s0: tuple = (0.0, 0.0)
    ds: tuple = (1.0, 1.0)
    bump_tex: int = -1
    is_media_interface: bool = False
    medium_out_eta: float = 1.0
    medium_in_eta: float = 1.0
    medium_out_trans: tuple = (1.0, 1.0, 1.0)
    medium_in_trans: tuple = (1.0, 1.0, 1.0)


def _c3(v, default=(1.0, 1.0, 1.0)):
    if v is None:
        return tuple(float(x) for x in default)
    if np.isscalar(v):
        return (float(v),) * 3
    return tuple(float(x) for x in v)


def make_material(mtype: str, p: dict, tex_id: int = -1) -> MaterialSpec:
    """Compile a material; `p` holds the reference's parameter names."""
    if mtype.lower() != 'matte':
        raise NotImplementedError(
            f"material type {mtype!r} is not ported to the torch package "
            "yet ('matte' only)")
    # matte.h: Lambertian(reflectance)
    return MaterialSpec([LobeSpec(lb.LAMBERTIAN, _c3(p.get('reflectance')))],
                        s0=tuple(p.get('s0', (0.0, 0.0))),
                        ds=tuple(p.get('ds', (1.0, 1.0))))


def build_table(mats: list[MaterialSpec]) -> dict:
    """Stack MaterialSpecs into the material table (numpy; commit moves
    it to the device)."""
    if not mats:
        mats = [make_material('matte', {})]
    m, l = len(mats), MAX_LOBES
    out = {
        'lobe_type': np.zeros((m, l), np.int32),
        'lobe_color': np.zeros((m, l, 3), np.float32),
        'lobe_cscale': np.ones((m, l), np.float32),
        'lobe_eta': np.ones((m, l), np.float32),
        'lobe_exp': np.zeros((m, l), np.float32),
        'lobe_ceta': np.ones((m, l, 3), np.float32),
        'lobe_ck': np.zeros((m, l, 3), np.float32),
        'lobe_tex': np.full((m, l), -1, np.int32),
        'lobe_texmode': np.zeros((m, l), np.int32),
        'lobe_medium': np.zeros((m, l), np.int32),
        's0': np.zeros((m, 2), np.float32),
        'ds': np.ones((m, 2), np.float32),
        'media': np.zeros((m,), np.int32),
        'medium_out_eta': np.ones((m,), np.float32),
        'medium_in_eta': np.ones((m,), np.float32),
        'medium_out_trans': np.ones((m, 3), np.float32),
        'medium_in_trans': np.ones((m, 3), np.float32),
    }
    for i, ms in enumerate(mats):
        if len(ms.lobes) > l:
            raise ValueError(f"material {i} has {len(ms.lobes)} lobes, "
                             f"more than MAX_LOBES={l}")
        for j, lo in enumerate(ms.lobes):
            out['lobe_type'][i, j] = lo.type
            out['lobe_color'][i, j] = lo.color
            out['lobe_cscale'][i, j] = lo.cscale
            out['lobe_eta'][i, j] = lo.eta
            out['lobe_exp'][i, j] = lo.exp
            out['lobe_ceta'][i, j] = lo.ceta
            out['lobe_ck'][i, j] = lo.ck
            out['lobe_tex'][i, j] = lo.tex
            out['lobe_texmode'][i, j] = lo.texmode
            out['lobe_medium'][i, j] = int(lo.medium_sensitive)
        out['s0'][i] = ms.s0
        out['ds'][i] = ms.ds
        out['media'][i] = int(ms.is_media_interface)
        out['medium_out_eta'][i] = ms.medium_out_eta
        out['medium_in_eta'][i] = ms.medium_in_eta
        out['medium_out_trans'][i] = ms.medium_out_trans
        out['medium_in_trans'][i] = ms.medium_in_trans
    # fused (M, 78) matrix: one row gather per hit
    out['mat_tab'] = np.concatenate([
        out['lobe_type'].astype(np.float32),                  # 0:4
        out['lobe_color'].reshape(m, 12),                     # 4:16
        out['lobe_cscale'],                                   # 16:20
        out['lobe_eta'],                                      # 20:24
        out['lobe_exp'],                                      # 24:28
        out['lobe_ceta'].reshape(m, 12),                      # 28:40
        out['lobe_ck'].reshape(m, 12),                        # 40:52
        out['lobe_tex'].astype(np.float32),                   # 52:56
        out['lobe_texmode'].astype(np.float32),               # 56:60
        out['lobe_medium'].astype(np.float32),                # 60:64
        out['s0'],                                            # 64:66
        out['ds'],                                            # 66:68
        out['media'].astype(np.float32)[:, None],             # 68
        out['medium_out_eta'][:, None],                       # 69
        out['medium_in_eta'][:, None],                        # 70
        out['medium_out_trans'],                              # 71:74
        out['medium_in_trans'],                               # 74:77
        np.asarray([ms.bump_tex for ms in mats], np.float32)[:, None],  # 77
    ], axis=1).astype(np.float32)
    return out


def check_table(table: dict):
    """Raise for lobe types or texture modes this port does not implement
    yet (a table compiled by the reference may hold any)."""
    lb.check_types(np.unique(np.asarray(table['lobe_type'])))
    if np.any(np.asarray(table['lobe_texmode']) != TEX_NONE):
        raise NotImplementedError(
            "texture modes are not ported to the torch package yet")


def shade_context(table: dict, textable: dict, mat_id, medium_eta,
                  medium_trans):
    """Per-hit lobe arrays for lobes.eval_lobes / sample_lobes.

    mat_id: (R,) int; medium_eta: (R,), medium_trans: (R, 3) (the ray's
    current medium).  Texture coordinates are not needed while the atlas
    is empty.  Returns (lobes dict of (R, L[, 3]) tensors, aux dict)."""
    if textable['data'].shape[0] > 1:
        raise NotImplementedError(
            "textured materials are not ported to the torch package yet")
    tab = table['mat_tab'][torch.clamp(mat_id, min=0)]     # (R, 78)
    r = tab.shape[0]
    ltype = torch.round(tab[:, 0:4]).to(torch.int64)
    base = tab[:, 4:16].reshape(r, 4, 3)
    cscale = tab[:, 16:20][..., None]
    eta0 = tab[:, 20:24]
    lobe_medium = torch.round(tab[:, 60:64]).to(torch.int64)
    color = base * cscale           # TEX_NONE, the only mode check_table lets in
    in_eta = tab[:, 70]
    in_trans = tab[:, 74:77]
    # medium-sensitive relative IOR (dielectric.h:59-66)
    inside = (torch.abs(medium_eta - in_eta) < 1e-6) & torch.all(
        torch.abs(medium_trans - in_trans) < 1e-6, dim=-1)
    eta = torch.where((lobe_medium != 0) & inside[..., None],
                      1.0 / torch.clamp(eta0, min=1e-6), eta0)
    lobed = {'type': ltype, 'color': color, 'eta': eta}
    aux = {
        'is_media_interface': tab[:, 68] != 0,
        'medium_out_eta': tab[:, 69],
        'medium_in_eta': in_eta,
        'medium_out_trans': tab[:, 71:74],
        'medium_in_trans': in_trans,
        'inside': inside,
    }
    return lobed, aux


def next_medium(aux, sampled_transmission_bit, medium_eta, medium_trans):
    """Medium tracking: on a sampled TRANSMISSION component at a media
    interface, switch to the other medium."""
    switch = aux['is_media_interface'] & sampled_transmission_bit
    new_eta = torch.where(aux['inside'], aux['medium_out_eta'],
                          aux['medium_in_eta'])
    new_trans = torch.where(aux['inside'][..., None],
                            aux['medium_out_trans'], aux['medium_in_trans'])
    return (torch.where(switch, new_eta, medium_eta),
            torch.where(switch[..., None], new_trans, medium_trans))
