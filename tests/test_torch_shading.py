"""The torch port's shading layer held against the JAX package on the same
numpy inputs: reflect/refract and the power-cosine sampler, the texture
atlas and its fetch, all 16 lobe types, all 14 material presets with
their texture modes and bump maps, authored tangents, and a materials
probe (the cornell box with its boxes in each preset) rendered by both
packages.

Tolerances: float outputs of the lobes within rtol 2e-4 / atol 2e-5 (the
power-cosine exponents reach 1000 here, and torch's and XLA's pow, exp
and sqrt differ by ulps on the CPU); the texture fetch and the shade
context within atol 1e-6; tables and integer outputs equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.core import math as jvm
from yulio_raytracer_tpu.sampling import shapesampler as jss
from yulio_raytracer_tpu.shading import lobes as jlb
from yulio_raytracer_tpu.shading import materials as jmat
from yulio_raytracer_tpu.shading import textures as jtex
from yulio_raytracer_tpu.geometry import mesh as jmesh
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.core import math as vm
from yulio_raytracer_tpu_torch.sampling import shapesampler as ss
from yulio_raytracer_tpu_torch.shading import lobes as lb
from yulio_raytracer_tpu_torch.shading import materials as mat
from yulio_raytracer_tpu_torch.shading import textures as tex
from yulio_raytracer_tpu_torch.geometry import mesh
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum

from probe_scene import PROBE_PRESETS, materials_probe

torch.set_num_threads(2)
R = 1024
LOBE_RTOL, LOBE_ATOL = 2e-4, 2e-5
# at most this share of lanes may pick another lobe, and only where s1
# lies within 1e-6 of a step of the pick's CDF
NEAR_STEP, NEAR_STEP_MAX = 1e-6, 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _frame(rs, n):
    """Unit ns and a tangent frame (tx, ty) orthonormal to it."""
    ns = _unit(rs, n)
    h = _unit(rs, n)
    tx = np.cross(h, ns)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(ns, tx)
    return ns, tx.astype(np.float32), ty.astype(np.float32)


# ------------------------------------------------------------ math, sampler

def test_reflect_refract_match():
    rs = np.random.RandomState(1)
    v, n = _unit(rs, R), _unit(rs, R)
    cos_i = np.abs(rs.rand(R)).astype(np.float32)
    eta = rs.uniform(0.4, 2.5, R).astype(np.float32)
    np.testing.assert_allclose(
        vm.reflect(_t(v), _t(n)).numpy(),
        _np(jvm.reflect(jnp.asarray(v), jnp.asarray(n))), atol=1e-6)
    np.testing.assert_allclose(
        vm.reflect(_t(v), _t(n), _t(cos_i)).numpy(),
        _np(jvm.reflect(jnp.asarray(v), jnp.asarray(n),
                        jnp.asarray(cos_i))), atol=1e-6)
    got = vm.refract(_t(v), _t(n), _t(eta), _t(cos_i))
    ref = jvm.refract(jnp.asarray(v), jnp.asarray(n), jnp.asarray(eta),
                      jnp.asarray(cos_i))
    np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))
    assert 0 < got[1].sum() < R           # both branches, TIR included
    for g, r in zip(got[::2], ref[::2]):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6)


def test_hemisphere_samplers_and_pdfs_match():
    rs = np.random.RandomState(2)
    u, v = (rs.rand(R).astype(np.float32) for _ in range(2))
    exp = rs.uniform(0.0, 1000.0, R).astype(np.float32)
    n, wi = _unit(rs, R), _unit(rs, R)
    for up in (None, n):
        got = ss.power_cosine_sample_hemisphere(
            _t(u), _t(v), _t(exp), None if up is None else _t(up))
        ref = jss.power_cosine_sample_hemisphere(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(exp),
            None if up is None else jnp.asarray(up))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), _np(r), rtol=LOBE_RTOL,
                                       atol=LOBE_ATOL)
    np.testing.assert_allclose(
        ss.power_cosine_hemisphere_pdf(_t(wi), _t(n), _t(exp)).numpy(),
        _np(jss.power_cosine_hemisphere_pdf(jnp.asarray(wi), jnp.asarray(n),
                                            jnp.asarray(exp))),
        rtol=LOBE_RTOL, atol=LOBE_ATOL)
    np.testing.assert_allclose(
        ss.cosine_hemisphere_pdf(_t(wi), _t(n)).numpy(),
        _np(jss.cosine_hemisphere_pdf(jnp.asarray(wi), jnp.asarray(n))),
        atol=1e-7)


# ------------------------------------------------------------------ textures

def _images(rs):
    """One image of each kind the builder converts."""
    return {
        'uint8_rgb': rs.randint(0, 256, (5, 7, 3)).astype(np.uint8),
        'uint8_rgba': rs.randint(0, 256, (3, 4, 4)).astype(np.uint8),
        'grey': rs.rand(6, 3).astype(np.float32),
        'rgb': rs.rand(4, 9, 3).astype(np.float32),
        'rgba': rs.rand(2, 2, 4).astype(np.float32),
        'one_texel': rs.rand(1, 1, 3).astype(np.float32),
    }


def _both_builders(adds):
    """The same add() calls on both builders; returns (jax table, port
    table, jax ids, port ids)."""
    jb, tb = jtex.TextureTableBuilder(), tex.TextureTableBuilder()
    jids = [jb.add(img, **kw) for img, kw in adds]
    tids = [tb.add(img, **kw) for img, kw in adds]
    return jb.build(), tb.build(), jids, tids


@pytest.mark.parametrize('kind', ['uint8_rgb', 'uint8_rgba', 'grey', 'rgb',
                                  'rgba', 'invert_nearest', 'key_cache',
                                  'empty'])
def test_texture_builder_matches(kind):
    imgs = _images(np.random.RandomState(3))
    if kind == 'invert_nearest':
        adds = [(imgs['rgb'], dict(filter=tex.FILTER_NEAREST, invert=True))]
    elif kind == 'key_cache':
        # a key added again (same filter, invert) keeps its id; another
        # filter or invert is a texture of its own
        adds = [(imgs['rgb'], dict(key='a')), (imgs['grey'], dict(key='a')),
                (imgs['grey'], dict(key='a', invert=True)),
                (imgs['rgba'], dict(key='b')),
                (imgs['rgb'], dict(key='a', filter=tex.FILTER_NEAREST))]
    elif kind == 'empty':
        adds = []
    else:
        adds = [(imgs[kind], {})]
    jt, tt, jids, tids = _both_builders(adds)
    assert jids == tids
    if kind == 'key_cache':
        assert tids == [0, 0, 1, 2, 3]
    assert jt.keys() == tt.keys()
    for k in jt:
        assert tt[k].dtype == np.asarray(jt[k]).dtype, k
        np.testing.assert_array_equal(tt[k], _np(jt[k]), err_msg=k)
    if kind == 'empty':
        assert tt['data'].shape == (1, 4) and (tt['data'] == 1).all()


def _fetch_case(rs, n=R):
    """An atlas of six textures (both filters, one inverted, a 1x1 and
    a 1-wide one), and (tid, uv) lanes at random uv in [-2.5, 3.5), on
    exact texel centres and edges, and at -1 (white)."""
    imgs = _images(rs)
    adds = [(imgs['uint8_rgb'], {}),
            (imgs['rgb'], dict(filter=tex.FILTER_NEAREST)),
            (imgs['grey'], dict(invert=True)),
            (imgs['one_texel'], {}),
            (imgs['rgba'], dict(filter=tex.FILTER_NEAREST, invert=True)),
            (rs.rand(5, 1, 3).astype(np.float32), {})]
    jt, tt, _, _ = _both_builders(adds)
    w, h = tt['w'], tt['h']
    tid = rs.randint(-1, len(adds), n).astype(np.int32)
    uv = rs.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    safe = np.maximum(tid, 0)
    third = n // 3
    # texel centres (k + .5) / W and edges k / W, shifted by whole periods
    for lo, off in ((third, 0.5), (2 * third, 0.0)):
        kx = rs.randint(0, 8, n)
        ky = rs.randint(0, 8, n)
        per = rs.randint(-2, 3, (n, 2))
        cu = ((kx % w[safe]) + off) / w[safe] + per[:, 0]
        cv = ((ky % h[safe]) + off) / h[safe] + per[:, 1]
        uv[lo - third:lo] = np.stack([cu, cv], 1)[lo - third:lo]
    return jt, tt, tid, uv


def test_texture_fetch_matches():
    jt, tt, tid, uv = _fetch_case(np.random.RandomState(4))
    ttt = {k: _t(v) for k, v in tt.items()}
    got = tex.fetch(ttt, _t(tid), _t(uv)).numpy()
    ref = _np(jtex.fetch(jt, jnp.asarray(tid), jnp.asarray(uv)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got[tid < 0] == 1.0).all()


def test_texture_fetch_texel_indices_match():
    """Each texel's weight in every lane's fetch (the fetch is linear in
    the atlas data, so a one-hot atlas reads one texel's weight): the
    texels each filter reads, and their weights, are the reference's."""
    jt, tt, tid, uv = _fetch_case(np.random.RandomState(5), n=256)
    keep = tid >= 0
    tid, uv = tid[keep], uv[keep]
    for t in (jt, tt):                     # weights, not inverted colours
        t['invert'] = np.zeros_like(np.asarray(t['invert']))
    p = tt['data'].shape[0]
    got = np.empty((p, tid.shape[0]), np.float32)
    ref = np.empty_like(got)
    for k in range(p):
        onehot = np.zeros((p, 4), np.float32)
        onehot[k] = 1.0
        tt['data'] = onehot
        jt = {**jt, 'data': jnp.asarray(onehot)}
        got[k] = tex.fetch({kk: _t(v) for kk, v in tt.items()}, _t(tid),
                           _t(uv))[:, 0].numpy()
        ref[k] = _np(jtex.fetch(jt, jnp.asarray(tid), jnp.asarray(uv)))[:, 0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # nearest: one texel at weight 1, the reference's, in every lane
    nearest = np.asarray(tt['filter'])[tid] == tex.FILTER_NEAREST
    assert nearest.any()
    np.testing.assert_array_equal(np.argmax(got[:, nearest], axis=0),
                                  np.argmax(ref[:, nearest], axis=0))
    np.testing.assert_array_equal(got[:, nearest].max(axis=0), 1.0)


# --------------------------------------------------------------------- lobes

def _lobe_case(ltype, rs, n=R):
    """Lobe arrays with `ltype` in slot 0 on every lane, a Lambertian in
    slot 1 on half of them, and random parameters: eta in [0.4, 2.5] (the
    anisotropic lobe's second exponent in [1, 1000]), exp in [0, 200] (its
    first in [1, 1000]; a thin dielectric's thickness in [0, 0.5])."""
    t = np.zeros((n, 4), np.int32)
    t[:, 0] = ltype
    t[: n // 2, 1] = jlb.LAMBERTIAN
    color = rs.uniform(0.05, 1.0, (n, 4, 3)).astype(np.float32)
    eta = rs.uniform(0.4, 2.5, (n, 4)).astype(np.float32)
    exp = rs.uniform(0.0, 200.0, (n, 4)).astype(np.float32)
    if ltype == jlb.MICROFACET_CONDUCTOR_ANISO:
        eta[:, 0] = rs.uniform(1.0, 1000.0, n)
        exp[:, 0] = rs.uniform(1.0, 1000.0, n)
    if ltype == jlb.THIN_DIELECTRIC_TRANSMIT:
        exp[:, 0] = rs.uniform(0.0, 0.5, n)
    if ltype == jlb.MICROFACET_CONDUCTOR:
        eta[: n // 4, 0] = 1.0           # unlayered, as metal's
    return {'type': t, 'color': color, 'eta': eta, 'exp': exp,
            'ceta': rs.uniform(0.2, 3.0, (n, 4, 3)).astype(np.float32),
            'ck': rs.uniform(0.0, 5.0, (n, 4, 3)).astype(np.float32)}


def _sample_both(lobes, geo, s1, tangents, present):
    ns, ng, wo, s2, tx, ty = geo
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    ref = jlb.sample_lobes(
        jl, *(jnp.asarray(x) for x in (ns, ng, wo, s2, s1)), jlb.ALL,
        tx=jnp.asarray(tx) if tangents else None,
        ty=jnp.asarray(ty) if tangents else None, types_present=present)
    tl = {k: _t(v).long() if k == 'type' else _t(v)
          for k, v in lobes.items()}
    got = lb.sample_lobes(tl, *(_t(x) for x in (ns, ng, wo, s2, s1)), lb.ALL,
                          tx=_t(tx) if tangents else None,
                          ty=_t(ty) if tangents else None,
                          types_present=present)
    return ({k: _np(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize('ltype', range(lb.NUM_LOBE_TYPES))
def test_lobe_type_matches(ltype):
    """sample_lobes and eval_lobes of one lobe type (with a Lambertian
    beside it on half the lanes) against the reference, with the tangent
    frame given and not, and with types_present None and exact."""
    rs = np.random.RandomState(100 + ltype)
    lobes = _lobe_case(ltype, rs)
    ns, tx, ty = _frame(rs, R)
    # ng near ns; wo in both hemispheres (backlit lanes included)
    ng = ns + 0.3 * _unit(rs, R)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo = _unit(rs, R)
    wo[: R * 3 // 4] *= np.sign((wo * ns).sum(1))[: R * 3 // 4, None]
    wi = _unit(rs, R)
    s2 = rs.rand(R, 2).astype(np.float32)
    s1 = rs.rand(R).astype(np.float32)
    geo = (ns, ng, wo, s2, tx, ty)
    exact = tuple(sorted({ltype, jlb.LAMBERTIAN} - {jlb.NONE}))
    assert lb.type_bits(_t(np.arange(16))).tolist() == \
        _np(jlb.type_bits(jnp.arange(16))).astype(np.int64).tolist()
    for tangents in (True, False):
        for present in (None, exact):
            ref, got = _sample_both(lobes, geo, s1, tangents, present)
            # lanes whose s1 lies within NEAR_STEP of a CDF step: the pick
            # changes across [s1 - NEAR_STEP, s1 + NEAR_STEP]
            lo, _ = _sample_both(lobes, geo, s1 - NEAR_STEP, tangents,
                                 present)
            hi, _ = _sample_both(lobes, geo, s1 + NEAR_STEP, tangents,
                                 present)
            near = np.zeros(R, bool)
            for k in ('wi', 'weight'):
                near |= np.any(lo[k] != hi[k], axis=-1)
            near |= lo['type_bits'] != hi['type_bits']
            assert near.mean() <= NEAR_STEP_MAX, near.sum()
            far = ~near
            for k in ('type_bits', 'valid'):
                np.testing.assert_array_equal(
                    got[k][far], ref[k][far].astype(got[k].dtype),
                    err_msg=f'{k} tangents={tangents} present={present}')
            ok = far & ref['valid']
            assert ok.mean() > 0.2 or ltype == jlb.NONE
            for k in ('wi', 'pdf', 'weight', 'eta'):
                np.testing.assert_allclose(
                    got[k][ok], ref[k][ok], rtol=LOBE_RTOL, atol=LOBE_ATOL,
                    err_msg=f'{k} tangents={tangents} present={present}')
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    tl = {k: _t(v).long() if k == 'type' else _t(v)
          for k, v in lobes.items()}
    for present in (None, exact):
        np.testing.assert_allclose(
            lb.eval_lobes(tl, *(_t(x) for x in (ns, ng, wo, wi)), lb.DIFFUSE,
                          types_present=present).numpy(),
            _np(jlb.eval_lobes(jl, *(jnp.asarray(x)
                                     for x in (ns, ng, wo, wi)),
                               jlb.DIFFUSE)),
            rtol=LOBE_RTOL, atol=LOBE_ATOL)
    np.testing.assert_array_equal(lb.has_type(tl, lb.SPECULAR).numpy(),
                                  _np(jlb.has_type(jl, jlb.SPECULAR)))


# ----------------------------------------------------------------- materials

PRESETS = tuple(PROBE_PRESETS)


def _materials(pkg, name, tex_id, **extra):
    """A preset through pkg's make_material, and its variants: the other
    roughness / reflectivity branches, and Obj's extra maps."""
    p = {**PROBE_PRESETS[name], **extra}
    out = [pkg.make_material(name, p, tex_id=tex_id)]
    if name == 'obj':
        out.append(pkg.make_material(name, p, tex_id=tex_id, tex_ids={
            'map_d': tex_id, 'map_Ks': tex_id, 'map_Bump': tex_id}))
    if name == 'uber':
        out += [pkg.make_material(name, {**p, 'reflectivity': 0.4},
                                  tex_id=tex_id),
                pkg.make_material(name, {**p, 'roughness': 0.0},
                                  tex_id=-1)]
    if name in ('plastic', 'metal'):
        out.append(pkg.make_material(name, {**p, 'roughness': 0.0}))
    if name == 'brushedmetal':
        out.append(pkg.make_material(name, {**p, 'roughnessX': 0.0}))
    return out


@pytest.mark.parametrize('name', PRESETS)
def test_preset_table_matches(name):
    """build_table of the preset (and its branches) is the reference's,
    mat_tab bit for bit, and its lobe types those the reference lists."""
    j = jmat.build_table(_materials(jmat, name, 1))
    t = mat.build_table(_materials(mat, name, 1))
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], _np(j[k]), err_msg=k)
    assert mat.table_gates(t)[1] == (name == 'obj')


def _atlas(pkg, rs):
    b = pkg.TextureTableBuilder()
    b.add((rs.rand(8, 6, 4)).astype(np.float32))
    b.add((rs.rand(5, 7, 3) * 255).astype(np.uint8))
    b.add(rs.rand(4, 4).astype(np.float32), filter=pkg.FILTER_NEAREST)
    return b.build()


@pytest.mark.parametrize('medium', ['outside', 'inside'])
@pytest.mark.parametrize('bump', ['bump', 'no_bump'])
def test_shade_context_all_modes_match(medium, bump):
    """Every preset on a textured atlas (all seven texture modes, the
    Obj bump map where 'bump'), rays outside and inside the dielectric's
    medium, against the reference; the port runs with the table's static
    gates."""
    rs = np.random.RandomState(7)
    tids = rs.randint(0, 3, len(PRESETS))
    specs = {pkg: [m for name, tid in zip(PRESETS, tids)
                   for m in _materials(pkg, name, int(tid))]
             for pkg in (jmat, mat)}
    if bump == 'no_bump':
        for pkg in specs:
            for m in specs[pkg]:
                m.bump_tex = -1
    jtab, ttab = jmat.build_table(specs[jmat]), mat.build_table(specs[mat])
    np.testing.assert_array_equal(ttab['mat_tab'], _np(jtab['mat_tab']))
    jtx, ttx = _atlas(jtex, np.random.RandomState(8)), _atlas(
        tex, np.random.RandomState(8))
    m = ttab['mat_tab'].shape[0]
    modes, has_bump = mat.table_gates(ttab)
    assert modes == tuple(range(7)) and has_bump == (bump == 'bump')
    mid = rs.randint(-1, m, R).astype(np.int32)
    st = rs.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    ns, tx, ty = _frame(rs, R)
    if medium == 'inside':
        # the dielectric's inside medium (etaInside 1.5, its transmission)
        eta = np.full(R, 1.5, np.float32)
        trans = np.tile(np.float32([0.9, 0.8, 0.7]), (R, 1))
    else:
        eta, trans = np.ones(R, np.float32), np.ones((R, 3), np.float32)
    jl, jaux = jmat.shade_context(
        jtab, jtx, jnp.asarray(mid), jnp.asarray(st), jnp.asarray(eta),
        jnp.asarray(trans), ns=jnp.asarray(ns), tx=jnp.asarray(tx),
        ty=jnp.asarray(ty))
    t_tab = {k: _t(v) for k, v in ttab.items()}
    t_tx = {k: _t(v) for k, v in ttx.items()}
    tl, taux = mat.shade_context(t_tab, t_tx, _t(mid).long(), _t(st),
                                 _t(eta), _t(trans), tex_modes=modes,
                                 bump=has_bump, ns=_t(ns), tx=_t(tx),
                                 ty=_t(ty))
    np.testing.assert_array_equal(tl['type'].numpy(),
                                  _np(jl['type']).astype(np.int64))
    for k in ('color', 'eta', 'exp', 'ceta', 'ck'):
        np.testing.assert_allclose(tl[k].numpy(), _np(jl[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    # the reference's bump step always runs and reads ns back where no
    # material binds a bump map; the port's runs only where one does
    assert ('ns' in taux) == (bump == 'bump')
    assert jaux.keys() == taux.keys() | {'ns'}
    for k in taux:
        np.testing.assert_allclose(
            taux[k].numpy().astype(np.float32),
            _np(jaux[k]).astype(np.float32), rtol=0, atol=1e-6, err_msg=k)
    if bump == 'no_bump':
        np.testing.assert_array_equal(_np(jaux['ns']), ns)
    if medium == 'inside':
        assert taux['inside'].any() and not taux['inside'].all()
    if bump == 'bump':
        moved = np.abs(taux['ns'].numpy() - ns).max(axis=1) > 1e-3
        assert moved.any() and not moved.all()


def test_authored_tangents_shade_table_matches():
    """Meshes with tangent_x and tangent_y, with tangent_x alone, and
    without (in one scene): the packed shade_tab equals the reference's,
    and the authored rows differ from the uv-derived frame."""
    rs = np.random.RandomState(9)

    def meshes(pkg):
        out = []
        for k, (tx, ty) in enumerate(((True, True), (True, False),
                                      (False, False))):
            pos = rs.randn(12, 3).astype(np.float32)
            tri = rs.randint(0, 12, (10, 3)).astype(np.int32)
            uv = rs.rand(12, 2).astype(np.float32)
            t_x = _unit(rs, 12) if tx else None
            t_y = _unit(rs, 12) if ty else None
            out.append(pkg.HostMesh(pos, tri, texcoords=uv, tangent_x=t_x,
                                    tangent_y=t_y, material=k))
        return out

    state = rs.get_state()
    jpk = jmesh.pack_meshes(meshes(jmesh))
    rs.set_state(state)
    pk = mesh.pack_meshes(meshes(mesh))
    for k in ('ptx', 'pty'):
        np.testing.assert_array_equal(getattr(pk, k), getattr(jpk, k))

    def table(pkg, p):
        keys = ('v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id',
                'illum_mask', 'shadow_mask', 'ptx', 'pty')
        return pkg.add_shade_table({k: getattr(p, k) for k in keys})

    got, ref = table(mesh, pk), table(jmesh, jpk)
    np.testing.assert_array_equal(got['shade_tab'], ref['shade_tab'])
    assert 'ptx' not in got
    plain = mesh.add_shade_table({k: getattr(pk, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id',
        'illum_mask', 'shadow_mask')})['shade_tab']
    authored = np.isfinite(pk.ptx).all(axis=1)
    assert authored[:20].all() and not authored[20:].any()
    assert not np.allclose(got['shade_tab'][:20, 22:], plain[:20, 22:])
    np.testing.assert_array_equal(got['shade_tab'][20:], plain[20:])


# ----------------------------------------------------------- materials probe

def _trimmed_psnr(a, b, trim=0.01):
    """PSNR over the pixels left after dropping the trim share with the
    largest squared error."""
    err = ((a - b) ** 2).mean(axis=-1).ravel()
    keep = np.sort(err)[: int(len(err) * (1 - trim))]
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(keep.mean(), 1e-20))


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


@pytest.mark.parametrize('name', PRESETS)
def test_materials_probe_matches_jax_render(name):
    """The probe at 16^2, 4 spp, depth 4 through both packages: >= 60 dB
    with equal ray counts, every preset (the delta-specular ones, whose
    chains amplify float association (ROADMAP C4), included)."""
    sc = materials_probe(name, bs, mat, mesh).commit(device='cpu')
    js = materials_probe(name, jbs, jmat, jmesh).commit()
    assert sc.lobe_types == js.lobe_types
    for grp in ('geom', 'materials', 'textures'):
        for k, v in getattr(sc, grp).items():
            np.testing.assert_array_equal(v.numpy(),
                                          _np(getattr(js, grp)[k]))
    cam_t, cam_j = bs.cornell_camera(16, 16), jbs.cornell_camera(16, 16)
    film, stats = renderer.render_frame(sc, cam_t, pt.PTParams(max_depth=4),
                                        16, 16, spp=4, seed=42)
    img = accum.resolve(film).numpy()
    jfilm, jstats = jrenderer.render_frame(js, cam_j,
                                           jpt.PTParams(max_depth=4), 16, 16,
                                           spp=4, seed=42)
    ref = _np(jaccum.resolve(jfilm))
    assert np.isfinite(img).all() and img.shape == ref.shape
    db, trimmed = _psnr(img, ref), _trimmed_psnr(img, ref)
    print(f"{name}: {db:.2f} dB, trimmed-1% {trimmed:.2f} dB, "
          f"{stats.num_rays:.0f} rays (JAX {jstats.num_rays:.0f})")
    assert db >= 60.0, (db, trimmed)
    assert stats.num_rays == jstats.num_rays
