"""The torch port's RNG, sampling, camera, shading and light functions held
against the JAX package on the same numpy inputs."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.core import rng as jrng
from yulio_raytracer_tpu.sampling import patterns as jpat
from yulio_raytracer_tpu.sampling import shapesampler as jss
from yulio_raytracer_tpu.cameras import cameras as jcam
from yulio_raytracer_tpu.shading import lobes as jlb
from yulio_raytracer_tpu.shading import materials as jmat
from yulio_raytracer_tpu.lights import lights as jlights
from yulio_raytracer_tpu.film import tonemap as jtm

from yulio_raytracer_tpu_torch.core import rng
from yulio_raytracer_tpu_torch.sampling import patterns, shapesampler as ss
from yulio_raytracer_tpu_torch.cameras import cameras as cam
from yulio_raytracer_tpu_torch.shading import lobes as lb, materials as mat
from yulio_raytracer_tpu_torch.lights import lights
from yulio_raytracer_tpu_torch.film import tonemap

torch.set_num_threads(2)
N = 100_000
ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'scenes')


def _keys(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2 ** 32, size=(4, N), dtype=np.uint64).astype(
        np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _u32(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_pcg4d_bits_match():
    k = _keys()
    ref = jrng.pcg4d(*(jnp.asarray(x) for x in k))
    got = rng.pcg4d(*(_u32(x) for x in k))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize('fn', ['uniform1', 'uniform2', 'uniform3'])
def test_uniform_bits_match(fn):
    k = _keys(1)
    ref = np.asarray(getattr(jrng, fn)(*(jnp.asarray(x) for x in k)))
    got = getattr(rng, fn)(*(_u32(x) for x in k)).numpy()
    assert ref.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize('spp', [1, 8, 32, 7])
def test_pixel_sample_matches(spp):
    rs = np.random.RandomState(spp)
    pid = rs.randint(0, 1 << 20, size=4096).astype(np.uint32)
    sid = rs.randint(0, 1 << 31, size=4096).astype(np.uint32)
    ref = jpat.pixel_sample(np.uint32(42), jnp.asarray(pid), jnp.asarray(sid),
                            jpat.grid_scalars(spp), 0)
    got = patterns.pixel_sample(42, _u32(pid), _u32(sid),
                                patterns.grid_scalars(spp), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_pinhole_ray_matches():
    rs = np.random.RandomState(3)
    uv = rs.rand(4096, 2).astype(np.float32)
    args = ((278.0, 273.0, -800.0), (278.0, 273.0, 0.0), (0.0, 1.0, 0.0))
    ref = jcam.Pinhole(jcam.look_at(*args), angle=37.0, aspect=1.5).ray(
        jnp.asarray(uv), None)
    got = cam.Pinhole(cam.look_at(*args), angle=37.0, aspect=1.5).ray(
        _t(uv), None)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_shape_samplers_match():
    rs = np.random.RandomState(4)
    u, v = rs.rand(2, 4096).astype(np.float32)
    n = _unit(rs, 4096)
    for r, g in zip(jss.cosine_sample_hemisphere(u, v, jnp.asarray(n)),
                    ss.cosine_sample_hemisphere(_t(u), _t(v), _t(n))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    a, b, c = rs.randn(3, 3).astype(np.float32)
    ref = jss.uniform_sample_triangle(u, v, a, b, c)
    got = ss.uniform_sample_triangle(_t(u), _t(v), _t(a), _t(b), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for r, g in zip(jss.uniform_sample_sphere(u, v),
                    ss.uniform_sample_sphere(_t(u), _t(v))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    angle = np.float32(np.deg2rad(7.5))
    for r, g in zip(jss.uniform_sample_cone(u, v, angle),
                    ss.uniform_sample_cone(_t(u), _t(v), _t(angle))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _lambertian_lobes(rs, r):
    """Lobe arrays with one or two Lambertian slots per ray."""
    ltype = np.zeros((r, 4), np.int32)
    ltype[:, 0] = jlb.LAMBERTIAN
    ltype[: r // 2, 2] = jlb.LAMBERTIAN
    color = (rs.rand(r, 4, 3) * (ltype > 0)[..., None]).astype(np.float32)
    return {'type': ltype, 'color': color,
            'eta': np.ones((r, 4), np.float32),
            'exp': np.zeros((r, 4), np.float32)}


def test_lambertian_lobes_match():
    rs = np.random.RandomState(5)
    r = 4096
    lobes = _lambertian_lobes(rs, r)
    ns, wo, wi = _unit(rs, r), _unit(rs, r), _unit(rs, r)
    s2 = rs.rand(r, 2).astype(np.float32)
    s1 = rs.rand(r).astype(np.float32)
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    tl = {k: _t(v).to(torch.int64) if k == 'type' else _t(v)
          for k, v in lobes.items()}
    ref = jlb.sample_lobes(jl, jnp.asarray(ns), jnp.asarray(ns),
                           jnp.asarray(wo), jnp.asarray(s2), jnp.asarray(s1),
                           jlb.ALL, types_present=(jlb.LAMBERTIAN,))
    got = lb.sample_lobes(tl, _t(ns), _t(ns), _t(wo), _t(s2), _t(s1), lb.ALL,
                          types_present=(lb.LAMBERTIAN,))
    for k in ('wi', 'pdf', 'weight', 'eta'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    for k in ('type_bits', 'valid'):
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(ref[k]).astype(got[k].numpy().dtype))
    ref_e = jlb.eval_lobes(jl, jnp.asarray(ns), jnp.asarray(ns),
                           jnp.asarray(wo), jnp.asarray(wi), jlb.DIFFUSE)
    got_e = lb.eval_lobes(tl, _t(ns), _t(ns), _t(wo), _t(wi), lb.DIFFUSE)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), atol=1e-5)
    np.testing.assert_array_equal(
        lb.has_type(tl, lb.DIFFUSE).numpy(),
        np.asarray(jlb.has_type(jl, jlb.DIFFUSE)))


def test_shade_context_matches():
    specs = [jmat.make_material('matte', {'reflectance': c})
             for c in ((0.7, 0.6, 0.5), (0.1, 0.2, 0.3), (1.0, 1.0, 1.0))]
    tspecs = [mat.make_material('matte', {'reflectance': c})
              for c in ((0.7, 0.6, 0.5), (0.1, 0.2, 0.3), (1.0, 1.0, 1.0))]
    jtab = jmat.build_table(specs)
    ttab = mat.build_table(tspecs)
    for k, v in ttab.items():
        np.testing.assert_array_equal(v, np.asarray(jtab[k]), err_msg=k)
    from yulio_raytracer_tpu.shading import textures as jtex
    from yulio_raytracer_tpu_torch.shading import textures as ttex
    jtx = jtex.TextureTableBuilder().build()
    ttx = ttex.TextureTableBuilder().build()
    for k, v in ttx.items():
        np.testing.assert_array_equal(v, np.asarray(jtx[k]), err_msg=k)
    rs = np.random.RandomState(6)
    mid = rs.randint(-1, 3, size=512).astype(np.int32)
    eta = np.ones(512, np.float32)
    trans = np.ones((512, 3), np.float32)
    jl, jaux = jmat.shade_context(jtab, jtx, jnp.asarray(mid),
                                  jnp.zeros((512, 2)), jnp.asarray(eta),
                                  jnp.asarray(trans))
    tl, taux = mat.shade_context({k: _t(v) for k, v in ttab.items()},
                                 {k: _t(v) for k, v in ttx.items()},
                                 _t(mid).long(), torch.zeros((512, 2)),
                                 _t(eta), _t(trans),
                                 **dict(zip(('tex_modes', 'bump'),
                                            mat.table_gates(ttab))))
    for k in ('type', 'color', 'eta'):
        np.testing.assert_array_equal(tl[k].numpy(),
                                      np.asarray(jl[k]).astype(
                                          tl[k].numpy().dtype), err_msg=k)
    switch = _t(rs.rand(512) < 0.5)
    for g, r in zip(mat.next_medium(taux, switch, _t(eta), _t(trans)),
                    jmat.next_medium(jaux, jnp.asarray(switch.numpy()),
                                     jnp.asarray(eta), jnp.asarray(trans))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_triangle_light_matches():
    rs = np.random.RandomState(7)
    r = 4096
    v = rs.randn(3, 3) * 2
    jl = jlights.triangle(*v, L=(40.0, 38.0, 34.0))
    tl = {k: (_t(x) if isinstance(x, np.ndarray) else x)
          for k, x in lights.triangle(*v, L=(40.0, 38.0, 34.0)).items()}
    for k, x in tl.items():
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), jl[k])
    p = (rs.randn(r, 3) * 3).astype(np.float32)
    ns = _unit(rs, r)
    u2 = rs.rand(r, 2).astype(np.float32)
    ref = jlights.sample(jl, jnp.asarray(p), jnp.asarray(ns), jnp.asarray(u2))
    got = lights.sample(tl, _t(p), _t(ns), _t(u2))
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)
    back = rs.rand(r) < 0.5
    np.testing.assert_array_equal(
        lights.le_area(tl, _t(back)).numpy(),
        np.asarray(jlights.le_area(jl, jnp.asarray(back))))


def test_tonemap_matches():
    rgb = np.random.RandomState(8).rand(16, 24, 3).astype(np.float32) * 2
    for gamma, vig in ((1.0, False), (2.2, True)):
        ref = jtm.tonemap(jnp.asarray(rgb), gamma, vig)
        got = tonemap.tonemap(_t(rgb), gamma, vig)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_array_equal(tonemap.to_srgb_u8(got).numpy(),
                                      np.asarray(jtm.to_srgb_u8(ref)))


@pytest.mark.parametrize('make', [
    lambda: lights.le_area(lights.ambient((1, 1, 1)), None),
])
def test_unported_features_raise(make):
    with pytest.raises(NotImplementedError):
        make()
