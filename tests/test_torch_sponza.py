"""sponza_like through the torch port on the CPU: its committed tables
against the JAX package's commit, a reduced sponza rendered by both
packages, and the sponza_64 golden."""
import os

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.shading import lobes as lb
from yulio_raytracer_tpu_torch.shading import materials as mat
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.film import accum

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'assets', 'golden')
REDUCED = dict(stories=1, cols_x=4, cols_z=2, clutter=8)


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _numpy_scene(js):
    """A committed JAX scene's arrays as from_numpy_scene takes them."""
    def np_(d):
        return {k: np_(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in (d or {}).items()}
    lights = [{k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
               for k, v in l.items()} for l in js.lights]
    return dict(geom=np_(js.geom), packet=np_(js.packet),
                materials=np_(js.materials), textures=np_(js.textures),
                lights=lights, leaf_size=js.leaf_size, bbox_lo=js.bbox_lo,
                bbox_hi=js.bbox_hi, num_triangles=js.num_triangles,
                lobe_types=js.lobe_types, accel=js.accel, device='cpu')


def _tables(sc):
    """The arrays both packages commit alike: the shading, material and
    texture tables, the packed triangle rows and the BVH4 rows."""
    out = {'shade_tab': sc.geom['shade_tab'], 'nodes4': sc.nodes4,
           'tris': sc.tris}
    out.update({f'materials.{k}': v for k, v in sc.materials.items()})
    out.update({f'textures.{k}': v for k, v in sc.textures.items()})
    return out


def test_sponza_commit_matches_jax():
    """sponza_like at its defaults, leaf 32: 238,208 triangles, 269
    materials, 20 textures in an 81,920-texel atlas; every table equals the
    reference commit's, and from_numpy_scene of that commit carries the
    same tables and static facts."""
    own = bs.sponza_like().commit(device='cpu', leaf_size=32)
    js = jbs.sponza_like().commit(leaf_size=32)
    assert (own.num_triangles, own.accel, own.lobe_types) == (
        238208, 'bvh4', (lb.LAMBERTIAN, lb.DIELECTRIC_LAYER_LAMB,
                         lb.MICROFACET_DIELECTRIC))
    assert own.materials['mat_tab'].shape == (269, 78)
    assert own.textures['data'].shape == (81920, 4)
    assert (own.tex_modes, own.bump) == ((mat.TEX_NONE, mat.TEX_MUL_RGB),
                                         False)
    for k in ('leaf_size', 'num_triangles', 'lobe_types', 'accel',
              'bbox_lo', 'bbox_hi'):
        assert getattr(own, k) == getattr(js, k), k
    ref = {'shade_tab': js.geom['shade_tab'],
           'nodes4': js.packet['nodes4'], 'tris': js.packet['tris']}
    ref.update({f'materials.{k}': v for k, v in js.materials.items()})
    ref.update({f'textures.{k}': v for k, v in js.textures.items()})
    got = _tables(own)
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = np.asarray(ref[k])
        if k == 'tris':
            # the reference's rows end in zero rows only its TPU kernels
            # read
            assert not r[v.shape[0]:].any()
            r = r[:v.shape[0]]
        assert v.numpy().dtype == r.dtype, k
        np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
    carried = tscene.from_numpy_scene(**_numpy_scene(js))
    for k in ('lobe_types', 'accel', 'tex_modes', 'bump'):
        assert getattr(carried, k) == getattr(own, k), k
    for k, v in _tables(carried).items():
        g = got[k]
        np.testing.assert_array_equal(v[:g.shape[0]].numpy(), g.numpy(),
                                      err_msg=k)


@pytest.mark.parametrize('binning', ['morton', 'grid'])
def test_reduced_sponza_matches_jax_render(binning):
    """A reduced sponza (one story, 4 x 2 columns, 8 clutter spheres) at
    16^2, 4 spp, depth 3 through both packages' CPU paths: >= 60 dB and
    equal ray counts; under 'grid' the port's bounces >= 1 take the grid
    rounds, the reference's CPU path its BVH walk."""
    sc = bs.sponza_like(**REDUCED).commit(device='cpu', leaf_size=32)
    js = jbs.sponza_like(**REDUCED).commit(leaf_size=32)
    assert sc.accel == js.accel == 'bvh4' and sc.grid is not None
    film, stats = renderer.render_frame(
        sc, bs.sponza_like_camera(16, 16),
        pt.PTParams(max_depth=3, ray_binning=binning), 16, 16, spp=4,
        seed=42)
    jfilm, jstats = jrenderer.render_frame(
        js, jbs.sponza_like_camera(16, 16),
        jpt.PTParams(max_depth=3, ray_binning=binning), 16, 16, spp=4,
        seed=42)
    img, ref = accum.resolve(film).numpy(), np.asarray(jaccum.resolve(jfilm))
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert _psnr(img, ref) >= 60.0
    assert stats.num_rays == jstats.num_rays


def test_sponza_matches_pinned_golden():
    """The sponza_64 golden (bench.py bench_psnr_hbm: leaf 32, 64^2,
    depth 2, 4 spp, seed 42) through the port's BVH4 path, at the JAX
    package's own bar."""
    sc = bs.sponza_like().commit(device='cpu', leaf_size=32)
    film, stats = renderer.render_frame(
        sc, bs.sponza_like_camera(64, 64), pt.PTParams(max_depth=2), 64, 64,
        spp=4, seed=42)
    img = accum.resolve(film).numpy()
    golden = np.load(os.path.join(GOLDEN, 'sponza_64_cpu.npz'))['img']
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert _psnr(img, golden) > 60.0
    assert stats.num_rays > 64 * 64 * 4
