"""The torch port's stereo path held against the JAX package on the CPU:
the affine and rotation helpers, the disk sampler, the depth-of-field
camera, all 12 StereoCube faces of two rigs (toe-in off and on), and the
stereo_64 golden rendered through the port.

Camera rays are held per ray to 4 float32 ulps of the ray's largest
coordinate magnitude (arccos, cos and sin may differ by an ulp between
torch and XLA; the differences measured are at most ~1 such ulp)."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.core import math as jvm
from yulio_raytracer_tpu.sampling import shapesampler as jss
from yulio_raytracer_tpu.cameras import cameras as jcam
from yulio_raytracer_tpu.io import builtin_scenes as jbs

from yulio_raytracer_tpu_torch.core import math as vm
from yulio_raytracer_tpu_torch.sampling import shapesampler as ss
from yulio_raytracer_tpu_torch.cameras import cameras as cam
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'golden')
EPS32 = float(np.finfo(np.float32).eps)
ULPS = 4
# the two rigs: cornell_stereo_camera's and the production face's
# (bench.py bench_stereo_face)
RIGS = {
    'cornell': (((278.0, 273.0, 150.0), (278.0, 273.0, 559.0),
                 (0.0, 1.0, 0.0)), 10.0),
    'production': (((-9.0, 2.2, 0.0), (10.0, 1.6, 0.0), (0.0, 1.0, 0.0)),
                   0.05),
}


def _assert_rays_close(got, ref, ulps=ULPS):
    """Each ray's coordinates within ulps float32 ulps of its largest
    coordinate magnitude."""
    got, ref = got.cpu().numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max(axis=-1, keepdims=True) * EPS32 * ulps
    err = np.abs(got - ref)
    assert (err <= scale).all(), float((err / scale).max())


def _pixels():
    """A jittered 16 x 16 set and the exact centre."""
    rs = np.random.RandomState(16)
    yy, xx = np.mgrid[0:16, 0:16]
    grid = (np.stack([xx.ravel(), yy.ravel()], -1) + rs.rand(256, 2)) / 16
    return np.concatenate([grid, [[0.5, 0.5]]]).astype(np.float32)


def _affine(rs):
    a = rs.randn(4, 3).astype(np.float32)
    return a


@pytest.mark.parametrize('fn', ['xfm_point', 'affine_compose',
                                'affine_rotate', 'rotate_about_axis',
                                'smoothstep'])
def test_math_helpers_match(fn):
    """The five helpers on seeded inputs, within 4 ulps of each result's
    magnitude (1e-6 absolute for smoothstep in [0, 1])."""
    rs = np.random.RandomState(3)
    if fn == 'xfm_point':
        a, x = _affine(rs), rs.randn(500, 3).astype(np.float32)
        ref = jvm.xfm_point(jnp.asarray(a), jnp.asarray(x))
        got = vm.xfm_point(torch.as_tensor(a), torch.as_tensor(x))
    elif fn == 'affine_compose':
        a, b = _affine(rs), _affine(rs)
        ref = jvm.affine_compose(jnp.asarray(a), jnp.asarray(b))
        got = vm.affine_compose(torch.as_tensor(a), torch.as_tensor(b))
    elif fn == 'affine_rotate':
        c, ax = rs.randn(3).astype(np.float32), rs.randn(3).astype(np.float32)
        for deg in (90.0, 180.0, -90.0, 37.5):
            ang = np.float32(np.deg2rad(deg))
            ref = jvm.affine_rotate(jnp.asarray(c), jnp.asarray(ax),
                                    jnp.float32(ang))
            got = vm.affine_rotate(torch.as_tensor(c), torch.as_tensor(ax),
                                   torch.tensor(ang))
            _assert_rays_close(got, ref)
    elif fn == 'rotate_about_axis':
        v = rs.randn(500, 3).astype(np.float32)
        u = rs.randn(3).astype(np.float32)
        u /= np.linalg.norm(u)
        ang = rs.uniform(-np.pi, np.pi, 500).astype(np.float32)
        ref = jvm.rotate_about_axis(jnp.asarray(v), jnp.asarray(u),
                                    jnp.asarray(ang))
        got = vm.rotate_about_axis(torch.as_tensor(v), torch.as_tensor(u),
                                   torch.as_tensor(ang))
    else:
        x = rs.uniform(-20, 110, 1000).astype(np.float32)
        for e0, e1 in ((0.0, 1.0), (30.0, 90.0)):
            ref = np.asarray(jvm.smoothstep(e0, e1, jnp.asarray(x)))
            got = vm.smoothstep(e0, e1, torch.as_tensor(x)).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        return
    _assert_rays_close(got, ref)


def test_uniform_sample_disk_matches():
    """Disk points within 1e-6 (radius 2.5 and 0)."""
    u = np.random.RandomState(4).rand(10_000, 2).astype(np.float32)
    for radius in (2.5, 0.0):
        ref = np.asarray(jss.uniform_sample_disk(jnp.asarray(u), radius))
        got = ss.uniform_sample_disk(torch.as_tensor(u), radius).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_depth_of_field_rays_match():
    args = ((1.0, 2.0, -8.0), (0.5, 1.0, 3.0), (0.0, 1.0, 0.0))
    rs = np.random.RandomState(5)
    pix = rs.rand(2000, 2).astype(np.float32)
    lens = rs.rand(2000, 2).astype(np.float32)
    kw = dict(angle=50.0, aspect=1.25, lens_radius=0.3, focal_distance=6.0)
    ref = jcam.DepthOfField(jcam.look_at(*args), **kw).ray(
        jnp.asarray(pix), jnp.asarray(lens))
    got = cam.DepthOfField(cam.look_at(*args), **kw).ray(
        torch.as_tensor(pix), torch.as_tensor(lens))
    for g, r in zip(got, ref):
        _assert_rays_close(g, r)


@pytest.mark.parametrize('rig', sorted(RIGS))
@pytest.mark.parametrize('toe_in', [False, True])
@pytest.mark.parametrize('face', range(12))
def test_stereo_cube_rays_match(rig, toe_in, face):
    """Every face of the rig (both eyes, the GearVR up/down flips, the
    falloff past 30 degrees, the head rotation), on the jittered 16 x 16
    pixels and the face's exact centre (where an up/down face's in-face
    vector is zero)."""
    look, scale = RIGS[rig]
    pix = _pixels()
    ref = jcam.make_stereo_rig(jcam.look_at(*look), scene_scale=scale,
                               toe_in=toe_in)[face].ray(jnp.asarray(pix),
                                                        None)
    got = cam.make_stereo_rig(cam.look_at(*look), scene_scale=scale,
                              toe_in=toe_in)[face].ray(torch.as_tensor(pix),
                                                       None)
    for g, r in zip(got, ref):
        _assert_rays_close(g, r)


def test_cornell_stereo_camera_matches():
    ref = jbs.cornell_stereo_camera(64, 64)
    got = bs.cornell_stereo_camera(64, 64)
    assert got.cube_face_index == ref.cube_face_index == 7
    pix = _pixels()
    for g, r in zip(got.ray(torch.as_tensor(pix), None),
                    ref.ray(jnp.asarray(pix), None)):
        _assert_rays_close(g, r)


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def test_stereo_matches_pinned_golden():
    """The stereo_64 golden (cornell, face 7, depth 2, 8 spp, seed 42)
    through the port's dense path, at the JAX test's own bar."""
    film, stats = renderer.render_frame(
        bs.cornell_box().commit(device='cpu'), bs.cornell_stereo_camera(64, 64),
        pt.PTParams(max_depth=2), 64, 64, spp=8, seed=42)
    img = accum.resolve(film).numpy()
    golden = np.load(os.path.join(GOLDEN, 'stereo_64_cpu.npz'))['img']
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert _psnr(img, golden) > 60.0
    assert stats.num_rays > 64 * 64 * 8
