"""The torch port's CUDA kernels on the card: each held against its plain
torch version, and the cornell golden rendered through them.

Every test here is marked `cuda` and skips without a CUDA device.  The
file imports no jax, so it also runs on a GPU machine without JAX (where
tests/conftest.py, which configures jax, cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import dense, wide
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'golden')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device('cuda')


def _tables_and_rays(dev, n=1000):
    """Packed rows and BVH4 nodes of a sphere over a floor with one culled
    triangle (leaf 8), and n random rays with dead and finite lanes."""
    packed = mesh.pack_meshes([
        primitives.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        primitives.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5],
                        [-5, -1.2, 5]),
        primitives.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                                   cull=mesh.CULL_BACK)], pad_multiple=64)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=8)
    host = bvh.permute_geom({k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'cull', 'valid')}, tree.order)
    woop = mesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                              host['valid'])
    rs = np.random.RandomState(5)
    d = rs.randn(n, 3).astype(np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::7] = -1.0
    tf[3::7] = 2.5
    rays = [(rs.randn(n, 3) * 3).astype(np.float32),
            d / np.linalg.norm(d, axis=1, keepdims=True),
            np.full((n,), 1e-4, np.float32), tf]
    return (torch.as_tensor(wide.pack_tris(woop, host)).to(dev),
            torch.as_tensor(wide.pack_nodes4(tree)).to(dev),
            [torch.as_tensor(x).to(dev) for x in rays])


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['dense', 'wide'])
def test_kernels_match_plain_on_card(cuda, which):
    tris, nodes4, rays = _tables_and_rays(cuda)
    if which == 'dense':
        pairs = ((dense.intersect_dense, dense.intersect_dense_plain),
                 (dense.occluded_dense, dense.occluded_dense_plain))
        tables = (tris,)
    else:
        pairs = ((wide.intersect_packet4, wide.intersect_wide_plain),
                 (wide.occluded_packet4, wide.occluded_wide_plain))
        tables = (nodes4, tris)
    (kc, pc), (ka, pa) = pairs
    launches = kc.launches
    got, ref = kc(*tables, *rays), pc(*tables, *rays)
    torch.cuda.synchronize()
    assert kc.launches == launches + 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(ka(*tables, *rays).cpu().numpy(),
                                  pa(*tables, *rays).cpu().numpy())


@pytest.mark.cuda
def test_kernel_rejects_tables_off_the_card(cuda):
    tris, _, rays = _tables_and_rays(cuda)
    with pytest.raises(ValueError):
        dense.intersect_dense(tris.cpu(), *rays)


@pytest.mark.cuda
def test_cornell_golden_on_card(cuda):
    before = (dense.intersect_dense.launches, dense.occluded_dense.launches,
              dense.intersect_dense_plain.cuda_calls)
    film, _ = renderer.render_frame(
        bs.cornell_box().commit(device=cuda), bs.cornell_camera(64, 64),
        pt.PTParams(max_depth=4), 64, 64, spp=32, seed=42)
    img = accum.resolve(film).cpu().numpy()
    golden = np.load(os.path.join(GOLDEN, 'cornell_64_cpu.npz'))['img']
    mse = ((img - golden) ** 2).mean()
    assert 10 * np.log10(img.max() ** 2 / max(mse, 1e-20)) >= 40.0
    assert dense.intersect_dense.launches > before[0]
    assert dense.occluded_dense.launches > before[1]
    assert dense.intersect_dense_plain.cuda_calls == before[2]
