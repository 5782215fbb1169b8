"""The torch port's whole slice: render_frame against the pinned CPU golden
and against the JAX package's render_frame, pass-size independence, and an
import check that the port never loads jax."""
import os
import subprocess
import sys

import numpy as np
import torch

from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'assets', 'golden')
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _render(scene, cam, depth, res, spp):
    film, stats = renderer.render_frame(scene, cam, pt.PTParams(
        max_depth=depth), res, res, spp=spp, seed=42)
    return accum.resolve(film).cpu().numpy(), stats


def test_cornell_matches_pinned_golden():
    """The cornell golden (depth 4, 32 spp, seed 42) through the dense
    path, at the JAX package's own bar (tests/test_golden.py)."""
    img, stats = _render(bs.cornell_box().commit(device='cpu'),
                         bs.cornell_camera(64, 64),
                         4, 64, 32)
    golden = np.load(os.path.join(GOLDEN, 'cornell_64_cpu.npz'))['img']
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert _psnr(img, golden) > 60.0
    assert stats.num_rays > 64 * 64 * 32


def test_colonnade_matches_jax_render():
    """The reduced colonnade through the BVH4 path against the JAX
    package's CPU render (Moller-Trumbore BVH traversal there, Woop here:
    float-level differences only)."""
    img, stats = _render(bs.colonnade(**COLONNADE_SMALL).commit(
        device='cpu', leaf_size=32),
                         bs.colonnade_camera(32, 32), 3, 32, 2)
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    jfilm, jstats = jrenderer.render_frame(
        js, jbs.colonnade_camera(32, 32), jpt.PTParams(max_depth=3), 32, 32,
        spp=2, seed=42)
    ref = np.asarray(jaccum.resolve(jfilm))
    assert _psnr(img, ref) >= 60.0
    assert stats.num_rays == jstats.num_rays


def test_render_independent_of_pass_size(monkeypatch):
    """Cutting the frame into other passes (sample folds, pixel splits)
    changes only the order of the per-pixel sums."""
    sc = bs.cornell_box().commit(device='cpu')
    cam = bs.cornell_camera(16, 16)
    ref, rstats = _render(sc, cam, 3, 16, 6)
    for max_rays in (16 * 16 * 4, 100):       # folds of 4 + 2; pixel splits
        monkeypatch.setattr(renderer, 'MAX_RAYS_PER_PASS', max_rays)
        film, stats = renderer.render_frame(
            sc, cam, pt.PTParams(max_depth=3), 16, 16, spp=6, seed=42)
        np.testing.assert_allclose(accum.resolve(film).numpy(), ref,
                                   rtol=1e-5, atol=1e-6)
        assert stats.num_rays == rstats.num_rays


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from yulio_raytracer_tpu_torch.io import builtin_scenes as bs\n"
        "from yulio_raytracer_tpu_torch.integrator import pathtracer as pt\n"
        "from yulio_raytracer_tpu_torch import renderer\n"
        "sc = bs.cornell_box().commit(device='cpu')\n"
        "renderer.render_frame(sc, bs.cornell_camera(8, 8),\n"
        "                      pt.PTParams(max_depth=2), 8, 8, spp=1)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'yulio_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
