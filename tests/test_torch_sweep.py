"""The dense-sweep layout prototype's port (yulio_raytracer_tpu_torch/
proto_sublane_sweep.py) held against the JAX script it ports,
scripts/proto_sublane_sweep.py: its `old_kernel` and `new_kernel` run in
interpret mode (as the JAX package's tests run Pallas kernels on the CPU)
against the port's plain versions, on the cornell box's packed rows and
32x32 of its camera rays (the script's random rows hit nothing).  The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import importlib.util
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from yulio_raytracer_tpu_torch import proto_sublane_sweep as sweep
from yulio_raytracer_tpu_torch import raysets
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def proto():
    """scripts/proto_sublane_sweep.py as a module; the environment and
    sys.path it sets on import are restored."""
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location(
        'proto_sublane_sweep_script',
        os.path.join(ROOT, 'scripts', 'proto_sublane_sweep.py'))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


@pytest.fixture(scope='module')
def cornell():
    """The cornell box's 16 packed rows (128 triangles, 2 super-tiles) and
    1024 camera rays (32x32, seed 3)."""
    sc = bs.cornell_box().commit(device='cpu')
    org, d, _ = raysets.camera_rays(sc, bs.cornell_camera(32, 32), 32, 32,
                                    torch.device('cpu'), 3)
    assert sc.tris.shape == (16, 128) and org.shape == (1024, 3)
    return sc.tris, org, d


def _script(kernel, shape, table, org, d):
    """One `pl.pallas_call` of a script kernel as the script's `run`
    makes it (every operand whole in VMEM), in interpret mode."""
    f = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32),
                   jax.ShapeDtypeStruct(shape, jnp.int32)],
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 7,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        interpret=True)
    cols = [jnp.asarray(x[:, k].numpy().reshape(shape))
            for x in (org, d) for k in range(3)]
    t, tri = f(jnp.asarray(table.numpy()), *cols)
    return np.asarray(t).ravel(), np.asarray(tri).ravel()


def _script_sweep(proto, which, rows, org, d, reps):
    """The script's kernel `which` over all rays: 'old' takes the 1024
    rays in one call, 'new' and 'newsw' 128 a call on the super-tiles."""
    if which == 'old':
        return _script(partial(proto.old_kernel, rows=rows.shape[0],
                               reps=reps), (1024,), rows, org, d)
    tiles = sweep.supertiles(rows)
    kern = partial(proto.new_kernel, rows=tiles.shape[0] // 8, reps=reps,
                   switch=which == 'newsw')
    outs = [_script(kern, (1, 128), tiles, org[i:i + 128], d[i:i + 128])
            for i in range(0, org.shape[0], 128)]
    return tuple(np.concatenate(x) for x in zip(*outs))


@pytest.mark.parametrize('reps', [1, 2])
@pytest.mark.parametrize('which', ['old', 'new', 'newsw'])
def test_plain_sweeps_match_the_script(proto, cornell, which, reps):
    """The port's plain versions against the script's kernels on the same
    triangles and rays: hit masks equal, tri equal on >= 99.9% of rays
    (ties), t within rtol 1e-6 / atol 1e-7 where tri agrees (XLA's CPU
    backend may contract the Woop dot products into fused multiply-adds;
    the port never does)."""
    rows, org, d = cornell
    t0, tri0 = _script_sweep(proto, which, rows, org, d, reps)
    if which == 'old':
        t1, tri1 = sweep.sweep_rows(rows, org, d, reps)
    else:
        t1, tri1 = sweep.sweep_tiles(sweep.supertiles(rows), org, d, reps,
                                     which == 'newsw')
    t1, tri1 = t1.numpy(), tri1.numpy()
    np.testing.assert_array_equal(tri1 >= 0, tri0 >= 0)
    assert 0.5 < (tri0 >= 0).mean()
    assert (tri1 == tri0).mean() >= 0.999
    same = tri1 == tri0
    np.testing.assert_allclose(t1[same], t0[same], rtol=1e-6, atol=1e-7)
    assert np.isinf(t1[tri1 < 0]).all() and np.isinf(t0[tri0 < 0]).all()


@pytest.mark.parametrize('reps', [1, 2])
def test_layouts_agree_on_the_same_triangles(cornell, reps):
    """One ray per thread over the rows and 8 lanes per ray over their
    super-tiles find the same t and triangle, bit for bit, either way the
    groups are read."""
    rows, org, d = cornell
    t, tri = sweep.sweep_rows(rows, org, d, reps)
    assert bool((tri >= 0).any())
    for switch in (False, True):
        t2, tri2 = sweep.sweep_tiles(sweep.supertiles(rows), org, d, reps,
                                     switch)
        assert torch.equal(t, t2) and torch.equal(tri, tri2)


def test_sweep_rows_takes_any_ray_count(cornell):
    """1000 rays (not a multiple of the script's 1024 or 128) give the
    first 1000 results of 1024."""
    rows, org, d = cornell
    t, tri = sweep.sweep_rows(rows, org, d)
    t2, tri2 = sweep.sweep_rows(rows, org[:1000], d[:1000])
    assert torch.equal(t[:1000], t2) and torch.equal(tri[:1000], tri2)


def test_supertiles_pad_with_zero_triangles(cornell):
    """120 triangles (15 rows) pack into the super-tiles of the same rows
    with a zero row after them, which never hits: both layouts give the
    same result for the two."""
    rows, org, d = cornell
    padded = torch.cat([rows[:15], torch.zeros(1, 128)])
    tiles = sweep.supertiles(rows[:15])
    assert tiles.shape == (16, 128)
    assert torch.equal(tiles, sweep.supertiles(padded))
    assert torch.equal(sweep._tile_rows(tiles), padded.reshape(-1, 16))
    t, tri = sweep.sweep_rows(padded, org, d)
    assert bool((tri >= 0).any()) and int(tri.max()) < 120
    for got in (sweep.sweep_rows(rows[:15], org, d),
                sweep.sweep_tiles(tiles, org, d)):
        assert torch.equal(got[0], t) and torch.equal(got[1], tri)


def test_sweep_script_needs_a_card():
    """The module's main raises without a CUDA device, before it builds
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sweep.main(['--rows', '4'])


def test_sweep_module_never_imports_jax():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from yulio_raytracer_tpu_torch import proto_sublane_sweep as s\n"
        "rows = torch.rand(4, 128)\n"
        "t, tri = s.sweep_tiles(s.supertiles(rows), torch.rand(10, 3),\n"
        "                       torch.rand(10, 3))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'yulio_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
