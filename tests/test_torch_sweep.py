"""The dense-sweep layout prototype's port (yulio_raytracer_tpu_torch/
proto_sublane_sweep.py) held against the JAX script it ports,
scripts/proto_sublane_sweep.py: its `old_kernel` and `new_kernel` run in
interpret mode (as the JAX package's tests run Pallas kernels on the CPU)
against the port's plain versions, on the cornell box's packed rows and
32x32 of its camera rays (the script's random rows hit nothing).  Plain
torch emulations of the kernels' schedules (each lane's own best over
triangles 8 g + s and a lex-min over the 8 lanes, triangle slices
merged by the 64-bit key, a thread's two rays with a best each) are held
against the plain versions bit for bit, also on a table of duplicated
triangles, where equal t occur across lanes and slices.  The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda.py, which alone runs the kernels' own schedules.
The turns tool's loading of another checkout and its stage counts are
tested here on the CPU."""
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
from yulio_raytracer_tpu_torch import raysets, turns
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


# ------------------------------------------------- the kernels' schedules

def _loop(tris, idx, org, d, reps):
    """One thread's loop in csrc/sweep.cu: the triangles tris (k, 16),
    numbered idx, tested one at a time in order, `reps` times, a strictly
    nearer hit replacing the best; also the tests past the sign test and
    past the t window (as turns.stage_passes counts them)."""
    n = org.shape[0]
    t_b = torch.full((n,), float('inf'))
    tri_b = torch.full((n,), -1, dtype=torch.int32)
    passed = [0, 0]
    for _ in range(reps):
        for j in range(tris.shape[0]):
            w = tris[j:j + 1]
            th, ok = (x[:, 0] for x in sweep._proto_test(w, org, d, t_b))
            owp = (org * w[:, [2, 5, 8]]).sum(1) + w[0, 11]
            dwp = (d * w[:, [2, 5, 8]]).sum(1)
            sign = (dwp.abs() > 1e-12) & (owp * dwp < 0)
            passed[0] += int(sign.sum())
            passed[1] += int((sign & (th > 0) & (th < t_b)).sum())
            t_b = torch.where(ok, th, t_b)
            tri_b = torch.where(ok, int(idx[j]), tri_b)
    return t_b, tri_b, passed


def _keys(t, tri):
    """csrc/sweep.cu sweep_key of results (t, tri), as int64: t's bits
    above the triangle's."""
    hi = t.contiguous().view(torch.int32).to(torch.int64) << 32
    return hi | (tri.to(torch.int64) & 0xffffffff)


def _decode(keys):
    """(t, tri) of keys, as csrc/sweep.cu sweep_decode_kernel writes
    them."""
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    return t, (keys & 0xffffffff).to(torch.int32)


def _merge(results):
    """The least key over (t, tri) results, decoded: the kernels' merge
    across lanes (shuffles) and across slices (atomicMin)."""
    return _decode(torch.stack([_keys(t, tri) for t, tri in results])
                   .min(0).values)


def _slice_ranges(units, n_slices):
    """The units of each slice, as csrc/sweep.cu sweep_grid cuts them."""
    n_slices = max(1, min(n_slices, units))
    per = -(-units // n_slices)
    return [range(lo, min(units, lo + per)) for lo in range(0, units, per)]


def _lanes(tris, org, d, reps, units=None):
    """The tiles kernel: lane s over triangles 8 g + s of the super-tiles
    `units` (all by default), then the 8 lanes' lex-min."""
    idx = torch.arange(tris.shape[0])
    if units is not None:
        idx = idx[64 * units.start:64 * units.stop]
    return _merge([_loop(tris[idx[s::8]], idx[s::8], org, d, reps)[:2]
                   for s in range(8)])


def _schedule(name, tris, org, d, reps):
    """(t, tri) of the kernels' schedule `name` over triangles tris
    (T, 16), T a multiple of 64."""
    rows = tris.shape[0] // 8
    if name == 'lanes':
        return _lanes(tris, org, d, reps)
    if name == 'row slices':
        n = sweep.slices(128, org.shape[0], rows, sweep.MIN_SLICE['rows'],
                         132)
        assert n > 1
        return _merge([_loop(tris[8 * u.start:8 * u.stop],
                             torch.arange(8 * u.start, 8 * u.stop), org, d,
                             reps)[:2] for u in _slice_ranges(rows, n)])
    if name == 'tile slices':
        n = sweep.slices(16, org.shape[0], rows // 8,
                         sweep.MIN_SLICE['tiles'], 132)
        assert n > 1
        return _merge([_lanes(tris, org, d, reps, u)
                       for u in _slice_ranges(rows // 8, n)])
    assert name == 'two rays'
    return _two_rays(tris, org, d, reps)


def _two_rays(tris, org, d, reps):
    """The rows kernel's threads at SWEEP_ROWS_RAYS 2: thread x of the
    256-ray block b holds ray 256 b + x in slot 0 and 256 b + 128 + x in
    slot 1 (a zero ray past the last ray); one loop over the triangles
    loads each once and tests it against slot 0, then slot 1, each with
    its own best; a live slot's result goes to its ray."""
    n = org.shape[0]
    blocks = -(-n // 256)
    ray = ((torch.arange(blocks)[:, None, None] * 2
            + torch.arange(2)[None, :, None]) * 128
           + torch.arange(128)[None, None, :])
    ray = ray.permute(0, 2, 1).reshape(-1, 2)      # (threads, slot)
    live = ray < n
    safe = torch.where(live, ray, 0)
    o = torch.where(live[..., None], org[safe], 0.0)
    dd = torch.where(live[..., None], d[safe], 0.0)
    t_b = torch.full(ray.shape, float('inf'))
    tri_b = torch.full(ray.shape, -1, dtype=torch.int32)
    for _ in range(reps):
        for j in range(tris.shape[0]):
            w = tris[j:j + 1]
            for k in range(2):
                th, ok = (x[:, 0] for x in sweep._proto_test(
                    w, o[:, k], dd[:, k], t_b[:, k]))
                t_b[:, k] = torch.where(ok, th, t_b[:, k])
                tri_b[:, k] = torch.where(ok, j, tri_b[:, k])
    t = torch.full((n,), float('inf'))
    tri = torch.full((n,), -1, dtype=torch.int32)
    t[ray[live]] = t_b[live]
    tri[ray[live]] = tri_b[live]
    return t, tri


@pytest.fixture(scope='module')
def duplicated(cornell):
    """Cornell's 128 triangles, 3 zero triangles, the 128 again and 45
    zero triangles (304 = 38 rows, 4.75 super-tiles): triangle k and
    131 + k tie, in other lanes (131 % 8 = 3) and, for most slicings,
    other slices."""
    rows, org, d = cornell
    t16 = rows.reshape(-1, 16)
    z = torch.zeros(3, 16)
    return (torch.cat([t16, z, t16, torch.zeros(45, 16)]), org, d)


@pytest.mark.parametrize('reps', [1, 2])
@pytest.mark.parametrize('table', ['cornell', 'duplicated'])
@pytest.mark.parametrize('name', ['lanes', 'row slices', 'tile slices',
                                  'two rays'])
def test_kernel_schedules_match_the_plain_sweep(request, name, table, reps):
    """Each of the kernels' schedules gives the plain sweep's (t, tri) bit
    for bit: the least t and, among equal t, the lowest triangle."""
    tris, org, d = request.getfixturevalue(table)
    tris = tris.reshape(-1, 16)
    tris = torch.cat([tris, torch.zeros(-tris.shape[0] % 64, 16)])
    org, d = org[:300], d[:300]
    t, tri = sweep._sweep_plain(tris, org, d, reps)
    assert bool((tri >= 0).any())
    if table == 'duplicated':
        # every hit has its twin at the same t; the lower one is kept
        assert int(tri.max()) < 128
    t2, tri2 = _schedule(name, tris, org, d, reps)
    assert torch.equal(t, t2) and torch.equal(tri, tri2)


def test_sweep_keys_order_as_t_then_triangle():
    """The key round-trips (t, tri), orders hits as (t, tri) do, puts the
    miss key (inf, -1) above every hit, and decodes the miss key to
    (inf, -1)."""
    rs = np.random.RandomState(1)
    t = torch.as_tensor(np.concatenate([
        rs.rand(500) * 10.0 ** rs.randint(-30, 30, 500),
        [1e-45, 3.4e38, 1.0, 1.0, 1.0]]).astype(np.float32))
    tri = torch.as_tensor(np.concatenate([
        rs.randint(0, 1 << 31, 500), [0, (1 << 31) - 1, 0, 5, 1 << 20]])
        .astype(np.int32))
    keys = _keys(t, tri)
    back = _decode(keys)
    assert torch.equal(back[0], t) and torch.equal(back[1], tri)
    order = np.lexsort((tri.numpy(), t.numpy()))
    assert (np.diff(keys.numpy()[order]) > 0).all()
    assert int(keys.max()) < sweep.MISS_KEY
    miss = torch.tensor([sweep.MISS_KEY])
    assert torch.equal(_keys(torch.tensor([float('inf')]),
                             torch.tensor([-1], dtype=torch.int32)), miss)
    mt, mtri = _decode(miss)
    assert float(mt) == float('inf') and int(mtri) == -1


def test_slices_fill_the_card_only_when_rays_are_few():
    """One slice when the rays alone make 4 blocks a multiprocessor; else
    enough slices for that many blocks, none smaller than its minimum."""
    assert sweep.slices(128, 1 << 18, 512, 2, 132) == 1
    assert sweep.slices(128, 128 * 528, 512, 2, 132) == 1
    assert sweep.slices(128, 1024, 512, 2, 132) == 66
    assert sweep.slices(16, 128, 512, 1, 132) == 66
    assert sweep.slices(128, 100, 512, 2, 132) == 256
    assert sweep.slices(128, 100, 3, 2, 132) == 1
    assert sweep.slices(128, 0, 512, 2, 132) == 1


@pytest.mark.parametrize('reps', [1, 2])
def test_stage_passes_count_a_sequential_sweep(duplicated, reps):
    """turns.stage_passes' counts equal those of a loop over the
    triangles one at a time: the tests past the sign test, and those with
    0 < t < the best t before them."""
    tris, org, d = duplicated
    org, d = org[:200], d[:200]
    _, _, passed = _loop(tris, torch.arange(tris.shape[0]), org, d, reps)
    got = turns.stage_passes(tris, org, d, reps)
    assert got == {'pair': 200 * tris.shape[0] * reps, 'sign': passed[0],
                   'window': passed[1]}
    assert 0 < got['window'] < got['sign'] < got['pair']


def test_sweep_turns_runs_the_other_tree_through_its_wrappers(cornell):
    """`turns sweep` imports another checkout's sweep module under a package
    name of its own, bound to that checkout's csrc, and runs a set's call
    through its wrappers; one_slice sets SLICE_BLOCKS_PER_SM to 0 for the
    call and restores it.  The other tree is this checkout, on CPU
    tensors: the plain versions."""
    other = turns.other_sweep(ROOT)
    assert other is not sweep
    assert other.__name__ == '_other_yrt.proto_sublane_sweep'
    assert other.cb.CSRC == sweep.cb.CSRC
    rows, org, d = cornell
    tiles = sweep.supertiles(rows)
    ref = sweep.sweep_rows_plain(rows, org, d, 2)
    assert bool((ref[1] >= 0).any())
    for one in (False, True):
        for kind, switch, table in (('rows', False, rows),
                                    ('tiles', False, tiles),
                                    ('tiles', True, tiles)):
            got = turns.sweep_call(other, kind, switch, table, org, d, 2,
                                   one)
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])
    with turns.one_slice(other, True):
        assert other.slices(128, 100, 512, 2, 132) == 1
    assert other.SLICE_BLOCKS_PER_SM == sweep.SLICE_BLOCKS_PER_SM
    assert other.slices(128, 100, 512, 2, 132) == 256
