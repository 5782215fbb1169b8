"""The torch port's pixel and triangle parallelism (parallel/sharding.py)
held against its own one-device film and the JAX package on the CPU.

Tolerances: a mesh's film bit-equal to the one-device film of the same
seed (each pixel's samples stay on one slot); >= 60 dB against the JAX
package's sharded renders; the triangle-sharded film within
test_parallel.py's bar against the one-device film (> 99.5% of pixels
within 1e-4, mean < 1e-3); the two-process gloo film bit-equal to the
one-process render_frame_sharded's.
"""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.parallel import sharding as jsharding

from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.api import output
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import ecs
from yulio_raytracer_tpu_torch.parallel import sharding

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {'px8': dict(devices=['cpu'] * 8),
          'px2_tri2': dict(devices=['cpu'] * 4, tri_parallel=2)}


def _psnr(a, b):
    mse = ((np.asarray(a, np.float64) - b) ** 2).mean()
    return 10 * np.log10(max(float(np.max(a)), 1e-9) ** 2 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def scene():
    return bs.cornell_box(with_boxes=False).commit(device='cpu')


@pytest.fixture(scope='module')
def jscene():
    return jbs.cornell_box(with_boxes=False).commit()


def _render(scene, mesh, w, h, spp, seed, **kw):
    """The film of `mesh` (render_frame for a pixel mesh,
    render_frame_sharded for a triangle axis)."""
    cam = bs.cornell_camera(w, h)
    params = pt.PTParams(max_depth=2)
    if mesh.shape['tri'] > 1:
        return sharding.render_frame_sharded(scene, cam, params, w, h, spp,
                                             mesh, seed=seed, **kw)
    film, _ = renderer.render_frame(scene, cam, params, w, h, spp,
                                    seed=seed, mesh=mesh, **kw)
    return film


def test_make_mesh_shapes_and_refusals():
    m = sharding.make_mesh(devices=['cpu'] * 8, tri_parallel=2)
    assert m.shape == {'px': 4, 'tri': 2}
    assert len(m.slots) == 4 and m.slots[1] == (torch.device('cpu'),) * 2
    assert sharding.make_mesh(3, devices=['cpu'] * 8).shape['px'] == 3
    with pytest.raises(ValueError):
        sharding.make_mesh(devices=['cpu'] * 3, tri_parallel=2)
    with pytest.raises(ValueError):
        sharding.make_mesh(9, devices=['cpu'] * 8)
    if torch.cuda.device_count() == 0:
        # the cards by default: none here, and none falls back to the CPU
        with pytest.raises(RuntimeError):
            sharding.make_mesh()
        with pytest.raises(RuntimeError):
            sharding.make_mesh(devices=['cuda:0'] * 2)
    else:
        with pytest.raises(ValueError):
            sharding.make_mesh(torch.cuda.device_count() + 1)


@pytest.mark.parametrize('name', sorted(MESHES))
@pytest.mark.parametrize('size', [(32, 32), (37, 13)])
def test_mesh_film_bit_equal_to_one_device(scene, name, size):
    """The mesh's film equals the one-device film bit for bit; progress
    reaches 1.0, the rays counted are the one device's and the padding's,
    and a stop before the first pass leaves the film zero."""
    w, h = size
    mesh = sharding.make_mesh(**MESHES[name])
    ref, st_ref = renderer.render_frame(scene, bs.cornell_camera(w, h),
                                        pt.PTParams(max_depth=2), w, h, 2,
                                        seed=5)
    if mesh.shape['tri'] == 1:
        fracs = []
        film, st = renderer.render_frame(
            scene, bs.cornell_camera(w, h), pt.PTParams(max_depth=2), w, h,
            2, seed=5, mesh=mesh, progress_cb=fracs.append)
        assert fracs and fracs[-1] == 1.0
        # the padding's rays are traced, and counted, too
        assert st.num_rays >= st_ref.num_rays
        assert (st.num_rays == st_ref.num_rays) == (w * h % 8 == 0)
        stopped, _ = renderer.render_frame(
            scene, bs.cornell_camera(w, h), pt.PTParams(max_depth=2), w, h,
            2, seed=5, mesh=mesh, stop_flag=lambda: True)
        assert float(stopped.rgb_sum.abs().sum()) == 0.0
    else:
        film = _render(scene, mesh, w, h, 2, 5)
    assert torch.equal(film.rgb_sum, ref.rgb_sum)
    assert torch.equal(film.weight, ref.weight)


@pytest.mark.parametrize('size', [(32, 32), (37, 13)])
def test_mesh_matches_jax_sharded(scene, jscene, size):
    """Both meshes against the JAX package's render_frame(mesh=) and
    render_frame_sharded on its 8 CPU devices (>= 60 dB)."""
    w, h = size
    jcam, jparams = jbs.cornell_camera(w, h), jpt.PTParams(max_depth=2)
    jfilm, _ = jrenderer.render_frame(jscene, jcam, jparams, w, h, 2, seed=5,
                                      mesh=jsharding.make_mesh(8))
    jsh = jsharding.render_frame_sharded(jscene, jcam, jparams, w, h, 2,
                                         mesh=jsharding.make_mesh(8), seed=5)
    for name, kw in MESHES.items():
        film = _render(scene, sharding.make_mesh(**kw), w, h, 2, 5)
        for ref in (jfilm, jsh):
            db = _psnr(film.rgb_sum.numpy(), np.asarray(ref.rgb_sum))
            assert db >= 60.0, (name, db)


def test_tri_sharded_meets_jax_bar(scene):
    """Against the one-device film, the bar of the JAX package's
    test_tri_sharded_matches_single, at its seed and over 4 shards."""
    ref, _ = renderer.render_frame(scene, bs.cornell_camera(32, 32),
                                   pt.PTParams(max_depth=2), 32, 32, 2,
                                   seed=5)
    film = _render(scene, sharding.make_mesh(devices=['cpu'] * 8,
                                             tri_parallel=4), 32, 32, 2, 5)
    a, b = accum.resolve(ref).numpy(), accum.resolve(film).numpy()
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-4).mean() > 0.995, (d > 1e-4).sum()
    assert d.mean() < 1e-3


def test_shard_triangles_offsets(scene):
    """Shards are contiguous runs of whole 128-float rows covering every
    triangle in order, each starting at its first triangle's id."""
    shards = sharding.shard_triangles(scene, [torch.device('cpu')] * 3)
    rows = torch.cat([r.reshape(-1, 16) for _, r in shards])
    n = scene.tris.reshape(-1, 16).shape[0]
    assert torch.equal(rows[:n], scene.tris.reshape(-1, 16))
    assert not rows[n:].any()
    starts = [s for s, _ in shards]
    assert starts[0] == 0 and all(
        b - a == shards[0][1].shape[0] * 8 for a, b in zip(starts, starts[1:]))


def test_padded_odd_size_and_accumulation(scene):
    """18 x 14 pixels do not divide 8 slots: the padding renders and is
    dropped; a second frame adds to the film (weight 4)."""
    mesh = sharding.make_mesh(devices=['cpu'] * 8)
    f1 = sharding.render_frame_sharded(scene, bs.cornell_camera(18, 14),
                                       pt.PTParams(max_depth=2), 18, 14, 1,
                                       mesh, seed=0)
    out = accum.resolve(f1).numpy()
    assert out.shape == (14, 18, 3) and np.isfinite(out).all()
    ref, _ = renderer.render_frame(scene, bs.cornell_camera(18, 14),
                                   pt.PTParams(max_depth=2), 18, 14, 1,
                                   seed=0)
    assert torch.equal(f1.rgb_sum, ref.rgb_sum)
    f2 = sharding.render_frame_sharded(scene, bs.cornell_camera(18, 14),
                                       pt.PTParams(max_depth=2), 18, 14, 1,
                                       mesh, film=f1, seed=0, iteration=1)
    assert float(f2.weight[0, 0]) == 2.0
    ref2, _ = renderer.render_frame(scene, bs.cornell_camera(18, 14),
                                    pt.PTParams(max_depth=2), 18, 14, 1,
                                    seed=0, film=ref, iteration=1)
    assert torch.equal(f2.rgb_sum, ref2.rgb_sum)


def test_render_frame_rejects_tri_axis(scene):
    mesh = sharding.make_mesh(devices=['cpu'] * 4, tri_parallel=2)
    with pytest.raises(ValueError):
        renderer.render_frame(scene, bs.cornell_camera(16, 16),
                              pt.PTParams(max_depth=2), 16, 16, 1, mesh=mesh)


def test_run_slots_threads_distinct_devices():
    """Tasks of one device run in turn on one thread; distinct devices
    on threads of their own; results in task order; an error raises."""
    a, b = torch.device('cpu', 0), torch.device('cpu', 1)
    seen = []
    lock = threading.Lock()
    # tasks 0 and 1 meet: they run at once, on two threads
    meet = threading.Barrier(2, timeout=30)

    def task(i):
        def run():
            if i in (0, 1):
                meet.wait()
            with lock:
                seen.append((i, threading.get_ident()))
            return i * i
        return run

    out = sharding.run_slots([(a, task(0)), (b, task(1)), (a, task(2))])
    assert out == [0, 1, 4]
    ids = dict(seen)
    assert ids[0] == ids[2] != ids[1]
    assert sharding.run_slots([(a, task(3)), (a, task(4))]) == [9, 16]

    def boom():
        raise KeyError('slot')
    with pytest.raises(KeyError):
        sharding.run_slots([(a, task(5)), (b, boom)])


def test_scene_to_copies_every_tensor(scene):
    """TorchScene.to: self on its own device; elsewhere every tensor
    copied and the static fields kept."""
    assert scene.to('cpu') is scene
    moved = scene.to(torch.device('cpu', 0))
    assert moved.device == torch.device('cpu', 0)
    assert torch.equal(moved.tris, scene.tris)
    assert moved.lights[0]['kind'] == scene.lights[0]['kind']
    assert (moved.accel, moved.num_triangles, moved.lobe_types) == (
        scene.accel, scene.num_triangles, scene.lobe_types)


def test_settings_mesh():
    """settings.devices: 1 one device; N > 1 N CPU slots on the CPU; 0
    and 1 no mesh there; on the card the visible cards cap N."""
    mk = lambda n: ecs.RenderSettings(devices=n)
    assert output.settings_mesh(mk(1), 'cpu') is None
    assert output.settings_mesh(mk(0), 'cpu') is None
    assert output.settings_mesh(mk(3), 'cpu').shape == {'px': 3, 'tri': 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            output.settings_mesh(mk(2))


def test_render_mono_devices_equals_one_device(scene):
    """render_mono with settings.devices = 4 on the CPU writes the image
    of one device."""
    st = ecs.RenderSettings(width=24, height=16, spp=2, depth=2,
                            cam_pos=(278.0, 273.0, -800.0),
                            cam_look_at=(278.0, 273.0, 0.0), fov=39.0)
    img1, _ = output.render_mono(scene, st, '', device='cpu')
    st.devices = 4
    img4, _ = output.render_mono(scene, st, '', device='cpu')
    assert np.array_equal(img1, img4)


CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
from yulio_raytracer_tpu_torch.parallel import sharding
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt

rank = int(sys.argv[1])
sharding.init_distributed(%(coord)r, num_processes=2, process_id=rank)
mesh = sharding.make_mesh(devices=['cpu'] * 2)
assert mesh.shape == {'px': 4, 'tri': 1} and mesh.rank == rank
assert torch.distributed.get_backend() == 'gloo'
scene = bs.cornell_box(with_boxes=False).commit(device='cpu')
film = sharding.render_frame_sharded(scene, bs.cornell_camera(16, 16),
                                     pt.PTParams(max_depth=2), 16, 16, 1,
                                     mesh, seed=3)
torch.save(film.rgb_sum, %(out)r + '.%%d' %% rank)
torch.distributed.destroy_process_group()
print('rank', rank, 'ok')
"""


def test_two_process_gloo_render(tmp_path, scene):
    """Two processes joined by init_distributed (gloo by default), two
    CPU slots each: every rank holds the whole film, bit-equal to one
    process's render_frame_sharded over 4 slots."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    out = str(tmp_path / 'film.pt')
    script = CHILD % dict(repo=REPO, coord=f'127.0.0.1:{port}', out=out)
    env = {k: v for k, v in os.environ.items()
           if k not in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE')}
    procs = [subprocess.Popen([sys.executable, '-c', script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    ref = sharding.render_frame_sharded(
        scene, bs.cornell_camera(16, 16), pt.PTParams(max_depth=2), 16, 16,
        1, sharding.make_mesh(devices=['cpu'] * 4), seed=3)
    for rank in range(2):
        assert torch.equal(torch.load(f'{out}.{rank}'), ref.rgb_sum)


def test_init_distributed_nccl_needs_a_card_per_process():
    """nccl is taken only when asked for, and refused before any group
    is joined where the processes outnumber the cards."""
    with pytest.raises(ValueError, match='nccl'):
        sharding.init_distributed('127.0.0.1:1', num_processes=2,
                                  process_id=0, backend='nccl')
    assert not torch.distributed.is_initialized()


def test_launch_counts_survive_threads():
    """cuda_build.bump, which every kernel's operator calls where it
    launches, loses no count when 16 threads bump one wrapper at once
    with the interpreter switching threads every microsecond."""
    from yulio_raytracer_tpu_torch.ops import cuda_build

    def wrapper():
        pass
    wrapper.launches = 0

    def work():
        for _ in range(2000):
            cuda_build.bump(wrapper)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000
