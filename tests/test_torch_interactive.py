"""The torch port's interactive and debugging layer on the CPU, held
against the JAX package on the same seeded inputs: `renderer.pick` (hit
flags equal, points within 1e-5 of the scene's extent), the debug
renderer (colours in {0, 1}, >= 99% of pixels equal, rays within 1%),
the random-scene fuzzer (staged scenes equal; renders >= 60 dB, or
trimmed-1% >= 60 where a glass or mirror chain flips a sample, ROADMAP
C4), `utils/profiling.py`, the display loop, the web viewer (its camera
controller in float64 to rtol 1e-12, its PNG frames), the CLI's
`-display`, `-viewer` and `-regression`, and `io/image.store`'s PNG
writer."""
import base64
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.api import cli as jcli
from yulio_raytracer_tpu.api import display as jdisplay
from yulio_raytracer_tpu.api import viewer as jviewer
from yulio_raytracer_tpu.cameras import cameras as jcam
from yulio_raytracer_tpu.film import accum as jaccum
from yulio_raytracer_tpu.integrator import debugrenderer as jdbg
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.utils import profiling as jprofiling
from yulio_raytracer_tpu.utils import regression as jregression

from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.api import cli, display, viewer
from yulio_raytracer_tpu_torch.cameras import cameras as cam
from yulio_raytracer_tpu_torch.film import accum, stereo_strip
from yulio_raytracer_tpu_torch.integrator import debugrenderer as dbg
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import image
from yulio_raytracer_tpu_torch.utils import profiling, regression

from test_torch_io import _trimmed_psnr, assert_builders_equal

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, 'assets', 'scenes')
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(b.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _orbit_cameras():
    """The regression tests' fixed view, in both packages."""
    args = ((0, 3, -12), (0, 0, 0), (0, 1, 0))
    return (cam.Pinhole(cam.look_at(*args), angle=60.0, aspect=1.0),
            jcam.Pinhole(jcam.look_at(*args), angle=60.0, aspect=1.0))


# ------------------------------------------------------------------ pick

@pytest.mark.parametrize('which', ['cornell', 'colonnade'])
def test_pick_matches_jax(which):
    """A grid of image points, some outside the image (misses on
    cornell): 9 x 9 through the dense kernels' plain versions (cornell),
    5 x 5 through the BVH4 ones (the reduced colonnade)."""
    if which == 'cornell':
        scene, jscene = (bs.cornell_box().commit(device='cpu'),
                         jbs.cornell_box().commit())
        c, jc = bs.cornell_camera(32, 32), jbs.cornell_camera(32, 32)
        grid = np.linspace(-0.3, 1.3, 9)
    else:
        scene = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                       leaf_size=32)
        jscene = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
        c, jc = bs.colonnade_camera(32, 32), jbs.colonnade_camera(32, 32)
        grid = np.linspace(0.05, 0.95, 5)
    extent = float(np.linalg.norm(np.subtract(scene.bbox_hi,
                                              scene.bbox_lo)))
    hits = 0
    for x in grid:
        for y in grid:
            ok, p = renderer.pick(scene, c, float(x), float(y))
            jok, jp = jrenderer.pick(jscene, jc, float(x), float(y))
            assert ok == jok, (x, y)
            assert p.shape == (3,) and p.dtype == np.float32
            np.testing.assert_allclose(p, np.asarray(jp), rtol=0,
                                       atol=1e-5 * extent)
            hits += ok
    assert 0 < hits and (hits < grid.size ** 2) == (which == 'cornell')


# ------------------------------------------------------- debug renderer

def test_debug_renderer_matches_jax():
    """The JAX package's test_regression.py scene: random scene 3, 16^2
    pixel-centre rays, 2 bounces (and 4)."""
    sb, jsb = (regression.create_random_scene(3),
               jregression.create_random_scene(3))
    scene, jscene = sb.commit(device='cpu'), jsb.commit()
    c, jc = _orbit_cameras()
    n = 256
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing='ij')
    uv = np.stack([(xs.ravel() + 0.5) / 16, (ys.ravel() + 0.5) / 16],
                  -1).astype(np.float32)
    org, d = c.ray(torch.as_tensor(uv), torch.full((n, 2), 0.5))
    jorg, jd = jc.ray(jnp.asarray(uv), jnp.full((n, 2), 0.5))
    for depth in (2, 4):
        color, nrays = dbg.trace(scene, dbg.DebugParams(max_depth=depth),
                                 org, d, 0, torch.arange(n))
        jcolor, jnrays = jdbg.trace(jscene, jdbg.DebugParams(max_depth=depth),
                                    jorg, jd, 0, jnp.arange(n,
                                                            dtype=jnp.uint32))
        c_np = color.numpy()
        assert set(np.unique(c_np)) <= {0.0, 1.0}
        assert np.mean(np.all(c_np == np.asarray(jcolor), -1)) >= 0.99
        assert abs(float(nrays) - float(jnrays)) <= 0.01 * float(jnrays)
        assert float(nrays) >= n


def test_debug_render_frame_matches_jax_trace(monkeypatch):
    """debugrenderer.render on the reduced colonnade (BVH4), 12 x 10, 3
    rays a pixel, depth 3, in passes of 100 rays: each pixel the mean of
    the JAX package's trace of its centre rays under the same keys
    (k * W * H + p)."""
    scene = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                   leaf_size=32)
    jscene = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    w, h, spp = 12, 10, 3
    monkeypatch.setattr(renderer, 'MAX_RAYS_PER_PASS', 100)
    img, stats = dbg.render(scene, bs.colonnade_camera(w, h),
                            dbg.DebugParams(max_depth=3, spp=spp), w, h,
                            seed=2)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    uv = np.stack([(xs.ravel() + 0.5) / w, (ys.ravel() + 0.5) / h],
                  -1).astype(np.float32)
    jorg, jd = jbs.colonnade_camera(w, h).ray(jnp.asarray(uv),
                                               jnp.full((w * h, 2), 0.5))
    ref, jrays = np.zeros((w * h, 3), np.float32), 0.0
    for k in range(spp):
        col, nr = jdbg.trace(jscene, jdbg.DebugParams(max_depth=3), jorg, jd,
                             2, jnp.arange(w * h, dtype=jnp.uint32)
                             + np.uint32(k * w * h))
        ref += np.asarray(col)
        jrays += float(nr)
    ref = (ref / spp).reshape(h, w, 3)
    assert img.shape == (h, w, 3)
    assert np.mean(np.abs(img.numpy() - ref) < 1e-6) >= 0.99
    assert abs(stats.num_rays - jrays) <= 0.01 * jrays
    assert stats.seconds > 0


# ------------------------------------------------------------- fuzzer

@pytest.mark.parametrize('seed', range(8))
def test_random_scene_matches_jax(seed):
    """create_random_scene(seed): meshes, materials, textures and lights
    equal to the JAX builder's; the render (16^2, 2 spp, depth 3) >= 60 dB
    against the JAX render, or trimmed-1% >= 60 (C4), rays within
    0.5%."""
    sb, jsb = (regression.create_random_scene(seed),
               jregression.create_random_scene(seed))
    assert_builders_equal(sb, jsb)
    c, jc = _orbit_cameras()
    film, stats = renderer.render_frame(sb.commit(device='cpu'), c,
                                        pt.PTParams(max_depth=3), 16, 16,
                                        spp=2, seed=seed)
    jfilm, jstats = jrenderer.render_frame(jsb.commit(), jc,
                                           jpt.PTParams(max_depth=3), 16, 16,
                                           spp=2, seed=seed)
    img, ref = accum.resolve(film).numpy(), np.asarray(jaccum.resolve(jfilm))
    assert np.isfinite(img).all() and (img >= 0).all()
    assert _psnr(img, ref) >= 60.0 or _trimmed_psnr(img, ref) >= 60.0
    assert abs(stats.num_rays - jstats.num_rays) <= 0.005 * jstats.num_rays


def test_random_scene_binary_bvh_matches_jax():
    """The JAX package's BVH-against-brute scene (seed 11, 6 shapes)
    committed with force_bvh at leaf 16 and accel 'bvh2' (the binary
    walk): >= 60 dB against the JAX render of the same tree."""
    sb, jsb = (regression.create_random_scene(11, num_shapes=6),
               jregression.create_random_scene(11, num_shapes=6))
    scene = sb.commit(device='cpu', force_bvh=True, leaf_size=16,
                      accel='bvh2')
    assert scene.accel == 'bvh2'
    c, jc = _orbit_cameras()
    film, _ = renderer.render_frame(scene, c, pt.PTParams(max_depth=2), 16,
                                    16, spp=2, seed=0)
    jfilm, _ = jrenderer.render_frame(
        jsb.commit(force_bvh=True, leaf_size=16, accel='bvh2'), jc,
        jpt.PTParams(max_depth=2), 16, 16, spp=2, seed=0)
    img, ref = accum.resolve(film).numpy(), np.asarray(jaccum.resolve(jfilm))
    assert _psnr(img, ref) >= 60.0 or _trimmed_psnr(img, ref) >= 60.0


# ----------------------------------------------------------- profiling

def test_commit_stats_match_jax():
    """CommitStats' fields: the JAX package's less packet_hbm; equal
    counts on cornell (dense) and its forced BVH at leaf 8; the port
    fills bvh_seconds where it built a tree."""
    names = [f for f in jprofiling.CommitStats.__dataclass_fields__
             if f != 'packet_hbm']
    assert list(profiling.CommitStats.__dataclass_fields__) == names
    for kw in ({}, {'force_bvh': True, 'leaf_size': 8}):
        scene, st = profiling.committed_stats(bs.cornell_box(), device='cpu',
                                              **kw)
        _, jst = jprofiling.committed_stats(jbs.cornell_box(), **kw)
        for f in ('triangles', 'bvh_nodes', 'leaf_size'):
            assert getattr(st, f) == getattr(jst, f), f
        assert st.total_seconds >= st.bvh_seconds
        assert (st.bvh_seconds > 0) == bool(kw) and st.total_seconds > 0
        assert st.triangles == scene.num_triangles
    assert st.bvh_nodes > 1 and st.leaf_size == 8


def test_profiling_trace_names_the_ranges(tmp_path):
    """trace() writes a Chrome trace of a render that names the bounce's
    yrt.* ranges and a span of its own; a second trace does not overwrite
    the first."""
    scene = bs.cornell_box().commit(device='cpu')
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span('yrt.test_frame'):
            renderer.render_frame(scene, bs.cornell_camera(8, 8),
                                  pt.PTParams(max_depth=2), 8, 8, spp=1)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'yrt.test_frame', pt.SPAN_SHADE, pt.SPAN_LOBES} <= names
    with profiling.trace(str(tmp_path)) as prof2:
        pass
    assert prof2.trace_path != prof.trace_path
    assert os.path.exists(prof.trace_path)


# -------------------------------------------------------------- display

def test_display_loop_matches_jax(tmp_path):
    """The JAX package's test_display.py scenario in both packages: frames
    until the callback stops at frame 3, the camera moved at frame 1
    (accumulation restarts), the PNG read back equal to the last frame,
    the films >= 60 dB apart."""
    def run(pkg_display, params, scene, cam_fn, out):
        events = []

        def cb(frame, img, stats):
            events.append((frame, np.array(img)))
            if frame == 1:
                return cam_fn(16, 16), True
            return None, frame < 3

        film = pkg_display.display_loop(
            scene, cam_fn(16, 16), params(max_depth=2), 16, 16,
            spp_per_frame=2, max_frames=10, out_path=out, seed=4,
            frame_cb=cb, use_matplotlib=False)
        return film, events

    out, jout = str(tmp_path / 'view.png'), str(tmp_path / 'jview.png')
    film, events = run(display, pt.PTParams, bs.cornell_box(
        with_boxes=False).commit(device='cpu'), bs.cornell_camera, out)
    jfilm, jevents = run(jdisplay, jpt.PTParams, jbs.cornell_box(
        with_boxes=False).commit(), jbs.cornell_camera, jout)
    assert [e[0] for e in events] == [0, 1, 2, 3] == [e[0] for e in jevents]
    assert float(film.weight[0, 0]) == 4.0 == float(jfilm.weight[0, 0])
    with open(out, 'rb') as f:
        np.testing.assert_array_equal(stereo_strip.decode_png(f.read()),
                                      events[-1][1])
    assert _psnr(film.rgb_sum.numpy(), np.asarray(jfilm.rgb_sum)) >= 60.0
    for (_, a), (_, b) in zip(events, jevents):
        assert a.dtype == np.uint8 and a.shape == (16, 16, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


# --------------------------------------------------------------- viewer

def _controllers():
    kw = dict(pos=np.array([0.5, 1.0, -10.0]), lookat=np.array([0.2, 0.1,
                                                                 0.3]),
              up=np.array([0.1, 1.0, 0.05]), angle=50.0, aspect=1.5)
    return viewer.CameraController(**kw), jviewer.CameraController(**kw)


def _same_state(c, jc):
    for f in ('pos', 'lookat', 'up'):
        a, b = getattr(c, f), getattr(jc, f)
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=f)
    for f in ('speed', 'radius', 'psi', 'angle', 'aspect'):
        np.testing.assert_allclose(getattr(c, f), getattr(jc, f),
                                   rtol=1e-12, atol=0, err_msg=f)


def test_camera_controller_matches_jax():
    """Every mouse method and key, one after another, in float64 against
    the JAX package's controller; the camera it builds (Pinhole, then
    DepthOfField once a lens radius is set) and the 'c' line."""
    c, jc = _controllers()
    steps = [('rotate', (40.0, 25.0)), ('pan', (100.0, -50.0)),
             ('dolly', (30.0, 5.0)), ('dolly', (2.0, -60.0)),
             ('roll', (12.0, 0.0)), ('recenter', (np.array([3.0, 2.0,
                                                             0.5]),)),
             ('refocus', (np.array([1.0, -1.0, 2.0]),))]
    keys = [(' ', False), ('r', False), ('t', False), ('q', False),
            ('Q', False), ('Escape', False), ('c', False), ('L', False),
            ('L', False), ('l', False), ('Home', False), ('Home', False),
            ('End', False), ('ArrowLeft', False), ('ArrowLeft', True),
            ('ArrowRight', False), ('ArrowRight', True), ('ArrowUp', False),
            ('ArrowUp', True), ('ArrowDown', False), ('ArrowDown', True),
            ('PageUp', False), ('PageDown', False), ('x', False)]
    for name, args in steps:
        getattr(c, name)(*args)
        getattr(jc, name)(*args)
        _same_state(c, jc)
    for k, alt in keys:
        assert c.key(k, alt) == jc.key(k, alt)
        _same_state(c, jc)
    assert c.camera_line() == jc.camera_line()
    built, jbuilt = c.camera(), jc.camera()
    assert type(built).__name__ == type(jbuilt).__name__ == 'DepthOfField'
    np.testing.assert_allclose(built.local2world.numpy(),
                               np.asarray(jbuilt.local2world), rtol=1e-6,
                               atol=1e-6)
    assert built.focal_distance == jbuilt.focal_distance
    c.key('l')
    assert type(c.camera()).__name__ == 'Pinhole'


def test_viewer_server_roundtrip_png():
    """The page (a PNG data URL), an event POSTed and drained, a poll
    made before any frame waits for the first (never an empty frame),
    which arrives as a PNG equal to it, and a malformed event answered
    with 400 without killing the server."""
    srv = viewer.ViewerServer(port=0)
    try:
        base = 'http://127.0.0.1:%d' % srv.port
        page = urllib.request.urlopen(base + '/', timeout=5).read()
        assert b'data:image/png;base64' in page and b'img' in page
        req = urllib.request.Request(
            base + '/event',
            data=json.dumps({'type': 'rotate', 'dx': 3, 'dy': 4}).encode(),
            method='POST')
        urllib.request.urlopen(req, timeout=5).read()
        assert srv.drain_events() == [{'type': 'rotate', 'dx': 3, 'dy': 4}]
        frame = np.random.RandomState(1).randint(0, 256, (5, 7, 3)).astype(
            np.uint8)
        later = threading.Timer(0.3, srv.submit_frame, (frame, '1.0 fps'))
        later.start()
        j = json.loads(urllib.request.urlopen(
            base + '/frame?since=-1', timeout=5).read())
        later.join(timeout=5)
        assert j['i'] == 1 and j['hud'] == '1.0 fps'
        np.testing.assert_array_equal(
            stereo_strip.decode_png(base64.b64decode(j['png'])), frame)
        req = urllib.request.Request(base + '/event', data=b'{oops',
                                     method='POST')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 400
        assert srv.drain_events() == []
    finally:
        srv.close()


def _scripted_server(pkg, script):
    """A port-0 server of package pkg whose frames are captured; after
    frame i is published, script[i]'s events are queued."""
    srv = pkg.ViewerServer(port=0)
    frames = []
    orig = srv.submit_frame

    def capture(img, hud=''):
        frames.append(np.array(img))
        orig(img, hud)
        if len(frames) <= len(script):
            with srv._lock:
                srv._events.extend(script[len(frames) - 1])
    srv.submit_frame = capture
    return srv, frames


def test_interactive_loop_matches_jax():
    """The JAX package's test_viewer.py scenario, with a shift-click pick
    that hits between a rotate and 'q', in both packages: the same frame
    count, 99% of the frames' values within one 8-bit level, the
    controllers re-centred on the same point (float32 picks: rtol
    1e-5)."""
    script = [[{'type': 'rotate', 'dx': 10, 'dy': 0}],
              [{'type': 'pick', 'x': 0.5, 'y': 0.6}],
              [{'type': 'key', 'k': 'q'}]]
    results = []
    for pkg, builtin, params, kw in (
            (viewer, bs, pt.PTParams, {'device': 'cpu'}),
            (jviewer, jbs, jpt.PTParams, {})):
        scene = builtin.cornell_box().commit(**kw)
        l2w = np.asarray(builtin.cornell_camera(16, 16).local2world,
                         np.float64)
        ctl = pkg.CameraController(pos=l2w[3], lookat=l2w[3] + l2w[2],
                                   up=l2w[1], angle=37.0, aspect=1.0)
        srv, frames = _scripted_server(pkg, script)
        try:
            film = pkg.interactive_loop(scene, ctl, params(max_depth=2), 16,
                                        16, spp_per_frame=1, server=srv,
                                        max_frames=5)
        finally:
            srv.close()
        results.append((ctl, frames, film))
    (ctl, frames, film), (jctl, jframes, _) = results
    assert len(frames) == len(jframes) == 3
    assert frames[0].shape == (16, 16, 3) and frames[0].max() > 0
    for a, b in zip(frames, jframes):
        assert np.mean(np.abs(a.astype(int) - b.astype(int)) <= 1) >= 0.99
    np.testing.assert_allclose(ctl.lookat, jctl.lookat, rtol=1e-5)
    np.testing.assert_allclose(ctl.pos, jctl.pos, rtol=1e-5)
    assert float(film.weight[0, 0]) == 1.0      # the pick restarted it


# ------------------------------------------------------------------ CLI

def _quiet_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device='cpu')
    return rc, out.getvalue()


def test_cli_display_writes_png(tmp_path, monkeypatch):
    """-display -frames 2: two progressive frames of the cornell .ecs at
    16^2 into the -o PNG; 99% of its values within one 8-bit level of
    the JAX package's CLI run of the same command line (its PNG through
    Pillow)."""
    monkeypatch.chdir(tmp_path)
    argv = ['-c', os.path.join(ASSETS, 'cornell_box.ecs'), '-size', '16',
            '16', '-spp', '2', '-display', '-frames', '2', '-o']
    rc, out = _quiet_main(argv + ['shown.png'])
    assert rc == 0 and out.count(' fps (avg ') == 2
    with open(tmp_path / 'shown.png', 'rb') as f:
        img = stereo_strip.decode_png(f.read())
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(argv + ['ref.png']) == 0
    ref = np.asarray(Image.open(tmp_path / 'ref.png'))
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.mean(np.abs(img.astype(int) - ref.astype(int)) <= 1) >= 0.99


def test_cli_viewer_runs_its_frames(monkeypatch):
    """-viewer P -frames 2: the web viewer on port P (a server of the
    port's own, here on a free port) publishes two frames and stops."""
    frames, ports = [], []

    class Server(viewer.ViewerServer):
        def __init__(self, port):
            ports.append(port)
            super().__init__(0)

        def submit_frame(self, img, hud=''):
            frames.append(img)
            super().submit_frame(img, hud)

    monkeypatch.setattr(viewer, 'ViewerServer', Server)
    rc, out = _quiet_main(['-c', os.path.join(ASSETS, 'cornell_box.ecs'),
                           '-size', '16', '12', '-viewer', '9123',
                           '-frames', '2'])
    assert rc == 0 and ports == [9123] and 'viewer: http://' in out
    assert len(frames) == 2 and frames[-1].shape == (12, 16, 3)
    assert frames[-1].max() > 0


def test_cli_regression_loop(monkeypatch):
    """-regression, bounded by a scene generator that stops after three
    scenes: each random scene committed, rendered and reported finite."""
    made = []

    class Enough(Exception):
        pass

    def scenes(seed):
        if len(made) == 3:
            raise Enough
        made.append(seed)
        return jregression_free(seed)

    jregression_free = regression.create_random_scene
    monkeypatch.setattr(regression, 'create_random_scene', scenes)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(Enough):
        cli.main(['-regression', '-size', '12', '12', '-spp', '1', '-depth',
                  '2'], device='cpu')
    assert made == [0, 1, 2]
    lines = out.getvalue().splitlines()
    assert [ln.split(' (')[0] for ln in lines] == [
        f'regression scene {k}: ok' for k in range(3)]


# ------------------------------------------------------------------ misc

def test_png_store_matches_decoder_and_pillow(tmp_path):
    """image.store writes .png without Pillow (grey, RGB, RGBA, floats
    quantized): read back equal by the port's decoder and by Pillow."""
    rs = np.random.RandomState(3)
    for shape in ((5, 7, 3), (4, 9, 4), (6, 3)):
        a = rs.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f'x{len(shape)}{shape[-1]}.png')
        image.store(path, a)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
        if a.ndim == 3:
            with open(path, 'rb') as f:
                np.testing.assert_array_equal(
                    stereo_strip.decode_png(f.read()), a)
    f = rs.rand(3, 4, 3).astype(np.float32)
    image.store(str(tmp_path / 'f.png'), f)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / 'f.png')),
        np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_new_modules_never_import_jax():
    """The sampler's, the debug renderer's and the interactive modules,
    imported and run, load no jax and nothing of the JAX package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torch\n"
        "from yulio_raytracer_tpu_torch import renderer\n"
        "from yulio_raytracer_tpu_torch.api import cli, display, viewer\n"
        "from yulio_raytracer_tpu_torch.integrator import debugrenderer\n"
        "from yulio_raytracer_tpu_torch.sampling import precomputed\n"
        "from yulio_raytracer_tpu_torch.utils import profiling, regression\n"
        "from yulio_raytracer_tpu_torch.integrator import pathtracer as pt\n"
        "from yulio_raytracer_tpu_torch.io import builtin_scenes as bs\n"
        "sc = regression.create_random_scene(1).commit(device='cpu')\n"
        "renderer.render_frame(sc, bs.cornell_camera(4, 4),\n"
        "    pt.PTParams(max_depth=2), 4, 4, 1, sampler='precomputed')\n"
        "renderer.pick(sc, bs.cornell_camera(4, 4), 0.5, 0.5)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'yulio_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
