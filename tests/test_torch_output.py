"""The torch port's production output path held against the JAX package
on the CPU: the scenes without geometry (C6), the b-spline pixel filter,
progressive frames (`render_frame` with film, iteration and accumulate),
the film's checkpoints, camera-aligned billboards and the Collada loader
(staged meshes and committed tables at two viewpoints), the watermark
PNG and its decoder, the strip helpers, `render_stereo`'s strip, the
StartRT session, the once-per-face retry, and the CLI's mono and
-stereo modes.

Tolerances: integer and table outputs bit-equal; rendered images >= 60
dB against the JAX render with equal ray counts, images read back from
8-bit files (PPM, JPEG) >= 50 dB; a black frame equal.
"""
import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.api import cli as jcli
from yulio_raytracer_tpu.api import output as joutput
from yulio_raytracer_tpu.api import session as jsession
from yulio_raytracer_tpu.film import accum as jaccum
from yulio_raytracer_tpu.film import stereo_strip as jstrip
from yulio_raytracer_tpu.geometry import mesh as jmesh
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.io import collada as jcollada
from yulio_raytracer_tpu.io import ecs as jecs
from yulio_raytracer_tpu.lights import lights as jgl
from yulio_raytracer_tpu.sampling import patterns as jpatterns
from yulio_raytracer_tpu.scene import SceneBuilder as JSceneBuilder

from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.api import cli
from yulio_raytracer_tpu_torch.api import output
from yulio_raytracer_tpu_torch.api import session
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.film import stereo_strip
from yulio_raytracer_tpu_torch.geometry import mesh as gmesh
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import collada
from yulio_raytracer_tpu_torch.io import ecs
from yulio_raytracer_tpu_torch.io import image
from yulio_raytracer_tpu_torch.sampling import patterns
from yulio_raytracer_tpu_torch.scene import SceneBuilder

from test_torch_io import _eq, assert_builders_equal
from test_torch_scene import _assert_scenes_equal, _numpy_leaves

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, 'assets', 'scenes')
DAE = os.path.join(ASSETS, 'test_room.dae')
# the StartRT defaults but size, depth and spp; the strip tests and the
# session tests share these so the JAX package compiles their faces once
SESSION = dict(size=16, depth=2, spp=2, watermark=True)


def _psnr(a, b):
    mse = ((np.asarray(a, np.float64) - b) ** 2).mean()
    return 10 * np.log10(max(float(np.max(a)), 1e-9) ** 2 / max(mse, 1e-20))


def _read(path):
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.float32) / 255.0


# ------------------------------------------------------------ C6 scenes

def _mono_both(st, sb, jst, jsb):
    img, stats = output.render_mono(sb.commit(device='cpu'), st, '',
                                    device='cpu')
    jimg, jstats = joutput.render_mono(jsb.commit(), jst, '')
    return img, stats, np.asarray(jimg), jstats


def test_empty_scene_renders_black_like_jax():
    """sphere_view.ecs alone stages no mesh: the scene commits 'dense' and
    renders black (8^2, 1 spp, the default depth 10 and b-spline filter),
    frame and ray count equal to the JAX package's."""
    path = os.path.join(ASSETS, 'sphere_view.ecs')
    st, sb = ecs.parse_ecs(path)
    jst, jsb = jecs.parse_ecs(path)
    for s in (st, jst):
        s.width = s.height = 8
    assert not sb.meshes and sb.commit(device='cpu').accel == 'dense'
    img, stats, jimg, jstats = _mono_both(st, sb, jst, jsb)
    assert not jimg.any()
    np.testing.assert_array_equal(img, jimg)
    assert stats.num_rays == jstats.num_rays


def _hdri_only(tmp_path):
    """An XML holding only sphere_mirror.xml's lines.ppm HDRI light."""
    shutil.copy(os.path.join(ASSETS, 'lines.ppm'), tmp_path)
    p = tmp_path / 'hdri_only.xml'
    p.write_text('<?xml version="1.0"?>\n<scene><Group><HDRILight>'
                 '<AffineSpace>1 0 0 0 0 1 0 0 0 0 1 0</AffineSpace>'
                 '<L>2.0 1.5 1.2</L><image>"lines.ppm"</image>'
                 '</HDRILight></Group></scene>\n')
    return str(p)


def test_hdri_only_scene_matches_jax(tmp_path):
    """The HDRI light alone, seen through sphere_view.ecs's camera at 16^2,
    2 spp, depth 2: the environment at >= 60 dB against the JAX render,
    equal ray counts."""
    xml = _hdri_only(tmp_path)
    view = os.path.join(ASSETS, 'sphere_view.ecs')
    (st, sb), (jst, jsb) = ecs.parse_ecs(view), jecs.parse_ecs(view)
    ecs.load_scene_file(xml, st, sb)
    jecs.load_scene_file(xml, jst, jsb)
    for s in (st, jst):
        s.width = s.height = 16
        s.spp, s.depth = 2, 2
    img, stats, jimg, jstats = _mono_both(st, sb, jst, jsb)
    assert jimg.min() > 0.0
    assert _psnr(img, jimg) >= 60.0
    assert stats.num_rays == jstats.num_rays


# ------------------------------------------------- sampling and the film

@pytest.mark.parametrize('spp', [1, 6, 16])
def test_pixel_sample_bspline_bit_equal(spp):
    rs = np.random.RandomState(spp)
    pid = rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    sid = rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for dim, seed in ((0, 0), (5, 1234567), (0x7FFFFFFF, 2 ** 32 - 1)):
        ref = jpatterns.pixel_sample_bspline(
            jnp.uint32(seed), jnp.asarray(pid), jnp.asarray(sid),
            jpatterns.grid_scalars(spp), dim)
        got = patterns.pixel_sample_bspline(
            seed, torch.as_tensor(pid.astype(np.int64)),
            torch.as_tensor(sid.astype(np.int64)),
            patterns.grid_scalars(spp), dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_progressive_frames_match_jax():
    """Two b-spline frames of the cornell box (12 x 10, 2 spp, depth 2)
    into one film, iteration 0 then 1, then a frame with accumulate off:
    each film >= 60 dB against the JAX package's, weights equal exactly,
    equal ray counts.  progress_cb reaches 1; a stop before the first pass
    leaves the film's sums as they were and still adds the weight, as the
    reference."""
    w, h, spp = 12, 10, 2
    sc = bs.cornell_box().commit(device='cpu')
    js = jbs.cornell_box().commit()
    cam, jcam = bs.cornell_camera(w, h), jbs.cornell_camera(w, h)
    params, jparams = pt.PTParams(max_depth=2), jpt.PTParams(max_depth=2)
    film = jfilm = None
    fractions = []
    for it, acc in ((0, True), (1, True), (2, False)):
        film, stats = renderer.render_frame(
            sc, cam, params, w, h, spp, seed=3, film=film, iteration=it,
            accumulate=acc, pixel_filter='bspline',
            progress_cb=fractions.append)
        jfilm, jstats = jrenderer.render_frame(
            js, jcam, jparams, w, h, spp, seed=3, film=jfilm, iteration=it,
            accumulate=acc, pixel_filter='bspline')
        np.testing.assert_array_equal(film.weight.numpy(),
                                      np.asarray(jfilm.weight))
        assert float(film.weight[0, 0]) == spp * (it + 1 if acc else 1)
        assert _psnr(film.rgb_sum.numpy(), np.asarray(jfilm.rgb_sum)) >= 60
        assert stats.num_rays == jstats.num_rays
        assert fractions[-1] == 1.0
    stopped, st = renderer.render_frame(sc, cam, params, w, h, spp,
                                        film=film, stop_flag=lambda: True)
    jstopped, _ = jrenderer.render_frame(js, jcam, jparams, w, h, spp,
                                         film=jfilm, stop_flag=lambda: True)
    assert torch.equal(stopped.rgb_sum, film.rgb_sum)
    np.testing.assert_array_equal(np.asarray(jstopped.rgb_sum),
                                  np.asarray(jfilm.rgb_sum))
    np.testing.assert_array_equal(stopped.weight.numpy(),
                                  np.asarray(jstopped.weight))
    assert st.num_rays == 0
    with pytest.raises(NotImplementedError):
        renderer.render_frame(sc, cam, params, w, h, spp, mesh=object())
    with pytest.raises(ValueError):
        renderer.render_frame(sc, cam, params, w, h, spp,
                              pixel_filter='gauss')


def test_film_accumulate_and_checkpoint_like_jax():
    """create, accumulate (adding and reset), resolve and the checkpoint
    round trip, bit-equal to the JAX package's on random sums."""
    rs = np.random.RandomState(2)
    rgb = [rs.rand(5, 7, 3).astype(np.float32) for _ in range(3)]
    wt = [rs.rand(5, 7).astype(np.float32) + 0.5 for _ in range(3)]
    film, jfilm = accum.create(5, 7), jaccum.create(5, 7)
    for i, reset in enumerate((False, False, True)):
        film = accum.accumulate(film, rgb[i], wt[i], reset=reset)
        jfilm = jaccum.accumulate(jfilm, jnp.asarray(rgb[i]),
                                  jnp.asarray(wt[i]), reset=reset)
        np.testing.assert_array_equal(accum.resolve(film).numpy(),
                                      np.asarray(jaccum.resolve(jfilm)))
    film = accum.accumulate(film, rgb[0], wt[0])
    jfilm = jaccum.accumulate(jfilm, jnp.asarray(rgb[0]),
                              jnp.asarray(wt[0]))
    d, jd = accum.to_numpy_checkpoint(film), jaccum.to_numpy_checkpoint(jfilm)
    assert d.keys() == jd.keys()
    for k in d:
        _eq(d[k], jd[k], k)
    back = accum.from_numpy_checkpoint(jd, device='cpu')
    assert torch.equal(back.rgb_sum, film.rgb_sum)
    assert torch.equal(back.weight, film.weight)


# ------------------------------------------------- billboards and Collada

def _assert_committed_equal(js, own):
    """A JAX commit's tables equal the port's own commit's; the lights
    apart, the HDRI's distribution tables each as an array."""
    carried = tscene.from_numpy_scene(**_numpy_leaves(
        dataclasses.replace(js, light_arrays=[], light_static=())))
    _assert_scenes_equal(carried, dataclasses.replace(own, lights=[]))
    assert len(own.lights) == len(js.lights)
    for i, (l, jl) in enumerate(zip(own.lights, js.lights)):
        assert l.keys() == jl.keys(), i
        for k in l:
            if isinstance(l[k], (str, int, float)):
                assert l[k] == jl[k], (i, k)
            elif k == 'dist':
                for a, b in zip(l[k], jl[k], strict=True):
                    _eq(a.numpy(), np.asarray(b), f'light {i} dist')
            else:
                _eq(l[k].numpy(), np.asarray(jl[k]), f'light {i} {k}')


def test_billboard_transform_bit_equal():
    rs = np.random.RandomState(4)
    for _ in range(8):
        orig = np.concatenate([rs.randn(3, 3) * 2, rs.randn(1, 3) * 5]
                              ).astype(np.float32)
        for view in (rs.randn(3) * 10, [0.0, 3.0, 0.0]):
            for up in ((0, 1, 0), (0.0, 0.0, 2.0)):
                got = gmesh.billboard_transform(orig, view, up)
                ref = jmesh.billboard_transform(orig, view, up)
                assert got.dtype == ref.dtype == np.float32
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('mode', ['default', 'forcesingle', 'forcedouble'])
def test_collada_loads_like_jax(mode):
    """test_room.dae through both loaders: the FPR camera (prefix gone,
    scene scale 2), the staged meshes (the billboard flagged, its
    authored placement kept), materials and settings equal, the rigs'
    cameras equal, and the committed tables equal at two viewpoints."""
    st, jst = ecs.RenderSettings(), jecs.RenderSettings()
    sb, jsb = SceneBuilder(), JSceneBuilder()
    res = collada.load_dae(DAE, st, sb, face_culling_mode=mode)
    jres = jcollada.load_dae(DAE, jst, jsb, face_culling_mode=mode)
    assert [c.name for c in res.cameras] == ['Scene_1']
    assert res.scene_scale == jres.scene_scale == st.scene_scale == 2.0
    assert res.mesh_ids == jres.mesh_ids
    for c, jc in zip(res.cameras, jres.cameras, strict=True):
        for f in ('position', 'look_at', 'up'):
            _eq(getattr(c, f), getattr(jc, f), f)
        assert (c.name, c.scene_scale) == (jc.name, jc.scene_scale)
    assert_builders_equal(sb, jsb)
    for i, (m, jm) in enumerate(zip(sb.meshes, jsb.meshes)):
        assert m.face_camera == jm.face_camera, i
        _eq(m.orig_transform, jm.orig_transform, f'mesh {i} orig_transform')
    assert sb.has_billboards() and jsb.has_billboards()
    rigs = collada.make_stereo_cameras(res, toe_in=True)
    jrigs = jcollada.make_stereo_cameras(jres, toe_in=True)
    for (name, cams), (jname, jcams) in zip(rigs, jrigs, strict=True):
        assert name == jname and len(cams) == len(jcams) == 12
        for c, jc in zip(cams, jcams):
            _eq(c.local2world.numpy(), jc.local2world, 'local2world')
            assert (c.cube_face_index, c.toe_in, c.scene_scale) == (
                jc.cube_face_index, jc.toe_in, jc.scene_scale)
    for view in (np.asarray(rigs[0][1][0].local2world[3]),
                 np.asarray([10.0, 0.0, 2.0])):
        own = sb.commit(device='cpu', view_pos=view, view_up=(0, 1, 0))
        js = jsb.commit(view_pos=view, view_up=(0, 1, 0))
        _assert_committed_equal(js, own)


@pytest.mark.parametrize('name', ['test_stereo.xml', 'test_stereo.ecs'])
def test_stereo_field_loads_static_like_jax(name):
    """test_stereo's faceCamera quad loads as a static mesh, as in the
    reference (its XML loader never reads the flag): 14,704 triangles, no
    billboard, and the committed tables equal the JAX package's."""
    path = os.path.join(ASSETS, name)
    if name.endswith('.ecs'):
        (st, sb), (jst, jsb) = ecs.parse_ecs(path), jecs.parse_ecs(path)
    else:
        sb, jsb = SceneBuilder(), JSceneBuilder()
        ecs.load_scene_file(path, ecs.RenderSettings(), sb)
        jecs.load_scene_file(path, jecs.RenderSettings(), jsb)
    assert_builders_equal(sb, jsb)
    assert not sb.has_billboards() and not jsb.has_billboards()
    own = sb.commit(device='cpu')
    assert sum(len(m.triangles) for m in sb.meshes) == 14704
    assert own.accel == 'bvh4'
    _assert_committed_equal(jsb.commit(), own)


# ------------------------------------------------ the watermark and strip

def _png(px, ftypes, ctype=None, depth=8, interlace=0):
    """A PNG of uint8 rows px (H, W, C), row y filtered with
    ftypes[y % len(ftypes)] (the filters as the PNG spec defines them)."""
    h, w, c = px.shape
    bpp = c
    raw, prev = bytearray(), np.zeros(w * c, np.int64)
    for y in range(h):
        row = px[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        ft = ftypes[y % len(ftypes)]
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + bytes(((row - pred) & 0xFF).astype(np.uint8))
        prev = row

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))
    ctype = {3: 2, 4: 6}[c] if ctype is None else ctype
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b'IDAT', zlib.compress(bytes(raw)))
            + chunk(b'IEND', b''))


def test_watermark_decodes_like_pillow(tmp_path):
    """The package's watermark is the JAX package's file, and decodes to
    Pillow's RGBA of it; PNGs of every row filter, RGB and RGBA, decode to
    Pillow's pixels; other PNGs raise (no fallback glyph)."""
    jpath = os.path.join(ROOT, 'yulio_raytracer_tpu', 'resources',
                         'watermark_100x100.png')
    with open(jpath, 'rb') as a, open(stereo_strip.WATERMARK_PNG, 'rb') as b:
        assert a.read() == b.read()
    wm = stereo_strip.load_watermark()
    with Image.open(jpath) as im:
        ref = np.asarray(im.convert('RGBA'), np.float32) / 255.0
    assert wm.shape == (100, 100, 4)
    np.testing.assert_array_equal(wm, ref)
    np.testing.assert_array_equal(wm, jstrip.load_watermark())
    rs = np.random.RandomState(5)
    for c in (3, 4):
        px = rs.randint(0, 256, (9, 11, c)).astype(np.uint8)
        data = _png(px, [0, 1, 2, 3, 4])
        p = tmp_path / f'f{c}.png'
        p.write_bytes(data)
        with Image.open(p) as im:
            np.testing.assert_array_equal(np.asarray(im), px)
        np.testing.assert_array_equal(stereo_strip.decode_png(data), px)
        rgba = stereo_strip.load_watermark(str(p))
        assert rgba.shape == (9, 11, 4)
        np.testing.assert_array_equal(rgba[..., :c] * 255.0, px)
    px = rs.randint(0, 256, (4, 4, 3)).astype(np.uint8)
    for bad in (_png(px, [0], depth=16), _png(px, [0], interlace=1),
                _png(px[..., :1], [0], ctype=0), _png(px, [5]),
                b'GIF89a'):
        with pytest.raises(ValueError):
            stereo_strip.decode_png(bad)


def test_strip_helpers_equal_reference():
    rs = np.random.RandomState(6)
    faces = [rs.rand(6, 5, 3).astype(np.float32) for _ in range(12)]
    np.testing.assert_array_equal(stereo_strip.assemble_strip(faces),
                                  jstrip.assemble_strip(faces))
    for wshape, fshape in (((4, 3, 4), (9, 8, 3)), ((12, 10, 4), (6, 5, 4)),
                           ((100, 100, 4), (16, 16, 3))):
        wm = rs.rand(*wshape).astype(np.float32)
        face = rs.rand(*fshape).astype(np.float32)
        for i in range(12):
            np.testing.assert_array_equal(
                stereo_strip.apply_watermark(face, wm, i),
                jstrip.apply_watermark(face, wm, i))
    for i in range(12):
        assert stereo_strip.face_filename('room', 'Scene_1', i) == \
            jstrip.face_filename('room', 'Scene_1', i)
    assert stereo_strip.strip_filename('room', 'Scene_1') == \
        jstrip.strip_filename('room', 'Scene_1') == 'room_Scene_1.jpg'
    np.testing.assert_array_equal(stereo_strip.default_watermark(),
                                  jstrip.default_watermark())


# ------------------------------------------------------- render_stereo

def _jax_job():
    """test_room.dae staged by the JAX package as its StartRT worker stages
    it (SESSION's size, depth, spp and watermark; the other ParamsRT
    defaults)."""
    p = jsession.ParamsRT(**SESSION)
    settings = jecs.RenderSettings(
        stereo=True, width=p.size, height=p.size, depth=p.depth, spp=p.spp,
        jpeg_quality=p.jpeg_quality, toe_in=p.toe_in,
        eye_separation=p.eye_separation, zero_parallax=p.zero_parallax,
        watermark=p.watermark, face_culling_mode=p.face_culling_mode,
        gamma=1.0)
    sb = JSceneBuilder()
    res = jcollada.load_dae(DAE, settings, sb, toe_in=p.toe_in)
    settings.t_max_shadow_ray = p.t_max_shadow_ray * res.scene_scale
    sb.add_light(jgl.ambient(p.ambientlight))
    return settings, sb, jcollada.make_stereo_cameras(res, toe_in=p.toe_in)


def _capture(monkeypatch, module):
    """Record the arrays `module` stores, by file name, still writing
    them."""
    stored = {}
    real = module.gimage.store

    def store(path, img, jpeg_quality=90):
        stored[os.path.basename(path)] = np.asarray(img)
        real(path, img, jpeg_quality=jpeg_quality)
    monkeypatch.setattr(module.gimage, 'store', store)
    return stored


def _port_job():
    """The port's StartRT job of test_room.dae (session.collada_job)."""
    return session.collada_job(DAE, session.ParamsRT(**SESSION))


def test_render_stereo_matches_jax(tmp_path, monkeypatch):
    """test_room.dae's strip (16^2 faces, 2 spp, depth 2, toe-in, the
    watermark, the billboard recommitted at the rig) with the debug faces:
    the same file names, the strip and every face >= 60 dB against the
    JAX package's arrays."""
    got, ref = _capture(monkeypatch, output), _capture(monkeypatch, joutput)
    (tmp_path / 'a').mkdir()
    (tmp_path / 'b').mkdir()
    settings, sb, rigs = _port_job()
    written, saved = output.render_stereo(
        sb, settings, rigs, 'room', str(tmp_path / 'a'), debug_faces=True,
        device='cpu')
    jsettings, jsb, jrigs = _jax_job()
    jwritten, jsaved = joutput.render_stereo(
        jsb, jsettings, jrigs, 'room', str(tmp_path / 'b'), debug_faces=True)
    assert [os.path.basename(f) for f in written] == ['room_Scene_1.jpg']
    assert sorted(map(os.path.basename, saved)) == \
        sorted(map(os.path.basename, jsaved))
    assert all(os.path.exists(f) for f in saved)
    assert sorted(got) == sorted(ref) and len(got) == 13
    assert got['room_Scene_1.jpg'].shape == (16, 16 * 12, 3)
    for name in got:
        assert _psnr(got[name], ref[name]) >= 60.0, name


def test_face_retry_gives_the_same_strip(tmp_path, monkeypatch):
    """A face that raises once is rendered again, and the strip equals an
    untroubled run's bit for bit."""
    got = _capture(monkeypatch, output)
    settings, sb, rigs = _port_job()
    output.render_stereo(sb, settings, rigs, 'clean', str(tmp_path),
                         device='cpu')
    real, calls = renderer.render_frame, {'n': 0}

    def flaky(*a, **k):
        calls['n'] += 1
        if calls['n'] == 3:
            raise RuntimeError("transient face failure")
        return real(*a, **k)
    monkeypatch.setattr(renderer, 'render_frame', flaky)
    settings.log_display = False
    output.render_stereo(sb, settings, rigs, 'retried', str(tmp_path),
                         device='cpu')
    assert calls['n'] == 13
    np.testing.assert_array_equal(got['retried_Scene_1.jpg'],
                                  got['clean_Scene_1.jpg'])


# ------------------------------------------------------------ StartRT

def test_session_lifecycle_matches_jax(tmp_path):
    """StartRT on a missing file reports MissingColladaFile; on
    test_room.dae it runs to Done with progress 1 and writes
    <scene>_<camera>.jpg, whose image reads >= 50 dB against the JAX
    session's; without a card, a start on the default device raises."""
    for d in ('a', 'b'):
        (tmp_path / d).mkdir()
        shutil.copy(DAE, tmp_path / d / 'room.dae')
    s = session.RenderSession()
    assert not s.start(str(tmp_path / 'nope.dae'), device='cpu')
    assert s.last_error() == session.ErrorCodeRT.MissingColladaFile
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            s.start(str(tmp_path / 'a' / 'room.dae'))
    p = session.ParamsRT(**SESSION)
    assert s.start(str(tmp_path / 'a' / 'room.dae'), p, device='cpu')
    assert s.wait()
    st = s.status()
    assert st.state == session.StateRT.Done and st.progress == 1.0
    assert st.last_error == session.ErrorCodeRT.MissingColladaFile
    assert [os.path.basename(f) for f in s.written_files] == \
        ['room_Scene_1.jpg']
    js = jsession.RenderSession()
    assert js.start(str(tmp_path / 'b' / 'room.dae'),
                    jsession.ParamsRT(**SESSION))
    assert js.wait() and js.status().state == jsession.StateRT.Done
    img, ref = _read(s.written_files[0]), _read(js.written_files[0])
    assert img.shape == (16, 16 * 12, 3)
    assert _psnr(img, ref) >= 50.0


def test_session_stop_discards_partial_outputs(tmp_path, monkeypatch):
    """StopRT(keep_results=False) during a face: the render stops, the
    state is Stopped, and the debug faces written so far are deleted.
    StopRT right after StartRT ends Stopped with nothing left on disk,
    or Done if the render won the race."""
    shutil.copy(DAE, tmp_path / 'room.dae')
    s = session.RenderSession()
    real, calls = renderer.render_frame, {'n': 0}

    def stopping(*a, **k):
        calls['n'] += 1
        if calls['n'] == 3:
            s._keep_results = False     # what stop(keep_results=False) sets
            s._stop.set()
        return real(*a, **k)
    monkeypatch.setattr(renderer, 'render_frame', stopping)
    p = session.ParamsRT(size=8, depth=2, spp=1, debug=True)
    assert s.start(str(tmp_path / 'room.dae'), p, device='cpu')
    assert s.wait()
    assert s.status().state == session.StateRT.Stopped
    assert calls['n'] == 3
    assert not [f for f in os.listdir(tmp_path) if f.endswith('.jpg')]
    assert s.written_files == []
    s2 = session.RenderSession()
    assert s2.start(str(tmp_path / 'room.dae'), p, device='cpu')
    assert s2.stop(keep_results=False)
    if s2.status().state == session.StateRT.Stopped:
        assert not [f for f in os.listdir(tmp_path) if f.endswith('.jpg')]
    else:
        assert s2.status().state == session.StateRT.Done


# ------------------------------------------------------------ the CLI

CORNELL = ['-c', os.path.join(ASSETS, 'cornell_box.ecs'), '-size', '16',
           '16', '-spp', '2']


def test_cli_mono_matches_jax(tmp_path):
    """cli.main on cornell_box.ecs at 16^2, 2 spp: the .ppm it writes reads
    >= 50 dB against the JAX CLI's."""
    a, b = str(tmp_path / 'a.ppm'), str(tmp_path / 'b.ppm')
    assert cli.main(CORNELL + ['-o', a], device='cpu') == 0
    assert jcli.main(CORNELL + ['-o', b]) == 0
    img, ref = image.load(a), image.load(b)
    assert img.shape == (16, 16, 3)
    assert _psnr(img, ref) >= 50.0


def test_cli_stereo_matches_jax(tmp_path, monkeypatch):
    """cli.main -stereo on test_room.dae (one rig at the CLI camera, the
    session's depth, cap and sky) writes test_room_view.jpg, which reads
    >= 50 dB against the JAX CLI's."""
    argv = ['-i', DAE, '-stereo', '-toeIn', '-size', '16', '16', '-spp',
            '2', '-depth', '2', '-tMaxShadowRay', '240', '-ambientlight',
            '0.83', '0.95', '0.98', '-vp', '1', '-2', '0.5', '-vi', '2',
            '-1.5', '0.5']
    for d, main in (('a', lambda: cli.main(argv, device='cpu')),
                    ('b', lambda: jcli.main(argv))):
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        assert main() == 0
    img = _read(tmp_path / 'a' / 'test_room_view.jpg')
    ref = _read(tmp_path / 'b' / 'test_room_view.jpg')
    assert img.shape == (16, 16 * 12, 3)
    assert _psnr(img, ref) >= 50.0
