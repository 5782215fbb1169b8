"""The torch port's loaders held against the JAX package's: the image
codecs (PPM, PFM, EXR) and their cache, every scene file in assets/scenes
through both packages' ecs/xml/obj loaders (meshes, material table,
texture atlas, lights and settings equal), the ECS token language (-c
includes, the -renderer block, -accel, every tag, unknown tags), every
XML tag on a file written here, the sphere_glass goldens, and an import
check that the loaders need neither JAX nor Pillow."""
import os
import subprocess
import sys
from dataclasses import fields

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu.io import ecs as jecs
from yulio_raytracer_tpu.io import image as jimage
from yulio_raytracer_tpu.io import exr as jexr
from yulio_raytracer_tpu.shading import materials as jmat
from yulio_raytracer_tpu.scene import SceneBuilder as JSceneBuilder

from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import ecs
from yulio_raytracer_tpu_torch.io import image
from yulio_raytracer_tpu_torch.io import exr
from yulio_raytracer_tpu_torch.io import xml_scene
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.shading import materials as gmat
from yulio_raytracer_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, 'assets', 'scenes')
GOLDEN = os.path.join(ROOT, 'assets', 'golden')
LINES = os.path.join(ASSETS, 'lines.ppm')
MESH_FIELDS = ('positions', 'triangles', 'normals', 'texcoords', 'motions',
               'tangent_x', 'tangent_y', 'material', 'light', 'cull',
               'illum_mask', 'shadow_mask')
# the scene files, but the Collada one (not ported)
SCENE_FILES = sorted(f for f in os.listdir(ASSETS)
                     if f.endswith(('.ecs', '.xml', '.obj')))
# files that hold a camera-aligned billboard (not ported)
BILLBOARDS = ('test_stereo.ecs', 'test_stereo.xml')


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _eq(a, b, msg):
    if a is None or b is None:
        assert a is None and b is None, msg
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


def assert_builders_equal(sb, jsb):
    """The staged scenes equal: every mesh field, the material table, the
    texture atlas and every light's fields (the HDRI's tables too)."""
    assert len(sb.meshes) == len(jsb.meshes)
    for i, (m, jm) in enumerate(zip(sb.meshes, jsb.meshes)):
        for f in MESH_FIELDS:
            _eq(getattr(m, f), getattr(jm, f), f'mesh {i} {f}')
    tab, jtab = gmat.build_table(sb.materials), jmat.build_table(jsb.materials)
    assert tab.keys() == jtab.keys()
    for k in tab:
        _eq(tab[k], jtab[k], f'materials {k}')
    tex, jtex = sb.textures.build(), jsb.textures.build()
    assert tex.keys() == jtex.keys()
    for k in tex:
        _eq(tex[k], jtex[k], f'textures {k}')
    assert len(sb.lights) == len(jsb.lights)
    for i, (l, jl) in enumerate(zip(sb.lights, jsb.lights)):
        assert l.keys() == jl.keys(), i
        for k in l:
            if isinstance(l[k], (str, int)):
                assert l[k] == jl[k], (i, k)
            elif k == 'dist':
                for a, b in zip(l[k], jl[k]):
                    _eq(a.numpy(), b, f'light {i} dist')
            else:
                _eq(l[k], jl[k], f'light {i} {k}')


def assert_settings_equal(st, jst):
    for f in fields(jst):
        a, b = getattr(st, f.name), getattr(jst, f.name)
        if f.name == 'backplate':
            _eq(a, b, 'backplate')
        elif f.name == 'scene_file':
            assert os.path.basename(a) == os.path.basename(b)
        else:
            assert a == b, f.name


def _load_both(path):
    """(settings, builder) of the file through each package."""
    if path.endswith('.ecs'):
        return ecs.parse_ecs(path), jecs.parse_ecs(path)
    st, jst = ecs.RenderSettings(), jecs.RenderSettings()
    sb, jsb = SceneBuilder(), JSceneBuilder()
    ecs.load_scene_file(path, st, sb)
    jecs.load_scene_file(path, jst, jsb)
    return (st, sb), (jst, jsb)


# ---------------------------------------------------------------- images

def test_ppm_loads_equal_and_round_trips(tmp_path):
    """lines.ppm (P6) and an ASCII P3 with comments load equal in both
    packages; a stored u8 image loads back exactly."""
    image.clear_cache()
    got = image.load(LINES)
    _eq(got, jimage.load(LINES), 'lines.ppm')
    assert got.shape == (64, 64, 3)
    p3 = tmp_path / 'a.ppm'
    p3.write_text('P3\n# comment\n3 2\n15\n'
                  '0 1 2 3 4 5 6 7 8\n9 10 11 12 13 14 15 0 1\n')
    _eq(image.load(str(p3)), jimage.load(str(p3)), 'P3')
    img = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    out = str(tmp_path / 'b.ppm')
    image.store(out, img)
    np.testing.assert_array_equal(image.load(out), img / np.float32(255))
    _eq(image.load(out), jimage.load(out), 'stored ppm')


def test_pfm_loads_equal_and_round_trips(tmp_path):
    """A stored float image loads back exactly in both packages, and a
    big-endian greyscale Pf loads as RGB alike."""
    img = np.random.RandomState(1).rand(6, 9, 3).astype(np.float32) * 10
    out = str(tmp_path / 'a.pfm')
    image.store(out, img)
    np.testing.assert_array_equal(image.load(out), img)
    _eq(image.load(out), jimage.load(out), 'pfm')
    grey = np.random.RandomState(2).rand(4, 5).astype('>f4')
    pf = tmp_path / 'g.pfm'
    pf.write_bytes(b'Pf\n5 4\n1.0\n' + grey[::-1].tobytes())
    got = image.load(str(pf))
    _eq(got, jimage.load(str(pf)), 'Pf')
    np.testing.assert_array_equal(got[..., 1], grey.astype(np.float32))


def test_exr_loads_equal_and_round_trips(tmp_path):
    """The port's EXR writer (HALF RGBA, ZIP) reads back as the image
    rounded to half in both packages, and the reference's file reads the
    same through the port."""
    img = np.random.RandomState(3).rand(37, 21, 4).astype(np.float32) * 4
    out, jout = str(tmp_path / 'a.exr'), str(tmp_path / 'b.exr')
    image.store(out, img)
    jimage.store(jout, img)
    half = img.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(exr.load_exr(out), half)
    _eq(image.load(out), jimage.load(out), 'exr')
    _eq(image.load(jout), jexr.load_exr(jout), 'reference exr')
    with open(out, 'rb') as f, open(jout, 'rb') as g:
        assert f.read() == g.read()


def test_image_cache_holds_until_cleared(tmp_path):
    """load caches by absolute path; clear_cache drops it."""
    p = str(tmp_path / 'c.pfm')
    image.store(p, np.ones((2, 2, 3), np.float32))
    first = image.load(p)
    image.store(p, np.zeros((2, 2, 3), np.float32))
    assert image.load(p) is first
    image.clear_cache()
    assert not image.load(p).any()


# ---------------------------------------------------------------- scenes

@pytest.mark.parametrize('name', SCENE_FILES)
def test_scene_file_loads_like_jax(name):
    """Each scene file in assets/scenes through both packages: the staged
    meshes, materials, textures, lights and settings equal.  The files
    with a camera-aligned billboard raise NotImplementedError."""
    path = os.path.join(ASSETS, name)
    if name in BILLBOARDS:
        with pytest.raises(NotImplementedError, match='faceCamera'):
            _load_both(path)
        return
    (st, sb), (jst, jsb) = _load_both(path)
    assert_settings_equal(st, jst)
    assert_builders_equal(sb, jsb)


def test_ecs_include_recursion_and_renderer_block(tmp_path):
    """-c includes nest (paths relative to the including file), later tags
    override earlier ones, and the -renderer block sets depth, spp,
    minContribution, tMaxShadowRay (scaled), backplate, filter and sampler
    and skips unknown keys."""
    sub = tmp_path / 'sub'
    sub.mkdir()
    (sub / 'lines.ppm').write_bytes(open(LINES, 'rb').read())
    (sub / 'inner.ecs').write_text('-spp 7  # inner\n-vp 1 2 3\n')
    (sub / 'mid.ecs').write_text('-c inner.ecs\n-size 40 30\n'
                                 '-renderer pathtracer { depth = 3 '
                                 'spp = 9 minContribution = 0.1 '
                                 'tMaxShadowRay = 12 backplate lines.ppm '
                                 'filter = BoxFilter sampler default '
                                 'unknownKey 5 }\n')
    top = tmp_path / 'top.ecs'
    top.write_text('-c sub/mid.ecs\n-fov 50\n')
    got, jgot = ecs.parse_ecs(str(top)), jecs.parse_ecs(str(top))
    assert_settings_equal(got[0], jgot[0])
    st = got[0]
    assert (st.spp, st.depth, st.width, st.height, st.fov) == (9, 3, 40, 30,
                                                               50.0)
    assert (st.cam_pos, st.min_contribution, st.t_max_shadow_ray) == (
        (1.0, 2.0, 3.0), 0.1, 12.0)
    assert (st.pixel_filter, st.sampler) == ('box', 'precomputed')
    assert st.backplate.shape == (64, 64, 3)


@pytest.mark.parametrize('tok,want', [
    ('default', 'default'), ('bvh2', 'bvh2'), ('bvh4', 'bvh4'),
    ('bvh4.triangle4', 'bvh4'), ('bvh4mb', 'bvh4mb'), ('bvh2.x', 'bvh2')])
def test_ecs_accel(tok, want):
    st = ecs.RenderSettings()
    ecs.parse(ecs.TokenStream.from_argv(['-accel', tok]), st, SceneBuilder())
    jst = jecs.RenderSettings()
    jecs.parse(jecs.TokenStream.from_argv(['-accel', tok]), jst,
               JSceneBuilder())
    assert st.accel == jst.accel == want


@pytest.mark.parametrize('argv', [['-bogus'], ['-accel', 'kdtree'],
                                  ['-connect']])
def test_ecs_rejects_unknown_tags(argv):
    for mod, sb in ((ecs, SceneBuilder()), (jecs, JSceneBuilder())):
        with pytest.raises(ValueError):
            mod.parse(mod.TokenStream.from_argv(argv), mod.RenderSettings(),
                      sb)


def test_ecs_every_tag_like_jax(tmp_path):
    """Every tag of the token language, the eight light tags and
    -backplate among them, on one stream through both packages."""
    (tmp_path / 'lines.ppm').write_bytes(open(LINES, 'rb').read())
    text = """
-trisphere 1 2 3 4 6 8
-ambientlight 0.1 0.2 0.3
-pointlight 1 2 3 4 5 6
-masked_pointlight 1 2 3 4 5 6 3 5
-directionallight 0 -1 0.5 1 1 1
-dirlight 0.2 -1 0 2 2 2
-distantlight 0 -1 0 3 3 3 4.5
-spotlight 0 5 0 0 -1 0 9 9 9 20 40
-trianglelight 0 3 0 1 0 0 0 0 1 5 5 5
-quadlight 0 4 0 2 0 0 0 0 2 6 6 6
-hdrilight 1.5 1 0.5 lines.ppm
-vp 1 2 3 -vi 4 5 6 -vd 0 0 1 -vu 0 0 1 -angle 45 -radius 0.5
-focaldistance 7 -stereo -toeIn -waterMark -eyeSeparation 6.5
-zeroParallax 200 -size 64 48 -jpegQuality 80 -fb RGBA8 -refine 3
-gamma 2.2 -vignetting 1 -depth 6 -tMaxShadowRay 50 -tMaxShadowJitter 0.3
-faceCullingMode forcesingle -spp 16 -backplate lines.ppm -frames 2
-o out.jpg -display -viewer 9001 -accel bvh2 -scene x -builder y
-traverser z -device w -devices 2 -connect a:1 b -threads 4 -verbose 2
-debug -profiling -fullscreen -regression -rtcore accel=bvh4
-renderer debug
"""
    p = tmp_path / 'all.ecs'
    p.write_text(text)
    (st, sb), (jst, jsb) = ecs.parse_ecs(str(p)), jecs.parse_ecs(str(p))
    assert_settings_equal(st, jst)
    assert_builders_equal(sb, jsb)
    assert [l['kind'] for l in sb.lights] == [
        'ambient', 'point', 'point', 'directional', 'directional', 'distant',
        'spot', 'triangle', 'triangle', 'triangle', 'hdri']
    assert st.connect == ('a:1', 'b') and st.viewer_port == 9001
    assert st.log_display
    ecs.parse(ecs.TokenStream.from_argv(['--no-logging']), st, sb)
    assert not st.log_display


def _write_xml_scene(d):
    """A scene file that uses every XML tag: named materials and scenes,
    Group and Transform in each affine form, TriangleMesh with a .bin
    sidecar, Sphere with motion, Disk, obj, xml and extern includes, and
    the eight light tags."""
    (d / 'lines.ppm').write_bytes(open(LINES, 'rb').read())
    pos = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    tri = np.int32([[0, 1, 2], [0, 2, 3]])
    nrm = np.float32([[0, 0, 1]] * 4)
    (d / 'scene.bin').write_bytes(pos.tobytes() + tri.tobytes()
                                  + nrm.tobytes())
    (d / 'part.obj').write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n'
                                'vt 0 0\nvt 1 0\nvt 0 1\n'
                                'f 1/1 2/2 3/3\ng two\nf -4 -2 -1\n')
    (d / 'inner.xml').write_text(
        '<scene><Sphere><position>0 0 0</position><radius>0.5</radius>'
        '<numTheta>4</numTheta><numPhi>5</numPhi></Sphere>'
        '<PointLight><AffineSpace translate="1 1 1"/><I>2 2 2</I>'
        '</PointLight></scene>')
    (d / 'scene.xml').write_text(f"""<?xml version="1.0"?>
<scene>
  <assign type="material" id="red"><material><code>"Matte"</code>
    <parameters><float3 name="reflectance">0.9 0.1 0.1</float3>
    </parameters></material></assign>
  <assign type="scene" id="ball"><Sphere><position>0 1 0</position>
    <radius>0.25</radius><numTheta>3</numTheta><numPhi>4</numPhi>
    <material id="red"/></Sphere></assign>
  <Group>
    <TriangleMesh>
      <material><code>"MatteTextured"</code><parameters>
        <texture name="Kd">"lines.ppm"</texture>
        <texture name="Ks">"missing.ppm"</texture>
        <float2 name="ds">2 2</float2><int name="n">3</int>
      </parameters></material>
      <positions ofs="0" size="4"/>
      <triangles ofs="{pos.nbytes}" size="2"/>
      <normals ofs="{pos.nbytes + tri.nbytes}" size="4"/>
      <texcoords>0 0 1 0 1 1 0 1</texcoords>
      <tangent_x>1 0 0 1 0 0 1 0 0 1 0 0</tangent_x>
      <tangent_y>0 1 0 0 1 0 0 1 0 0 1 0</tangent_y>
    </TriangleMesh>
    <Transform><AffineSpace translate="5 0 0"/>
      <ref id="ball"/>
      <Transform><AffineSpace scale="2 1 3"/>
        <Disk><position>0 0 0</position><radius>2</radius>
          <numTriangles>7</numTriangles><material id="red"/></Disk>
        <obj src="part.obj"/>
      </Transform>
      <Transform><AffineSpace rotate_x="30"/><xml src="inner.xml"/>
      </Transform>
      <Transform><AffineSpace rotate_y="45"/><extern src="part.obj"/>
      </Transform>
      <Transform><AffineSpace rotate_z="60"/><extern src="inner.xml"/>
      </Transform>
      <Transform><AffineSpace rotate="20" axis="1 1 0"/>
        <Sphere><position>0 0 0</position><radius>1</radius>
          <numTheta>3</numTheta><numPhi>3</numPhi>
          <motion>0 1 0</motion></Sphere>
      </Transform>
      <Transform><AffineSpace>0 0 1 1 0 1 0 2 -1 0 0 3</AffineSpace>
        <SpotLight><AffineSpace translate="0 4 0"/><I>5 5 5</I>
          <angleMin>20</angleMin><angleMax>40</angleMax></SpotLight>
        <DirectionalLight><AffineSpace rotate_x="-90"/><E>1 1 1</E>
        </DirectionalLight>
        <DistantLight><AffineSpace rotate_z="10"/><L>2 2 2</L>
          <halfAngle>3</halfAngle></DistantLight>
        <TriangleLight><AffineSpace translate="0 6 0"/><L>4 4 4</L>
        </TriangleLight>
        <QuadLight><AffineSpace scale="2 2 2"/><L>3 3 3</L></QuadLight>
        <HDRILight><AffineSpace rotate_y="90"/><L>1 0.5 0.25</L>
          <image>"lines.ppm"</image></HDRILight>
      </Transform>
    </Transform>
    <AmbientLight><L>0.2 0.3 0.4</L></AmbientLight>
  </Group>
</scene>
""")
    return str(d / 'scene.xml')


def test_xml_every_tag_like_jax(tmp_path):
    path = _write_xml_scene(tmp_path)
    (st, sb), (jst, jsb) = _load_both(path)
    assert_builders_equal(sb, jsb)
    assert len(sb.meshes) == 13 and len(sb.lights) == 10
    assert {l['kind'] for l in sb.lights} == {
        'point', 'spot', 'directional', 'distant', 'triangle', 'hdri',
        'ambient'}
    assert sb.meshes[0].motions is None and sb.meshes[9].motions is not None


@pytest.mark.parametrize('body,err', [
    ('<notscene/>', ValueError),
    ('<scene><Bogus/></scene>', ValueError),
    ('<scene><assign type="x" id="a"><Group/></assign></scene>', ValueError),
    ('<scene><Transform><AffineSpace>1 2 3</AffineSpace></Transform>'
     '</scene>', ValueError),
    ('<scene><TriangleMesh><positions ofs="0" size="1"/></TriangleMesh>'
     '</scene>', FileNotFoundError),
    ('<scene><TriangleMesh><positions>0 0 0 1</positions></TriangleMesh>'
     '</scene>', ValueError),
    ('<scene><TriangleMesh><faceCamera>1</faceCamera><positions>0 0 0 1 0 0'
     ' 0 1 0</positions><triangles>0 1 2</triangles></TriangleMesh>'
     '</scene>', NotImplementedError)])
def test_xml_rejects_malformed_scenes(tmp_path, body, err):
    p = tmp_path / 'bad.xml'
    p.write_text(body)
    with pytest.raises(err):
        xml_scene.load_xml(str(p), SceneBuilder())


def test_loaders_need_neither_jax_nor_pillow():
    """Every port module imports, and the ppm-textured sphere scenes load,
    commit and render (with a backplate) on the CPU without JAX, the JAX
    package or Pillow being imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import yulio_raytracer_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from yulio_raytracer_tpu_torch.io import builtin_scenes as bs, ecs\n"
        "from yulio_raytracer_tpu_torch.integrator import pathtracer as pt\n"
        "from yulio_raytracer_tpu_torch import renderer\n"
        f"st, sb = ecs.parse_ecs({os.path.join(ASSETS, 'sphere_mirror.ecs')!r})\n"
        "sb.commit(device='cpu')\n"
        "sc = bs.sphere_glass().commit(device='cpu')\n"
        "renderer.render_frame(sc, bs.sphere_glass_camera(8, 8),\n"
        "                      pt.PTParams(max_depth=2), 8, 8, spp=1,\n"
        "                      backplate=st.backplate or [[[1, 1, 1]]])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] in ('yulio_raytracer_tpu', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


# ---------------------------------------------------------------- goldens

def _trimmed_psnr(a, b, keep=0.99):
    """PSNR over the 99% of values closest to the reference: tells a few
    chaotic specular paths from a fault across the image."""
    err = np.sort(((a - b) ** 2).ravel())[:int(a.size * keep)]
    return 10 * np.log10(max(b.max(), 1e-9) ** 2 / max(err.mean(), 1e-20))


def _glass(res, depth, spp):
    sc = bs.sphere_glass().commit(device='cpu')
    assert (sc.accel, sc.num_triangles) == ('bvh4', 4992)
    film, stats = renderer.render_frame(
        sc, bs.sphere_glass_camera(res, res), pt.PTParams(max_depth=depth),
        res, res, spp=spp, seed=42)
    img = accum.resolve(film).numpy()
    golden = np.load(os.path.join(GOLDEN, f'sphere_glass_{res}_cpu.npz'))[
        'img']
    assert img.shape == golden.shape and np.isfinite(img).all()
    return img, golden


def test_sphere_glass_32_matches_pinned_golden():
    """The sphere_glass_32 golden (32^2, 8 spp, depth 6, seed 42, as
    tests/test_golden.py) through the port's BVH4 path.  Its glass chains
    amplify the last-ulp differences of the port's hit distances into a
    few whole samples (ROADMAP C4: the reference's own TPU render reads
    49.28 dB on the 64^2 golden), so the gate is the trimmed-1% PSNR at
    60 dB with the plain PSNR at 40 dB."""
    img, golden = _glass(32, 6, 8)
    assert _trimmed_psnr(img, golden) >= 60.0
    assert _psnr(img, golden) >= 40.0


@pytest.mark.slow
def test_sphere_glass_64_matches_pinned_golden():
    """The full sphere_glass_64 golden (64^2, 32 spp, depth 8) at the same
    gates."""
    img, golden = _glass(64, 8, 32)
    assert _trimmed_psnr(img, golden) >= 60.0
    assert _psnr(img, golden) >= 40.0
