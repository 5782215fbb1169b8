"""The torch port's precomputed sampler, render_progressive and
commit(quality=) on the CPU, held against the JAX package on the same
inputs: the sample tables bit-equal (np.array_equal), renders >= 60 dB
with equal ray counts, compaction 'off' and 'on' films bit-equal, the
three quality trees' node tables and triangle order equal, and a
stopped-and-resumed progressive run bit-equal to an uninterrupted
one."""
import os

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.api import output as joutput
from yulio_raytracer_tpu.film import accum as jaccum
from yulio_raytracer_tpu.geometry import bvh as jbvh
from yulio_raytracer_tpu.geometry import mesh as jmesh
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.io import ecs as jecs
from yulio_raytracer_tpu.sampling import precomputed as jpc
from yulio_raytracer_tpu.scene import SceneBuilder as JSceneBuilder

from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.api import output
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.geometry import bvh
from yulio_raytracer_tpu_torch.geometry import mesh
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import ecs
from yulio_raytracer_tpu_torch.sampling import precomputed as pc
from yulio_raytracer_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))
ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'scenes')


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(b.max(), 1e-9) ** 2 / max(mse, 1e-20))


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize('seed', [27, 0, 5897, -42, 2147483646])
def test_ran1_streams_match_jax(seed):
    """200 getInt and 200 getFloat draws after each seed's warm-up."""
    r, jr = pc.Ran1(seed), jpc.Ran1(seed)
    assert [r.get_int() for _ in range(200)] == \
        [jr.get_int() for _ in range(200)]
    f, jf = [r.get_float() for _ in range(200)], \
        [jr.get_float() for _ in range(200)]
    assert all(type(a) is np.float32 and a == b for a, b in zip(f, jf))
    assert np.array_equal(r.get_floats(37), jr.get_floats(37))
    assert r.get_int(64) == jr.get_int(64)


@pytest.mark.parametrize('n', [1, 4, 17, 64, 100])
def test_patterns_match_jax(n):
    """permutation, jittered and multi_jittered (non-squares too), drawn
    one after another from one stream, and the b-spline warp."""
    r, jr = pc.Ran1(n), jpc.Ran1(n)
    assert np.array_equal(pc.permutation(n, r), jpc.permutation(n, jr))
    a, b = pc.jittered(n, r), jpc.jittered(n, jr)
    assert a.dtype == np.float32 and np.array_equal(a, b)
    a, b = pc.multi_jittered(n, r), jpc.multi_jittered(n, jr)
    assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(pc.bspline_warp(a), jpc.bspline_warp(b))
    assert r.get_int() == jr.get_int()


@pytest.mark.parametrize('filt', ['box', 'bspline'])
@pytest.mark.parametrize('iteration', [0, 3])
@pytest.mark.parametrize('spp', [1, 3, 6, 16])
def test_build_tables_match_jax(spp, iteration, filt):
    """Every table of every set, at powers of two and not."""
    got = pc.build_tables(spp, iteration, num_1d=3, num_2d=4,
                          pixel_filter=filt)
    ref = jpc.build_tables(spp, iteration, num_1d=3, num_2d=4,
                           pixel_filter=filt)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize('w,h,line', [(40, 24, 0), (40, 24, 4), (16, 16, 0),
                                      (33, 17, 2)])
def test_tile_set_ids_match_jax(w, h, line):
    got, ref = pc.tile_set_ids(w, h, line), jpc.tile_set_ids(w, h, line)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


# ----------------------------------------------------------- the renders

def _render_pair(scene, jscene, cam, jcam, res, spp, depth, **kw):
    """Port and JAX render_frame under the precomputed sampler: (port
    film, its stats, PSNR against the JAX film, the JAX ray count)."""
    film, stats = renderer.render_frame(
        scene, cam, pt.PTParams(max_depth=depth), res, res, spp=spp,
        seed=7, sampler='precomputed', **kw)
    kw.pop('compaction', None)
    kw.pop('bounce_stats', None)
    jfilm, jstats = jrenderer.render_frame(
        jscene, jcam, jpt.PTParams(max_depth=depth), res, res, spp=spp,
        seed=7, sampler='precomputed', **kw)
    img = accum.resolve(film).numpy()
    assert np.isfinite(img).all()
    return (film, stats, _psnr(img, np.asarray(jaccum.resolve(jfilm))),
            jstats.num_rays)


@pytest.mark.parametrize('filt,iteration', [('bspline', 0), ('box', 2)])
def test_precomputed_cornell_matches_jax(filt, iteration):
    """cornell 24^2, 2 spp, depth 3 (dense: trace), the b-spline filter
    and the box at a later iteration: >= 60 dB, equal rays."""
    _, stats, db, jn = _render_pair(
        bs.cornell_box().commit(device='cpu'), jbs.cornell_box().commit(),
        bs.cornell_camera(24, 24), jbs.cornell_camera(24, 24), 24, 2, 3,
        pixel_filter=filt, iteration=iteration)
    assert db >= 60.0 and stats.num_rays == jn


def test_precomputed_motion_matches_jax():
    """The reduced motion field (each ray's time from the tables' time
    dimension), 24^2, 3 spp (tables of 4), depth 2: >= 60 dB, equal
    rays."""
    _, stats, db, jn = _render_pair(
        bs.motion_field(n_spheres=4).commit(device='cpu'),
        jbs.motion_field(n_spheres=4).commit(),
        bs.motion_field_camera(24, 24), jbs.motion_field_camera(24, 24),
        24, 3, 2)
    assert db >= 60.0 and stats.num_rays == jn


def test_precomputed_roulette_compaction_matches_jax():
    """The reduced colonnade at depth 6 (roulette fires from bounce 4 on
    the 1D scatter-type value): compaction 'on' >= 60 dB against the JAX
    package's compacted render with equal rays, and bit-equal to the
    port's 'off' film."""
    scene = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                   leaf_size=32)
    jscene = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    cams = bs.colonnade_camera(16, 16), jbs.colonnade_camera(16, 16)
    stats_on = []
    f_on, s_on, db, jn = _render_pair(scene, jscene, *cams, 16, 2, 6,
                                      compaction='on',
                                      bounce_stats=stats_on)
    assert db >= 60.0 and s_on.num_rays == jn
    assert stats_on[-1]['live'] < stats_on[0]['live'] // 2
    f_off, s_off = renderer.render_frame(
        scene, cams[0], pt.PTParams(max_depth=6), 16, 16, spp=2, seed=7,
        sampler='precomputed', compaction='off')
    assert torch.equal(f_on.rgb_sum, f_off.rgb_sum)
    assert s_on.num_rays == s_off.num_rays


def test_stateless_path_builds_no_tables(monkeypatch):
    """sampler='stateless' builds no table and adds no state key; an
    unknown sampler raises."""
    monkeypatch.setattr(pc, 'build_tables', None)
    scene = bs.cornell_box().commit(device='cpu')
    cam = bs.cornell_camera(8, 8)
    film, _ = renderer.render_frame(scene, cam, pt.PTParams(max_depth=2),
                                    8, 8, spp=1)
    assert np.isfinite(accum.resolve(film).numpy()).all()
    org = torch.zeros((4, 3))
    ids = torch.arange(4)
    assert not {'sset', 'ssidx'} & pt._init_state(org, org, ids, ids).keys()
    with pytest.raises(ValueError):
        renderer.render_frame(scene, cam, pt.PTParams(), 8, 8, spp=1,
                              sampler='sobol')


def test_renderer_block_sampler_through_render_mono():
    """`-renderer pathtracer { sampler = precomputed }` in argv reaches
    render_frame through render_mono: >= 60 dB against the JAX package's
    render_mono of the same settings."""
    argv = ['-c', os.path.join(ASSETS, 'cornell_box.ecs'), '-size', '16',
            '16', '-renderer', 'pathtracer', '{', 'spp', '=', '2', 'depth',
            '=', '3', 'sampler', '=', 'precomputed', '}']
    st, jst = ecs.RenderSettings(), jecs.RenderSettings()
    sb, jsb = SceneBuilder(), JSceneBuilder()
    ecs.parse(ecs.TokenStream.from_argv(argv), st, sb, '.')
    jecs.parse(jecs.TokenStream.from_argv(argv), jst, jsb, '.')
    assert st.sampler == jst.sampler == 'precomputed'
    img, stats = output.render_mono(sb.commit(device='cpu'), st, '',
                                    device='cpu')
    jimg, jstats = joutput.render_mono(jsb.commit(), jst, '')
    assert _psnr(img, np.asarray(jimg)) >= 60.0
    assert stats.num_rays == jstats.num_rays


# --------------------------------------------------- render_progressive

def test_render_progressive_resumes_bit_equal(tmp_path):
    """The JAX package's test_film.py scenario: 2 of 4 iterations, stopped,
    then resumed from the checkpoint, is bit-equal to an uninterrupted
    run of render_frame iterations, and >= 60 dB against the JAX
    package's resumed run; progress reaches 1."""
    scene = bs.cornell_box(with_boxes=False).commit(device='cpu')
    cam = bs.cornell_camera(16, 16)
    params = pt.PTParams(max_depth=2)
    ckpt = str(tmp_path / 'film.npz')
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] > 2

    film_a, done = renderer.render_progressive(
        scene, cam, params, 16, 16, 2, 4, checkpoint_path=ckpt, seed=5,
        stop_flag=stop)
    assert done == 2 and os.path.exists(ckpt)
    assert not os.path.exists(ckpt + '.tmp.npz')
    with np.load(ckpt) as d:
        assert int(d['iteration']) == 2
        np.testing.assert_array_equal(d['rgb_sum'], film_a.rgb_sum.numpy())
    fractions = []
    film_b, done_b = renderer.render_progressive(
        scene, cam, params, 16, 16, 2, 4, checkpoint_path=ckpt, seed=5,
        progress_cb=fractions.append)
    assert done_b == 4 and fractions == [0.75, 1.0]
    film_ref = None
    for it in range(4):
        film_ref, _ = renderer.render_frame(scene, cam, params, 16, 16, 2,
                                            film=film_ref, iteration=it,
                                            seed=5)
    assert torch.equal(film_b.rgb_sum, film_ref.rgb_sum)
    assert torch.equal(film_b.weight, film_ref.weight)
    jckpt = str(tmp_path / 'jfilm.npz')
    jscene = jbs.cornell_box(with_boxes=False).commit()
    jcalls = [0]

    def jstop():
        jcalls[0] += 1
        return jcalls[0] > 2

    jargs = (jscene, jbs.cornell_camera(16, 16), jpt.PTParams(max_depth=2),
             16, 16, 2, 4)
    jrenderer.render_progressive(*jargs, checkpoint_path=jckpt, seed=5,
                                 stop_flag=jstop)
    jfilm, _ = jrenderer.render_progressive(*jargs, checkpoint_path=jckpt,
                                            seed=5)
    assert _psnr(film_b.rgb_sum.numpy(), np.asarray(jfilm.rgb_sum)) >= 60.0
    np.testing.assert_array_equal(film_b.weight.numpy(),
                                  np.asarray(jfilm.weight))


# -------------------------------------------------------- commit quality

@pytest.mark.parametrize('quality', ['normal', 'high', 'high-spatial'])
def test_commit_quality_matches_jax(quality):
    """The reduced colonnade at leaf 32: the tree (nodes, leaf ranges,
    skip pointers, triangle order) equal to the JAX package's
    gbvh.build(..., quality=q), the committed binary and BVH4 tables and
    the gathered shading table equal to the JAX commit's, and the render
    >= 60 dB against the JAX render with equal rays."""
    sb = bs.colonnade(**COLONNADE_SMALL)
    jsb = jbs.colonnade(**COLONNADE_SMALL)
    packed, jpacked = mesh.pack_meshes(sb.meshes), jmesh.pack_meshes(
        jsb.meshes)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=32, quality=quality)
    jtree = jbvh.build(jpacked.v0, jpacked.e1, jpacked.e2, jpacked.valid,
                       leaf_size=32, quality=quality)
    for f in ('lo', 'hi', 'start', 'count', 'skip', 'order'):
        a, b = getattr(tree, f), getattr(jtree, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tree.num_nodes == jtree.num_nodes
    t = packed.num_triangles
    assert (tree.num_refs == t) == (quality == 'normal')
    scene = sb.commit(device='cpu', leaf_size=32, quality=quality)
    jscene = jsb.commit(leaf_size=32, quality=quality)
    assert scene.bvh_refs == tree.num_refs and scene.bvh_seconds > 0
    assert (scene.accel, scene.num_triangles) == (jscene.accel, t)
    np.testing.assert_array_equal(scene.nodes.numpy(),
                                  np.asarray(jscene.packet['nodes']))
    np.testing.assert_array_equal(scene.nodes4.numpy(),
                                  np.asarray(jscene.packet['nodes4']))
    np.testing.assert_array_equal(scene.geom['shade_tab'].numpy(),
                                  np.asarray(jscene.geom['shade_tab']))
    film, stats = renderer.render_frame(
        scene, bs.colonnade_camera(16, 16), pt.PTParams(max_depth=3), 16,
        16, spp=2, seed=42)
    jfilm, jstats = jrenderer.render_frame(
        jscene, jbs.colonnade_camera(16, 16), jpt.PTParams(max_depth=3), 16,
        16, spp=2, seed=42)
    assert _psnr(accum.resolve(film).numpy(),
                 np.asarray(jaccum.resolve(jfilm))) >= 60.0
    assert stats.num_rays == jstats.num_rays


def test_commit_quality_motion_and_unknown():
    """A motion scene builds its numpy tree whatever the quality (as the
    reference's commit forces 'normal'); an unknown quality raises."""
    sb = bs.motion_field(n_spheres=4)
    a = sb.commit(device='cpu', force_bvh=True, quality='high-spatial')
    b = sb.commit(device='cpu', force_bvh=True)
    assert a.accel == 'bvh4mb' and torch.equal(a.nodes, b.nodes)
    with pytest.raises(ValueError):
        bs.cornell_box().commit(device='cpu', quality='fast')
