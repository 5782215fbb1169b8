"""The torch port's motion-blur path held against the JAX package: motion
vertex buffers, union bounds, the numpy SAH builder over them and the
motion tables; the plain motion traversal, closest and any hit, against
the Pallas kernel (interpret mode) and the brute-force reference; the
committed scenes; and the motion field rendered end to end.  The CUDA
kernel's two forms are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import bvh as jbvh, mesh as jmesh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.ops import intersect as jops
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu.scene import SceneBuilder as JSceneBuilder
from yulio_raytracer_tpu.shading import materials as jmat
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.geometry import bvh, mesh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import intersect as ops, traverse
from yulio_raytracer_tpu_torch.scene import SceneBuilder
from yulio_raytracer_tpu_torch.shading import materials as gmat
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.film import accum

from test_torch_scene import _numpy_leaves, _assert_scenes_equal

torch.set_num_threads(2)
R = ppt.BLOCK          # tests/test_motion.py test_motion_packet_matches_brute
R_ODD = 1000           # the port takes any count


def _moving_scene(m, p, builder, mats):
    """The tests/test_motion.py packet scene: a quad moving along +x and
    a sphere falling, built with mesh/primitives/SceneBuilder/materials
    modules m, p, builder, mats of one package."""
    sb = builder()
    mat = sb.add_material(mats.make_material('matte', {}))
    pos = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
    sb.add_mesh(m.HostMesh(pos, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                           motions=np.tile(np.float32([2, 0, 0]), (4, 1)),
                           material=mat))
    sph = p.tessellate_sphere([0, 2, 0], 0.6, 10, 12, material=mat)
    sph.motions = np.tile(np.asarray([0.0, -1.5, 0.0], np.float32),
                          (len(sph.positions), 1))
    sb.add_mesh(sph)
    return sb


def _both(which):
    """(JAX SceneBuilder, port SceneBuilder, commit kwargs) of a motion
    scene."""
    if which == 'test_motion':
        return (_moving_scene(jmesh, jprim, JSceneBuilder, jmat),
                _moving_scene(mesh, primitives, SceneBuilder, gmat),
                dict(force_bvh=True, leaf_size=8))
    return (jbs.motion_field(n_spheres=4), bs.motion_field(n_spheres=4), {})


@pytest.mark.parametrize('which', ['test_motion', 'motion_field_4'])
def test_motion_tables_match(which):
    """pack_meshes' motion arrays, motion_bounds, the numpy builder over
    them, pack_nodes and pack_tris_mb equal the JAX package's."""
    jsb, sb, _ = _both(which)
    jpk, pk = jmesh.pack_meshes(jsb.meshes), mesh.pack_meshes(sb.meshes)
    for k in bvh.PER_TRIANGLE_KEYS:
        np.testing.assert_array_equal(getattr(pk, k), getattr(jpk, k),
                                      err_msg=k)
    keys = ('v0', 'e1', 'e2', 'mv0', 'me1', 'me2')
    jb = ppt.motion_bounds(*(getattr(jpk, k) for k in keys))
    b = traverse.motion_bounds(*(getattr(pk, k) for k in keys))
    for x, y in zip(b, jb):
        np.testing.assert_array_equal(x, y)
    jtree = jbvh.build(jpk.v0, jpk.e1, jpk.e2, jpk.valid, leaf_size=8,
                       bounds=jb, quality='normal')
    tree = bvh.build(pk.v0, pk.e1, pk.e2, pk.valid, leaf_size=8, bounds=b)
    for f in ('lo', 'hi', 'start', 'count', 'skip', 'order'):
        np.testing.assert_array_equal(getattr(tree, f), getattr(jtree, f),
                                      err_msg=f)
    np.testing.assert_array_equal(traverse.pack_nodes(tree),
                                  ppt.pack_nodes(jtree))
    host = bvh.permute_geom({k: getattr(pk, k) for k in bvh.PER_TRIANGLE_KEYS},
                            tree.order)
    jhost = jbvh.permute_geom({k: getattr(jpk, k) for k in (
        *keys, 'cull', 'valid')}, jtree.order)
    np.testing.assert_array_equal(traverse.pack_tris_mb(host),
                                  ppt.pack_tris_mb(jhost))


@pytest.mark.parametrize('which', ['test_motion', 'motion_field_4'])
def test_from_numpy_scene_equals_own_commit_motion(which):
    jsb, sb, kw = _both(which)
    js, own = jsb.commit(**kw), sb.commit(device='cpu', **kw)
    assert own.motion is not None
    assert own.accel == ('bvh4mb' if which == 'test_motion' else 'dense')
    _assert_scenes_equal(tscene.from_numpy_scene(**_numpy_leaves(js)), own)


@pytest.fixture(scope='module')
def moving():
    """The test_motion.py packet scene committed by both packages, its
    rays (RandomState(9)) and times."""
    jsb, sb, kw = _both('test_motion')
    js, sc = jsb.commit(**kw), sb.commit(device='cpu', **kw)
    rs = np.random.RandomState(9)
    org = rs.randn(R, 3).astype(np.float32) * 2 + np.float32([0, 3, 0])
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (org, d, np.full((R,), 1e-4, np.float32),
            np.full((R,), np.inf, np.float32))
    return dict(js=js, sc=sc, rays=rays,
                time=rs.rand(R).astype(np.float32))


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_motion_matches_pallas_and_brute(moving, n):
    """The plain motion traversal against the Pallas motion kernel and
    the brute-force reference, at tests/test_motion.py's tolerances."""
    js, sc = moving['js'], moving['sc']
    jr = tuple(jnp.asarray(x) for x in moving['rays'])
    jtime = jnp.asarray(moving['time'])
    tr = tuple(torch.as_tensor(x[:n]) for x in moving['rays'])
    time = torch.as_tensor(moving['time'][:n])
    got = traverse.intersect_packet_mb(sc.nodes, sc.tris_mb, *tr, time)
    t1 = got.t.numpy()
    for ref in (ppt.intersect_packet_mb(
            js.packet['nodes'], js.packet['tris_mb'], *jr, jtime,
            max_leaf=js.leaf_size, interpret=True),
                jops.intersect_brute(js.geom, *jr, block=64, time=jtime)):
        t0 = np.asarray(ref.t)[:n]
        assert (np.isfinite(t1) == np.isfinite(t0)).all()
        both = np.isfinite(t1)
        np.testing.assert_allclose(t1[both], t0[both], rtol=1e-4, atol=1e-5)
        assert (got.tri.numpy()[both] == np.asarray(ref.tri)[:n][both]
                ).mean() > 0.999
    tf4 = torch.full((n,), 4.0)
    occ = traverse.occluded_packet_mb(sc.nodes, sc.tris_mb, *tr[:3], tf4,
                                      time)
    occ_ref = jops.occluded_brute(js.geom, *jr[:3], jnp.full((R,), 4.0),
                                  time=jtime)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])
    # the port's brute-force reference agrees as well
    brute = ops.intersect_brute(sc.motion, *tr, time=time)
    np.testing.assert_array_equal(brute.tri.numpy() >= 0, np.isfinite(t1))
    np.testing.assert_array_equal(
        ops.occluded_brute(sc.motion, *tr[:3], tf4, time=time).numpy(),
        occ.numpy())


def _both_trees(which):
    """The JAX and port commits of a motion scene with its tree: the
    test_motion.py scene at leaf 8, or the reduced motion field at the
    default leaf 64 (leaves of 33-64 rows)."""
    jsb, sb, kw = _both(which)
    kw = dict(kw, force_bvh=True)
    js, sc = jsb.commit(**kw), sb.commit(device='cpu', **kw)
    assert sc.accel == 'bvh4mb'
    return js, sc


def _segments(sc, n, seed):
    """n rays from the scene's box in random directions at random times
    (numpy RandomState(seed)), tnear 1e-4: every seventh dead (tfar -1),
    every eleventh empty (tfar == tnear), every fifth of the others ending
    at a random t below 3, the rest to infinity.  Returns (rays, time) as
    numpy arrays."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(sc.bbox_lo), np.asarray(sc.bbox_hi)
    org = (lo + (hi - lo) * rs.rand(n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[3::5] = rs.rand(len(tf[3::5])).astype(np.float32) * 3.0
    tf[::7] = -1.0
    tf[1::11] = tn[1::11]
    return (org, d, tn, tf), rs.rand(n).astype(np.float32)


@pytest.mark.parametrize('which', ['test_motion', 'motion_field_4'])
def test_motion_any_hit_is_the_closest_hit_mask(which):
    """The motion any-hit plain version (occluded_packet_mb on the CPU)
    equals intersect_motion_plain's tri >= 0 on every ray, dead and empty
    segments and segments behind the origin included (all false there);
    and it equals the JAX occluded_packet_mb (interpret mode) and both
    packages' brute-force occlusion, as tests/test_motion.py holds them."""
    js, sc = _both_trees(which)
    rays, time = _segments(sc, R, 4)
    tr = [torch.as_tensor(x) for x in rays]
    ttime = torch.as_tensor(time)
    occ = traverse.occluded_packet_mb(sc.nodes, sc.tris_mb, *tr, ttime)
    hit = traverse.intersect_motion_plain(sc.nodes, sc.tris_mb, *tr, ttime)
    np.testing.assert_array_equal(occ.numpy(), (hit.tri >= 0).numpy())
    empty = rays[3] <= rays[2]
    assert empty.any() and not occ.numpy()[empty].any()
    assert 0 < occ.numpy().sum() < (~empty).sum()
    jr, jtime = [jnp.asarray(x) for x in rays], jnp.asarray(time)
    for ref in (ppt.occluded_packet_mb(js.packet['nodes'],
                                       js.packet['tris_mb'], *jr, jtime,
                                       max_leaf=js.leaf_size, interpret=True),
                jops.occluded_brute(js.geom, *jr, time=jtime),
                ops.occluded_brute(sc.motion, *tr, time=ttime)):
        np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    # segments behind their origins (tnear < tfar < 0): the closest walk
    # takes its root at entry t 0, so neither form reports a hit
    tr[2], tr[3] = torch.full((R,), -2.0), torch.full((R,), -0.5)
    hit = traverse.intersect_motion_plain(sc.nodes, sc.tris_mb, *tr, ttime)
    occ = traverse.occluded_packet_mb(sc.nodes, sc.tris_mb, *tr, ttime)
    assert not bool(occ.any()) and not bool((hit.tri >= 0).any())


def test_brute_matches_jax_with_and_without_time(moving):
    js, sc = moving['js'], moving['sc']
    jr = tuple(jnp.asarray(x) for x in moving['rays'])
    tr = tuple(torch.as_tensor(x) for x in moving['rays'])
    geom = dict(sc.motion)
    for time in (None, moving['time']):
        ref = jops.intersect_brute(
            js.geom, *jr, time=None if time is None else jnp.asarray(time))
        got = ops.intersect_brute(
            geom, *tr, time=None if time is None else torch.as_tensor(time))
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
        hit = got.tri.numpy() >= 0
        np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(ref.u)[hit],
                                   atol=1e-5)


# ------------------------------------------------------------ whole slice

def _render_both(jsb, sb, res, spp, depth, **kw):
    film, stats = renderer.render_frame(
        sb.commit(device='cpu', **kw), bs.motion_field_camera(res, res),
        pt.PTParams(max_depth=depth), res, res, spp=spp, seed=42)
    jfilm, jstats = jrenderer.render_frame(
        jsb.commit(**kw), jbs.motion_field_camera(res, res),
        jpt.PTParams(max_depth=depth), res, res, spp=spp, seed=42)
    img, ref = accum.resolve(film).numpy(), np.asarray(jaccum.resolve(jfilm))
    assert img.shape == ref.shape and np.isfinite(img).all()
    mse = ((img - ref) ** 2).mean()
    return 10 * np.log10(ref.max() ** 2 / max(mse, 1e-20)), stats, jstats


def test_motion_field_matches_jax_render():
    """The reduced motion field (brute-force motion path on both sides)
    against the JAX package's render_frame."""
    db, stats, jstats = _render_both(jbs.motion_field(n_spheres=4),
                                     bs.motion_field(n_spheres=4), 32, 4, 2)
    assert db >= 60.0
    assert stats.num_rays == jstats.num_rays


def test_motion_field_packet_path_matches_jax_render():
    """The full motion field through the plain motion traversal against
    the JAX package's CPU render (brute force at each ray's time)."""
    db, stats, jstats = _render_both(jbs.motion_field(), bs.motion_field(),
                                     24, 2, 2)
    assert db >= 60.0
    assert stats.num_rays == jstats.num_rays
