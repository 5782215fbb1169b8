"""The torch port's binary-BVH path held against the JAX package: the binary
node table, the plain closest-hit and any-hit traversals against the Pallas
kernels (interpret mode, as the JAX package's own tests run them) and
against the brute-force reference, commit's accel semantics, the reduced
colonnade rendered with accel='bvh2', and the split of the shadow any-hit
batch.  The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.ops import intersect as jops
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu.ops import pallas_wide as pw
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import cuda_build as cb
from yulio_raytracer_tpu_torch.ops import traverse, wide
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.film import accum

from test_torch_ops import build_tables, _assert_hits_agree
from test_torch_scene import _numpy_leaves, _assert_scenes_equal

torch.set_num_threads(2)
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))
R = 2 * ppt.BLOCK      # tests/test_pallas.py test_packet_matches_brute
R_ODD = 1000           # the port takes any count


def test_pack_nodes_match_on_pallas_scene():
    _, _, jtree = build_tables(jmesh, jbvh, jprim, quality='high')
    _, _, tree = build_tables(mesh, bvh, primitives)
    np.testing.assert_array_equal(traverse.pack_nodes(tree),
                                  ppt.pack_nodes(jtree))


def _chain(depth):
    """Node rows of a chain of `depth` levels: interior node i has the
    leaf i + 1 as its left child and the next interior node as its
    right child."""
    n = 2 * depth - 1
    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 7] = 1.0                     # one-triangle leaves
    for i in range(0, n - 1, 2):
        nodes[i, 6:8] = (i + 2, -1.0)
    return nodes


def test_pack_nodes_checks_the_stack_bound():
    """A tree whose walk could overflow the per-ray stack raises, as
    pack_nodes4 does for the BVH4 rows."""
    traverse._check_nodes(_chain(traverse.STACK - 1))
    with pytest.raises(ValueError, match='stack'):
        traverse._check_nodes(_chain(traverse.STACK))


@pytest.fixture(scope='module')
def tables():
    """JAX and port tables of the tests/test_pallas.py scene (leaf 8, the
    commit's default tree), its rays (RandomState(0)) and its brute-force
    reference hits."""
    jhost, jwoop, jtree = build_tables(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = build_tables(mesh, bvh, primitives)
    rs = np.random.RandomState(0)
    org = rs.randn(R, 3).astype(np.float32) * 3
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (org, d, np.full((R,), 1e-4, np.float32),
            np.full((R,), np.inf, np.float32))
    jr = tuple(jnp.asarray(x) for x in rays)
    jgeom = {k: jnp.asarray(v) for k, v in jhost.items()}
    return dict(
        jnodes=jnp.asarray(ppt.pack_nodes(jtree)),
        jtris=jnp.asarray(ppt.pack_tris(jwoop, jhost)),
        nodes=torch.as_tensor(traverse.pack_nodes(tree)),
        tris=torch.as_tensor(wide.pack_tris(woop, host)),
        rays=rays, brute=jops.intersect_brute(jgeom, *jr, block=64))


def _torch_rays(rays, n=None):
    return tuple(torch.as_tensor(x[:n]) for x in rays)


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_binary_matches_pallas_and_brute(tables, n):
    jr = tuple(jnp.asarray(x) for x in tables['rays'])
    tr = _torch_rays(tables['rays'], n)
    ref = ppt.intersect_packet(tables['jnodes'], tables['jtris'], *jr,
                               max_leaf=8, interpret=True)
    got = traverse.intersect_packet(tables['nodes'], tables['tris'], *tr)
    _assert_hits_agree(got, ref, n)
    # the brute-force reference (Moller-Trumbore: float-level t only)
    brute = tables['brute']
    t0 = np.asarray(brute.t)[:n]
    np.testing.assert_array_equal(got.tri.numpy() >= 0, np.isfinite(t0))
    hit = np.isfinite(t0)
    np.testing.assert_allclose(got.t.numpy()[hit], t0[hit], rtol=1e-4,
                               atol=1e-5)
    assert (got.tri.numpy()[hit] == np.asarray(brute.tri)[:n][hit]).mean() \
        > 0.999
    occ_ref = ppt.occluded_packet(tables['jnodes'], tables['jtris'], *jr,
                                  max_leaf=8, interpret=True)
    occ = traverse.occluded_packet(tables['nodes'], tables['tris'], *tr)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])
    np.testing.assert_array_equal(occ.numpy(), hit)


def test_plain_binary_dead_and_finite_lanes(tables):
    """Dead lanes (tfar < tnear) miss and are not occluded; finite
    segments stop at tfar; both as the Pallas kernels."""
    org, d, tn, tf = (x[:ppt.BLOCK].copy() for x in tables['rays'])
    tf[::7] = -1.0
    tf[3::7] = 2.5
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    tr = tuple(torch.as_tensor(x) for x in (org, d, tn, tf))
    ref = ppt.intersect_packet(tables['jnodes'], tables['jtris'], *jr,
                               max_leaf=8, interpret=True)
    got = traverse.intersect_packet(tables['nodes'], tables['tris'], *tr)
    _assert_hits_agree(got, ref)
    assert (got.tri.numpy()[::7] == -1).all()
    occ = traverse.occluded_packet(tables['nodes'], tables['tris'], *tr)
    assert not occ.numpy()[::7].any()
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(ppt.occluded_packet(
            tables['jnodes'], tables['jtris'], *jr, max_leaf=8,
            interpret=True)))


def test_plain_binary_wrappers_bound_the_ray_count(tables):
    """A batch the kernels cannot index raises before any launch."""
    n = cb.MAX_RAYS
    rays = (torch.empty((n, 3), device='meta'),
            torch.empty((n, 3), device='meta'),
            torch.empty((n,), device='meta'), torch.empty((n,), device='meta'))
    tabs = (tables['nodes'].to('meta'), tables['tris'].to('meta'))
    for fn in (traverse.intersect_packet, traverse.occluded_packet):
        with pytest.raises(ValueError, match='exceed one launch'):
            fn(*tabs, *rays)
    for fn in (traverse.intersect_packet_mb, traverse.occluded_packet_mb):
        with pytest.raises(ValueError, match='exceed one launch'):
            fn(*tabs, *rays, torch.empty((n,), device='meta'))


def test_plain_binary_matches_bvh4_on_colonnade():
    """The binary and BVH4 traversals of one reduced-colonnade tree find
    the same closest hits and occlusion."""
    s2 = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32,
                                                accel='bvh2')
    s4 = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    torch.testing.assert_close(s2.tris, s4.tris, rtol=0, atol=0)
    rs = np.random.RandomState(4)
    n = 2000
    org = torch.as_tensor((rs.randn(n, 3) * 4 + [0, 2, 0]).astype(np.float32))
    d = rs.randn(n, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    tn = torch.full((n,), 1e-4)
    tf = torch.full((n,), float('inf'))
    got = traverse.intersect_packet(s2.nodes, s2.tris, org, d, tn, tf)
    ref = wide.intersect_packet4(s4.nodes4, s4.tris, org, d, tn, tf)
    np.testing.assert_array_equal(got.tri.numpy(), ref.tri.numpy())
    np.testing.assert_array_equal(got.t.numpy(), ref.t.numpy())
    tf = torch.full((n,), 3.0)
    np.testing.assert_array_equal(
        traverse.occluded_packet(s2.nodes, s2.tris, org, d, tn, tf).numpy(),
        wide.occluded_packet4(s4.nodes4, s4.tris, org, d, tn, tf).numpy())


# ------------------------------------------------------ commit semantics

def test_commit_accel_records_what_runs():
    sb = bs.colonnade(**COLONNADE_SMALL)
    assert sb.commit(device='cpu', leaf_size=32).accel == 'bvh4'
    s2 = sb.commit(device='cpu', leaf_size=32, accel='bvh2')
    assert s2.accel == 'bvh2' and s2.nodes4 is None
    assert s2.nodes is not None and s2.tris is not None
    assert bs.cornell_box().commit(device='cpu', accel='bvh2').accel == 'dense'
    assert bs.cornell_box().commit(device='cpu',
                                   force_bvh=True).accel == 'bvh4'


def test_commit_default_falls_back_to_binary(monkeypatch):
    """'default' takes the binary tables when the BVH4 collapse fails its
    guard; 'bvh4' raises there."""
    def refuse(out, width):
        raise ValueError("wide tree too deep")
    monkeypatch.setattr(wide, '_check_packed', refuse)
    sb = bs.colonnade(**COLONNADE_SMALL)
    sc = sb.commit(device='cpu', leaf_size=32)
    assert sc.accel == 'bvh2' and sc.nodes4 is None
    np.testing.assert_array_equal(
        sc.nodes.numpy(),
        sb.commit(device='cpu', leaf_size=32, accel='bvh2').nodes.numpy())
    with pytest.raises(ValueError, match='too deep'):
        sb.commit(device='cpu', leaf_size=32, accel='bvh4')


@pytest.mark.parametrize('accel', ['default', 'bvh4'])
def test_commit_takes_bvh4_with_large_leaves(accel):
    """At leaf 512 the reduced colonnade has leaves of 256 triangles and
    more: the port commits the reference's accel (BVH4) with the
    reference's rows."""
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=512, accel=accel)
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=512,
                                                accel=accel)
    assert sc.accel == js.accel == 'bvh4'
    np.testing.assert_array_equal(sc.nodes4.numpy(),
                                  np.asarray(js.packet['nodes4']))
    assert sc.nodes4.numpy().reshape(-1, 4, 8)[:, :, 7].max() >= 256


def _assert_hits_within_rounding(got, ref, rows, org, d):
    """_assert_hits_agree, except that a t outside rtol 1e-6 of the
    reference's passes where both lie within 4 float32 roundings of the
    float64 distance to the triangle's plane in the Woop rows (row w:
    -(o . w[2, 5, 8] + w[11]) / d . w[2, 5, 8]), a rounding there being
    2^-24 of (sum |o_i w_i| + |w[11]|) / |d . w[2, 5, 8]|: XLA's CPU
    backend contracts the Woop dot products into fused multiply-adds, so
    where o'_w cancels strongly the two t differ by such roundings (on
    this test's rays, the port's t lies within 2.4 of them everywhere and
    within 0.7 where the two differ by more than 1e-6)."""
    t0, tri0 = np.asarray(ref.t), np.asarray(ref.tri)
    t1, tri1 = got.t.numpy(), got.tri.numpy()
    np.testing.assert_array_equal(tri1 >= 0, tri0 >= 0)
    assert (tri1 == tri0).mean() >= 0.999
    assert np.isinf(t1[tri1 < 0]).all()
    same = (tri1 == tri0) & (tri0 >= 0)
    far = same & ~np.isclose(t1, t0, rtol=1e-6, atol=1e-7)
    i = np.nonzero(far)[0]
    w = rows[tri1[i]][:, [2, 5, 8, 11]]
    o, dd = org[i].astype(np.float64), d[i].astype(np.float64)
    dw = (dd * w[:, :3]).sum(1)
    exact = -((o * w[:, :3]).sum(1) + w[:, 3]) / dw
    ulp = 2.0 ** -24 * (np.abs(o * w[:, :3]).sum(1) + np.abs(w[:, 3])) \
        / np.abs(dw)
    assert (np.abs(t1[i] - exact) <= 4 * ulp).all()
    assert (np.abs(t0[i] - exact) <= 4 * ulp).all()


def test_plain_wide_large_leaves_match_binary_and_pallas():
    """On the reduced colonnade at leaf 512 (leaves of up to 420
    triangles) the BVH4 plain versions find the binary plain versions'
    hits and occlusion bit for bit, and the reference's BVH4 kernels'
    (interpret mode) within _assert_hits_within_rounding; dead lanes
    neither hit nor are occluded."""
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=512)
    s4 = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=512)
    s2 = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=512,
                                                accel='bvh2')
    rs = np.random.RandomState(4)
    n = ppt.BLOCK
    org = (rs.randn(n, 3) * 4 + [0, 2, 0]).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::7] = -1.0
    rows = s4.tris.reshape(-1, 16).numpy().astype(np.float64)
    for tfar in (tf, np.where(tf > 0, 3.0, tf).astype(np.float32)):
        jr = tuple(jnp.asarray(x) for x in (org, d, tn, tfar))
        tr = _torch_rays((org, d, tn, tfar))
        got = wide.intersect_packet4(s4.nodes4, s4.tris, *tr)
        two = traverse.intersect_packet(s2.nodes, s2.tris, *tr)
        np.testing.assert_array_equal(got.tri.numpy(), two.tri.numpy())
        np.testing.assert_array_equal(got.t.numpy(), two.t.numpy())
        _assert_hits_within_rounding(got, pw.intersect_packet4(
            js.packet['nodes4'], js.packet['tris'], *jr, max_leaf=512,
            interpret=True), rows, org, d)
        occ = wide.occluded_packet4(s4.nodes4, s4.tris, *tr).numpy()
        np.testing.assert_array_equal(
            occ, traverse.occluded_packet(s2.nodes, s2.tris, *tr).numpy())
        np.testing.assert_array_equal(occ, np.asarray(pw.occluded_packet4(
            js.packet['nodes4'], js.packet['tris'], *jr, max_leaf=512,
            interpret=True)))
        assert (got.tri.numpy()[::7] == -1).all() and not occ[::7].any()
        assert 0 < (got.tri.numpy() >= 0).mean() < 1 and occ.any()


@pytest.mark.parametrize('accel', ['bvh4mb', 'bvh8'])
def test_commit_rejects_accel(accel):
    """'bvh4mb' needs motion geometry; unknown values raise."""
    with pytest.raises(ValueError, match='accel'):
        bs.cornell_box().commit(accel=accel)


def test_from_numpy_scene_equals_own_commit_bvh2():
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32, accel='bvh2')
    own = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32,
                                                 accel='bvh2')
    assert js.accel == own.accel == 'bvh2'
    _assert_scenes_equal(tscene.from_numpy_scene(**_numpy_leaves(js)), own)


# ------------------------------------------------------------ whole slice

def test_colonnade_bvh2_matches_jax_render():
    """The reduced colonnade through the binary path against the JAX
    package's CPU render (as test_torch_render does for BVH4)."""
    film, stats = renderer.render_frame(
        bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32,
                                               accel='bvh2'),
        bs.colonnade_camera(32, 32), pt.PTParams(max_depth=3), 32, 32,
        spp=2, seed=42)
    img = accum.resolve(film).numpy()
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32, accel='bvh2')
    jfilm, jstats = jrenderer.render_frame(
        js, jbs.colonnade_camera(32, 32), jpt.PTParams(max_depth=3), 32, 32,
        spp=2, seed=42)
    ref = np.asarray(jaccum.resolve(jfilm))
    mse = ((img - ref) ** 2).mean()
    assert 10 * np.log10(ref.max() ** 2 / max(mse, 1e-20)) >= 60.0
    assert stats.num_rays == jstats.num_rays


def _lamp_box():
    """The cornell box lit by 128 small quad lamps (256 triangle lights)
    instead of its one quad light."""
    sb = bs.cornell_box()
    sb.lights.clear()
    sb.meshes[:] = sb.meshes[:-2]          # the light's two triangles
    for i in range(128):
        x, z = 60 + 28 * (i % 16), 60 + 50 * (i // 16)
        bs.add_quad_light(sb, [x, 548.0, z], [10.0, 0, 0], [0, 0, 10.0],
                          (20.0, 20.0, 20.0))
    return sb


@pytest.mark.parametrize('scene,per', [('cornell', 1), ('lamps', 100)])
def test_shadow_batch_split_is_bit_equal(monkeypatch, scene, per):
    """With a launch bound below all lights' shadow rays, the any-hit
    batch goes out in launches of `per` whole lights (cornell: its 2
    lights one by one; 256 triangle lights: 100 + 100 + 56); the film
    is bit-equal to the unsplit render's."""
    sb = bs.cornell_box() if scene == 'cornell' else _lamp_box()
    sc = sb.commit(device='cpu')
    nl, res, spp, depth = len(sc.lights), 8, 2, 2
    cam = bs.cornell_camera(res, res)

    def render():
        film, stats = renderer.render_frame(
            sc, cam, pt.PTParams(max_depth=depth), res, res, spp=spp,
            seed=42)
        return accum.resolve(film).numpy(), stats.num_rays

    calls = []
    occluded = pt._occluded
    monkeypatch.setattr(pt, '_occluded', lambda *a: calls.append(
        a[1].shape[0]) or occluded(*a))
    ref, ref_rays = render()
    r = res * res * spp
    assert calls == [nl * r] * depth and ref.max() > 0
    calls.clear()
    monkeypatch.setattr(cb, 'MAX_RAYS', per * r + 1)
    img, rays = render()
    sizes = [min(per, nl - l0) * r for l0 in range(0, nl, per)]
    assert calls == sizes * depth
    np.testing.assert_array_equal(img, ref)
    assert rays == ref_rays
