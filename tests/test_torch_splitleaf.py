"""The torch port's split-leaf traversal (K11) held against the JAX
package: the plain version, which replays the CUDA kernel's packet
schedule, against the Pallas kernel and its sorted form (interpret mode,
as tests/test_pallas.py runs them) and against the port's binary BVH
traversal (K5), with the flush rule exercised and the leaf-size guard.
The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.ops import pallas_splitleaf as psl
from yulio_raytracer_tpu.ops import pallas_traverse as ppt

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.ops import splitleaf, traverse, wide

torch.set_num_threads(2)
R = psl.BLOCK          # the reference kernel takes 1024s
R_ODD = 1000           # the port takes any count: a tail packet of 232


def _split_scene(m, b, p, **tree_kw):
    """(host, woop, tree) of tests/test_pallas.py
    test_splitleaf_matches_packet's scene (two spheres, a floor, a
    back-culled triangle; leaf 8), with a commit's tree."""
    packed = m.pack_meshes([
        p.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        p.tessellate_sphere([2.5, 0.5, -1], 0.8, 10, 12),
        p.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5], [-5, -1.2, 5]),
        p.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                          cull=m.CULL_BACK)], pad_multiple=64)
    tree = b.build(packed.v0, packed.e1, packed.e2, packed.valid,
                   leaf_size=8, **tree_kw)
    host = b.permute_geom({k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'cull', 'valid')}, tree.order)
    woop = m.woop_matrices(host['v0'], host['e1'], host['e2'], host['valid'])
    return host, woop, tree


@pytest.fixture(scope='module')
def split_setup():
    """Both packages' tables of the scene, its rays (RandomState(3), 1024,
    every seventh dead) and the Pallas kernel's results, unsorted and
    sorted."""
    jhost, jwoop, jtree = _split_scene(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = _split_scene(mesh, bvh, primitives)
    nodes = traverse.pack_nodes(tree)
    np.testing.assert_array_equal(nodes, ppt.pack_nodes(jtree))
    rs = np.random.RandomState(3)
    org = (rs.randn(R, 3) * 3).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((R,), 1e-4, np.float32)
    tf = np.full((R,), np.inf, np.float32)
    tf[::7] = -1.0
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    jnodes = jnp.asarray(nodes)
    jtris = jnp.asarray(ppt.pack_tris(jwoop, jhost))
    bb = (tuple(np.asarray(jhost['v0']).min(axis=0).tolist()),
          tuple(np.asarray(jhost['v0']).max(axis=0).tolist()))
    return dict(
        nodes=torch.as_tensor(nodes),
        tris=torch.as_tensor(wide.pack_tris(woop, host)),
        rays=(org, d, tn, tf), bb=bb,
        ref=psl.intersect_packet_split(jnodes, jtris, *jr, max_leaf=8,
                                       interpret=True),
        ref_sorted=psl.intersect_packet_split_sorted(
            jnodes, jtris, *jr, bbox_lo=bb[0], bbox_hi=bb[1], max_leaf=8,
            interpret=True))


def _assert_split_hits(got, ref, n):
    """Hit masks equal; tri equal but at ties (another triangle at the
    same t); t within 1e-5 (inf for misses)."""
    t0, tri0 = np.asarray(ref.t)[:n], np.asarray(ref.tri)[:n]
    t1, tri1 = got.t.numpy(), got.tri.numpy()
    np.testing.assert_array_equal(tri1 >= 0, tri0 >= 0)
    hit = tri0 >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(t1[hit], t0[hit], atol=1e-5, rtol=0)
    assert np.isinf(t1[~hit]).all()
    differ = tri1 != tri0
    assert differ.mean() <= 1e-3
    np.testing.assert_array_equal(t1[differ], t0[differ])


def _rays(s, n):
    return tuple(torch.as_tensor(x[:n]) for x in s['rays'])


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_split_matches_pallas(split_setup, n):
    """The plain K11 (32-ray packets, one warp each, a row tested only by
    the rays that hit its leaf) against the Pallas kernel (1024-ray
    packets of 8 sub-blocks of 128)."""
    s = split_setup
    got = splitleaf.intersect_packet_split(s['nodes'], s['tris'],
                                           *_rays(s, n), max_leaf=8)
    _assert_split_hits(got, s['ref'], n)
    assert not (got.tri.numpy()[::7] >= 0).any()      # dead rays miss


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_split_sorted_matches_pallas(split_setup, n):
    """The sorted form (octant/Morton order, dead rays last) against the
    Pallas kernel's, results in the callers' order."""
    s = split_setup
    got = splitleaf.intersect_packet_split_sorted(
        s['nodes'], s['tris'], *_rays(s, n), *s['bb'], max_leaf=8)
    _assert_split_hits(got, s['ref_sorted'], n)


@pytest.mark.parametrize('listcap', [48, 6])
def test_plain_split_matches_binary(split_setup, monkeypatch, listcap):
    """The plain K11 equals the port's plain K5 in t, tri, u and v (one
    Woop test, nearest hit kept) with lists of `listcap` rows flushed
    when full, as the reference flushes (LISTCAP - max_groups rows): 48
    rows defer many leaves, 6 rows flush after nearly every leaf, so its
    pop culling runs on fresh bounds (the default FLUSH_ROWS, a flush at
    3 rows, is held to the Pallas kernel above).  Its counted tests:
    every lane of a packet per box; per row swept, 8 for each lane whose
    ray hit the row's leaf box, fewer than a flush that tests every row
    for every lane of the packet would make."""
    s = split_setup
    monkeypatch.setattr(splitleaf, 'LISTCAP', listcap)
    monkeypatch.setattr(splitleaf, 'FLUSH_ROWS', listcap)
    rays = _rays(s, R_ODD)
    counts = {}
    got = splitleaf.intersect_split_plain(s['nodes'], s['tris'], *rays,
                                          max_leaf=8, counts=counts)
    ref = traverse.intersect_binary_plain(s['nodes'], s['tris'], *rays)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    packets = -(-R_ODD // splitleaf.PACKET)
    assert counts['box'] % splitleaf.PACKET == 0
    assert counts['box'] >= 3 * packets * splitleaf.PACKET
    assert counts['pair'] % 8 == 0 and counts['pair'] > 0
    assert counts['pair'] < 8 * splitleaf.WARP * counts['row']


def test_split_rejects_leaves_past_max_leaf(split_setup):
    """A table leaf larger than max_leaf, or a max_leaf whose rows one
    warp cannot append, raises instead of overflowing a list."""
    s = split_setup
    rays = _rays(s, 8)
    with pytest.raises(ValueError, match='max_leaf'):
        splitleaf.intersect_packet_split(s['nodes'], s['tris'], *rays,
                                         max_leaf=4)
    with pytest.raises(ValueError, match='max_leaf'):
        splitleaf.intersect_packet_split(s['nodes'], s['tris'], *rays,
                                         max_leaf=256)
    assert splitleaf.max_groups(8) == 2 and splitleaf.max_groups(32) == 5
