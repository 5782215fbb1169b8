"""The torch port's 8-wide BVH and staged-t walks held against the JAX
package: `pack_nodes8` bit-equal to the reference's, the width-8 plain
closest and any-hit walks (through the wrappers on the CPU) against the
Pallas kernels at width=8 (interpret mode, as the JAX package's own tests
run them), width 8 against width 4 and binary on the same tree, the stack
bound and the width checks, and the staged walks against the reference's
staged walks.  The CUDA kernels are held against the plain versions on
the card by tests/test_torch_cuda.py."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu.ops import pallas_wide as pw

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.ops import traverse, wide
from yulio_raytracer_tpu_torch import raysets, wide_ab

from test_torch_ops import build_tables, _assert_hits_agree

torch.set_num_threads(2)
R = ppt.BLOCK          # the reference kernels take multiples of 1024
R_ODD = 1000           # the port takes any count
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))
INF = float('inf')


def _rays(n, seed, scale=3.0, centre=(0.0, 0.0, 0.0)):
    """n random rays (RandomState(seed)) with dead lanes (tfar < tnear)
    and finite segments, as tests/test_torch_ops.py's tables."""
    rs = np.random.RandomState(seed)
    org = (rs.randn(n, 3) * scale + centre).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::7] = -1.0
    tf[3::7] = 2.5
    return org, d, tn, tf


def _colonnade_tables(m, b, builtin):
    """(host geometry, woop, tree) of the reduced colonnade at leaf 32,
    built with the mesh/bvh/builtin_scenes modules of one package."""
    pk = m.pack_meshes(builtin.colonnade(**COLONNADE_SMALL).meshes)
    kw = {'quality': 'high'} if b is jbvh else {}
    tree = b.build(pk.v0, pk.e1, pk.e2, pk.valid, leaf_size=32, **kw)
    keys = ('v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id', 'cull',
            'illum_mask', 'shadow_mask', 'valid')
    host = b.permute_geom({k: getattr(pk, k) for k in keys}, tree.order)
    woop = m.woop_matrices(host['v0'], host['e1'], host['e2'], host['valid'])
    return host, woop, tree


@pytest.fixture(scope='module')
def scenes():
    """The port's and the reference's tables of the tests/test_pallas.py
    wide-kernel scene (leaf 8) and of the reduced colonnade (leaf 32):
    their trees and, from the port's, the packed rows and the binary,
    BVH4 and BVH8 node rows; with rays of each scene's size."""
    out = {}
    for name, port, ref, rays in (
            ('pallas_scene', lambda: build_tables(mesh, bvh, primitives),
             lambda: build_tables(jmesh, jbvh, jprim, quality='high'),
             _rays(R, 5)),
            ('reduced_colonnade',
             lambda: _colonnade_tables(mesh, bvh, bs),
             lambda: _colonnade_tables(jmesh, jbvh, jbs),
             _rays(R, 4, scale=4.0, centre=(0.0, 2.0, 0.0)))):
        host, woop, tree = port()
        jhost, jwoop, jtree = ref()
        out[name] = dict(
            tree=tree, jtree=jtree,
            tris=torch.as_tensor(wide.pack_tris(woop, host)),
            jtris=jnp.asarray(ppt.pack_tris(jwoop, jhost)),
            nodes=torch.as_tensor(traverse.pack_nodes(tree)),
            jnodes=jnp.asarray(ppt.pack_nodes(jtree)),
            nodes4=torch.as_tensor(wide.pack_nodes4(tree)),
            nodes8=torch.as_tensor(wide.pack_nodes8(tree)),
            jnodes8=jnp.asarray(pw.pack_nodes8(jtree)),
            bbox=(tuple(float(x) for x in tree.lo[0]),
                  tuple(float(x) for x in tree.hi[0])),
            rays=rays)
    return out


def _torch_rays(rays, n=None):
    return tuple(torch.as_tensor(x[:n]) for x in rays)


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade'])
def test_pack_nodes8_matches_jax(scenes, tree):
    """pack_nodes8 is bit-equal to the reference's, and rows of 8 slots
    hold more than 4 on these trees (the greedy fill goes deeper than
    BVH4's two levels)."""
    sc = scenes[tree]
    ref = pw.pack_nodes8(sc['jtree'])
    got = wide.pack_nodes8(sc['tree'])
    np.testing.assert_array_equal(got, ref)
    assert got.shape[1] == 64 and got.shape[0] < sc['nodes4'].shape[0]
    assert ((got.reshape(-1, 8, 8)[:, :, 7] != 0).sum(1) > 4).any()


def test_nodes8_of_a_committed_scene():
    """raysets.nodes8 reads a committed scene's tree back from its binary
    rows: the same 8-wide rows as pack_nodes8 of the tree it was built
    from."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    _, _, tree = _colonnade_tables(mesh, bvh, bs)
    np.testing.assert_array_equal(traverse.pack_nodes(tree), sc.nodes.numpy())
    np.testing.assert_array_equal(raysets.nodes8(sc).numpy(),
                                  wide.pack_nodes8(tree))


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_wide8_matches_pallas(scenes, n):
    """The width-8 closest and any-hit walks (the wrappers' plain versions
    on the CPU) against the reference's width=8 kernels."""
    sc = scenes['pallas_scene']
    jr = tuple(jnp.asarray(x) for x in sc['rays'])
    tr = _torch_rays(sc['rays'], n)
    ref = pw.intersect_packet4(sc['jnodes8'], sc['jtris'], *jr, max_leaf=8,
                               interpret=True, width=8)
    got = wide.intersect_packet4(sc['nodes8'], sc['tris'], *tr, width=8)
    _assert_hits_agree(got, ref, n)
    occ_ref = pw.occluded_packet4(sc['jnodes8'], sc['jtris'], *jr,
                                  max_leaf=8, interpret=True, width=8)
    occ = wide.occluded_packet4(sc['nodes8'], sc['tris'], *tr, width=8)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])
    assert bool((got.tri >= 0).any()) and bool(occ.any())


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade'])
def test_wide8_matches_wide4_and_binary(scenes, tree):
    """Width 8, width 4 and binary are encodings of one tree: the same t
    and hit mask, the same triangle but for ties, the same occlusion.
    The width-8 plain versions count a box test for each non-empty slot
    of a row they visit (the kernel's 8 a row under 'slots') and stay
    within the stack bound."""
    sc = scenes[tree]
    rays = _torch_rays(sc['rays'])
    counts = {}
    h8 = wide.intersect_wide_plain(sc['nodes8'], sc['tris'], *rays,
                                   counts=counts)
    for other in (wide.intersect_packet4(sc['nodes4'], sc['tris'], *rays),
                  traverse.intersect_packet(sc['nodes'], sc['tris'], *rays)):
        np.testing.assert_array_equal(h8.t.numpy(), other.t.numpy())
        assert (h8.tri == other.tri).float().mean() >= 0.999
    occ8 = wide.occluded_packet8(sc['nodes8'], sc['tris'], *rays)
    for other in (wide.occluded_packet4(sc['nodes4'], sc['tris'], *rays),
                  traverse.occluded_packet(sc['nodes'], sc['tris'], *rays)):
        np.testing.assert_array_equal(occ8.numpy(), other.numpy())
    assert counts['slots'] % 8 == 0 and counts['pair'] > 0
    assert 0 < int(counts['box']) < int(counts['slots'])
    deepest = torch.cat(counts['stack'])
    assert 1 < int(deepest.max()) <= wide.STACK


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade'])
def test_empty_slots_cost_no_box_tests(scenes, tree):
    """BVH4 rows padded with four empty slots to 8-wide rows are the
    same tree: the same t and occlusion, and the same box and pair tests
    counted (the any-hit walk pushes in slot order, so it walks both in
    one order), while the slab tests the kernels make ('slots') double."""
    sc = scenes[tree]
    rays = _torch_rays(sc['rays'])
    n4 = sc['nodes4']
    pad = torch.tensor([INF] * 3 + [-INF] * 3 + [0.0, 0.0]).repeat(4)
    n8 = torch.cat([n4, pad.expand(n4.shape[0], 32)], dim=1)
    for fn in (wide.intersect_wide_plain, wide.occluded_wide_plain):
        c4, c8 = {}, {}
        got4 = fn(n4, sc['tris'], *rays, counts=c4)
        got8 = fn(n8, sc['tris'], *rays, counts=c8)
        np.testing.assert_array_equal(np.asarray(got8[0]),
                                      np.asarray(got4[0]))
        assert int(c8['slots']) == 2 * int(c4['slots'])
        if fn is wide.occluded_wide_plain:
            assert [int(c8[k]) for k in ('box', 'pair')] == [
                int(c4[k]) for k in ('box', 'pair')]
        assert int(c4['box']) < int(c4['slots'])


def _caterpillar(levels):
    """A binary FlatBVH of `levels` interior nodes in a chain: each has a
    one-triangle leaf on the left and the next interior node on the right
    (the last one a second leaf), in the skip-pointer layout; boxes
    shrink down the chain.  Its 8-wide collapse holds 7 binary levels a
    row."""
    n = 2 * levels + 1
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    start = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    skip = np.full(n, n, np.int32)
    for i in range(n):
        hi[i] = float(n - i)
    for i in range(0, n - 1, 2):          # interior i: leaf i+1, right i+2
        skip[i + 1] = i + 2
        start[i + 1], count[i + 1] = i // 2, 1
    start[n - 1], count[n - 1] = levels, 1
    return SimpleNamespace(lo=lo, hi=hi, start=start, count=count,
                           skip=skip, order=np.arange(levels + 1),
                           num_nodes=n)


@pytest.mark.parametrize('case', ['depth_18', 'depth_19', 'leaf_start',
                                  'leaf_count'])
def test_pack_nodes8_checks_the_stack(case):
    """A width-8 tree whose walk could overflow STACK ((8 - 1) x depth +
    1 entries) raises where the reference asserts; a tree at the bound
    packs as the reference's.  A leaf range that the stack words cannot
    hold (reaching 2^24 by its start or its count) raises too."""
    levels = {'depth_18': 7 * 18, 'depth_19': 7 * 18 + 1}.get(case, 20)
    tree = _caterpillar(levels)
    if case == 'depth_19':
        with pytest.raises(AssertionError, match='stack'):
            pw.pack_nodes8(tree)
        with pytest.raises(ValueError, match='stack'):
            wide.pack_nodes8(tree)
        return
    out = wide.pack_nodes8(tree)
    np.testing.assert_array_equal(out, pw.pack_nodes8(tree))
    if case == 'depth_18':
        assert out.shape[0] == 18
        return
    slots = out.reshape(-1, 8, 8)
    k = np.argwhere(slots[:, :, 7] > 0)[0]
    if case == 'leaf_start':
        slots[k[0], k[1], 6] = float(1 << 24)
    else:
        slots[k[0], k[1], 7] = float(1 << 24) - slots[k[0], k[1], 6]
    with pytest.raises(ValueError, match='2\\^24'):
        wide._check_packed(out, 8)


@pytest.mark.parametrize('fn', ['intersect', 'occluded'])
@pytest.mark.parametrize('table,width', [('nodes8', 4), ('nodes4', 8),
                                         ('nodes4', 6), ('nodes', 4)])
def test_wrappers_refuse_a_table_of_another_width(scenes, fn, table, width):
    """The wrappers raise when the table's row length is not their width
    (or the width is neither 4 nor 8); they never reshape it."""
    sc = scenes['pallas_scene']
    f = wide.intersect_packet4 if fn == 'intersect' else wide.occluded_packet4
    with pytest.raises(ValueError, match='wide nodes'):
        f(sc[table], sc['tris'], *_torch_rays(sc['rays'], 8), width=width)


@pytest.mark.parametrize('n', [R, R_ODD])
def test_staged_walks_match_pallas(scenes, n):
    """The staged walks (K5/K6's plain versions on the CPU) against the
    reference's staged walks on the same box: closest hits within the
    tolerance, occlusion equal.  (On the reduced colonnade's close-range
    rays the reference's interpret-mode K5 itself, staged or not, differs
    from the kernels' f32 operation order by more than that tolerance's
    rtol in t, up to 6e-5 on 19 of 1024 rays, the same triangle each
    time: its Woop dot products are not rounded term by term on the CPU.
    So the comparison with it is made on the scene its own wide tests
    use.)"""
    sc = scenes['pallas_scene']
    jr = tuple(jnp.asarray(x) for x in sc['rays'])
    tr = _torch_rays(sc['rays'], n)
    lo, hi = sc['bbox']
    ref = ppt.intersect_packet_staged(sc['jnodes'], sc['jtris'], *jr, lo, hi,
                                      max_leaf=8, interpret=True)
    got = traverse.intersect_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                           hi)
    _assert_hits_agree(got, ref, n)
    occ_ref = ppt.occluded_packet_staged(sc['jnodes'], sc['jtris'], *jr, lo,
                                         hi, max_leaf=8, interpret=True)
    occ = traverse.occluded_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                          hi)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade'])
def test_staged_walks_equal_one_walk(scenes, tree):
    """A staged walk finds what one unstaged walk finds: the same t, hit
    mask and occlusion, the same triangle but for ties; and rays resolve
    in every stage (hits nearer than the first cap and past the
    second)."""
    sc = scenes[tree]
    tr = _torch_rays(sc['rays'])
    lo, hi = sc['bbox']
    got = traverse.intersect_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                           hi)
    one = traverse.intersect_packet(sc['nodes'], sc['tris'], *tr)
    np.testing.assert_array_equal(got.t.numpy(), one.t.numpy())
    assert (got.tri == one.tri).float().mean() >= 0.999
    np.testing.assert_array_equal(
        traverse.occluded_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                        hi).numpy(),
        traverse.occluded_packet(sc['nodes'], sc['tris'], *tr).numpy())
    diag = float(np.linalg.norm(np.subtract(hi, lo)))
    t = got.t.numpy()[got.tri.numpy() >= 0]
    assert (t < 0.07 * diag).any() and (t > 0.3 * diag).any()


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade'])
def test_staged_walks_start_no_stage_before_tnear(scenes, tree):
    """Rays whose tnear lies past the first cap, or past both: a later
    stage starts at the ray's own tnear, not at the cap before it, so the
    staged walks find what one walk from tnear finds.  The rays are
    chosen so that starting at the first cap would report hits in front
    of tnear."""
    sc = scenes[tree]
    org, dirn, tnear, tfar = _torch_rays(sc['rays'])
    lo, hi = sc['bbox']
    cap = traverse._staged_caps(lo, hi, (0.07, 0.3))
    rs = np.random.RandomState(11)
    tnear = torch.as_tensor(rs.uniform(cap[0], 1.2 * cap[1], tnear.shape)
                            .astype(np.float32))
    tnear[::5] = 1e-4
    rays = (sc['nodes'], sc['tris'], org, dirn, tnear, tfar)
    got = traverse.intersect_packet_staged(*rays, lo, hi)
    one = traverse.intersect_packet(*rays)
    np.testing.assert_array_equal(got.t.numpy(), one.t.numpy())
    assert (got.tri == one.tri).float().mean() >= 0.999
    np.testing.assert_array_equal(
        traverse.occluded_packet_staged(*rays, lo, hi).numpy(),
        traverse.occluded_packet(*rays).numpy())
    from_cap = torch.full_like(tnear, cap[0] * (1.0 - 1e-5))
    early = traverse.occluded_packet(sc['nodes'], sc['tris'], org, dirn,
                                     from_cap, torch.minimum(tnear, tfar))
    assert bool(early.any()) and bool((tnear > cap[1]).any())


def test_staged_plain_counts_every_stage(scenes):
    """The staged plain versions are the staged walks over K5/K6's plain
    versions, their counts gathered over every stage."""
    sc = scenes['reduced_colonnade']
    tr = _torch_rays(sc['rays'])
    lo, hi = sc['bbox']
    counts = {}
    got = traverse.intersect_staged_plain(sc['nodes'], sc['tris'], *tr, lo,
                                          hi, counts=counts)
    ref = traverse.intersect_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                           hi)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(counts['stack']) == 3 and counts['pair'] > 0
    acounts = {}
    occ = traverse.occluded_staged_plain(sc['nodes'], sc['tris'], *tr, lo, hi,
                                         counts=acounts)
    np.testing.assert_array_equal(
        occ.numpy(),
        traverse.occluded_packet_staged(sc['nodes'], sc['tris'], *tr, lo,
                                        hi).numpy())
    assert len(acounts['stack']) == 3


def test_wide_ab_needs_a_card():
    """The width A/B tool exits 1 without a CUDA device, before it builds
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert wide_ab.main([]) == 1
