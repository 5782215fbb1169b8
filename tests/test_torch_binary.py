"""The binary-BVH kernels' (K5/K6, and the motion kernel K7) tooling on
the CPU: the plain versions' stack occupancy against the tree's depth
bound, the any-hit plain versions' test counts against a walk written out
in the kernels' order, the recorders of a frame's K5/K6 calls
(raysets.frame_binary_calls) on the reduced colonnade through accel
'bvh2' and ray_binning 'grid', 'dense' and 'treelet' and of its K7 calls
(raysets.frame_motion_calls) on the reduced motion field, and the timing
script's refusal to run without a card.  The plain versions are held
against the JAX package's kernels by tests/test_torch_traverse.py,
tests/test_torch_treelet.py and tests/test_torch_motion.py, the CUDA
kernels against the plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.ops import traverse, wide
from yulio_raytracer_tpu_torch import raysets

torch.set_num_threads(2)
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))
PLAIN = {'intersect_packet': traverse.intersect_binary_plain,
         'occluded_packet': traverse.occluded_binary_plain}


@pytest.fixture(scope='module')
def colonnade():
    """The reduced colonnade (leaf 32) on the CPU, with its binary rows,
    grid and treelets beside its BVH4 rows."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    assert sc.accel == 'bvh4' and sc.nodes is not None
    return sc


def _rays(sc, n, seed):
    """n rays from the scene's box in random directions, tnear 1e-4, every
    seventh dead (tfar -1), every fifth of the others ending at 3."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(sc.bbox_lo), np.asarray(sc.bbox_hi)
    org = (lo + (hi - lo) * rs.rand(n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tf = np.full((n,), np.inf, np.float32)
    tf[3::5] = 3.0
    tf[::7] = -1.0
    return tuple(torch.as_tensor(x) for x in (
        org, d, np.full((n,), 1e-4, np.float32), tf))


@pytest.mark.parametrize('rooted', [False, True])
def test_plain_binary_records_its_stack_depth(colonnade, rooted):
    """With counts, each binary plain version reports every ray's largest
    stack occupancy: at least the root's entry, at most the tree's depth
    bound that pack_nodes checks (stack_bound), more than one for rays
    that walk the tree and exactly one for the any-hit version's dead
    rays; counting changes no result.  From treelet roots as from the
    tree's."""
    sc = colonnade
    rays = _rays(sc, 2000, 3)
    if rooted:
        rays = raysets.from_treelet_roots(sc, *rays)
        assert bool((rays[4] > 0).any())
    else:
        rays = (*rays, None)
    bound = traverse.stack_bound(sc.nodes.numpy())
    assert 1 < bound <= traverse.STACK
    for plain in PLAIN.values():
        counts = {}
        got = plain(sc.nodes, sc.tris, *rays, counts=counts)
        ref = plain(sc.nodes, sc.tris, *rays)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, ref))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        deepest = torch.cat(counts['stack']).numpy()
        assert deepest.shape == (2000,)
        assert deepest.min() >= 1 and deepest.max() <= bound
        live = (rays[3] > rays[2]).numpy()
        assert deepest[live].max() > 1
        if plain is traverse.occluded_binary_plain:
            assert np.all(deepest[~live] == 1)
        assert counts['pair'] > 0 and counts['box'] > 0


# the K5/K6 calls of one bounce-1 trace (bounce 0 and 1 under 'bvh2';
# bounce 1 alone under a binning), in order: (wrapper, started at roots)
FRAME_CALLS = {
    'bvh2': [('intersect_packet', False), ('occluded_packet', False)] * 2,
    'grid': [('intersect_packet', False), ('occluded_packet', False)],
    'dense': [('intersect_packet', False), ('occluded_packet', False)],
    'treelet': [('intersect_packet', True)] * 2 + [('intersect_packet',
                                                     False)]
    + [('occluded_packet', True)] * 2 + [('occluded_packet', False)],
}


@pytest.mark.parametrize('how', list(FRAME_CALLS))
def test_frame_binary_calls_record_every_call(colonnade, how):
    """raysets.frame_binary_calls on the reduced colonnade records one
    entry per K5/K6 call of the path, in order: under 'bvh2' both
    bounces' whole-tree calls; under 'grid' and 'dense' bounce 1's
    fallback; under 'treelet' bounce 1's two rounds from treelet roots
    ((R,) int32 nodes of the tree) and the fallback from the tree's root.
    Each call's rays are the pass's (the any-hit calls': every light's
    shadow rays from its hit points), the plain versions reproduce its
    results, the wrappers are back after the block, and on the CPU no
    launch is counted."""
    sc = colonnade
    launches = (traverse.intersect_packet.launches,
                traverse.occluded_packet.launches)
    calls = raysets.frame_binary_calls(sc, bs.colonnade_camera(16, 16), how,
                                       16, 16)
    assert [(c['kernel'], c['args'][6] is not None)
            for c in calls] == FRAME_CALLS[how]
    for c in calls:
        nodes, tris, org, dirn, tnear, tfar, roots = c['args']
        n = 256 * (len(sc.lights) if c['kernel'] == 'occluded_packet'
                   else 1)
        assert nodes is sc.nodes and tris is sc.tris
        assert org.shape == (n, 3) and tfar.shape == (n,)
        assert bool((tfar > tnear).any())
        if roots is not None:
            assert roots.dtype == torch.int32 and roots.shape == (n,)
            assert bool((roots > 0).any())
            assert int(roots.max()) < sc.nodes.shape[0]
        ref = PLAIN[c['kernel']](*c['args'])
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (ref, c['out']))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(getattr(traverse, k).__name__ == k for k in PLAIN)
    assert (traverse.intersect_packet.launches,
            traverse.occluded_packet.launches) == launches
    assert sc.accel == 'bvh4'


def test_frame_binary_calls_rejects_other_paths(colonnade):
    with pytest.raises(ValueError, match='accel_or_binning'):
        raysets.frame_binary_calls(colonnade, bs.colonnade_camera(8, 8),
                                   'morton', 8, 8)


def _walk_nearest_first(nodes, leaf_ok, org, dirn, tnear, tfar, root):
    """One ray's any-hit walk written out as K6 (and K7's any-hit form)
    makes it: (occluded, triangle tests, box tests).  From the untested
    root, an interior node slab-tests both children and visits the hit
    ones, the one of least entry t first (the side the direction points to
    on a tie); a leaf tests its triangles in order up to the first hit,
    which ends the walk.  leaf_ok(a, tag) gives which of the leaf's
    triangles [a, a + tag) the ray hits."""
    if not bool(tfar > tnear):
        return False, 0, 0
    inv = wide._safe_inv(dirn[None])
    stack, pair, box = [root], 0, 0
    while stack:
        node = stack.pop()
        a, tag = int(nodes[node, 6]), int(nodes[node, 7])
        if tag > 0:
            hits = torch.nonzero(leaf_ok(a, tag))[:, 0]
            if hits.numel():
                return True, pair + int(hits[0]) + 1, box
            pair += tag
            continue
        box += 2
        near, far = ((node + 1, a) if float(dirn[-tag - 1]) >= 0.0
                     else (a, node + 1))
        hit, tmin = wide._slab(nodes[[near, far]][None], org[None, None],
                               inv[:, None], tnear.view(1, 1),
                               tfar.view(1, 1))
        (hn, hf), (tn, tf) = hit[0].tolist(), tmin[0].tolist()
        first, second = ((far, near) if hn and hf and tf < tn
                         else (near, far))
        for kid in (second, first):
            if (hn if kid == near else hf):
                stack.append(kid)
    return False, pair, box


@pytest.mark.parametrize('rooted', [False, True])
def test_plain_any_hit_counts_the_kernels_walk(colonnade, rooted):
    """The binary any-hit plain version walks as K6 does, nearest child
    first by entry t, so the triangle and box tests it counts for K6's
    bound are the kernel's: they equal a ray-by-ray walk written out in
    that order, and so does its mask."""
    sc = colonnade
    rays = _rays(sc, 300, 5)
    roots = (raysets.from_treelet_roots(sc, *rays)[4] if rooted
             else torch.zeros(300, dtype=torch.int32))
    counts = {}
    occ = traverse.occluded_binary_plain(sc.nodes, sc.tris, *rays,
                                         roots if rooted else None,
                                         counts=counts)
    rows = sc.tris.reshape(-1, 16)

    def walk(i):
        ray = [x[i] for x in rays]

        def leaf_ok(a, tag):
            return wide._leaf_test(rows, torch.tensor([a]),
                                   torch.tensor([tag]),
                                   *(x[None] for x in ray))[3][0, :tag]
        return _walk_nearest_first(sc.nodes, leaf_ok, *ray, int(roots[i]))
    walks = [walk(i) for i in range(300)]
    assert occ.tolist() == [w[0] for w in walks]
    assert 0 < sum(occ.tolist()) < 300
    assert int(counts['pair']) == sum(w[1] for w in walks)
    assert int(counts['box']) == sum(w[2] for w in walks)


@pytest.fixture(scope='module')
def motion_field():
    """The reduced motion field (4 spheres) with its tree on the CPU
    (leaf 64: leaves of up to 54 motion rows)."""
    sc = bs.motion_field(n_spheres=4).commit(device='cpu', force_bvh=True)
    assert sc.accel == 'bvh4mb' and float(sc.nodes[:, 7].max()) > 32
    return sc


def test_plain_motion_any_hit_counts_the_kernels_walk(motion_field):
    """The motion any-hit plain version walks as K7's any-hit form does,
    nearest child first by entry t over the motion rows at each ray's
    time, so the motion and box tests it counts for that form's bound are
    the kernel's: they equal a ray-by-ray walk written out in that order,
    and so does its mask."""
    sc = motion_field
    rays = _rays(sc, 300, 6)
    time = torch.as_tensor(np.random.RandomState(7).rand(300)
                           .astype(np.float32))
    counts = {}
    occ = traverse.occluded_motion_plain(sc.nodes, sc.tris_mb, *rays, time,
                                         counts=counts)
    leaf = traverse._motion_leaf(sc.tris_mb)

    def walk(i):
        ray = [x[i] for x in rays]

        def leaf_ok(a, tag):
            return leaf(torch.tensor([a]), torch.tensor([tag]),
                        *(x[None] for x in ray), time[i:i + 1])[3][0, :tag]
        return _walk_nearest_first(sc.nodes, leaf_ok, *ray, 0)
    walks = [walk(i) for i in range(300)]
    assert occ.tolist() == [w[0] for w in walks]
    assert 0 < sum(occ.tolist()) < 300
    assert int(counts['pair']) == sum(w[1] for w in walks)
    assert int(counts['box']) == sum(w[2] for w in walks)


def test_frame_motion_calls_record_every_call(motion_field):
    """raysets.frame_motion_calls on the reduced motion field records one
    entry per K7 call of one bounce-1 trace, in order: each bounce's
    closest call on the pass's rays at their times, then the any-hit call
    of its NEE on every light's shadow rays.  The plain versions reproduce
    each call's results, the wrappers are back after the block, and on
    the CPU no launch is counted.  A scene without the motion tree is
    refused."""
    sc = motion_field
    launches = (traverse.intersect_packet_mb.launches,
                traverse.occluded_packet_mb.launches)
    calls = raysets.frame_motion_calls(sc, bs.motion_field_camera(16, 16),
                                       16, 16)
    assert [c['kernel'] for c in calls] == [
        'intersect_packet_mb', 'occluded_packet_mb'] * 2
    plain = {'intersect_packet_mb': traverse.intersect_motion_plain,
             'occluded_packet_mb': traverse.occluded_motion_plain}
    for c in calls:
        nodes, tris_mb, org, dirn, tnear, tfar, time = c['args']
        n = 256 * (len(sc.lights) if c['kernel'] == 'occluded_packet_mb'
                   else 1)
        assert nodes is sc.nodes and tris_mb is sc.tris_mb
        assert org.shape == (n, 3) and time.shape == (n,)
        assert bool((tfar > tnear).any())
        assert float(time.min()) >= 0.0 and float(time.max()) <= 1.0
        ref = plain[c['kernel']](*c['args'])
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (ref, c['out']))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(getattr(traverse, k).__name__ == k for k in plain)
    assert (traverse.intersect_packet_mb.launches,
            traverse.occluded_packet_mb.launches) == launches
    with pytest.raises(ValueError, match='bvh4mb'):
        raysets.frame_motion_calls(
            bs.motion_field(n_spheres=4).commit(device='cpu'),
            bs.motion_field_camera(8, 8), 8, 8)
