"""The torch port's CUDA kernels on the card: each held against its plain
torch version (the binary kernels also from per-ray roots, under both
leaf schedules, on a frame's own calls and at leaf 512, the
BVH4 kernels and their width-8 forms also on leaves of 128 triangles and
more and under both leaf schedules, the staged walks over K5/K6, the pair
kernels
K8/K9 also on a frame's own calls and on edge cases of their binning, the
split-leaf kernel K11 and the sweep prototype's kernels K12, the motion
kernel K7's closest and any-hit forms also on the motion field's entry
sets, leaves of 33-64 rows, dead lanes, 65,537 rays and a frame's own
calls), the cornell, stereo, motion, grid, treelet and dense colonnade
goldens rendered through them, the StereoCube rays against the port's
CPU rays, compaction 'auto' against 'off' on the colonnade, the fetch
kernel against the plain fetch on the card, the lobe kernels against the
plain eval and sample (every lobe type, the cells' material tables, edge
inputs, whole sponza and test_stereo frames), the RNG kernel against the
plain int64 draws (every form of the port's callers, edge ids, whole
sponza and test_stereo frames, a first call that imports nothing), and the
shading layer (the texture fetch, the shade context and the materials
probe of every preset), a scene of an HDRI light alone and test_room.dae's
12 stereo faces against the port's CPU results; the precomputed sampler,
the three BVH qualities, pick, the debug renderer, render_progressive,
the viewer's loop and profiling.trace on the card, and a frame's host
syncs with the port's tracer on and off.

Every test here is marked `cuda` and skips without a CUDA device.  The
file imports no jax, so it also runs on a GPU machine without JAX (where
tests/conftest.py, which configures jax, cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import (binning, dense, grid, pairs,
                                           splitleaf, traverse, treelets,
                                           wide)
from yulio_raytracer_tpu_torch.scene import SceneBuilder
from yulio_raytracer_tpu_torch.shading import lobes as lb
from yulio_raytracer_tpu_torch.shading import materials as mat
from yulio_raytracer_tpu_torch.shading import textures as tex
from yulio_raytracer_tpu_torch import raysets, renderer
from yulio_raytracer_tpu_torch import proto_sublane_sweep as sweep
from yulio_raytracer_tpu_torch.film import accum

from probe_scene import PROBE_PRESETS, materials_probe

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets', 'golden')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device('cuda')


def _tables_and_rays(dev, n=1000):
    """Packed rows, and the BVH4 and binary nodes and the res-8 grid, of a
    sphere over a floor with one culled triangle (leaf 8), and n random
    rays with dead and finite lanes."""
    packed = mesh.pack_meshes([
        primitives.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        primitives.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5],
                        [-5, -1.2, 5]),
        primitives.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                                   cull=mesh.CULL_BACK)], pad_multiple=64)
    tree = bvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                     leaf_size=8)
    host = bvh.permute_geom({k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'cull', 'valid')}, tree.order)
    woop = mesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                              host['valid'])
    rs = np.random.RandomState(5)
    d = rs.randn(n, 3).astype(np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::7] = -1.0
    tf[3::7] = 2.5
    rays = [(rs.randn(n, 3) * 3).astype(np.float32),
            d / np.linalg.norm(d, axis=1, keepdims=True),
            np.full((n,), 1e-4, np.float32), tf]
    return (torch.as_tensor(wide.pack_tris(woop, host)).to(dev),
            {'wide': torch.as_tensor(wide.pack_nodes4(tree)).to(dev),
             'wide8': torch.as_tensor(wide.pack_nodes8(tree)).to(dev),
             'binary': torch.as_tensor(traverse.pack_nodes(tree)).to(dev),
             'grid': {k: torch.as_tensor(v).to(dev) for k, v in
                      grid.build_grid(woop, host).items()}},
            [torch.as_tensor(x).to(dev) for x in rays])


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['dense', 'wide', 'wide8', 'binary'])
def test_kernels_match_plain_on_card(cuda, which):
    tris, nodes, rays = _tables_and_rays(cuda)
    if which == 'dense':
        pairs = ((dense.intersect_dense, dense.intersect_dense_plain),
                 (dense.occluded_dense, dense.occluded_dense_plain))
        tables = (tris,)
    elif which == 'wide':
        pairs = ((wide.intersect_packet4, wide.intersect_wide_plain),
                 (wide.occluded_packet4, wide.occluded_wide_plain))
        tables = (nodes['wide'], tris)
    elif which == 'wide8':
        pairs = ((wide.intersect_packet8, wide.intersect_wide_plain),
                 (wide.occluded_packet8, wide.occluded_wide_plain))
        tables = (nodes['wide8'], tris)
    else:
        pairs = ((traverse.intersect_packet, traverse.intersect_binary_plain),
                 (traverse.occluded_packet, traverse.occluded_binary_plain))
        tables = (nodes['binary'], tris)
    (kc, pc), (ka, pa) = pairs
    launches = kc.launches
    got, ref = kc(*tables, *rays), pc(*tables, *rays)
    torch.cuda.synchronize()
    assert kc.launches == launches + 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(ka(*tables, *rays).cpu().numpy(),
                                  pa(*tables, *rays).cpu().numpy())


@pytest.fixture(scope='module')
def colonnade_card():
    """The full colonnade on the card (leaf 32: 1,803 BVH4 rows, leaves of
    up to 32 triangles), or a skip without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return bs.colonnade().commit(device=torch.device('cuda'), leaf_size=32)


def _edge_rays(lo, hi, n, seed):
    """n rays from inside the box [lo, hi] (so inside the root's box and
    most of the boxes they start in): a third along the axes and the
    diagonals of a face (direction components of exactly 0), some with
    tfar <= tnear (equal, and below), some with a finite tfar, the rest
    to infinity."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    org = (lo + (hi - lo) * rs.rand(n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3), [[1, 1, 0], [0, -1, 1]]])
    k = n // 3
    d[:k] = axes[rs.randint(0, len(axes), k)]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[1::11] = tn[1::11]                       # tfar == tnear
    tf[2::11] = -1.0                            # tfar < tnear
    tf[3::5] = rs.rand(len(tf[3::5])).astype(np.float32) * 8.0
    return [torch.as_tensor(x).cuda() for x in (org, d, tn, tf)]


def _assert_wide_matches_plain(nodes4, tris, rays, width=4):
    hit = wide.intersect_packet4(nodes4, tris, *rays, width=width)
    ref = wide.intersect_wide_plain(nodes4, tris, *rays)
    occ = wide.occluded_packet4(nodes4, tris, *rays, width=width)
    occ_ref = wide.occluded_wide_plain(nodes4, tris, *rays)
    torch.cuda.synchronize()
    for g, r in zip(hit, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(occ.cpu().numpy(), occ_ref.cpu().numpy())
    return ref, occ_ref


@pytest.mark.cuda
@pytest.mark.parametrize('n', [65_536, 65_537])
def test_wide_kernels_match_plain_on_colonnade(colonnade_card, n):
    """K3 and K4 bit-equal to their plain versions on the full colonnade
    tree at ~64k rays (a block multiple and one past it), launched twice
    in a row."""
    sc = colonnade_card
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 11)
    launches = (wide.intersect_packet4.launches,
                wide.occluded_packet4.launches)
    ref, occ = _assert_wide_matches_plain(sc.nodes4, sc.tris, rays)
    again = wide.intersect_packet4(sc.nodes4, sc.tris, *rays)
    np.testing.assert_array_equal(again.tri.cpu().numpy(),
                                  ref.tri.cpu().numpy())
    assert (wide.intersect_packet4.launches,
            wide.occluded_packet4.launches) == (launches[0] + 2,
                                                launches[1] + 1)
    hits = (ref.tri >= 0).float().mean()
    assert 0.3 < float(hits) < 1.0 and bool(occ.any()) and not bool(occ.all())


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['sphere', 'colonnade'])
def test_wide_kernels_on_edge_rays(cuda, colonnade_card, scene):
    """Rays that start inside boxes, run along the axes (direction
    components of exactly 0) or have tfar <= tnear, on a tree of a few
    rows and on the colonnade's: bit-equal to the plain versions, and the
    empty segments neither hit nor are occluded."""
    if scene == 'sphere':
        tris, nodes, _ = _tables_and_rays(cuda)
        nodes4, lo, hi = nodes['wide'], (-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)
    else:
        sc = colonnade_card
        tris, nodes4, lo, hi = sc.tris, sc.nodes4, sc.bbox_lo, sc.bbox_hi
    rays = _edge_rays(lo, hi, 4000, 12)
    ref, occ = _assert_wide_matches_plain(nodes4, tris, rays)
    empty = (rays[3] <= rays[2]).cpu().numpy()
    assert not occ.cpu().numpy()[empty].any()
    assert (ref.tri.cpu().numpy()[rays[3].cpu().numpy() < 0] == -1).all()
    assert bool((ref.tri >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize('width', [4, 8])
@pytest.mark.parametrize('rays', ['camera', 'every_fourth_live', 'fifteen'])
def test_wide_leaf_schedules_agree(request, colonnade_card, rays, width):
    """K3 and K4, and the width-8 kernels over the same tree's 8-wide
    rows, bit-equal to their plain versions whichever way the warp tests
    its lanes' leaves: coherent camera rays, whose lanes reach leaves
    together, mostly take each lane's own leaf loop; with only every
    fourth ray live (8 lanes a warp), or 15 rays in all, fewer than 16
    lanes can hold a leaf, so every leaf is tested across the warp."""
    sc, dev = colonnade_card, torch.device('cuda')
    nodes = (sc.nodes4 if width == 4
             else request.getfixturevalue('colonnade_nodes8'))
    if rays == 'camera':
        org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(128, 128),
                                        128, 128, dev, 7)
        zeros = torch.zeros(org.shape[0], device=dev)
        batch = [org, d, zeros, torch.full_like(zeros, float('inf'))]
    else:
        n = 15 if rays == 'fifteen' else 20_000
        batch = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 13)
        if rays == 'every_fourth_live':
            batch[3][torch.arange(n, device=dev) % 4 != 0] = -1.0
    ref, _ = _assert_wide_matches_plain(nodes, sc.tris, batch, width)
    assert bool((ref.tri >= 0).any())


@pytest.fixture(scope='module')
def colonnade_nodes8(colonnade_card):
    """The full colonnade's tree (leaf 32) as 8-wide rows on the card."""
    return raysets.nodes8(colonnade_card)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [65_536, 65_537])
def test_wide8_kernels_match_plain_on_colonnade(colonnade_card,
                                                colonnade_nodes8, n):
    """The width-8 kernels bit-equal to their plain versions on the full
    colonnade tree at ~64k edge rays, their launches counted apart from
    K3's and K4's, and the same t, hit mask and occlusion as K3/K4."""
    sc = colonnade_card
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 11)
    before = [f.launches for f in (wide.intersect_packet4,
                                   wide.occluded_packet4,
                                   wide.intersect_packet8,
                                   wide.occluded_packet8)]
    ref, occ = _assert_wide_matches_plain(colonnade_nodes8, sc.tris, rays,
                                          width=8)
    assert [f.launches for f in (wide.intersect_packet4,
                                 wide.occluded_packet4,
                                 wide.intersect_packet8,
                                 wide.occluded_packet8)] == [
        before[0], before[1], before[2] + 1, before[3] + 1]
    four = wide.intersect_packet4(sc.nodes4, sc.tris, *rays)
    np.testing.assert_array_equal(ref.t.cpu().numpy(), four.t.cpu().numpy())
    np.testing.assert_array_equal(
        occ.cpu().numpy(),
        wide.occluded_packet4(sc.nodes4, sc.tris, *rays).cpu().numpy())
    assert 0.3 < float((ref.tri >= 0).float().mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['hemisphere', 'shadow', 'edge'])
def test_staged_walks_match_plain_on_card(colonnade_card, rays):
    """The staged walks (K5/K6 a stage) bit-equal to their plain
    versions on the colonnade: hemisphere rays from 128^2 camera hits,
    the shadow rays from those hits, and edge rays."""
    sc, dev = colonnade_card, torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(7)
    org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(128, 128), 128,
                                    128, dev, 7)
    zeros = torch.zeros(org.shape[0], device=dev)
    hit = wide.intersect_packet4(sc.nodes4, sc.tris, org, d, zeros,
                                 torch.full_like(zeros, float('inf')))
    *hemi, dg, eps = raysets.hemisphere_rays(sc, org, d, hit, gen, dev)
    batch = {'hemisphere': lambda: hemi,
             'shadow': lambda: raysets.shadow_rays(sc, dg, eps, hit.valid,
                                                   gen, dev),
             'edge': lambda: _edge_rays(sc.bbox_lo, sc.bbox_hi, 4000, 15)
             }[rays]()
    box = (sc.bbox_lo, sc.bbox_hi)
    launches = traverse.intersect_packet.launches
    got = traverse.intersect_packet_staged(sc.nodes, sc.tris, *batch, *box)
    ref = traverse.intersect_staged_plain(sc.nodes, sc.tris, *batch, *box)
    occ = traverse.occluded_packet_staged(sc.nodes, sc.tris, *batch, *box)
    occ_ref = traverse.occluded_staged_plain(sc.nodes, sc.tris, *batch, *box)
    torch.cuda.synchronize()
    assert traverse.intersect_packet.launches == launches + 3
    for g, r in zip((*got, occ), (*ref, occ_ref)):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    one = traverse.intersect_packet(sc.nodes, sc.tris, *batch)
    np.testing.assert_array_equal(got.t.cpu().numpy(), one.t.cpu().numpy())


@pytest.fixture(scope='module')
def colonnade_leaf512():
    """The full colonnade on the card at leaf 512: BVH4 with leaves of up
    to 504 triangles (a leaf of 128 or more goes on the stack by its
    slot), or a skip without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sc = bs.colonnade().commit(device=torch.device('cuda'), leaf_size=512)
    assert sc.accel == 'bvh4'
    assert float(sc.nodes4.reshape(-1, 4, 8)[:, :, 7].max()) >= 256
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['camera', 'hemisphere', 'edge'])
def test_wide_kernels_take_large_leaves(colonnade_leaf512, rays):
    """K3 and K4 bit-equal to their plain versions on the colonnade at
    leaf 512: coherent camera rays (each lane tests its own leaf),
    hemisphere rays from their hits and edge rays, some with tfar <=
    tnear (leaves tested across the warp); empty segments neither hit
    nor are occluded."""
    _assert_large_leaves(colonnade_leaf512, colonnade_leaf512.nodes4, rays,
                         4)


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['camera', 'hemisphere', 'edge'])
def test_wide8_kernels_take_large_leaves(colonnade_leaf512, rays):
    """The width-8 kernels' *_slots forms on the same tree as 8-wide rows,
    held as test_wide_kernels_take_large_leaves holds K3 and K4."""
    nodes8 = raysets.nodes8(colonnade_leaf512)
    assert float(nodes8.reshape(-1, 8)[:, 7].max()) >= wide.SLOTS_MIN
    _assert_large_leaves(colonnade_leaf512, nodes8, rays, 8)


def _assert_large_leaves(sc, nodes, rays, width):
    dev = torch.device('cuda')
    org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(128, 128), 128,
                                    128, dev, 7)
    zeros = torch.zeros(org.shape[0], device=dev)
    batch = [org, d, zeros, torch.full_like(zeros, float('inf'))]
    if rays == 'hemisphere':
        hit = wide.intersect_packet4(sc.nodes4, sc.tris, *batch)
        batch = list(raysets.hemisphere_rays(
            sc, org, d, hit, torch.Generator(device=dev).manual_seed(7),
            dev)[:4])
    elif rays == 'edge':
        batch = _edge_rays(sc.bbox_lo, sc.bbox_hi, 4000, 14)
    ref, occ = _assert_wide_matches_plain(nodes, sc.tris, batch, width)
    assert bool((ref.tri >= 0).any())
    empty = (batch[3] <= batch[2]).cpu().numpy()
    assert not occ.cpu().numpy()[empty].any()
    assert (ref.tri.cpu().numpy()[empty] == -1).all()


def _sweep_case(dev, case):
    """(rows, org, dirn) of one K12 case on the card, from the sphere over
    a floor: its rows against 1000 or 65,537 rays; 512 rows (4,096
    triangles, the table over and over: ties) against 100 rays; its
    triangles, 3 zero ones and its triangles again (ties across lanes and
    slices) against 1000 rays; 37 rows, a count no stage size divides,
    against 140,000 rays; its rows with every other triangle's dwp and
    owp floats scaled by 2^124 (|dwp| up to and past 2^126, where 1 / dwp
    leaves the reciprocal's fast path) against 1000 rays."""
    n = {'few rays': 100, 'ties': 1000, 'ragged': 140_000,
         'wide': 1000}.get(case, case)
    tris, _, rays = _tables_and_rays(dev, n)
    if case == 'few rays':
        tris = tris.repeat(-(-512 // tris.shape[0]), 1)[:512]
    elif case == 'ties':
        t16 = tris.reshape(-1, 16)
        t16 = torch.cat([t16, t16.new_zeros(3, 16), t16])
        tris = torch.cat([t16, t16.new_zeros(-t16.shape[0] % 8, 16)])
        tris = tris.reshape(-1, 128)
    elif case == 'ragged':
        tris = tris[:37]
    elif case == 'wide':
        t16 = tris.reshape(-1, 16).clone()
        t16[::2, [2, 5, 8, 11]] *= 2.0 ** 124
        tris = t16.reshape(-1, 128)
    return tris.contiguous(), rays[0], rays[1]


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1000, 65_537, 'few rays', 'ties', 'ragged',
                               'wide'])
def test_sweep_kernels_match_plain_on_card(cuda, n):
    """K12: one ray per thread over rows of 8 triangles, and 8 lanes per
    ray over their super-tiles (a group a step, or each super-tile's 8
    unrolled), each bit-equal to its plain version, and the two layouts
    to each other (2 reps); the few-ray and tie cases split the triangle
    range over blocks, the ragged one ends on a part stage, the wide one
    takes the checked reciprocal."""
    tris, org, d = _sweep_case(cuda, n)
    tiles = sweep.supertiles(tris)
    if n in ('few rays', 'ties'):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        block = sweep._lib().yrt_sweep_block_rays
        assert sweep.slices(block(0), org.shape[0], tris.shape[0],
                            sweep.MIN_SLICE['rows'], sms) > 1
        assert sweep.slices(block(1), org.shape[0], tiles.shape[0] // 8,
                            sweep.MIN_SLICE['tiles'], sms) > 1
    before = (sweep.sweep_rows.launches, sweep.sweep_tiles.launches)
    got = [sweep.sweep_rows(tris, org, d, 2),
           sweep.sweep_tiles(tiles, org, d, 2, False),
           sweep.sweep_tiles(tiles, org, d, 2, True)]
    ref = sweep.sweep_rows_plain(tris, org, d, 2)
    ref_tiles = sweep.sweep_tiles_plain(tiles, org, d, 2)
    torch.cuda.synchronize()
    assert (sweep.sweep_rows.launches, sweep.sweep_tiles.launches) == (
        before[0] + 1, before[1] + 2)
    assert bool((ref[1] >= 0).any())
    if n in ('few rays', 'ties'):
        # every hit has a twin at the same t: the first copy's (the
        # table's 55 rows) is kept
        assert int(ref[1].max()) < 8 * 55
    if n == 'wide':
        # some rays hit a triangle at |dwp| >= 2^126, others below it
        hit = ref[1] >= 0
        w = tris.reshape(-1, 16)[ref[1][hit].long()]
        dh = d[hit]
        dwp = (dh[:, 0] * w[:, 2] + dh[:, 1] * w[:, 5]) + dh[:, 2] * w[:, 8]
        big = dwp.abs() >= 2.0 ** 126
        assert bool(big.any()) and not bool(big.all())
    for (t, tri), (rt, rtri) in zip(got, (ref, ref_tiles, ref_tiles)):
        np.testing.assert_array_equal(t.cpu().numpy(), rt.cpu().numpy())
        np.testing.assert_array_equal(tri.cpu().numpy(), rtri.cpu().numpy())
    assert torch.equal(ref[0], ref_tiles[0])
    assert torch.equal(ref[1], ref_tiles[1])


def _march_case(case, request):
    """(grid, rays) of one K10 case on the card: the colonnade's grid and
    65,537 edge rays (a third along the axes and face diagonals, with
    dead and finite-tfar rays), those sorted by march_sort_key, rays from
    inside its widest cell (15 tiles), rays along the axes alone; or a
    grid with a large tilted quad whose two triangles each span most
    cells and rays at a shallow angle to it, which test its triangles in
    several cells before and after the cell of the hit."""
    if case == 'spanning':
        packed = mesh.pack_meshes([
            primitives.quad([-4, -4, -4], [4, -4, -4], [4, 3, 4],
                            [-4, 3, 4]),
            primitives.tessellate_sphere([0, 0, 0], 1.0, 8, 10)],
            pad_multiple=64)
        host = {k: getattr(packed, k) for k in ('v0', 'e1', 'e2', 'ng',
                                                 'cull', 'valid')}
        woop = mesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                                  host['valid'])
        g = {k: torch.as_tensor(v).cuda()
             for k, v in grid.build_grid(woop, host).items()}
        # the quad's plane is y = -4 + 0.875 (z + 4); the rays start below
        # it at z = -4.5 and climb a little more steeply
        rs = np.random.RandomState(21)
        n = 4096
        org = np.stack([rs.uniform(-4, 4, n),
                        -4.4375 - rs.uniform(0.2, 2.0, n),
                        np.full(n, -4.5)], 1).astype(np.float32)
        d = np.stack([rs.uniform(-0.3, 0.3, n), rs.uniform(0.95, 1.3, n),
                      np.ones(n)], 1).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = [torch.as_tensor(x).cuda() for x in (
            org, d, np.full(n, 1e-4, np.float32),
            np.full(n, np.inf, np.float32))]
        return g, rays
    sc = request.getfixturevalue('colonnade_card')
    g = sc.grid
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, 65_537, 19)
    if case == 'sorted':
        perm = torch.argsort(grid.march_sort_key(g, *rays), stable=True)
        rays = [x[perm] for x in rays]
    elif case == 'widest_cell':
        c = int(torch.argmax(g['cell_tile_hi'] - g['cell_tile_lo']))
        assert int(g['cell_tile_hi'][c] - g['cell_tile_lo'][c]) == 15
        cs = (g['grid_hi'] - g['grid_lo']) / grid.GRID_RES
        ijk = torch.tensor([c // 64, c // 8 % 8, c % 8], device='cuda')
        u = torch.as_tensor(np.random.RandomState(20).rand(8192, 3),
                            dtype=torch.float32).cuda()
        rays[0] = g['grid_lo'] + (ijk + u) * cs
        rays = [x[:8192] for x in rays]
    elif case == 'axis_dirs':
        axes = torch.cat([torch.eye(3), -torch.eye(3)]).cuda()
        rays[1] = axes[torch.arange(rays[1].shape[0], device='cuda') % 6]
    return g, rays


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['scene', 'rays_65537', 'sorted',
                                  'widest_cell', 'axis_dirs', 'spanning'])
def test_grid_kernels_match_plain_on_card(cuda, request, case):
    """K8 and K9 over the whole table and over each ray's entry cell, and
    the grid march K10, bit-equal to their plain versions on a small
    scene; K10 and its sorted entry point also on the cases of
    _march_case."""
    if case != 'scene':
        g, rays = _march_case(case, request)
        before = grid.march_raw.launches
        got, ref = grid.march_raw(g, *rays), grid.march_raw_plain(g, *rays)
        hit = grid.intersect_march(g, *rays)
        torch.cuda.synchronize()
        assert grid.march_raw.launches == before + 2
        assert bool((ref[1] >= 0).any())
        _assert_outputs_equal(got, ref)
        _assert_outputs_equal(tuple(hit), tuple(grid._to_hit(g, *rays[:2],
                                                             *ref)))
        return
    _, tables, rays = _tables_and_rays(cuda)
    g = tables['grid']
    before = (pairs.intersect_pairs_raw.launches,
              pairs.occluded_pairs.launches, grid.march_raw.launches)
    outs = []
    for ranges in ((), grid.entry_ranges(g, *rays)):
        outs += [(pairs.intersect_pairs_raw(g['rows'], *rays, *ranges),
                  pairs.intersect_pairs_raw_plain(g['rows'], *rays, *ranges)),
                 ((pairs.occluded_pairs(g['rows'], *rays, *ranges),),
                  (pairs.occluded_pairs_plain(g['rows'], *rays, *ranges),))]
    outs.append((grid.march_raw(g, *rays), grid.march_raw_plain(g, *rays)))
    torch.cuda.synchronize()
    assert (pairs.intersect_pairs_raw.launches, pairs.occluded_pairs.launches,
            grid.march_raw.launches) == tuple(b + k for b, k in
                                              zip(before, (2, 2, 1)))
    assert bool((outs[-1][1][1] >= 0).any()) and bool(outs[1][1][0].any())
    for got, ref in outs:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


_PLAIN_PAIRS = {'intersect_pairs_raw': pairs.intersect_pairs_raw_plain,
                'occluded_pairs': pairs.occluded_pairs_plain}


def _assert_outputs_equal(got, ref):
    got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('binning', ['grid', 'dense'])
def test_pair_kernels_match_plain_on_frame_calls(colonnade_card, binning):
    """K8 and K9 bit-equal to their plain versions on every call of one
    bounce-1 trace (256^2 rays) through the grid's rounds (over the
    grid's rows) or the dense rounds (over the treelets' rows)."""
    calls = raysets.frame_pair_calls(colonnade_card,
                                     bs.colonnade_camera(256, 256), binning,
                                     256, 256)
    assert len(calls) == (12 if binning == 'grid' else 4)
    for c in calls:
        _assert_outputs_equal(c['out'], _PLAIN_PAIRS[c['kernel']](*c['args']))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['rays_1', 'rays_127', 'rays_128',
                                  'rays_65537', 'one_bin', 'no_range',
                                  'empty_and_dead', 'mixed_ge'])
@pytest.mark.parametrize('table', ['grid', 'dense'])
def test_pair_kernels_on_edge_cases(colonnade_card, table, case):
    """K8 and K9 (and their binning) bit-equal to their plain versions
    over the colonnade's grid rows or treelet rows: random cells' or
    treelets' ranges at 1, 127, 128 and 65,537 rays; every ray in one
    bin; no ranges; empty ranges and dead rays; one gs with mixed ge."""
    sc = colonnade_card
    if table == 'grid':
        rows, lo, hi = (sc.grid[k] for k in ('rows', 'cell_tile_lo',
                                             'cell_tile_hi'))
    else:
        rows, lo, hi = (sc.treelets[k] for k in (
            'planes_rows', 'treelet_tile_lo', 'treelet_tile_hi'))
    n_tiles = rows.shape[0] // pairs.TL
    n = int(case.split('_')[1]) if case.startswith('rays_') else 4096
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 13)
    rs = np.random.RandomState(17)
    pick = torch.as_tensor(rs.randint(0, lo.shape[0], n)).cuda()
    gs, ge = lo[pick].int(), hi[pick].int()
    widest = int(torch.argmax(hi - lo))
    if case in ('one_bin', 'mixed_ge'):
        gs = torch.full_like(gs, int(lo[widest]))
        ge = torch.full_like(ge, int(hi[widest]))
    if case == 'mixed_ge':
        ge = torch.clamp(gs + torch.as_tensor(rs.randint(0, 6, n)).cuda(),
                         max=n_tiles).int()
    if case == 'empty_and_dead':
        ge = torch.where(torch.arange(n).cuda() % 3 == 0, gs, ge)
        rays[3] = torch.where(torch.arange(n).cuda() % 5 == 1, rays[2],
                              rays[3])
    ranges = () if case == 'no_range' else (gs, ge)
    before = (pairs.intersect_pairs_raw.launches,
              pairs.occluded_pairs.launches, pairs.bin_rays.launches)
    outs = [(f(rows, *rays, *ranges), _PLAIN_PAIRS[f.__name__](
        rows, *rays, *ranges)) for f in (pairs.intersect_pairs_raw,
                                         pairs.occluded_pairs)]
    torch.cuda.synchronize()
    assert (pairs.intersect_pairs_raw.launches, pairs.occluded_pairs.launches,
            pairs.bin_rays.launches) == (before[0] + 1, before[1] + 1,
                                         before[2] + 2 * bool(ranges))
    for got, ref in outs:
        _assert_outputs_equal(got, ref)
    if n > 1000:
        assert bool((outs[0][1][1] >= 0).any()) and bool(outs[1][1].any())


@pytest.mark.cuda
def test_motion_kernel_matches_plain_on_card(cuda):
    """The motion kernel on a moving quad and a falling sphere (the
    tests/test_motion.py scene, leaf 8) at random times, bit-equal to its
    plain version; its hit mask is occluded_packet_mb."""
    sb = SceneBuilder()
    sb.add_mesh(mesh.HostMesh(
        np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                   np.float32), np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
        motions=np.tile(np.float32([2, 0, 0]), (4, 1))))
    sph = primitives.tessellate_sphere([0, 2, 0], 0.6, 10, 12)
    sph.motions = np.tile(np.float32([0, -1.5, 0]), (len(sph.positions), 1))
    sb.add_mesh(sph)
    sc = sb.commit(device=cuda, force_bvh=True, leaf_size=8)
    assert sc.accel == 'bvh4mb'
    _, _, rays = _tables_and_rays(cuda)
    rays[0] = rays[0] * (2 / 3) + torch.tensor([0.0, 3.0, 0.0], device=cuda)
    time = torch.rand(rays[0].shape[0], generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda)
    ref, _ = _assert_motion_matches_plain(sc.nodes, sc.tris_mb, rays, time)
    assert bool((ref.tri >= 0).any())


def _assert_motion_matches_plain(nodes, tris_mb, rays, time):
    """K7's closest form bit-equal to its plain version and its any-hit
    form to its own and to the closest form's tri >= 0, each launched
    once; returns the plain results."""
    launches = (traverse.intersect_packet_mb.launches,
                traverse.occluded_packet_mb.launches)
    hit = traverse.intersect_packet_mb(nodes, tris_mb, *rays, time)
    ref = traverse.intersect_motion_plain(nodes, tris_mb, *rays, time)
    occ = traverse.occluded_packet_mb(nodes, tris_mb, *rays, time)
    occ_ref = traverse.occluded_motion_plain(nodes, tris_mb, *rays, time)
    torch.cuda.synchronize()
    assert (traverse.intersect_packet_mb.launches,
            traverse.occluded_packet_mb.launches) == (launches[0] + 1,
                                                      launches[1] + 1)
    for g, r in zip(hit, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(occ.cpu().numpy(), occ_ref.cpu().numpy())
    np.testing.assert_array_equal(occ.cpu().numpy(),
                                  (ref.tri >= 0).cpu().numpy())
    return ref, occ_ref


@pytest.fixture(scope='module')
def motion_card():
    """The motion field on the card (173 binary nodes over union bounds,
    leaves of up to 64 motion rows), or a skip without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sc = bs.motion_field().commit(device=torch.device('cuda'))
    assert sc.accel == 'bvh4mb' and float(sc.nodes[:, 7].max()) > 32
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['camera', 'scattered', 'every_fourth_live',
                                  'edge_65537'])
def test_motion_kernels_on_motion_field(motion_card, rays):
    """K7's two forms bit-equal to their plain versions on the motion
    field: chip_smoke.py's entry sets (512^2 camera rays with their
    times, 1M scattered rays) where most lanes test their own leaves;
    with only every fourth ray live (8 lanes a warp), where the warp tests
    each leaf across its lanes, two rounds of 32 for a leaf of 33-64 rows;
    and 65,537 edge rays (a block's edge; dead, empty and finite
    segments), where neither form reports a hit on an empty segment."""
    sc, dev = motion_card, torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(31)
    if rays == 'camera':
        org, d, time = raysets.camera_rays(
            sc, bs.motion_field_camera(512, 512), 512, 512, dev, 42)
        zeros = torch.zeros(org.shape[0], device=dev)
        batch = [org, d, zeros, torch.full_like(zeros, float('inf'))]
    elif rays == 'scattered':
        *batch, time = raysets.scattered_rays(sc, 1 << 20, gen, dev)
    else:
        n = 20_000 if rays == 'every_fourth_live' else 65_537
        batch = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 32)
        time = torch.rand(n, generator=gen, device=dev)
        if rays == 'every_fourth_live':
            batch[3][torch.arange(n, device=dev) % 4 != 0] = -1.0
    ref, occ = _assert_motion_matches_plain(sc.nodes, sc.tris_mb, batch,
                                            time)
    assert bool((ref.tri >= 0).any()) and bool(occ.any())
    empty = (batch[3] <= batch[2]).cpu().numpy()
    assert not occ.cpu().numpy()[empty].any()


@pytest.mark.cuda
def test_motion_kernels_match_plain_on_frame_calls(motion_card):
    """K7's two forms bit-equal to their plain versions on every call of
    one bounce-1 trace of the motion field (256^2, 4 spp): each bounce's
    closest call and its shadow rays' any-hit call."""
    calls = raysets.frame_motion_calls(motion_card,
                                       bs.motion_field_camera(256, 256),
                                       256, 256, spp=4)
    assert [c['kernel'] for c in calls] == ['intersect_packet_mb',
                                            'occluded_packet_mb'] * 2
    plain = {'intersect_packet_mb': traverse.intersect_motion_plain,
             'occluded_packet_mb': traverse.occluded_motion_plain}
    for c in calls:
        _assert_outputs_equal(c['out'], plain[c['kernel']](*c['args']))


@pytest.mark.cuda
def test_rooted_binary_kernels_match_plain_on_card(cuda):
    """K5/K6 with each ray started at a treelet root (the nearest treelet
    of its box entry, as the treelet binning's first round picks it),
    bit-equal to their plain versions."""
    tris, nodes, rays = _tables_and_rays(cuda)
    troots, tboxes = (torch.as_tensor(x).to(cuda) for x in
                      treelets.treelet_cut(nodes['binary'].cpu().numpy(), 6))
    sel, has = treelets.treelet_assign(tboxes, *rays, treelets.
                                       no_treelets_visited(rays[0].shape[0],
                                                           6, cuda))
    roots = troots[torch.clamp(sel, min=0).long()]
    rays[3] = torch.where(has, rays[3], -1.0)
    args = (nodes['binary'], tris, *rays, roots)
    got = traverse.intersect_packet(*args)
    ref = traverse.intersect_binary_plain(*args)
    torch.cuda.synchronize()
    assert bool((ref.tri >= 0).any())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(
        traverse.occluded_packet(*args).cpu().numpy(),
        traverse.occluded_binary_plain(*args).cpu().numpy())


def _assert_binary_matches_plain(nodes, tris, rays, roots=None):
    """K5 and K6 bit-equal to their plain versions on rays (from roots),
    each launched once; returns the plain results."""
    launches = (traverse.intersect_packet.launches,
                traverse.occluded_packet.launches)
    hit = traverse.intersect_packet(nodes, tris, *rays, roots)
    ref = traverse.intersect_binary_plain(nodes, tris, *rays, roots)
    occ = traverse.occluded_packet(nodes, tris, *rays, roots)
    occ_ref = traverse.occluded_binary_plain(nodes, tris, *rays, roots)
    torch.cuda.synchronize()
    assert (traverse.intersect_packet.launches,
            traverse.occluded_packet.launches) == (launches[0] + 1,
                                                   launches[1] + 1)
    for g, r in zip(hit, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    np.testing.assert_array_equal(occ.cpu().numpy(), occ_ref.cpu().numpy())
    return ref, occ_ref


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['camera', 'every_fourth_live', 'fifteen'])
def test_binary_leaf_schedules_agree(colonnade_card, rays):
    """K5 and K6 bit-equal to their plain versions whichever way the warp
    tests its lanes' leaves: coherent camera rays mostly take each lane's
    own leaf loop; with only every fourth ray live (8 lanes a warp), or 15
    rays in all, every leaf is tested across the warp."""
    sc, dev = colonnade_card, torch.device('cuda')
    if rays == 'camera':
        org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(128, 128),
                                        128, 128, dev, 7)
        zeros = torch.zeros(org.shape[0], device=dev)
        batch = [org, d, zeros, torch.full_like(zeros, float('inf'))]
    else:
        n = 15 if rays == 'fifteen' else 20_000
        batch = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 13)
        if rays == 'every_fourth_live':
            batch[3][torch.arange(n, device=dev) % 4 != 0] = -1.0
    ref, occ = _assert_binary_matches_plain(sc.nodes, sc.tris, batch)
    assert bool((ref.tri >= 0).any())
    if rays != 'fifteen':
        assert bool(occ.any())


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 127, 128, 65_537, 4000])
def test_binary_kernels_on_edge_rays(colonnade_card, n):
    """K5 and K6 bit-equal to their plain versions on the colonnade's
    tree at 1, 127, 128 and 65,537 rays (a block's edges) and 4,000: rays
    from inside boxes, along the axes, dead (tfar < tnear) or empty
    (tfar == tnear), which neither hit nor are occluded."""
    sc = colonnade_card
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, n, 21)
    ref, occ = _assert_binary_matches_plain(sc.nodes, sc.tris, rays)
    empty = (rays[3] <= rays[2]).cpu().numpy()
    assert not occ.cpu().numpy()[empty].any()
    assert (ref.tri.cpu().numpy()[empty] == -1).all()
    if n >= 4000:
        assert empty.any() and bool((ref.tri >= 0).any()) and bool(occ.any())


@pytest.mark.cuda
@pytest.mark.parametrize('roots', ['treelets', 'mixed'])
def test_rooted_binary_kernels_on_colonnade(colonnade_card, roots):
    """K5 and K6 bit-equal to their plain versions with each ray started
    at the root of its nearest treelet (as the treelet binning's first
    round), or at a random node of the tree: every third ray at a leaf,
    every third at an interior node, the rest at the root."""
    sc, dev = colonnade_card, torch.device('cuda')
    rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, 20_000, 22)
    if roots == 'treelets':
        *rays, start = raysets.from_treelet_roots(sc, *rays)
    else:
        rs = np.random.RandomState(23)
        tag = sc.nodes[:, 7].cpu().numpy()
        leaves, inner = np.nonzero(tag > 0)[0], np.nonzero(tag < 0)[0]
        pick = np.zeros(20_000, np.int32)
        pick[0::3] = rs.choice(leaves, len(pick[0::3]))
        pick[1::3] = rs.choice(inner, len(pick[1::3]))
        start = torch.as_tensor(pick, device=dev)
    ref, occ = _assert_binary_matches_plain(sc.nodes, sc.tris, rays, start)
    assert bool((ref.tri >= 0).any()) and bool(occ.any())


@pytest.mark.cuda
@pytest.mark.parametrize('how', ['bvh2', 'treelet'])
def test_binary_kernels_match_plain_on_frame_calls(colonnade_card, how):
    """K5 and K6 bit-equal to their plain versions on every call of one
    bounce-1 trace (256^2 rays): both bounces with accel 'bvh2', or
    bounce 1's two rounds from treelet roots and the fallback of
    ray_binning 'treelet'."""
    calls = raysets.frame_binary_calls(colonnade_card,
                                       bs.colonnade_camera(256, 256), how,
                                       256, 256)
    assert len(calls) == (4 if how == 'bvh2' else 6)
    plain = {'intersect_packet': traverse.intersect_binary_plain,
             'occluded_packet': traverse.occluded_binary_plain}
    for c in calls:
        _assert_outputs_equal(c['out'], plain[c['kernel']](*c['args']))


@pytest.fixture(scope='module')
def colonnade_bvh2_leaf512():
    """The full colonnade on the card at leaf 512 with accel='bvh2' (binary
    leaves of up to 504 triangles), or a skip without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sc = bs.colonnade().commit(device=torch.device('cuda'), leaf_size=512,
                               accel='bvh2')
    assert sc.accel == 'bvh2' and float(sc.nodes[:, 7].max()) >= 256
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize('rays', ['camera', 'hemisphere', 'edge'])
def test_binary_kernels_take_large_leaves(colonnade_bvh2_leaf512, rays):
    """K5 and K6 bit-equal to their plain versions on the binary colonnade
    at leaf 512: coherent camera rays (each lane tests its own leaf),
    hemisphere rays from their hits and edge rays (leaves of hundreds of
    triangles tested across the warp 32 at a time)."""
    sc, dev = colonnade_bvh2_leaf512, torch.device('cuda')
    org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(128, 128), 128,
                                    128, dev, 7)
    zeros = torch.zeros(org.shape[0], device=dev)
    batch = [org, d, zeros, torch.full_like(zeros, float('inf'))]
    if rays == 'hemisphere':
        hit = traverse.intersect_packet(sc.nodes, sc.tris, *batch)
        batch = list(raysets.hemisphere_rays(
            sc, org, d, hit, torch.Generator(device=dev).manual_seed(7),
            dev)[:4])
    elif rays == 'edge':
        batch = _edge_rays(sc.bbox_lo, sc.bbox_hi, 4000, 14)
    ref, occ = _assert_binary_matches_plain(sc.nodes, sc.tris, batch)
    assert bool((ref.tri >= 0).any())
    empty = (batch[3] <= batch[2]).cpu().numpy()
    assert not occ.cpu().numpy()[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize('n', ['1000', '1024', 'colonnade_65537',
                               'colonnade_sorted'])
def test_splitleaf_kernel_matches_plain_on_card(cuda, request, n):
    """K11 bit-equal to its plain version, the tail packet (1000 rays) and
    the sorted form among them, and on the colonnade (leaf 32, with
    leaves of max_leaf = 32 triangles) at 65,537 edge rays in call order
    and in octant/Morton order; its t and hit mask are K5's."""
    if n.startswith('colonnade'):
        sc = request.getfixturevalue('colonnade_card')
        nodes, tris = sc.nodes, sc.tris
        assert int(nodes[:, 7].max()) == sc.leaf_size == 32
        rays = _edge_rays(sc.bbox_lo, sc.bbox_hi, 65_537, 23)
        if n == 'colonnade_sorted':
            perm = binning.sort_perm(*rays, sc.bbox_lo, sc.bbox_hi)
            rays = [x[perm] for x in rays]
        box = (sc.bbox_lo, sc.bbox_hi)
    else:
        tris, tables, rays = _tables_and_rays(cuda, int(n))
        nodes = tables['binary']
        box = ((-5.0, -1.2, -5.0), (5.0, 1.0, 5.0))
    launches = splitleaf.intersect_packet_split.launches
    got = splitleaf.intersect_packet_split(nodes, tris, *rays, 32
                                           if n.startswith('col') else None)
    ref = splitleaf.intersect_split_plain(nodes, tris, *rays, 32
                                          if n.startswith('col') else None)
    srt = splitleaf.intersect_packet_split_sorted(nodes, tris, *rays, *box)
    k5 = traverse.intersect_packet(nodes, tris, *rays)
    torch.cuda.synchronize()
    assert splitleaf.intersect_packet_split.launches == launches + 2
    assert bool((ref.tri >= 0).any())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    for g in (got, srt):
        np.testing.assert_array_equal(g.t.cpu().numpy(), k5.t.cpu().numpy())
        # the colonnade's rays may hit two triangles at one t (a tie)
        tri = (g.tri, k5.tri) if n in ('1000', '1024') else (
            g.tri >= 0, k5.tri >= 0)
        np.testing.assert_array_equal(*(x.cpu().numpy() for x in tri))


def _woop_table(v0, e1, e2, cull, n_rows):
    """(n_rows / 8, 128) packed rows of the triangles (v0, e1, e2) with
    their cull flags, then zero rows."""
    woop = mesh.woop_matrices(v0, e1, e2, np.ones(len(v0), bool))
    ng = np.cross(e1, e2)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    rows = wide.pack_tris(woop, {'ng': ng, 'cull': cull}).reshape(-1, 16)
    out = np.zeros((n_rows, 16), np.float32)
    out[:len(v0)] = rows[:len(v0)]
    return torch.as_tensor(out.reshape(-1, 128))


def _random_table(n_live, n_rows, seed, cull_every=0):
    """n_live random triangles in [-2, 2]^3 (every cull_every-th with cull
    flag 1), then zero rows up to n_rows."""
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-2, 2, (n_live, 3)).astype(np.float32)
    e1, e2 = (rs.uniform(-0.7, 0.7, (n_live, 3)).astype(np.float32)
              for _ in range(2))
    cull = np.zeros(n_live, np.float32)
    if cull_every:
        cull[::cull_every] = mesh.CULL_BACK
    return _woop_table(v0, e1, e2, cull, n_rows)


def _dense_case(case, dev):
    """(tris, closest-hit rays, any-hit rays, live rows) of one case of
    test_dense_kernels_on_tables, on the card."""
    gen = torch.Generator(device=dev).manual_seed(42)
    if case in ('cornell', 'rays_65537'):
        sc = bs.cornell_box().commit(device=dev)
        size = 64 if case == 'cornell' else 256
        closest, shadow = raysets.dense_entry_rays(
            sc, bs.cornell_camera(size, size), size, dev, gen, 42)
        if case == 'cornell':      # the table trimmed to its 32 live rows
            return (dense._rows(sc.tris)[:32].reshape(4, 128).contiguous(),
                    closest, shadow, 32)
        return (sc.tris, tuple(x[:65_537] for x in closest),
                tuple(x[:65_537] for x in shadow), 32)
    tris, _, rays = _tables_and_rays(dev, 4000)
    rows = dense._rows(tris)
    if case == 'last_live':        # a large triangle over the floor, last
        last = _woop_table(np.float32([[-4, -1.0, -4]]),
                           np.float32([[8, 0, 0]]), np.float32([[0, 0, 8]]),
                           np.float32([0]), 8).to(dev)
        table = rows.clone()
        table[-1] = dense._rows(last)[0]
        return table.reshape(-1, 128), rays, rays, table.shape[0]
    if case == 'ties':             # every row twice, 448 rows apart
        live = dense.live_rows(tris)
        table = torch.cat([rows, rows]).reshape(-1, 128)
        return table, rays, rays, rows.shape[0] + live
    if case == 'all_zero':
        return torch.zeros((4, 128), device=dev), rays, rays, 0
    box = _edge_rays([-3, -3, -3], [3, 3, 3], 4000, 7)
    if case == 'tris_2048':
        return _random_table(1917, 2048, 5).to(dev), box, box, 1917
    assert case == 'culled'
    return _random_table(300, 320, 6, cull_every=2).to(dev), box, box, 300


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['cornell', 'last_live', 'tris_2048',
                                  'culled', 'all_zero', 'ties', 'rays_65537'])
def test_dense_kernels_on_tables(cuda, case):
    """K1/K2 over a table's live rows bit-equal to their plain versions
    over every row: cornell trimmed to its 32 live rows, a table whose
    last row is live, 2,048 triangles of which 1,917 live (16 tiles, the
    last one partly live), cull-flagged rows with rays from both sides
    (stage 3), an all-zero table (no launch; misses and no occlusion),
    every row twice (exact t ties across tiles: the lower index), and
    65,537 rays."""
    tris, closest, shadow, live = _dense_case(case, cuda)
    assert dense.live_rows(tris) == live
    before = (dense.intersect_dense.launches, dense.occluded_dense.launches)
    got = dense.intersect_dense(tris, *closest)
    occ = dense.occluded_dense(tris, *shadow)
    torch.cuda.synchronize()
    ran = int(live > 0)
    assert (dense.intersect_dense.launches,
            dense.occluded_dense.launches) == (before[0] + ran,
                                               before[1] + ran)
    ref = dense.intersect_dense_plain(tris, *closest)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy())
    ref_occ = dense.occluded_dense_plain(tris, *shadow)
    np.testing.assert_array_equal(occ.cpu().numpy(), ref_occ.cpu().numpy())
    if case == 'all_zero':
        assert not bool((ref.tri >= 0).any()) and not bool(ref_occ.any())
        return
    assert bool((ref.tri >= 0).any()) and bool(ref_occ.any())
    if case == 'ties':
        half = dense._rows(tris).shape[0] // 2
        assert bool((ref.tri[ref.tri >= 0] < half).all())
    if case == 'culled':           # the cull flags reject some hits
        flat = dense._rows(tris).clone()
        flat[:, 15] = 0
        open_ = dense.intersect_dense_plain(flat.reshape(-1, 128), *closest)
        assert not torch.equal(open_.tri, ref.tri)
    if case == 'last_live':
        assert bool((ref.tri == live - 1).any())


@pytest.mark.cuda
def test_kernel_rejects_tables_off_the_card(cuda):
    tris, _, rays = _tables_and_rays(cuda)
    with pytest.raises(ValueError):
        dense.intersect_dense(tris.cpu(), *rays)


@pytest.mark.cuda
def test_cornell_golden_on_card(cuda):
    before = (dense.intersect_dense.launches, dense.occluded_dense.launches,
              dense.intersect_dense_plain.cuda_calls)
    film, _ = renderer.render_frame(
        bs.cornell_box().commit(device=cuda), bs.cornell_camera(64, 64),
        pt.PTParams(max_depth=4), 64, 64, spp=32, seed=42)
    img = accum.resolve(film).cpu().numpy()
    golden = np.load(os.path.join(GOLDEN, 'cornell_64_cpu.npz'))['img']
    mse = ((img - golden) ** 2).mean()
    assert 10 * np.log10(img.max() ** 2 / max(mse, 1e-20)) >= 40.0
    assert dense.intersect_dense.launches > before[0]
    assert dense.occluded_dense.launches > before[1]
    assert dense.intersect_dense_plain.cuda_calls == before[2]


@pytest.mark.cuda
def test_motion_golden_on_card(cuda):
    """motion_64 (depth 2, 16 spp, seed 42) through the motion kernel's
    closest and any-hit forms, and no plain version."""
    before = (traverse.intersect_packet_mb.launches,
              traverse.occluded_packet_mb.launches,
              traverse.intersect_motion_plain.cuda_calls,
              traverse.occluded_motion_plain.cuda_calls)
    film, _ = renderer.render_frame(
        bs.motion_field().commit(device=cuda), bs.motion_field_camera(64, 64),
        pt.PTParams(max_depth=2), 64, 64, spp=16, seed=42)
    img = accum.resolve(film).cpu().numpy()
    golden = np.load(os.path.join(GOLDEN, 'motion_64_cpu.npz'))['img']
    mse = ((img - golden) ** 2).mean()
    assert 10 * np.log10(img.max() ** 2 / max(mse, 1e-20)) >= 40.0
    assert traverse.intersect_packet_mb.launches > before[0]
    assert traverse.occluded_packet_mb.launches > before[1]
    assert (traverse.intersect_motion_plain.cuda_calls,
            traverse.occluded_motion_plain.cuda_calls) == before[2:]


@pytest.mark.cuda
@pytest.mark.parametrize('binning', ['grid', 'dense', 'treelet'])
def test_colonnade_grid_golden_on_card(cuda, binning):
    """colonnade_64 (depth 3, 8 spp, leaf 32, seed 42) with ray_binning
    'grid', 'dense' or 'treelet': BVH4 on bounce 0, then the binning's
    kernels (the pair kernels and the binary fallback, or the binary
    kernels alone)."""
    kernels = ((traverse.intersect_packet, traverse.occluded_packet)
               + ((pairs.intersect_pairs_raw, pairs.occluded_pairs)
                  if binning != 'treelet' else ()))
    before = [f.launches for f in kernels]
    plain = pairs.intersect_pairs_raw_plain.cuda_calls
    film, _ = renderer.render_frame(
        bs.colonnade().commit(device=cuda, leaf_size=32),
        bs.colonnade_camera(64, 64),
        pt.PTParams(max_depth=3, ray_binning=binning), 64, 64, spp=8,
        seed=42)
    img = accum.resolve(film).cpu().numpy()
    golden = np.load(os.path.join(GOLDEN, 'colonnade_64_cpu.npz'))['img']
    mse = ((img - golden) ** 2).mean()
    assert 10 * np.log10(img.max() ** 2 / max(mse, 1e-20)) >= 40.0
    assert all(f.launches > b for f, b in zip(kernels, before))
    assert pairs.intersect_pairs_raw_plain.cuda_calls == plain


@pytest.mark.cuda
def test_stereo_golden_on_card(cuda):
    """stereo_64 (cornell through StereoCube face 7, depth 2, 8 spp, seed
    42) through the dense kernels."""
    before = (dense.intersect_dense.launches, dense.occluded_dense.launches)
    film, _ = renderer.render_frame(
        bs.cornell_box().commit(device=cuda), bs.cornell_stereo_camera(64, 64),
        pt.PTParams(max_depth=2), 64, 64, spp=8, seed=42)
    img = accum.resolve(film).cpu().numpy()
    golden = np.load(os.path.join(GOLDEN, 'stereo_64_cpu.npz'))['img']
    mse = ((img - golden) ** 2).mean()
    assert 10 * np.log10(img.max() ** 2 / max(mse, 1e-20)) >= 40.0
    assert dense.intersect_dense.launches > before[0]
    assert dense.occluded_dense.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize('toe_in', [False, True])
def test_stereo_rays_on_card_match_cpu(cuda, toe_in):
    """All 12 faces of the production rig (scene scale 0.05) against the
    port's own CPU rays, on a jittered 64 x 64 set and each face's exact
    centre.  Directions within 4 float32 ulps of each ray's largest
    coordinate magnitude.  Origins within that plus what the head
    rotation's angle, theta = arccos(c), makes of a few ulps in c: the
    card sums the dot product's three terms in another order than the
    CPU, and near c = 1 an error of 4 ulps in c moves theta by up to
    sqrt(8 eps), which moves the eye, |eye offset| from the head axis, by
    |eye offset| sqrt(8 eps)."""
    from yulio_raytracer_tpu_torch.cameras import cameras as cam
    rs = np.random.RandomState(64)
    yy, xx = np.mgrid[0:64, 0:64]
    pix = np.concatenate([(np.stack([xx.ravel(), yy.ravel()], -1)
                           + rs.rand(64 * 64, 2)) / 64, [[0.5, 0.5]]])
    pix = torch.as_tensor(pix.astype(np.float32))
    rig = cam.make_stereo_rig(cam.look_at((-9.0, 2.2, 0.0), (10.0, 1.6, 0.0),
                                          (0.0, 1.0, 0.0)),
                              scene_scale=0.05, toe_in=toe_in)
    eps = float(np.finfo(np.float32).eps)
    eye_off = 0.5 * cam.EYE_SEPARATION * 0.05
    for face in rig:
        for what, got, ref in zip(('origin', 'direction'),
                                  face.ray(pix.to(cuda), None),
                                  face.ray(pix, None)):
            assert got.device.type == 'cuda'
            bound = ref.abs().amax(dim=-1, keepdim=True) * eps * 4
            if what == 'origin':
                bound = bound + eye_off * np.sqrt(8 * eps)
            err = (got.cpu() - ref).abs()
            assert bool((err <= bound).all()), \
                (face.cube_face_index, what, float((err / bound).max()))


@pytest.mark.cuda
@pytest.mark.parametrize('accel', ['default', 'bvh2'])
def test_compaction_matches_off_on_card(cuda, accel):
    """The colonnade at 67 x 45 x 2 spp (no multiple of 32 rays), depth 10
    with the dome cap: compaction 'auto' films bit-equal to 'off' with
    equal rays, through the BVH4 (or binary) kernels."""
    sc = bs.colonnade().commit(device=cuda, leaf_size=32, accel=accel)
    kernels = ((wide.intersect_packet4, wide.occluded_packet4)
               if sc.accel == 'bvh4' else
               (traverse.intersect_packet, traverse.occluded_packet))
    cam = bs.colonnade_camera(67, 45)
    params = pt.PTParams(max_depth=10, t_max_shadow_ray=12.0)
    before = [f.launches for f in kernels]
    f_off, s_off = renderer.render_frame(sc, cam, params, 67, 45, spp=2,
                                         seed=5, compaction='off')
    stats = []
    f_on, s_on = renderer.render_frame(sc, cam, params, 67, 45, spp=2,
                                       seed=5, compaction='auto',
                                       bounce_stats=stats)
    assert len(stats) == params.max_depth or stats[-1]['live'] == 0
    assert stats[-1]['width'] < stats[0]['width']
    assert torch.equal(f_off.rgb_sum, f_on.rgb_sum)
    assert s_off.num_rays == s_on.num_rays
    assert all(f.launches > b for f, b in zip(kernels, before))


def _shading_inputs(n=4096):
    """A textured atlas (both filters, one inverted), a material table of
    every probe preset bound to its textures (Obj with a bump map), and n
    hits: material ids (with -1), uvs outside [0, 1), a tangent frame."""
    rs = np.random.RandomState(21)
    b = tex.TextureTableBuilder()
    b.add(bs._procedural_texture(rs, 2, res=32))
    b.add((rs.rand(5, 7, 3) * 255).astype(np.uint8), invert=True)
    b.add(rs.rand(4, 4).astype(np.float32), filter=tex.FILTER_NEAREST)
    specs = [mat.make_material(name, p, tex_id=k % 3)
             for k, (name, p) in enumerate(PROBE_PRESETS.items())]
    specs.append(mat.make_material('obj', PROBE_PRESETS['obj'], tex_id=0,
                                   tex_ids={'map_d': 1, 'map_Bump': 2}))
    table = mat.build_table(specs)
    ns = rs.randn(n, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    tx = np.cross(rs.randn(n, 3).astype(np.float32), ns)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    hits = {'mid': rs.randint(-1, len(specs), n),
            'st': rs.uniform(-1.5, 2.5, (n, 2)).astype(np.float32),
            'eta': np.where(rs.rand(n) < 0.5, 1.5, 1.0).astype(np.float32),
            'trans': np.ones((n, 3), np.float32),
            'ns': ns, 'tx': tx, 'ty': np.cross(ns, tx)}
    return b.build(), table, hits


@pytest.mark.cuda
def test_texture_fetch_and_shade_context_on_card_match_cpu(cuda):
    """The texture fetch and the shade context (all seven texture modes,
    a bump map, rays inside and outside a dielectric) on the card equal
    the port's CPU results within 1e-6."""
    atlas, table, hits = _shading_inputs()
    gates = mat.table_gates(table)
    outs = []
    for dev in ('cpu', cuda):
        t_atlas = {k: torch.as_tensor(v).to(dev) for k, v in atlas.items()}
        t_tab = {k: torch.as_tensor(v).to(dev) for k, v in table.items()}
        h = {k: torch.as_tensor(v).to(dev) for k, v in hits.items()}
        texel = tex.fetch(t_atlas, h['mid'] % 3 - (h['mid'] < 0).long(),
                          h['st'])
        lobed, aux = mat.shade_context(
            t_tab, t_atlas, h['mid'], h['st'], h['eta'], h['trans'],
            ns=h['ns'], tx=h['tx'], ty=h['ty'], tex_modes=gates[0],
            bump=gates[1])
        outs.append({'texel': texel, **{f'lobe_{k}': v for k, v in
                                        lobed.items()},
                     **{f'aux_{k}': v for k, v in aux.items()}})
    assert gates == (tuple(range(7)), True)
    for k, v in outs[0].items():
        g = outs[1][k].cpu()
        if v.dtype in (torch.bool, torch.int64):
            assert torch.equal(g, v), k
        else:
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


def _fetch_case(case, dev):
    """(atlas, tid, uv) of one fetch case on dev: ids with -1 and -5, both
    filters and an inverted map; uvs outside [0, 1) and on texel edges."""
    rs = np.random.RandomState(31)
    b = tex.TextureTableBuilder()
    if case == 'large_atlas':
        # 4 maps of 1024^2, 67 MB: larger than the 50 MB L2
        for k in range(4):
            b.add(rs.rand(1024, 1024, 4).astype(np.float32),
                  filter=(tex.FILTER_NEAREST if k == 3
                          else tex.FILTER_BILINEAR), invert=k == 2)
    else:
        b.add(rs.rand(9, 13, 4).astype(np.float32))
        b.add(rs.rand(6, 5, 3).astype(np.float32), invert=True)
        b.add(rs.rand(7, 3).astype(np.float32), filter=tex.FILTER_NEAREST)
        b.add(rs.rand(4, 6, 4).astype(np.float32), filter=tex.FILTER_NEAREST,
              invert=True)
        # 1 texel wide, 1 texel high, one texel: the max(W-2, 0) clamp
        b.add(rs.rand(5, 1, 4).astype(np.float32))
        b.add(rs.rand(1, 5, 4).astype(np.float32))
        b.add(rs.rand(1, 1, 4).astype(np.float32))
        b.add(rs.rand(1, 4, 4).astype(np.float32), filter=tex.FILTER_NEAREST)
    atlas = b.build()
    n_tex = len(atlas['off'])
    r = {'slots': 4096, 'bump': 4096, 'edges': 4096, 'thin': 4096,
         'empty_slots': 0, 'empty_bump': 0, 'large_atlas': 65_536}[case]
    shape = (r, 4) if case in ('slots', 'empty_slots', 'large_atlas') else (r,)
    tid = rs.randint(-1, n_tex, shape)
    tid[rs.rand(*shape) < 0.05] = -5
    if case == 'thin':
        tid = np.where(tid >= 0, 4 + tid % 4, tid)
    uv = rs.uniform(-1.5, 2.5, (r, 2)).astype(np.float32)
    if case in ('edges', 'thin'):
        # texel edges and centres of every size in the atlas, whole
        # numbers, and a hair below 0 (s rounds to 1)
        size = np.stack([atlas['w'], atlas['h']])[:, np.maximum(tid, 0)]
        j = rs.randint(-2 * size, 3 * size + 1)
        uv = ((j + 0.5 * rs.randint(0, 2, (2, r))) / size).T
        uv = uv.astype(np.float32)
        uv[::7] = np.round(uv[::7])
        uv[3::11] = -1e-9
    t_atlas = {k: torch.as_tensor(v).to(dev) for k, v in atlas.items()}
    t_uv = torch.as_tensor(uv).to(dev)
    if len(shape) == 2:
        t_uv = t_uv[:, None, :].expand(r, 4, 2)
    return t_atlas, torch.as_tensor(tid).to(dev), t_uv


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['slots', 'bump', 'edges', 'thin',
                                  'empty_slots', 'empty_bump', 'large_atlas'])
def test_fetch_kernel_matches_plain_on_card(cuda, case):
    """The fetch kernel against the plain fetch run on the same card, bit
    for bit: both filters, invert, ids < 0, uvs outside [0, 1) and on
    texel edges, maps 1 texel wide or high, the (R, 4) slots over an
    expanded (R, 2) uv and the (R,) bump shape, empty inputs and an atlas
    larger than L2.  Each non-empty call is one launch; an empty one
    launches nothing."""
    atlas, tid, uv = _fetch_case(case, cuda)
    before = tex.fetch.launches
    got = tex.fetch(atlas, tid, uv)
    ref = tex._fetch(atlas, tid, uv)
    torch.cuda.synchronize()
    assert tex.fetch.launches - before == (1 if tid.numel() else 0)
    assert got.shape == ref.shape == tid.shape + (4,)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got, ref)
    if tid.numel():
        assert bool((got[tid < 0] == 1.0).all())
        assert bool((tid >= 0).any()) and bool((tid < 0).any())


@pytest.mark.cuda
def test_fetch_kernel_stops_on_an_id_past_the_table(cuda):
    """An id past the texture table stops the fetch kernel with a device
    error, as it stops the plain fetch's gather, where it would read
    outside the table.  In a process of its own: the error leaves that
    process's CUDA context unusable."""
    code = ("import torch\n"
            "from yulio_raytracer_tpu_torch.shading import textures as t\n"
            "b = t.TextureTableBuilder()\n"
            "b.add(torch.rand(4, 4, 4).numpy())\n"
            "a = {k: torch.as_tensor(v).cuda() for k, v in b.build().items()}"
            "\n"
            "ok = t.fetch(a, torch.tensor([0, -1], device='cuda'),\n"
            "             torch.zeros(2, 2, device='cuda'))\n"
            "torch.cuda.synchronize()\n"
            "try:\n"
            "    t.fetch(a, torch.tensor([0, 1], device='cuda'),\n"
            "            torch.zeros(2, 2, device='cuda'))\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError as e:\n"
            "    print('stopped', t.fetch.launches, flush=True)\n"
            "else:\n"
            "    print('ran', flush=True)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip() == 'stopped 2', (out.stdout, out.stderr[-2000:])


@pytest.mark.cuda
@pytest.mark.parametrize('preset', list(PROBE_PRESETS))
def test_materials_probe_on_card_matches_cpu(cuda, preset):
    """The materials probe (the cornell box's blocks in one preset; 16^2,
    4 spp, depth 4) through the dense kernels on the card against the
    port's CPU render: >= 40 dB."""
    imgs = []
    for dev in ('cpu', cuda):
        film, _ = renderer.render_frame(
            materials_probe(preset, bs, mat, mesh).commit(device=dev),
            bs.cornell_camera(16, 16), pt.PTParams(max_depth=4), 16, 16,
            spp=4, seed=42)
        imgs.append(accum.resolve(film).cpu().numpy())
    mse = ((imgs[1] - imgs[0]) ** 2).mean()
    assert np.isfinite(imgs[1]).all()
    assert 10 * np.log10(imgs[0].max() ** 2 / max(mse, 1e-20)) >= 40.0


def _hdri_only_scene(tmp_path):
    """sphere_view.ecs's settings and a scene of sphere_mirror.xml's HDRI
    light alone (no geometry: the scene commits 'dense')."""
    from yulio_raytracer_tpu_torch.io import ecs
    assets = os.path.join(os.path.dirname(GOLDEN), 'scenes')
    shutil.copy(os.path.join(assets, 'lines.ppm'), tmp_path)
    xml = tmp_path / 'hdri_only.xml'
    xml.write_text('<?xml version="1.0"?>\n<scene><Group><HDRILight>'
                   '<AffineSpace>1 0 0 0 0 1 0 0 0 0 1 0</AffineSpace>'
                   '<L>2.0 1.5 1.2</L><image>"lines.ppm"</image>'
                   '</HDRILight></Group></scene>\n')
    st, sb = ecs.parse_ecs(os.path.join(assets, 'sphere_view.ecs'))
    ecs.load_scene_file(str(xml), st, sb)
    st.width = st.height = 32
    st.spp, st.depth = 4, 3
    return st, sb


@pytest.mark.cuda
def test_hdri_only_scene_on_card_matches_cpu(cuda, tmp_path):
    """The HDRI light with no geometry (C6) through the mono entry point on
    the card and on the CPU: finite, not black, >= 60 dB."""
    from yulio_raytracer_tpu_torch.api import output
    st, sb = _hdri_only_scene(tmp_path)
    imgs = [output.render_mono(sb.commit(device=dev), st, '', device=dev)[0]
            for dev in ('cpu', cuda)]
    mse = ((imgs[1] - imgs[0]) ** 2).mean()
    assert np.isfinite(imgs[1]).all() and imgs[0].min() > 0.0
    assert 10 * np.log10(imgs[0].max() ** 2 / max(mse, 1e-20)) >= 60.0


@pytest.mark.cuda
def test_collada_strip_faces_on_card_match_cpu(cuda):
    """test_room.dae's 12 faces as StartRT renders them (session.collada_job
    and render_rig_faces; 16^2, 2 spp, depth 2, toe-in, the watermark, the
    billboard committed at the rig) on the card against the port's CPU
    faces: >= 40 dB each."""
    from yulio_raytracer_tpu_torch.api import output, session
    from yulio_raytracer_tpu_torch.film import stereo_strip
    assets = os.path.join(os.path.dirname(GOLDEN), 'scenes')
    st, sb, rigs = session.collada_job(
        os.path.join(assets, 'test_room.dae'),
        session.ParamsRT(size=16, depth=2, spp=2, watermark=True))
    name, cams = rigs[0]
    origin = np.asarray(cams[0].local2world[3])
    faces = [output.render_rig_faces(
        sb.commit(device=dev, view_pos=origin), st, cams, name,
        stereo_strip.load_watermark())[0] for dev in ('cpu', cuda)]
    assert len(faces[1]) == 12
    for a, b in zip(*faces):
        mse = ((b - a) ** 2).mean()
        assert np.isfinite(b).all()
        assert 10 * np.log10(a.max() ** 2 / max(mse, 1e-20)) >= 40.0


def _db(img, ref):
    mse = ((img - ref) ** 2).mean()
    return 10 * np.log10(max(ref.max(), 1e-9) ** 2 / max(mse, 1e-20))


COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['cornell', 'motion', 'colonnade'])
def test_precomputed_sampler_on_card_matches_cpu(cuda, which):
    """sampler='precomputed' on the card against the port's CPU render of
    the same tables (cornell 32^2 through K1/K2, the reduced motion field
    through its time dimension, the reduced colonnade at depth 6 with
    compaction 'on'): >= 60 dB, equal rays; the colonnade's 'off' film
    bit-equal to its 'on' film on the card."""
    sb, cam, depth = {
        'cornell': (bs.cornell_box(), bs.cornell_camera(32, 32), 3),
        'motion': (bs.motion_field(n_spheres=4),
                   bs.motion_field_camera(32, 32), 2),
        'colonnade': (bs.colonnade(**COLONNADE_SMALL),
                      bs.colonnade_camera(32, 32), 6)}[which]
    kw = dict(sampler='precomputed', seed=3, spp=2, pixel_filter='bspline',
              compaction='on')
    params = pt.PTParams(max_depth=depth)
    out = [renderer.render_frame(sb.commit(device=dev, leaf_size=32), cam,
                                 params, 32, 32, **kw)
           for dev in ('cpu', cuda)]
    (ref, rs), (film, st) = out
    assert _db(accum.resolve(film).cpu().numpy(),
               accum.resolve(ref).numpy()) >= 60.0
    assert st.num_rays == rs.num_rays
    if which == 'colonnade':
        scene = sb.commit(device=cuda, leaf_size=32)
        off, _ = renderer.render_frame(scene, cam, params, 32, 32,
                                       **dict(kw, compaction='off'))
        on, _ = renderer.render_frame(scene, cam, params, 32, 32, **kw)
        assert torch.equal(off.rgb_sum, on.rgb_sum)


@pytest.mark.cuda
@pytest.mark.parametrize('quality', ['normal', 'high', 'high-spatial'])
def test_quality_trees_on_card_match_plain(cuda, quality):
    """The reduced colonnade committed at each quality: K3/K4 bit-equal to
    their plain versions on its 64^2 camera rays and their shadow rays to
    the tree's first light, and its render >= 60 dB against the CPU."""
    sb = bs.colonnade(**COLONNADE_SMALL)
    scene = sb.commit(device=cuda, leaf_size=32, quality=quality)
    org, d, _ = raysets.camera_rays(scene, bs.colonnade_camera(64, 64), 64,
                                    64, cuda, 5)
    z = torch.zeros(org.shape[0], device=cuda)
    rays = (org, d, z, torch.full_like(z, float('inf')))
    hit = wide.intersect_packet4(scene.nodes4, scene.tris, *rays)
    ref = wide.intersect_wide_plain(scene.nodes4, scene.tris, *rays)
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)
    p = org + torch.where(hit.valid, hit.t, 0.0)[:, None] * d
    to = scene.lights[0]['v0'].to(cuda) - p
    dist = torch.linalg.norm(to, dim=-1)
    srays = (p, to / dist[:, None], torch.full_like(z, 1e-3),
             torch.where(hit.valid, dist * 0.999, -1.0))
    assert torch.equal(wide.occluded_packet4(scene.nodes4, scene.tris,
                                             *srays),
                       wide.occluded_wide_plain(scene.nodes4, scene.tris,
                                                *srays))
    imgs = [accum.resolve(renderer.render_frame(
        sb.commit(device=dev, leaf_size=32, quality=quality),
        bs.colonnade_camera(24, 24), pt.PTParams(max_depth=3), 24, 24,
        spp=2)[0]).cpu().numpy() for dev in ('cpu', cuda)]
    assert _db(imgs[1], imgs[0]) >= 60.0


@pytest.mark.cuda
def test_pick_and_debug_renderer_on_card_match_cpu(cuda):
    """renderer.pick on a 7 x 7 grid and the debug renderer's 32^2 frame
    (3 rays a pixel, depth 4) on the reduced colonnade: hit flags equal,
    points within 1e-5 of the extent, >= 99% of pixels equal, rays within
    1%."""
    from yulio_raytracer_tpu_torch.integrator import debugrenderer
    sb = bs.colonnade(**COLONNADE_SMALL)
    cpu, card = (sb.commit(device='cpu', leaf_size=32),
                 sb.commit(device=cuda, leaf_size=32))
    cam = bs.colonnade_camera(32, 32)
    extent = float(np.linalg.norm(np.subtract(cpu.bbox_hi, cpu.bbox_lo)))
    for x in np.linspace(-0.2, 1.2, 7):
        for y in np.linspace(-0.2, 1.2, 7):
            (ok, p), (rok, rp) = (renderer.pick(card, cam, x, y),
                                  renderer.pick(cpu, cam, x, y))
            assert ok == rok
            np.testing.assert_allclose(p, rp, rtol=0, atol=1e-5 * extent)
    dp = debugrenderer.DebugParams(max_depth=4, spp=3)
    (img, st), (ref, rst) = (debugrenderer.render(s, cam, dp, 32, 32)
                             for s in (card, cpu))
    assert float((img.cpu() == ref).all(-1).float().mean()) >= 0.99
    assert abs(st.num_rays - rst.num_rays) <= 0.01 * rst.num_rays


@pytest.mark.cuda
def test_progressive_viewer_and_trace_on_card(cuda, tmp_path):
    """On the card: render_progressive stopped after 2 of 4 iterations and
    resumed, bit-equal to an uninterrupted run; the viewer's loop with a
    pick that hits and 'q', its last PNG the tonemapped film; a
    profiling.trace that names the dense kernels and the shade range."""
    from yulio_raytracer_tpu_torch.api import viewer
    from yulio_raytracer_tpu_torch.film import stereo_strip, tonemap
    from yulio_raytracer_tpu_torch.profile_frame import kernel_of
    from yulio_raytracer_tpu_torch.utils import profiling
    scene = bs.cornell_box().commit(device=cuda)
    args = (scene, bs.cornell_camera(32, 32), pt.PTParams(max_depth=3), 32,
            32, 2, 4)
    ckpt = str(tmp_path / 'film.npz')
    calls = []
    _, done = renderer.render_progressive(
        *args, checkpoint_path=ckpt, stop_flag=lambda: calls.append(1)
        or len(calls) > 2)
    film, done_b = renderer.render_progressive(*args, checkpoint_path=ckpt)
    ref = None
    for it in range(4):
        ref, _ = renderer.render_frame(*args[:6], film=ref, iteration=it)
    assert (done, done_b) == (2, 4) and torch.equal(film.rgb_sum, ref.rgb_sum)

    l2w = bs.cornell_camera(32, 32).local2world.numpy().astype(np.float64)
    ctl = viewer.CameraController(pos=l2w[3], lookat=l2w[3] + l2w[2],
                                  up=l2w[1], angle=37.0)
    srv = viewer.ViewerServer(port=0)
    with srv._lock:
        srv._events.append({'type': 'pick', 'x': 0.5, 'y': 0.5})
    publish, n = srv.submit_frame, []

    def submit(img, hud=''):
        publish(img, hud)
        n.append(1)
        with srv._lock:
            srv._events.append({'type': 'key', 'k': 'q'})
    srv.submit_frame = submit
    try:
        film = viewer.interactive_loop(scene, ctl, pt.PTParams(max_depth=2),
                                       32, 32, server=srv, max_frames=5)
        png = srv._frame[1]
    finally:
        srv.close()
    assert len(n) == 1 and not np.allclose(ctl.lookat, l2w[3] + l2w[2])
    np.testing.assert_array_equal(
        stereo_strip.decode_png(png),
        tonemap.to_srgb_u8(tonemap.tonemap(
            accum.resolve(film))).cpu().numpy())

    with profiling.trace(str(tmp_path)) as prof:
        renderer.render_frame(*args[:6])
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    assert pt.SPAN_SHADE in names
    assert {kernel_of(n) for n in names} >= {'intersect_dense_kernel',
                                             'occluded_dense_kernel'}


@pytest.mark.cuda
@pytest.mark.parametrize('compaction', ['off', 'auto'])
def test_tracer_adds_no_sync_on_card(colonnade_card, compaction):
    """A colonnade frame (depth 8 with the dome cap: 'auto' compacts)
    under torch.cuda.set_sync_debug_mode('warn') makes as many
    synchronising calls with the port's tracer on as off, gives the same
    film, and its bounce counts, numbers by its end, add up to
    num_rays."""
    import warnings
    from yulio_raytracer_tpu_torch.utils import profiling
    cam = bs.colonnade_camera(64, 64)
    params = pt.PTParams(max_depth=8, t_max_shadow_ray=12.0)

    def frame():
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out = renderer.render_frame(colonnade_card, cam, params, 64,
                                            64, spp=2, seed=9,
                                            compaction=compaction)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum('synchronizing' in str(w.message) for w in caught)

    frame()                                 # first calls fill the caches
    (f_off, s_off), n_off = frame()
    with profiling.tracing() as t:
        (f_on, s_on), n_on = frame()
    assert n_off > 0 and n_on == n_off
    assert torch.equal(f_off.rgb_sum, f_on.rgb_sum)
    b = [s for s in t.spans() if s.name == profiling.BOUNCE]
    assert len(b) == params.max_depth or b[-1].attrs['live'] == 0
    assert all(type(v) in (int, float) for s in b for v in s.attrs.values())
    assert sum(s.attrs['rays'] + s.attrs['shadow'] for s in b) == \
        s_on.num_rays == s_off.num_rays


# ------------------------------------------------------------ lobe kernels

LOBE_HITS = 65_537


def _unit_rows(gen, n, dev):
    v = torch.randn((n, 3), generator=gen, device=dev)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _lobe_record(case, gen, n, dev):
    """A lobe record of n hits on dev.  'type_<k>': type k in slot 0 on
    every hit, a Lambertian in slot 1 on half of them, NONE in the rest,
    the parameters of tests/test_torch_shading.py's cases; 'mixed': every
    type in every slot, a third of the slots NONE.  Then the edges: every
    slot NONE on 1/16 of the hits, a zero color on 1/8 of the slots, eta
    2.5 on 1/8 (total internal reflection at grazing angles)."""
    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    t = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    if case == 'mixed':
        t = torch.randint(1, lb.NUM_LOBE_TYPES, (n, 4), generator=gen,
                          device=dev)
        t[uni(0, 1, n, 4) < 1 / 3] = lb.NONE
        k = None
    else:
        k = int(case.split('_')[1])
        t[:, 0] = k
        t[: n // 2, 1] = lb.LAMBERTIAN
    color = uni(0.05, 1.0, n, 4, 3)
    eta = uni(0.4, 2.5, n, 4)
    exp = uni(0.0, 200.0, n, 4)
    aniso = t == lb.MICROFACET_CONDUCTOR_ANISO
    eta = torch.where(aniso, uni(1.0, 1000.0, n, 4), eta)
    exp = torch.where(aniso, uni(1.0, 1000.0, n, 4), exp)
    exp = torch.where(t == lb.THIN_DIELECTRIC_TRANSMIT, uni(0.0, 0.5, n, 4),
                      exp)
    unlayered = (t == lb.MICROFACET_CONDUCTOR) & (uni(0, 1, n, 4) < 0.25)
    eta = torch.where(unlayered, 1.0, eta)
    t[uni(0, 1, n) < 1 / 16] = lb.NONE
    color[uni(0, 1, n, 4) < 1 / 8] = 0.0
    eta = torch.where(uni(0, 1, n, 4) < 1 / 8, 2.5, eta)
    return {'type': t, 'color': color, 'eta': eta, 'exp': exp,
            'ceta': uni(0.2, 3.0, n, 4, 3), 'ck': uni(0.0, 5.0, n, 4, 3)}


@pytest.fixture(scope='module')
def lobe_scenes():
    """The cells' scenes committed on the card, for their material tables:
    sponza's mattetextured and plastic, test_stereo's MetallicPaint, Uber
    and textured ground, the colonnade's matte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from yulio_raytracer_tpu_torch.io import ecs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    settings, sb = ecs.parse_ecs(os.path.join(root, 'assets', 'scenes',
                                              'test_stereo.ecs'))
    return {'sponza': bs.sponza_like(stories=1, cols_x=2, cols_z=2,
                                     clutter=4, num_textures=3).commit(
                                         leaf_size=32),
            'test_stereo': sb.commit(accel=settings.accel),
            'colonnade': bs.colonnade(cols_x=2, cols_z=2,
                                      tess=(8, 10)).commit(leaf_size=32)}


def _lobe_case(case, request, gen, dev, n=LOBE_HITS):
    """(lobes, ns, ng, wo, tx, ty) of one case: a record of _lobe_record,
    or a scene's shade context (its (R, 4) record over random material
    ids and uvs, with the views into its material rows) at random hits.
    wo lies below ns on a quarter of the hits (cos_o <= 0)."""
    ns = _unit_rows(gen, n, dev)
    ng = ns + 0.3 * _unit_rows(gen, n, dev)
    ng = ng / torch.linalg.norm(ng, dim=-1, keepdim=True)
    wo = _unit_rows(gen, n, dev)
    up = torch.sign(torch.sum(wo * ns, dim=-1, keepdim=True))
    wo = torch.where(torch.arange(n, device=dev)[:, None] % 4 != 0,
                     wo * up, wo)
    tx = torch.linalg.cross(ns, _unit_rows(gen, n, dev))
    tx = tx / torch.linalg.norm(tx, dim=-1, keepdim=True)
    ty = torch.linalg.cross(ns, tx)
    if case in ('sponza', 'test_stereo', 'colonnade'):
        scene = request.getfixturevalue('lobe_scenes')[case]
        n_mat = scene.materials['mat_tab'].shape[0]
        mid = torch.randint(-1, n_mat, (n,), generator=gen, device=dev)
        st = torch.rand((n, 2), generator=gen, device=dev) * 4 - 1
        lobes, aux = mat.shade_context(
            scene.materials, scene.textures, mid, st,
            torch.ones((n,), device=dev), torch.ones((n, 3), device=dev),
            ns=ns, tx=tx, ty=ty, tex_modes=scene.tex_modes, bump=scene.bump)
        ns = aux.get('ns', ns)
    else:
        lobes = _lobe_record(case, gen, n, dev)
    return lobes, ns, ng, wo, tx, ty


LOBE_CASES = [f'type_{k}' for k in range(lb.NUM_LOBE_TYPES)] + [
    'mixed', 'sponza', 'test_stereo', 'colonnade']


@pytest.mark.cuda
@pytest.mark.parametrize('case', LOBE_CASES)
def test_lobe_kernels_match_plain_on_card(cuda, request, case):
    """The lobe kernels against the plain eval and sample run on the same
    card, bit for bit in every output: each lobe type alone in a slot, a
    mixed record with NONE slots, and the cells' material tables (read
    through the shade context's strided views); 1, 2 and 6 lights; the
    masks DIFFUSE and ALL; the tangent frame given and not; hits with
    cos_o <= 0, total internal reflection, zero-luminance slots, every
    slot dead, and s1 at 0 and a hair below 1.  Each call is one launch,
    and the plain versions count their CUDA calls."""
    gen = torch.Generator(device=cuda).manual_seed(
        7 + LOBE_CASES.index(case))
    lobes, ns, ng, wo, tx, ty = _lobe_case(case, request, gen, cuda)
    n = ns.shape[0]
    for nl in (1, 2, 6):
        wi = torch.stack([_unit_rows(gen, n, cuda) for _ in range(nl)])
        if nl == 1:
            wi = wi[0]
        for mask in (lb.DIFFUSE, lb.ALL):
            launches, plain = lb.eval_lobes.launches, lb._eval_lobes.cuda_calls
            got = lb.eval_lobes(lobes, ns, ng, wo, wi, mask)
            ref = lb._eval_lobes(lobes, ns, ng, wo, wi, mask)
            torch.cuda.synchronize()
            assert lb.eval_lobes.launches == launches + 1
            assert lb._eval_lobes.cuda_calls == plain + 1
            assert got.shape == ref.shape == wi.shape
            assert torch.equal(got, ref), (case, nl, mask, torch.nonzero(
                got != ref)[:4].tolist())
    s2 = torch.rand((n, 2), generator=gen, device=cuda)
    s1 = torch.rand((n,), generator=gen, device=cuda)
    s1[::13] = 0.0
    s1[5::13] = 1.0 - 2.0 ** -24
    for mask in (lb.DIFFUSE, lb.ALL):
        for frame in ((tx, ty), (None, None)):
            launches = lb.sample_lobes.launches
            got = lb.sample_lobes(lobes, ns, ng, wo, s2, s1, mask, *frame)
            ref = lb._sample_lobes(lobes, ns, ng, wo, s2, s1, mask, *frame)
            torch.cuda.synchronize()
            assert lb.sample_lobes.launches == launches + 1
            assert set(got) == set(ref)
            for k, v in ref.items():
                assert got[k].dtype == v.dtype and got[k].shape == v.shape
                assert torch.equal(got[k], v), (case, mask, frame[0] is None,
                                                k, torch.nonzero(
                                                    got[k] != v)[:4].tolist())
            valid = ref['valid']
            if case != 'type_0' and mask == lb.ALL:
                assert float(valid.float().mean()) > 0.2


def _lobe_frames(scene, camera, params, res, spp, monkeypatch, **kw):
    """One frame through the lobe kernels and one through the plain
    versions on the card: (films, stats, the kernels' launches, the plain
    versions' CUDA calls)."""
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(lb, 'eval_lobes', lb._eval_lobes)
            monkeypatch.setattr(lb, 'sample_lobes', lb._sample_lobes)
        before = (lb.eval_lobes.launches if not plain else 0,
                  lb.sample_lobes.launches if not plain else 0,
                  lb._eval_lobes.cuda_calls, lb._sample_lobes.cuda_calls)
        film, stats = renderer.render_frame(scene, camera, params, res, res,
                                            spp=spp, seed=42, **kw)
        torch.cuda.synchronize()
        after = (lb.eval_lobes.launches if not plain else 0,
                 lb.sample_lobes.launches if not plain else 0,
                 lb._eval_lobes.cuda_calls, lb._sample_lobes.cuda_calls)
        out.append((film, stats, [a - b for a, b in zip(after, before)]))
    monkeypatch.undo()
    return out


def _shading_frame(which):
    """(scene, camera, params, res, render_frame kw) of a small frame of a
    shading cell on the card: sponza_like at 64^2 (depth 4) or
    test_stereo's back face at 32^2 (depth 10, the cap 120, the b-spline
    filter, compacted)."""
    if which == 'sponza_64':
        scene = bs.sponza_like().commit(leaf_size=32)
        return (scene, bs.sponza_like_camera(64, 64),
                pt.PTParams(max_depth=4), 64, {})
    from yulio_raytracer_tpu_torch.api import cli
    from yulio_raytracer_tpu_torch.io import ecs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    settings, sb = ecs.parse_ecs(os.path.join(root, 'assets', 'scenes',
                                              'test_stereo.ecs'))
    scene = sb.commit(accel=settings.accel)
    camera = cli.stereo_rigs(settings)[0][1][2]
    params = pt.PTParams(max_depth=10, t_max_shadow_ray=120.0)
    return scene, camera, params, 32, dict(compaction='auto',
                                           pixel_filter='bspline')


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['sponza_64', 'test_stereo_32'])
def test_lobe_kernels_render_the_plain_frame_on_card(cuda, which,
                                                     monkeypatch):
    """A whole frame with the lobe kernels equals the frame with the plain
    eval and sample on the card, bit for bit: sponza_like at 64^2 (4 spp,
    depth 4: mattetextured and plastic) and test_stereo's back face at
    32^2 (4 spp, depth 10, the cap 120, the b-spline filter, compacted:
    MetallicPaint, Uber and the textured ground).  Every eval and sample
    call of the kernels' frame launches its kernel; no plain version runs
    there."""
    scene, camera, params, res, kw = _shading_frame(which)
    (f_k, s_k, n_k), (f_p, s_p, n_p) = _lobe_frames(
        scene, camera, params, res, 4, monkeypatch, **kw)
    assert n_k[0] > 0 and n_k[1] > 0 and n_k[2:] == [0, 0]
    assert n_p[2] > 0 and n_p[3] > 0
    assert s_k.num_rays == s_p.num_rays
    assert torch.equal(f_k.rgb_sum, f_p.rgb_sum)
    assert torch.equal(accum.resolve(f_k), accum.resolve(f_p))


# the RNG's ids at the edges of the u32 mask (0, 2^32 - 1, 2^32, 2^40), a
# negative one, and one whose key of (seed 0, sample 0, dim 0) is
# 0xFFFFFFFF, which converts to exactly 1.0
RNG_EDGES = [0, 2**32 - 1, 2**32, 2**40, -5]
RNG_SEED = 2**31 + 12345


def _unmix(y):
    """The u32 whose lowbias32 mix (core/rng.py _mix) is y."""
    m = 2**32 - 1
    y ^= y >> 16
    y = (y * pow(0x846CA68B, -1, 2**32)) & m
    y ^= (y >> 15) ^ (y >> 30)
    y = (y * pow(0x7FEB352D, -1, 2**32)) & m
    return y ^ (y >> 16)


def _rng_ids(seed, r, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 2**62, (r,), generator=g, dtype=torch.int64)
    ones = (_unmix(2**32 - 1) * pow(0x85EBCA77, -1, 2**32)) % 2**32
    edges = torch.tensor(RNG_EDGES + [ones])[:r]
    x[:edges.numel()] = edges
    return x.to(dev)


# the forms of the port's callers, by kind n (0 the key, n its floats):
# the NEE's light dims of a group (k = 1, 2, 6, 20, and 70, past one
# launch's 64) and the shadow cap's, the scatter's and roulette's int dim,
# the debug renderer's int sample, the b-spline's three dims, uniform3,
# the stratum's scramble, and a lane tensor in every place
RNG_FORMS = {
    'nee_1': (2, lambda p, s: (RNG_SEED, p, s, [24])),
    'nee_2': (2, lambda p, s: (RNG_SEED, p, s, [24, 25])),
    'nee_6': (2, lambda p, s: (RNG_SEED, p, s, list(range(24, 30)))),
    'nee_20': (2, lambda p, s: (RNG_SEED, p, s, list(range(23, 43)))),
    'shadow_6': (1, lambda p, s: (RNG_SEED, p, s, list(range(19, 25)))),
    'shadow_70': (1, lambda p, s: (7, p, s, list(range(3, 73)))),
    'scatter': (2, lambda p, s: (RNG_SEED, p, s, 16)),
    'roulette': (1, lambda p, s: (RNG_SEED, p, s, 18)),
    'debug': (2, lambda p, s: (0, p, 0, 8 + 3)),
    'bspline': (2, lambda p, s: (42, p, s, [0x5F375A86, 0x2545F491,
                                             0x9E3779B9])),
    'uniform3': (3, lambda p, s: (RNG_SEED, p, s, 5)),
    'uniform3_dims': (3, lambda p, s: (RNG_SEED, p, s, [5, 2**32 + 6])),
    'scramble': (0, lambda p, s: (p, 0, RNG_SEED, 0x9E3779B9)),
    'all_lanes': (1, lambda p, s: (p, s, p ^ s, s)),
    'ones': (1, lambda p, s: (0, p, 0, 0)),
}
RNG_PUBLIC = {0: 'hash_u32', 1: 'uniform1', 2: 'uniform2', 3: 'uniform3'}


@pytest.mark.cuda
@pytest.mark.parametrize('r', [1, 1001, 2**23])
@pytest.mark.parametrize('form', sorted(RNG_FORMS))
def test_rng_kernel_matches_plain_on_card(cuda, form, r):
    """F3 against the plain int64 versions run on the same card, bit for
    bit, in dtype, shape and device, on every form of the port's draws
    (RNG_FORMS) at R = 1, an odd R and 2^23 lanes, with ids at 0,
    2^32 - 1, 2^32, 2^40 and below 0 and a seed above 2^31; a key of
    0xFFFFFFFF gives 1.0.  Each call is one launch; the plain versions
    count their CUDA calls."""
    from yulio_raytracer_tpu_torch.core import rng
    n, make = RNG_FORMS[form]
    args = make(_rng_ids(1, r, cuda), _rng_ids(2, r, cuda))
    launches, plain = rng.draw.launches, rng.PLAIN[n].cuda_calls
    got = getattr(rng, RNG_PUBLIC[n])(*args)
    ref = rng.PLAIN[n](*args)
    torch.cuda.synchronize()
    assert rng.draw.launches == launches + 1
    assert rng.PLAIN[n].cuda_calls == plain + 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.device == ref.device == args[1 if n else 0].device
    assert torch.equal(got, ref), (form, r, torch.nonzero(
        got != ref)[:4].tolist())
    if form == 'ones' and r > len(RNG_EDGES):
        assert float(got[len(RNG_EDGES)]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['sponza_64', 'test_stereo_32'])
def test_rng_kernel_renders_the_plain_frame_on_card(cuda, which,
                                                    monkeypatch):
    """A whole frame with F3 equals the frame with every draw forced to
    the plain versions on the card, bit for bit (the frames of
    test_lobe_kernels_render_the_plain_frame_on_card, 4 spp): every draw
    of the kernel's frame launches F3, and the plain frame makes as many
    plain calls."""
    from yulio_raytracer_tpu_torch.core import rng
    scene, camera, params, res, kw = _shading_frame(which)

    def frame():
        return renderer.render_frame(scene, camera, params, res, res, spp=4,
                                     seed=42, **kw)

    def plain_calls():
        return sum(f.cuda_calls for f in rng.PLAIN.values())
    launches, plain = rng.draw.launches, plain_calls()
    f_k, s_k = frame()
    torch.cuda.synchronize()
    drawn = rng.draw.launches - launches
    assert drawn > 0 and plain_calls() == plain
    monkeypatch.setattr(rng, 'draw', lambda n, *args: rng.PLAIN[n](*args))
    f_p, s_p = frame()
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert plain_calls() - plain == drawn
    assert s_k.num_rays == s_p.num_rays
    assert torch.equal(f_k.rgb_sum, f_p.rgb_sum)
    assert torch.equal(accum.resolve(f_k), accum.resolve(f_p))


@pytest.mark.cuda
def test_rng_kernel_first_call_loads_no_module(cuda):
    """With rng.cu built and loaded, the first draws of each form on the
    card import no module, and each is one launch."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "from yulio_raytracer_tpu_torch import renderer\n"
        "from yulio_raytracer_tpu_torch.core import rng\n"
        "rng._lib()\n"
        "p = torch.arange(64, device='cuda')\n"
        "torch.cuda.synchronize()\n"
        "before = set(sys.modules)\n"
        "rng.uniform2(3, p, p, [1, 2, 3])\n"
        "rng.uniform1(3, p, 0, 4)\n"
        "rng.uniform3(3, p, p, 5)\n"
        "rng.hash_u32(p, 0, 3, 0x9E3779B9)\n"
        "torch.cuda.synchronize()\n"
        "print(sorted(set(sys.modules) - before), rng.draw.launches)\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[] 4'
