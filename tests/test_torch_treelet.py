"""The torch port's 'treelet' and 'dense' ray binnings held against the JAX
package: the ray sort key and permutation, the treelet cut and its tile
ranges, the committed treelet tables, the nearest-treelet choice, the
binary kernels started at per-ray roots (K5/K6, plain) against the Pallas
kernels from per-packet roots (interpret mode), the binned closest and
any-hit functions against the JAX ones, their dispatch, and the reduced
colonnade rendered through both binnings.  The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.ops import pallas_pairs as ppp
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import (binning, dense, grid, pairs,
                                           traverse, treelets, wide)
from yulio_raytracer_tpu_torch import raysets, renderer
from yulio_raytracer_tpu_torch.film import accum

from test_torch_grid import (COLONNADE_SMALL, PLAIN, _grid_scene, _record,
                             _render)

torch.set_num_threads(2)
R = ppt.BLOCK          # the reference's packet kernels take 1024s
N_TREELETS = 6         # tests/test_pallas.py test_binned_matches_plain


def _rays(rs, n, scale, dead):
    """n rays from rs: origins scale * N(0, 1), unit directions, tnear
    1e-4, every `dead`-th ray dead (tfar -1)."""
    org = (rs.randn(n, 3) * scale).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::dead] = -1.0
    return org, d, tn, tf


# ------------------------------------------------------------ ray sort

@pytest.mark.parametrize('seg', [False, True])
def test_sort_key_and_permutation_match_jax(seg):
    """ray_sort_key equals _ray_sort_key, and sorted_call traces in the
    permutation _sorted_call does (each ray's rank in the sorted order,
    unsorted, equal), with dead rays and with a segment id."""
    rs = np.random.RandomState(11)
    n = 3000
    org, d, tn, tf = _rays(rs, n, 2.0, 7)
    org[::5] = org[1::5]              # equal keys: the sort must be stable
    d[::5] = d[1::5]
    lo, hi = (-3.0, -2.0, -3.5), (3.0, 2.5, 3.0)
    segs = rs.randint(0, 4, n).astype(np.int32)
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    tr = tuple(torch.as_tensor(x) for x in (org, d, tn, tf))
    np.testing.assert_array_equal(
        binning.ray_sort_key(tr[0], tr[1], lo, hi).numpy(),
        np.asarray(ppt._ray_sort_key(jr[0], jr[1], jnp.asarray(lo),
                                     jnp.asarray(hi))).astype(np.int64))
    rank = np.asarray(ppt._sorted_call(
        lambda o, *_: jnp.arange(o.shape[0], dtype=jnp.int32), 1, *jr, lo,
        hi, seg=jnp.asarray(segs) if seg else None))
    got = binning.sorted_call(
        lambda o, *_: torch.arange(o.shape[0], dtype=torch.int32), *tr, lo,
        hi, seg=torch.as_tensor(segs) if seg else None)
    np.testing.assert_array_equal(got.numpy(), rank)
    perm = binning.sort_perm(*tr, lo, hi,
                             seg=torch.as_tensor(segs) if seg else None)
    assert (tf[perm.numpy()][-len(tf[::7]):] == -1.0).all()   # dead last


# ------------------------------------------------------------- tables

def test_treelet_tables_match_on_reduced_colonnade():
    """treelet_cut (64 treelets) and treelet_tri_tiles on the reduced
    colonnade's binary rows, and a commit's treelet tables with the pair
    rows, equal the JAX functions' and the reference commit's packet."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    nodes = sc.nodes.numpy()
    np.testing.assert_array_equal(nodes, np.asarray(js.packet['nodes']))
    roots, boxes = treelets.treelet_cut(nodes, treelets.MAX_TREELETS)
    jroots, jboxes = ppt.treelet_cut(nodes, max_treelets=64)
    assert len(roots) == 64
    np.testing.assert_array_equal(roots, jroots)
    np.testing.assert_array_equal(boxes, jboxes)
    for got, ref in zip(treelets.treelet_tri_tiles(nodes, roots),
                        ppt.treelet_tri_tiles(nodes, jroots)):
        np.testing.assert_array_equal(got, ref)
    assert set(sc.treelets) == {'treelet_roots', 'treelet_boxes',
                                'planes_rows', 'treelet_tile_lo',
                                'treelet_tile_hi'}
    for k, v in sc.treelets.items():
        ref = np.asarray(js.packet[k])
        assert v.numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)


@pytest.fixture(scope='module')
def binned_setup():
    """test_pallas.py's binned scene (two spheres over a floor, leaf 8;
    the commit's tree) in both packages, cut into 6 treelets, with its
    pair rows and tile ranges, and its rays (RandomState(5), 2048 rays,
    every fifth dead; tfar 3 for the any-hit calls)."""
    jhost, jwoop, jtree = _grid_scene(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = _grid_scene(mesh, bvh, primitives)
    nodes = traverse.pack_nodes(tree)
    np.testing.assert_array_equal(nodes, ppt.pack_nodes(jtree))
    roots, boxes = treelets.treelet_cut(nodes, N_TREELETS)
    tgs, tge = treelets.treelet_tri_tiles(nodes, roots)
    jplanes, jrows = ppp.pack_planes(jwoop, jhost)
    rays = _rays(np.random.RandomState(5), 2 * R, 2.0, 5)
    tfo = np.where(rays[3] < 0, -1.0, 3.0).astype(np.float32)
    return dict(
        jnodes=jnp.asarray(nodes), jtris=jnp.asarray(ppt.pack_tris(jwoop,
                                                                   jhost)),
        jplanes=jnp.asarray(jplanes), jrows=jnp.asarray(jrows),
        jroots=jnp.asarray(roots), jboxes=jnp.asarray(boxes),
        jtiles=(jnp.asarray(tgs), jnp.asarray(tge)),
        nodes=torch.as_tensor(nodes),
        tris=torch.as_tensor(wide.pack_tris(woop, host)),
        rows=torch.as_tensor(pairs.pack_planes(woop, host)[1]),
        roots=torch.as_tensor(roots), boxes=torch.as_tensor(boxes),
        tiles=(torch.as_tensor(tgs), torch.as_tensor(tge)),
        rays=rays, tfo=tfo,
        bb=(tuple(np.asarray(jhost['v0']).min(axis=0).tolist()),
            tuple(np.asarray(jhost['v0']).max(axis=0).tolist())))


@pytest.mark.parametrize('step', [1, 4, 6])
def test_treelet_assign_matches_jax(binned_setup, monkeypatch, step):
    """treelet_assign and mark_processed over three rounds choose the
    JAX functions' treelet for every ray, `step` treelets at a time."""
    s = binned_setup
    monkeypatch.setattr(treelets, '_ASSIGN_ELEMS', step * 2 * R)
    jr = tuple(jnp.asarray(x) for x in s['rays'])
    tr = tuple(torch.as_tensor(x) for x in s['rays'])
    jproc = jnp.zeros((2 * R, 1), jnp.uint32)
    proc = treelets.no_treelets_visited(2 * R, N_TREELETS, 'cpu')
    for _ in range(3):
        jsel, jhas = ppt._treelet_assign(s['jboxes'], *jr, jproc)
        sel, has = treelets.treelet_assign(s['boxes'], *tr, proc)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(has.numpy(), np.asarray(jhas))
        assert has.any()
        jproc = ppt._mark_processed(jproc, jsel, jhas)
        proc = treelets.mark_processed(proc, sel, has)
        np.testing.assert_array_equal(proc.numpy(),
                                      np.asarray(jproc).astype(np.int64))


# ------------------------------------------------ rooted K5/K6, plain

def test_rooted_plain_binary_matches_pallas(binned_setup):
    """The plain K5/K6 with a per-ray start node against the Pallas
    kernels with one root per 1024-ray packet: each ray carries its
    packet's root (a random treelet root, the whole tree among them)."""
    s = binned_setup
    rs = np.random.RandomState(2)
    proots = s['roots'].numpy()[rs.randint(0, N_TREELETS, 2)].astype(np.int32)
    proots[0] = 0
    org, d, tn, tf = s['rays']
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    tr = tuple(torch.as_tensor(x) for x in (org, d, tn, tf))
    roots = torch.as_tensor(np.repeat(proots, R))
    ref = ppt.intersect_packet(s['jnodes'], s['jtris'], *jr,
                               roots=jnp.asarray(proots), max_leaf=8,
                               interpret=True)
    got = traverse.intersect_packet(s['nodes'], s['tris'], *tr, roots)
    _assert_binned_hits(got, ref)
    assert (got.tri.numpy()[R:] >= 0).mean() < (got.tri.numpy()[:R] >= 0
                                                ).mean()
    jtfo, tfo = jnp.asarray(s['tfo']), torch.as_tensor(s['tfo'])
    occ_ref = ppt.occluded_packet(s['jnodes'], s['jtris'], *jr[:3], jtfo,
                                  roots=jnp.asarray(proots), max_leaf=8,
                                  interpret=True)
    occ = traverse.occluded_packet(s['nodes'], s['tris'], *tr[:3], tfo, roots)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def _assert_binned_hits(got, ref, u_tol=None):
    """tri equal, t within 1e-5 (inf on both sides for misses) and, with
    u_tol, u and v within it on the hits."""
    tri0 = np.asarray(ref.tri)
    np.testing.assert_array_equal(got.tri.numpy(), tri0)
    t0, t1 = np.asarray(ref.t), got.t.numpy()
    np.testing.assert_array_equal(np.isfinite(t1), np.isfinite(t0))
    hit = tri0 >= 0
    np.testing.assert_allclose(t1[hit], t0[hit], atol=1e-5, rtol=0)
    if u_tol is not None:
        for a, b in ((got.u, ref.u), (got.v, ref.v)):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                       atol=u_tol)


# ------------------------------------------- binned closest / any hit

@pytest.mark.parametrize('rounds', [0, 2])
@pytest.mark.parametrize('how', ['treelet', 'dense'])
def test_binned_match_jax_and_binary(binned_setup, how, rounds):
    """intersect/occluded_packet_binned ('treelet') and
    intersect/occluded_dense_binned ('dense', 16-ray JAX blocks: rt=2)
    against the JAX functions and the port's plain K5/K6."""
    s = binned_setup
    jr = tuple(jnp.asarray(x) for x in s['rays'])
    tr = tuple(torch.as_tensor(x) for x in s['rays'])
    jtfo, tfo = jnp.asarray(s['tfo']), torch.as_tensor(s['tfo'])
    jkw = dict(max_leaf=8, interpret=True, rounds=rounds)
    if how == 'treelet':
        ref = ppt.intersect_packet_binned(s['jnodes'], s['jtris'], s['jroots'],
                                          s['jboxes'], *jr, *s['bb'], **jkw)
        got = treelets.intersect_packet_binned(
            s['nodes'], s['tris'], s['roots'], s['boxes'], *tr, rounds=rounds)
        occ_ref = ppt.occluded_packet_binned(
            s['jnodes'], s['jtris'], s['jroots'], s['jboxes'], *jr[:3], jtfo,
            *s['bb'], **jkw)
        occ = treelets.occluded_packet_binned(
            s['nodes'], s['tris'], s['roots'], s['boxes'], *tr[:3], tfo,
            rounds=rounds)
    else:
        ref = ppt.intersect_dense_binned(
            s['jnodes'], s['jtris'], s['jplanes'], s['jrows'], s['jboxes'],
            *s['jtiles'], *jr, *s['bb'], rt=2, **jkw)
        got = treelets.intersect_dense_binned(
            s['nodes'], s['tris'], s['rows'], s['boxes'], *s['tiles'], *tr,
            rounds=rounds)
        occ_ref = ppt.occluded_dense_binned(
            s['jnodes'], s['jtris'], s['jplanes'], s['jboxes'], *s['jtiles'],
            *jr[:3], jtfo, *s['bb'], rt=2, **jkw)
        occ = treelets.occluded_dense_binned(
            s['nodes'], s['tris'], s['rows'], s['boxes'], *s['tiles'],
            *tr[:3], tfo, rounds=rounds)
    assert (got.tri.numpy() >= 0).any()
    _assert_binned_hits(got, ref, u_tol=1e-4)
    _assert_binned_hits(got, traverse.intersect_binary_plain(
        s['nodes'], s['tris'], *tr), u_tol=1e-4)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    np.testing.assert_array_equal(occ.numpy(), traverse.occluded_binary_plain(
        s['nodes'], s['tris'], *tr[:3], tfo).numpy())
    assert occ.numpy().any() and not occ.numpy()[::5].any()


# ------------------------------------------------------------- dispatch

_BINNED = tuple((treelets, f'{kind}_{how}_binned')
                for kind in ('intersect', 'occluded')
                for how in ('packet', 'dense'))


@pytest.mark.parametrize('binning_', ['treelet', 'dense'])
@pytest.mark.parametrize('which', ['colonnade', 'cornell', 'motion'])
def test_binned_dispatch(monkeypatch, which, binning_):
    """With ray_binning 'treelet' or 'dense' the reduced colonnade runs
    BVH4 on bounce 0 and the binned calls on bounce 1; cornell (dense)
    runs the dense kernels and a motion scene the motion kernel's closest
    and any-hit forms on every bounce: neither takes a binning."""
    calls = []
    for mod, name in _BINNED + (
            (grid, 'intersect_grid'), (grid, 'occluded_grid'),
            (wide, 'intersect_packet4'), (wide, 'occluded_packet4'),
            (dense, 'intersect_dense'), (dense, 'occluded_dense'),
            (traverse, 'intersect_packet_mb'),
            (traverse, 'occluded_packet_mb')):
        _record(monkeypatch, calls, mod, name)
    if which == 'colonnade':
        sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                    leaf_size=32)
        _render(sc, bs.colonnade_camera(8, 8), 8, 2, binning_)
        name = 'packet' if binning_ == 'treelet' else 'dense'
        assert calls == ['intersect_packet4', 'occluded_packet4',
                         f'intersect_{name}_binned',
                         f'occluded_{name}_binned']
    elif which == 'cornell':
        sc = bs.cornell_box().commit(device='cpu')
        assert sc.treelets is None
        _render(sc, bs.cornell_camera(8, 8), 8, 2, binning_)
        assert calls == ['intersect_dense', 'occluded_dense'] * 2
    else:
        sc = bs.motion_field(n_spheres=4).commit(device='cpu', force_bvh=True)
        assert sc.accel == 'bvh4mb' and sc.treelets is None
        _render(sc, bs.motion_field_camera(8, 8), 8, 2, binning_)
        assert calls == ['intersect_packet_mb', 'occluded_packet_mb'] * 2


# ----------------------------------------------------------- whole slice

def test_frame_pair_calls_record_the_dense_rounds():
    """raysets.frame_pair_calls on the reduced colonnade through 'dense':
    bounce 1's 2 K8 and 2 K9 calls over the treelets' rows, round 1 over
    the tiles of each ray's first treelet choice; the rounds run again on
    the recorded round-1 rays make the same calls, and the plain versions
    reproduce every call's results."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    tl = sc.treelets
    tables = (tl['planes_rows'], tl['treelet_boxes'], tl['treelet_tile_lo'],
              tl['treelet_tile_hi'])
    calls = raysets.frame_pair_calls(sc, bs.colonnade_camera(16, 16),
                                     'dense', 16, 16)
    assert [c['kernel'] for c in calls] == (['intersect_pairs_raw'] * 2
                                            + ['occluded_pairs'] * 2)
    k8, k9 = calls[0]['args'], calls[2]['args']
    for args in (k8, k9):
        assert args[0] is tl['planes_rows']
        sel, has = treelets.treelet_assign(
            tl['treelet_boxes'], *args[1:5], treelets.no_treelets_visited(
                args[1].shape[0], tl['treelet_boxes'].shape[0], 'cpu'))
        assert bool(has.any()) and not bool((args[4][~has] >= 0).any())
        for got, ref in zip(args[5:], treelets._tiles(*tables[2:], sel)):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
    with raysets.recorded_pair_calls() as again:
        treelets.intersect_dense_binned(sc.nodes, sc.tris, *tables, *k8[1:5])
        treelets.occluded_dense_binned(sc.nodes, sc.tris, *tables, *k9[1:5])
    assert len(again) == len(calls)
    for rec, rerun in zip(calls, again):
        assert rec['kernel'] == rerun['kernel']
        for a, b in zip(rec['args'], rerun['args']):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        out = PLAIN[rec['kernel']](*rec['args'])
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (out, rec['out']))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope='module')
def colonnade_refs():
    """The reduced colonnade (32^2, 2 spp, depth 3, seed 42): the port's
    scene, the JAX package's CPU render (its BVH on the CPU, whatever the
    binning) and the port's own BVH4 render."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    jfilm, jstats = jrenderer.render_frame(
        js, jbs.colonnade_camera(32, 32),
        jpt.PTParams(max_depth=3, ray_binning='treelet'), 32, 32, spp=2,
        seed=42)
    film4, stats4 = renderer.render_frame(
        sc, bs.colonnade_camera(32, 32), pt.PTParams(max_depth=3), 32, 32,
        spp=2, seed=42)
    return sc, (np.asarray(jaccum.resolve(jfilm)), jstats.num_rays), (
        accum.resolve(film4).numpy(), stats4.num_rays)


@pytest.mark.parametrize('binning_', ['treelet', 'dense'])
def test_colonnade_binned_matches_jax_render_and_bvh4(colonnade_refs,
                                                      binning_):
    """The reduced colonnade through ray_binning 'treelet' and 'dense' at
    >= 60 dB against the JAX CPU render with the same params and the
    port's own BVH4 render, with the same ray count."""
    sc, (ref, jrays), (img4, rays4) = colonnade_refs
    film, stats = renderer.render_frame(
        sc, bs.colonnade_camera(32, 32),
        pt.PTParams(max_depth=3, ray_binning=binning_), 32, 32, spp=2,
        seed=42)
    img = accum.resolve(film).numpy()
    for other in (ref, img4):
        mse = ((img - other) ** 2).mean()
        assert 10 * np.log10(other.max() ** 2 / max(mse, 1e-20)) >= 60.0
    assert stats.num_rays == jrays == rays4
