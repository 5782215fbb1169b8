"""The torch port's uniform-grid path held against the JAX package: the
pair tables and the grid, the plain pair kernels (K8/K9) and the plain
grid march (K10) against the Pallas kernels (interpret mode, as the JAX
package's own tests run them), the grid rounds against the JAX rounds and
the port's binary BVH traversal, the dispatch of ray_binning='grid', the
reduced colonnade rendered through the grid, and commit's default device.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu.ops import grid as gridm
from yulio_raytracer_tpu.ops import pallas_pairs as ppp
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.ops import dense, traverse, wide
from yulio_raytracer_tpu_torch.ops import grid, pairs
from yulio_raytracer_tpu_torch.ops.pairs import TL
from yulio_raytracer_tpu_torch import raysets, renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.film import accum

from test_torch_ops import build_tables

torch.set_num_threads(2)
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))
R = ppt.BLOCK          # the reference's packet kernels take 1024s
R_ODD = 1000           # the port takes any count


PLAIN = {'intersect_pairs_raw': pairs.intersect_pairs_raw_plain,
         'occluded_pairs': pairs.occluded_pairs_plain}


def _grid_scene(m, b, p, **tree_kw):
    """(host, woop, tree) of tests/test_pallas.py test_grid_matches_plain's
    scene (two spheres over a floor, leaf 8), with a commit's tree."""
    packed = m.pack_meshes([
        p.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        p.tessellate_sphere([3, 0, 0], 0.7, 10, 12),
        p.quad([-6, -1.2, -6], [6, -1.2, -6], [6, -1.2, 6], [-6, -1.2, 6])],
        pad_multiple=64)
    tree = b.build(packed.v0, packed.e1, packed.e2, packed.valid,
                   leaf_size=8, **tree_kw)
    host = b.permute_geom({k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id', 'cull',
        'illum_mask', 'shadow_mask', 'valid')}, tree.order)
    woop = m.woop_matrices(host['v0'], host['e1'], host['e2'], host['valid'])
    return host, woop, tree


def _assert_grids_equal(got, ref):
    assert got.keys() == set(ref.keys())
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


# ---------------------------------------------------------------- tables

def test_tables_match_on_pallas_scenes():
    """pack_planes on the pair test's scene (tests/test_pallas.py
    test_pairs_matches_brute's, which build_tables makes) and build_grid
    (res 4) on the grid test's scene equal the JAX functions'."""
    jhost, jwoop, _ = build_tables(jmesh, jbvh, jprim, quality='high')
    host, woop, _ = build_tables(mesh, bvh, primitives)
    for got, ref in zip(pairs.pack_planes(woop, host),
                        ppp.pack_planes(jwoop, jhost)):
        np.testing.assert_array_equal(got, ref)
    jhost, jwoop, _ = _grid_scene(jmesh, jbvh, jprim, quality='high')
    host, woop, _ = _grid_scene(mesh, bvh, primitives)
    jhost = dict(jhost, woop=np.asarray(jwoop))
    _assert_grids_equal(grid.build_grid(woop, host, res=4),
                        gridm.build_grid(jhost, res=4))


def test_grid_matches_on_reduced_colonnade():
    """The res-8 grid of the reduced colonnade's committed geometry equals
    the JAX build_grid's, and a commit keeps the grid and the binary rows
    beside the BVH4 rows (test_torch_scene holds the whole commit against
    the JAX commit)."""
    jpk = jmesh.pack_meshes(jbs.colonnade(**COLONNADE_SMALL).meshes)
    pk = mesh.pack_meshes(bs.colonnade(**COLONNADE_SMALL).meshes)
    jtree = jbvh.build(jpk.v0, jpk.e1, jpk.e2, jpk.valid, leaf_size=32,
                       quality='high')
    tree = bvh.build(pk.v0, pk.e1, pk.e2, pk.valid, leaf_size=32)
    jhost = jbvh.permute_geom({k: getattr(jpk, k) for k in jbvh._PER_TRIANGLE_KEYS
                               if getattr(jpk, k) is not None}, jtree.order)
    host = bvh.permute_geom({k: getattr(pk, k) for k in bvh.PER_TRIANGLE_KEYS
                             if getattr(pk, k) is not None}, tree.order)
    jhost['woop'] = jmesh.woop_matrices(jhost['v0'], jhost['e1'],
                                        jhost['e2'], jhost['valid'])
    woop = mesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                              host['valid'])
    ours = grid.build_grid(woop, host, res=grid.GRID_RES)
    _assert_grids_equal(ours, gridm.build_grid(jhost, res=8))
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    assert sc.accel == 'bvh4' and sc.nodes is not None
    assert sc.grid.keys() == set(grid.GRID_KEYS)
    for k in grid.GRID_KEYS:
        np.testing.assert_array_equal(sc.grid[k].numpy(), ours[k])


# ------------------------------------------------------ K8 / K9, plain

@pytest.fixture(scope='module')
def pair_setup():
    """The JAX and port rows of the pair test's scene and its rays
    (RandomState(3), 128 rays, every fifth dead), with random per-block
    tile ranges (16-ray blocks: rt=2) and their per-ray expansion."""
    jhost, jwoop, _ = build_tables(jmesh, jbvh, jprim, quality='high')
    planes, rows = ppp.pack_planes(jwoop, jhost)
    rs = np.random.RandomState(3)
    n = 128
    org = (rs.randn(n, 3) * 3).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-4, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    tf[::5] = -1.0
    gt = planes.shape[0]
    gs = rs.randint(0, gt, n // 16).astype(np.int32)
    ge = (gs + rs.randint(0, gt + 1, n // 16)).clip(max=gt).astype(np.int32)
    host, woop, _ = build_tables(mesh, bvh, primitives)
    return dict(jplanes=jnp.asarray(planes), jrows=jnp.asarray(rows),
                rows=torch.as_tensor(pairs.pack_planes(woop, host)[1]),
                rays=(org, d, tn, tf), ranges=(gs, ge))


@pytest.mark.parametrize('ranged', [False, True])
@pytest.mark.parametrize('n', [128, 100])
def test_plain_pairs_match_pallas(pair_setup, ranged, n):
    """Plain K8 (with u/v rebuilt) and K9 against the Pallas kernels over
    the whole table and over per-ray ranges (the JAX per-block ranges
    expanded), with the dead-lane case; the lane-major tie rule makes
    even ties agree."""
    s = pair_setup
    org, d, tn, tf = s['rays']
    jkw, kw = {}, {}
    if ranged:
        gs, ge = s['ranges']
        jkw = dict(gs=jnp.asarray(gs), ge=jnp.asarray(ge))
        kw = dict(gs=torch.as_tensor(np.repeat(gs, 16)[:n]),
                  ge=torch.as_tensor(np.repeat(ge, 16)[:n]))
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    tr = tuple(torch.as_tensor(x[:n]) for x in (org, d, tn, tf))
    ref = ppp.intersect_pairs(s['jplanes'], s['jrows'], *jr, rt=2, kb=2,
                              interpret=True, **jkw)
    got = pairs.intersect_pairs(s['rows'], *tr, **kw)
    tri0 = np.asarray(ref.tri)[:n]
    np.testing.assert_array_equal(got.tri.numpy(), tri0)
    hit = tri0 >= 0
    assert hit.any()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[:n][hit],
                               rtol=1e-6, atol=1e-7)
    assert np.isinf(got.t.numpy()[~hit]).all()
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[:n][hit],
                                   atol=1e-5)
    tfo = np.full_like(tf, 3.0)
    tfo[::5] = -1.0
    occ_ref = ppp.occluded_pairs(s['jplanes'], *jr[:3], jnp.asarray(tfo),
                                 rt=2, kb=2, interpret=True, **jkw)
    occ = pairs.occluded_pairs(s['rows'], *tr[:3],
                               torch.as_tensor(tfo[:n]), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])
    assert not occ.numpy()[::5].any()


def test_plain_pairs_wrappers_check_their_arguments(pair_setup):
    rays = (torch.empty((R, 3), device='meta'),) * 2 + (
        torch.empty((R,), device='meta'),) * 2
    rows = pair_setup['rows'].to('meta')
    with pytest.raises(ValueError, match='together'):
        pairs.intersect_pairs_raw(rows, *rays,
                                  gs=torch.zeros(R, dtype=torch.int32,
                                                 device='meta'))
    with pytest.raises(ValueError, match='whole tiles'):
        pairs.occluded_pairs(rows[:100], *rays)


# ------------------------------------------------ grid rounds and march

@pytest.fixture(scope='module')
def grid_setup():
    """The grid test's scene at res 4 in both packages, its rays
    (RandomState(5), 1024 rays, every fifth dead) and the JAX results,
    computed once per round count."""
    jhost, jwoop, jtree = _grid_scene(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = _grid_scene(mesh, bvh, primitives)
    jgrid = gridm.build_grid(dict(jhost, woop=np.asarray(jwoop)), res=4)
    rs = np.random.RandomState(5)
    org = (rs.randn(R, 3) * 2).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((R,), 1e-4, np.float32)
    tf = np.full((R,), np.inf, np.float32)
    tf[::5] = -1.0
    tfo = np.full((R,), 3.0, np.float32)
    tfo[::5] = -1.0
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    bb_lo = tuple(np.asarray(jhost['v0']).min(axis=0).tolist())
    bb_hi = tuple(np.asarray(jhost['v0']).max(axis=0).tolist())
    jnodes = jnp.asarray(ppt.pack_nodes(jtree))
    jtris = jnp.asarray(ppt.pack_tris(jwoop, jhost))
    jkw = dict(res=4, rt=2, max_leaf=8, interpret=True)
    cache = {}

    def jax_grid(rounds):
        if rounds not in cache:
            cache[rounds] = (
                gridm.intersect_grid(jgrid, jnodes, jtris, *jr, bb_lo, bb_hi,
                                     rounds=rounds, **jkw),
                gridm.occluded_grid(jgrid, jnodes, jtris, *jr[:3],
                                    jnp.asarray(tfo), bb_lo, bb_hi,
                                    rounds=rounds, **jkw))
        return cache[rounds]

    tgrid = {k: torch.as_tensor(v) for k, v in
             grid.build_grid(woop, host, res=4).items()}
    return dict(jgrid=jgrid, jr=jr, bb=(bb_lo, bb_hi), jax_grid=jax_grid,
                grid=tgrid, rays=(org, d, tn, tf), tfo=tfo,
                exact_of=lambda i, tri: _exact_t(host, org[i], d[i], tri),
                nodes=torch.as_tensor(traverse.pack_nodes(tree)),
                tris=torch.as_tensor(wide.pack_tris(woop, host)))


def _exact_t(host, org, d, tri):
    """Float64 distance along each ray to the plane of its triangle."""
    v0, e1, e2 = (np.asarray(host[k], np.float64)[tri]
                  for k in ('v0', 'e1', 'e2'))
    ng = np.cross(e1, e2)
    o, d = np.asarray(org, np.float64), np.asarray(d, np.float64)
    return ((v0 - o) * ng).sum(1) / (d * ng).sum(1)


def _assert_hits_close(got, ref, n, exact_of=None):
    """Hit masks equal, tri equal on >= 99.9% of rays (ties), t within
    1e-6 relative where tri agrees.  With exact_of ((rays, tri) ->
    float64 distances), a ray outside 1e-6 passes only if the port's t
    is the nearer of the two to the exact distance: XLA's CPU backend
    contracts the Woop dot products into fused multiply-adds, so the JAX
    t of a ray whose owp cancels strongly can be a few ulps of that
    cancellation off (2.1e-6 relative on one ray of this setup, which
    fused multiply-adds reproduce; the port's t is four times nearer the
    exact distance)."""
    t0, tri0 = np.asarray(ref.t)[:n], np.asarray(ref.tri)[:n]
    t1, tri1 = got.t.numpy(), got.tri.numpy()
    np.testing.assert_array_equal(tri1 >= 0, tri0 >= 0)
    assert (tri1 == tri0).mean() >= 0.999
    same = (tri1 == tri0) & (tri0 >= 0)
    far = same & ~np.isclose(t1, t0, rtol=1e-6, atol=0)
    if exact_of is not None and far.any():
        ex = exact_of(np.nonzero(far)[0], tri1[far])
        assert (np.abs(t1[far] - ex) <= np.abs(t0[far] - ex)).all()
        same &= ~far
    np.testing.assert_allclose(t1[same], t0[same], rtol=1e-6, atol=0)
    assert np.isinf(t1[tri1 < 0]).all()


@pytest.mark.parametrize('rounds,n', [(0, R), (3, R), (8, R), (8, R_ODD)])
def test_grid_rounds_match_jax_and_binary(grid_setup, rounds, n):
    """intersect_grid / occluded_grid at `rounds` DDA rounds against the
    JAX rounds and against the port's binary BVH traversal."""
    s = grid_setup
    tr = tuple(torch.as_tensor(x[:n]) for x in s['rays'])
    tfo = torch.as_tensor(s['tfo'][:n])
    jhit, jocc = s['jax_grid'](rounds)
    got = grid.intersect_grid(s['grid'], s['nodes'], s['tris'], *tr, res=4,
                              rounds=rounds)
    assert (got.tri.numpy() >= 0).any()
    _assert_hits_close(got, jhit, n, s['exact_of'])
    _assert_hits_close(got, traverse.intersect_binary_plain(
        s['nodes'], s['tris'], *tr), n)
    hit = got.tri.numpy() >= 0
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(jhit.u)[:n][hit],
                               atol=1e-5)
    occ = grid.occluded_grid(s['grid'], s['nodes'], s['tris'], *tr[:3], tfo,
                             res=4, rounds=rounds)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc)[:n])
    np.testing.assert_array_equal(occ.numpy(), traverse.occluded_binary_plain(
        s['nodes'], s['tris'], *tr[:3], tfo).numpy())


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_march_matches_jax_and_binary(grid_setup, n):
    """The plain grid march (K10) against the JAX march kernel and the
    port's binary BVH traversal; the march has no fallback."""
    s = grid_setup
    tr = tuple(torch.as_tensor(x[:n]) for x in s['rays'])
    ref = gridm.intersect_march(s['jgrid'], *s['jr'], *s['bb'], res=4, kb=2,
                                interpret=True)
    got = grid.intersect_march(s['grid'], *tr, res=4)
    _assert_hits_close(got, ref, n, s['exact_of'])
    _assert_hits_close(got, traverse.intersect_binary_plain(
        s['nodes'], s['tris'], *tr), n)


def test_sorted_march_matches_the_unsorted_plain_march(grid_setup):
    """intersect_march runs the rays sorted by entry cell and origin and
    returns them in the caller's order: bit-equal in t, tri, u and v to
    the plain march of the unsorted rays, with a tail warp (1,000 rays),
    dead rays and rays that miss the grid among them."""
    s = grid_setup
    tr = tuple(torch.as_tensor(x[:R_ODD]) for x in s['rays'])
    key = grid.march_sort_key(s['grid'], *tr, res=4)
    assert (key >> 18 == 4 ** 3).sum() > (tr[3] <= tr[2]).sum() > 0
    assert not torch.equal(torch.argsort(key, stable=True),
                           torch.arange(R_ODD))
    got = grid.intersect_march(s['grid'], *tr, res=4)
    ref = grid._to_hit(s['grid'], *tr[:2],
                       *grid.march_raw_plain(s['grid'], *tr, res=4))
    assert (ref.tri >= 0).any() and (ref.tri < 0).any()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_march_sort_key_is_the_references(grid_setup):
    """march_sort_key equals the key of the reference's _march_sorted,
    built from the JAX _dda_init, _cell_id and _ray_sort_key over the
    grid's box, so the port sorts the rays in the reference's order."""
    s = grid_setup
    jg, (org, d, tn, tf) = s['jgrid'], s['jr']
    ci, _, _, _, _, inside = gridm._dda_init(jg['grid_lo'], jg['grid_hi'], 4,
                                             org, d, tn)
    cid = gridm._cell_id(ci, 4)
    jkey = ppt._ray_sort_key(org, d, jnp.asarray(jg['grid_lo']),
                             jnp.asarray(jg['grid_hi']))
    ref = (jnp.where(inside & (tf > tn), cid.astype(jnp.uint32),
                     jnp.uint32(4 ** 3)) << jnp.uint32(18)) \
        | (jkey & jnp.uint32(0x3FFFF))
    got = grid.march_sort_key(s['grid'], *(torch.as_tensor(x)
                                           for x in s['rays']), res=4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref).astype(np.int64))


def _march_triples(g, org, d, tn, tf, res):
    """The (ray // 32, round, cell) triples of the march kernel's rounds,
    from a numpy float32 DDA in the kernel's constants, each round's
    cells swept by the plain pair sweep (K8's) to retire rays at their
    best hit; also the final (t, slot)."""
    f = np.float32
    org, d, tn, tf = (np.asarray(x, np.float32) for x in (org, d, tn, tf))
    lo = g['grid_lo'].numpy()
    cs = (g['grid_hi'].numpy() - lo) / f(res)
    hi = (lo.astype(np.float64) + res * cs.astype(np.float64)).astype(f)
    inv = f(1) / np.where(np.abs(d) > f(1e-30), d,
                          np.where(d >= 0, f(1e-30), f(-1e-30)))
    t0a, t1a = (lo - org) * inv, (hi - org) * inv
    tmin = np.minimum(t0a, t1a).max(axis=1)
    tmax = np.maximum(t0a, t1a).min(axis=1)
    t0 = np.maximum(tmin, tn)
    live = (t0 <= tmax) & (tf > tn) & (t0 <= tf)
    p = org + d * (t0 + f(1e-6))[:, None]
    ci = np.clip((p - lo) / cs, 0, res - 1).astype(np.int64)
    step = np.where(d >= 0, 1, -1)
    moving = np.abs(d) > f(1e-30)
    tnx = np.where(moving, (lo + (ci + (step > 0)).astype(f) * cs - org)
                   * inv, f(np.inf))
    tdl = np.where(moving, np.abs(cs * inv), f(np.inf))
    best_t = np.full(len(org), np.inf, f)
    best_s = np.full(len(org), -1, np.int32)
    triples, rnd = set(), 0
    while live.any():
        idx = np.nonzero(live)[0]
        cell = (ci[idx, 0] * res + ci[idx, 1]) * res + ci[idx, 2]
        triples |= {(i // 32, rnd, c) for i, c in zip(idx.tolist(),
                                                     cell.tolist())}
        t_s, s_s = pairs.intersect_pairs_raw_plain(
            g['rows'], *(torch.as_tensor(x[idx]) for x in (org, d, tn, tf)),
            g['cell_tile_lo'][cell], g['cell_tile_hi'][cell])
        take = pairs.better(t_s, s_s, torch.as_tensor(best_t[idx]),
                            torch.as_tensor(best_s[idx])).numpy()
        best_t[idx] = np.where(take, t_s.numpy(), best_t[idx])
        best_s[idx] = np.where(take, s_s.numpy(), best_s[idx])
        entry = tnx.min(axis=1)
        a = np.where(tnx[:, 0] <= entry, 0, np.where(tnx[:, 1] <= entry, 1,
                                                     2))
        r = np.arange(len(org))
        ci[r, a] += step[r, a]
        tnx[r, a] += tdl[r, a]
        live &= ((ci[r, a] >= 0) & (ci[r, a] < res)
                 & (entry <= np.minimum(tf, best_t)))
        rnd += 1
    return triples, best_t, best_s


def test_plain_march_counts_the_rows_a_warp_loads(grid_setup):
    """march_raw_plain's 'rows' count is the kernel's loads: each cell's
    rows once for every (warp of 32 consecutive rays, round, cell) of
    the march, counted here from an independent numpy march, whose
    results are the plain march's too."""
    s = grid_setup
    tr = tuple(torch.as_tensor(x[:R_ODD]) for x in s['rays'])
    counts = {}
    t, slot = grid.march_raw_plain(s['grid'], *tr, res=4, counts=counts)
    triples, t_ref, s_ref = _march_triples(
        s['grid'], *(x[:R_ODD] for x in s['rays']), 4)
    np.testing.assert_array_equal(t.numpy(), t_ref)
    np.testing.assert_array_equal(slot.numpy(), s_ref)
    g = s['grid']
    per_cell = (g['cell_tile_hi'] - g['cell_tile_lo']).numpy() * pairs.TL
    assert len({r for _, r, _ in triples}) > 2
    assert int(counts['rows']) == sum(int(per_cell[c])
                                      for _, _, c in triples) > 0


def test_sorted_rays_load_no_more_rows_on_the_reduced_colonnade():
    """On the reduced colonnade's hemisphere rays (from the hits of its
    32^2 camera rays), the rays sorted by march_sort_key load no more
    rows than in call order, with the same pair tests and results."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    dev = torch.device('cpu')
    org, d, _ = raysets.camera_rays(sc, bs.colonnade_camera(32, 32), 32, 32,
                                    dev, 42)
    zeros = torch.zeros(org.shape[0])
    cam = (org, d, zeros, torch.full_like(zeros, float('inf')))
    hit = traverse.intersect_binary_plain(sc.nodes, sc.tris, *cam)
    hemi = raysets.hemisphere_rays(sc, org, d, hit, torch.Generator(
        device=dev).manual_seed(42), dev)[:4]
    perm = torch.argsort(grid.march_sort_key(sc.grid, *hemi), stable=True)
    counts = [{}, {}]
    outs = [grid.march_raw_plain(sc.grid, *rays, counts=c) for rays, c in
            zip((hemi, tuple(x[perm] for x in hemi)), counts)]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a[perm].numpy(), b.numpy())
    assert int(counts[0]['pair']) == int(counts[1]['pair']) > 0
    assert 0 < int(counts[1]['rows']) <= int(counts[0]['rows'])


def test_entry_ranges_are_the_first_round(grid_setup):
    """entry_ranges gives the first round's cells: one K8 sweep over them
    finds the first round's hits."""
    s = grid_setup
    tr = tuple(torch.as_tensor(x) for x in s['rays'])
    gs, ge = grid.entry_ranges(s['grid'], *tr, res=4)
    assert (ge >= gs).all() and (ge > gs).any()
    assert not ((ge > gs) & (tr[3] <= tr[2])).any()   # dead rays: empty
    t, slot = pairs.intersect_pairs_raw(s['grid']['rows'], *tr, gs, ge)
    # one round, and a fallback tree of one empty leaf that finds nothing
    nodes = torch.zeros((1, 8))
    one = grid.intersect_grid(s['grid'], nodes, s['tris'], *tr, res=4,
                              rounds=1)
    np.testing.assert_array_equal(t.numpy(), one.t.numpy())


@pytest.mark.parametrize('ranged', [False, True])
def test_plain_pairs_commute_with_a_ray_permutation(pair_setup, ranged):
    """Permuting the rays (with their ranges) permutes both plain
    versions' outputs exactly, ties included: the pair kernels' binning
    reorders rays and relies on it.  The table starts with a copy of its
    first tile whose lanes are rotated by 64, so every hit there ties at
    a bit-equal t between lanes l + 64 and l of the first two tiles, and
    the later tile's lesser lane wins."""
    s = pair_setup
    rows = s['rows']
    rows = torch.cat([rows[:TL].roll(TL // 2, dims=0), rows])
    n_tiles = rows.shape[0] // TL
    rs = np.random.RandomState(7)
    tr = [torch.as_tensor(x) for x in s['rays']]
    tfo = torch.where(tr[3] < 0, -1.0, 3.0)
    ranges = ()
    if ranged:
        gs = torch.as_tensor(rs.randint(0, n_tiles, len(tfo)),
                             dtype=torch.int32)
        gs[::3] = 0
        ge = torch.clamp(gs + torch.as_tensor(rs.randint(0, n_tiles + 1,
                                                         len(tfo))),
                         max=n_tiles).to(torch.int32)
        ge[::3] = n_tiles
        ranges = (gs, ge)
    perm = torch.as_tensor(rs.permutation(len(tfo)))
    for plain, tf in ((pairs.intersect_pairs_raw_plain, tr[3]),
                      (pairs.occluded_pairs_plain, tfo)):
        args = (*tr[:3], tf, *ranges)
        ref = plain(rows, *args)
        got = plain(rows, *(x[perm] for x in args))
        ref, got = (x if isinstance(x, tuple) else (x,) for x in (ref, got))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b[perm].numpy())
    _, slot = pairs.intersect_pairs_raw_plain(rows, *tr, *ranges)
    assert bool(((slot >= TL) & (slot < TL + TL // 2)).any())  # ties


def test_frame_pair_calls_record_the_grid_rounds():
    """raysets.frame_pair_calls on the reduced colonnade through 'grid':
    bounce 1's 8 K8 and 4 K9 calls, round 1 over the cells entry_ranges
    gives; the rounds run again on the recorded round-1 rays make the
    same calls, and the plain versions reproduce every call's results."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    calls = raysets.frame_pair_calls(sc, bs.colonnade_camera(16, 16), 'grid',
                                     16, 16)
    assert [c['kernel'] for c in calls] == (['intersect_pairs_raw'] * 8
                                            + ['occluded_pairs'] * 4)
    k8, k9 = calls[0]['args'], calls[8]['args']
    for args in (k8, k9):
        assert args[0] is sc.grid['rows']
        for got, ref in zip(args[5:], grid.entry_ranges(sc.grid, *args[1:5])):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert bool((k8[6] > k8[5]).any()) and bool((k9[6] > k9[5]).any())
    with raysets.recorded_pair_calls() as again:
        grid.intersect_grid(sc.grid, sc.nodes, sc.tris, *k8[1:5])
        grid.occluded_grid(sc.grid, sc.nodes, sc.tris, *k9[1:5])
    assert len(again) == len(calls)
    for rec, rerun in zip(calls, again):
        assert rec['kernel'] == rerun['kernel']
        for a, b in zip(rec['args'][1:], rerun['args'][1:]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        out = PLAIN[rec['kernel']](*rec['args'])
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (out, rec['out']))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the wrappers are back in place
    assert all(getattr(pairs, k).__name__ == k for k in PLAIN)


# ------------------------------------------------------------- dispatch

def test_grid_binning_is_accepted():
    """All five binnings of the reference are accepted, 'grid' among
    them; an unknown one raises."""
    for binning in ('morton', 'none', 'grid', 'dense', 'treelet'):
        assert pt.PTParams(ray_binning=binning).ray_binning == binning
    with pytest.raises(ValueError, match='unknown ray_binning'):
        pt.PTParams(ray_binning='hilbert')


def _record(monkeypatch, calls, module, name):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(name) or fn(*a, **k))


def _render(sc, cam, res, depth, binning):
    film, stats = renderer.render_frame(
        sc, cam, pt.PTParams(max_depth=depth, ray_binning=binning), res, res,
        spp=1, seed=42)
    return accum.resolve(film).numpy(), stats


@pytest.mark.parametrize('which', ['colonnade', 'cornell', 'motion'])
def test_grid_dispatch(monkeypatch, which):
    """With ray_binning='grid', the reduced colonnade runs BVH4 on bounce 0
    and the grid on bounce 1; cornell (dense) runs the dense kernels on
    every bounce; a motion scene (BVH over union bounds) runs the motion
    kernel's closest and any-hit forms: neither takes the grid."""
    calls = []
    for mod, name in ((grid, 'intersect_grid'), (grid, 'occluded_grid'),
                      (wide, 'intersect_packet4'), (wide, 'occluded_packet4'),
                      (dense, 'intersect_dense'), (dense, 'occluded_dense'),
                      (traverse, 'intersect_packet_mb'),
                      (traverse, 'occluded_packet_mb')):
        _record(monkeypatch, calls, mod, name)
    if which == 'colonnade':
        sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                    leaf_size=32)
        _render(sc, bs.colonnade_camera(8, 8), 8, 2, 'grid')
        assert calls == ['intersect_packet4', 'occluded_packet4',
                         'intersect_grid', 'occluded_grid']
    elif which == 'cornell':
        sc = bs.cornell_box().commit(device='cpu')
        assert sc.grid is None
        _render(sc, bs.cornell_camera(8, 8), 8, 2, 'grid')
        assert calls == ['intersect_dense', 'occluded_dense'] * 2
    else:
        sc = bs.motion_field(n_spheres=4).commit(device='cpu', force_bvh=True)
        assert sc.accel == 'bvh4mb' and sc.grid is None
        _render(sc, bs.motion_field_camera(8, 8), 8, 2, 'grid')
        assert calls == ['intersect_packet_mb', 'occluded_packet_mb'] * 2


# ----------------------------------------------------------- whole slice

def test_colonnade_grid_matches_jax_render_and_bvh4():
    """The reduced colonnade with ray_binning='grid' against the JAX
    package's CPU render with the same params (which traces through its
    BVH on the CPU) and against the port's own BVH4 render."""
    sc = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu', leaf_size=32)
    params = pt.PTParams(max_depth=3, ray_binning='grid')
    film, stats = renderer.render_frame(sc, bs.colonnade_camera(32, 32),
                                        params, 32, 32, spp=2, seed=42)
    img = accum.resolve(film).numpy()
    js = jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32)
    jfilm, jstats = jrenderer.render_frame(
        js, jbs.colonnade_camera(32, 32),
        jpt.PTParams(max_depth=3, ray_binning='grid'), 32, 32, spp=2,
        seed=42)
    ref = np.asarray(jaccum.resolve(jfilm))
    film4, stats4 = renderer.render_frame(
        sc, bs.colonnade_camera(32, 32), pt.PTParams(max_depth=3), 32, 32,
        spp=2, seed=42)
    img4 = accum.resolve(film4).numpy()
    for other in (ref, img4):
        mse = ((img - other) ** 2).mean()
        assert 10 * np.log10(other.max() ** 2 / max(mse, 1e-20)) >= 60.0
    assert stats.num_rays == jstats.num_rays == stats4.num_rays


# ---------------------------------------------------------------- repair

@pytest.mark.parametrize('card', [True, False])
def test_commit_defaults_to_the_card(monkeypatch, card):
    """commit() with no device puts every table on 'cuda' (tensor moves
    recorded, no card needed), and raises where there is no card."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: card)
    if not card:
        with pytest.raises(RuntimeError, match='CUDA'):
            bs.cornell_box().commit()
        return
    moved = []
    monkeypatch.setattr(torch.Tensor, 'to',
                        lambda self, device: moved.append(device) or self)
    sc = bs.cornell_box().commit()
    assert sc.device == torch.device('cuda')
    assert moved and all(d == torch.device('cuda') for d in moved)
    assert tscene.resolve_device('cpu') == torch.device('cpu')
