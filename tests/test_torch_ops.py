"""The torch port's intersection ops held against the JAX package: the plain
dense and BVH4 traversals against the Pallas kernels (interpret mode, as
the JAX package's own tests run them), the Woop reference path and
post_intersect.  The CUDA kernels are held against the plain versions on
the card by tests/test_torch_cuda.py."""
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.ops import intersect as jops
from yulio_raytracer_tpu.ops import pallas_dense as ppd
from yulio_raytracer_tpu.ops import pallas_traverse as ppt
from yulio_raytracer_tpu.ops import pallas_wide as pw

from yulio_raytracer_tpu_torch.geometry import mesh, bvh, primitives
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.ops import dense, wide, intersect as ops
from yulio_raytracer_tpu_torch.ops import cuda_build as cb
from yulio_raytracer_tpu_torch import raysets, turns

torch.set_num_threads(2)


def build_tables(m, b, p, **tree_kw):
    """(host geometry, woop, tree) of the tests/test_pallas.py scene
    (sphere, floor quad, culled triangle; leaf 8), built as its _build
    does with the mesh/bvh/primitives modules m, b, p, but with the
    default tree of a commit (the port's only tree)."""
    packed = m.pack_meshes([
        p.tessellate_sphere([0, 0, 0], 1.0, 12, 16),
        p.quad([-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5], [-5, -1.2, 5]),
        p.single_triangle([2, 0, 0], [3, 0, 0], [2, 1, 0],
                          cull=m.CULL_BACK)], pad_multiple=64)
    tree = b.build(packed.v0, packed.e1, packed.e2, packed.valid,
                   leaf_size=8, **tree_kw)
    host = {k: getattr(packed, k) for k in (
        'v0', 'e1', 'e2', 'ng', 'vn', 'uv', 'mat_id', 'light_id', 'cull',
        'illum_mask', 'shadow_mask', 'valid')}
    host = b.permute_geom(host, tree.order)
    woop = m.woop_matrices(host['v0'], host['e1'], host['e2'], host['valid'])
    return host, woop, tree


def test_pack_tables_match_on_pallas_scene():
    jhost, jwoop, jtree = build_tables(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = build_tables(mesh, bvh, primitives)
    np.testing.assert_array_equal(woop, jwoop)
    assert_tris_equal(wide.pack_tris(woop, host), ppt.pack_tris(jwoop, jhost))
    np.testing.assert_array_equal(wide.pack_nodes4(tree),
                                  pw.pack_nodes4(jtree))


def assert_tris_equal(tris, jtris):
    """The port's packed rows equal the reference's, which only append
    zero rows for its TPU kernels."""
    g = tris.shape[0]
    np.testing.assert_array_equal(tris, jtris[:g])
    assert not np.any(jtris[g:])


R = ppt.BLOCK          # the reference kernels take multiples of 1024
R_ODD = 1000           # the port takes any count


@pytest.fixture(scope='module')
def tables():
    """JAX and port tables of the tests/test_pallas.py wide-kernel scene,
    and its rays (RandomState(5), as test_wide_bvh4_matches_binary)."""
    jhost, jwoop, jtree = build_tables(jmesh, jbvh, jprim, quality='high')
    host, woop, tree = build_tables(mesh, bvh, primitives)
    rs = np.random.RandomState(5)
    org = (rs.randn(R, 3) * 3).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((R,), 1e-4, np.float32)
    tf = np.full((R,), np.inf, np.float32)
    tf[::7] = -1.0                         # dead lanes: tfar < tnear
    tf[3::7] = 2.5                         # finite segments
    return dict(
        jtris=jnp.asarray(ppt.pack_tris(jwoop, jhost)),
        jnodes4=jnp.asarray(pw.pack_nodes4(jtree)),
        tris=torch.as_tensor(wide.pack_tris(woop, host)),
        nodes4=torch.as_tensor(wide.pack_nodes4(tree)),
        rays=(org, d, tn, tf))


def _jax_rays(rays):
    return tuple(jnp.asarray(x) for x in rays)


def _torch_rays(rays, n=None):
    return tuple(torch.as_tensor(x[:n]) for x in rays)


def _assert_hits_agree(got, ref, n=None):
    t0, tri0 = np.asarray(ref.t)[:n], np.asarray(ref.tri)[:n]
    t1, tri1 = got.t.numpy(), got.tri.numpy()
    assert t1.shape == t0.shape
    np.testing.assert_array_equal(tri1 >= 0, tri0 >= 0)
    hit = tri0 >= 0
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-6, atol=1e-7)
    assert np.isinf(t1[~hit]).all()
    assert (tri1 == tri0).mean() >= 0.999      # ties may pick another tri


@pytest.mark.parametrize('n,rows', [(R, 'all'), (R_ODD, 'all'),
                                    (R, 'live'), (R_ODD, 'live')],
                         ids=[str(R), str(R_ODD), f'{R}-live', f'{R_ODD}-live'])
def test_plain_dense_matches_pallas(tables, n, rows):
    """The plain dense versions against the reference's kernels over its
    full table; with rows 'live' the port's plain sweeps over the table's
    live rows alone (what the kernels test): tri and the mask exactly."""
    jr = _jax_rays(tables['rays'])
    ref = ppd.intersect_dense(tables['jtris'], *jr, interpret=True)
    occ_ref = ppd.occluded_dense(tables['jtris'], *jr, interpret=True)
    tr = _torch_rays(tables['rays'], n)
    if rows == 'all':
        got = dense.intersect_dense(tables['tris'], *tr)
        occ = dense.occluded_dense(tables['tris'], *tr)
    else:
        live = dense._rows(tables['tris'])[:dense.live_rows(tables['tris'])]
        assert live.shape[0] < dense._rows(tables['tris']).shape[0]
        got, occ = ops.closest_rows(live, *tr), ops.any_rows(live, *tr)
        np.testing.assert_array_equal(got.tri.numpy(),
                                      np.asarray(ref.tri)[:n])
    _assert_hits_agree(got, ref, n)
    hit = got.tri.numpy() >= 0
    for key in ('u', 'v') if rows == 'live' else ('u',):
        np.testing.assert_allclose(getattr(got, key).numpy()[hit],
                                   np.asarray(getattr(ref, key))[:n][hit],
                                   atol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])


@pytest.mark.parametrize('n', [R, R_ODD])
def test_plain_wide_matches_pallas(tables, n):
    jr = _jax_rays(tables['rays'])
    ref = pw.intersect_packet4(tables['jnodes4'], tables['jtris'], *jr,
                               max_leaf=8, interpret=True)
    got = wide.intersect_packet4(tables['nodes4'], tables['tris'],
                                 *_torch_rays(tables['rays'], n))
    _assert_hits_agree(got, ref, n)
    occ_ref = pw.occluded_packet4(tables['jnodes4'], tables['jtris'], *jr,
                                  max_leaf=8, interpret=True)
    occ = wide.occluded_packet4(tables['nodes4'], tables['tris'],
                                *_torch_rays(tables['rays'], n))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref)[:n])


def test_plain_wide_records_its_stack_depth(tables):
    """With counts, each plain version reports every ray's largest stack
    occupancy: at least the root's entry, at most the bound _check_packed
    enforces, and deeper for rays that walk the tree than for dead
    lanes."""
    rays = _torch_rays(tables['rays'])
    for plain in (wide.intersect_wide_plain, wide.occluded_wide_plain):
        counts = {}
        plain(tables['nodes4'], tables['tris'], *rays, counts=counts)
        deepest = torch.cat(counts['stack']).numpy()
        assert deepest.shape == (R,)
        assert deepest.min() >= 1 and deepest.max() <= wide.STACK
        dead = tables['rays'][3] < tables['rays'][2]
        assert deepest[~dead].max() > 1
        if plain is wide.occluded_wide_plain:
            assert np.all(deepest[dead] == 1)


def test_plain_wide_matches_brute_on_colonnade():
    """The BVH4 traversal of a real (reduced colonnade) tree finds the
    dense sweep's closest hits and occlusion over the same rows."""
    sc = bs.colonnade(cols_x=3, cols_z=2, tess=(8, 10)).commit(
        device='cpu', leaf_size=32)
    rs = np.random.RandomState(4)
    n = 2000
    org = torch.as_tensor((rs.randn(n, 3) * 4 + [0, 2, 0]).astype(np.float32))
    d = rs.randn(n, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))
    tn = torch.full((n,), 1e-4)
    tf = torch.full((n,), float('inf'))
    ref = dense.intersect_dense(sc.tris, org, d, tn, tf)
    got = wide.intersect_packet4(sc.nodes4, sc.tris, org, d, tn, tf)
    np.testing.assert_array_equal(got.tri.numpy(), ref.tri.numpy())
    np.testing.assert_array_equal(got.t.numpy(), ref.t.numpy())
    tf = torch.full((n,), 3.0)
    np.testing.assert_array_equal(
        wide.occluded_packet4(sc.nodes4, sc.tris, org, d, tn, tf).numpy(),
        dense.occluded_dense(sc.tris, org, d, tn, tf).numpy())


@pytest.fixture(scope='module')
def colonnade_nodes4():
    """The full colonnade's BVH4 rows (leaf 32), as the card renders it."""
    return bs.colonnade().commit(device='cpu', leaf_size=32).nodes4.numpy()


@pytest.mark.parametrize('field', ['count', 'start', 'none'])
def test_check_packed_guards_the_stack_words(tables, field):
    """The kernels' stack words take a leaf of any count whose triangle
    range ends below 2^24: a leaf of 256 triangles passes, and a range
    reaching 2^24 by its count or by its start raises; the table as
    packed passes."""
    out = tables['nodes4'].numpy().copy()
    slots = out.reshape(-1, 4, 8)
    leaf = np.argwhere(slots[:, :, 7] > 0)[0]
    if field == 'count':
        slots[leaf[0], leaf[1], 7] = 256.0
        assert wide._check_packed(out, 4) is out
        slots[leaf[0], leaf[1], 7] = float(1 << 24) - slots[leaf[0],
                                                            leaf[1], 6]
    elif field == 'start':
        slots[leaf[0], leaf[1], 6] = float(1 << 24)
    if field == 'none':
        assert wide._check_packed(out, 4) is out
    else:
        with pytest.raises(ValueError):
            wide._check_packed(out, 4)


def test_kernel_entry_follows_the_largest_leaf(colonnade_nodes4):
    """The wrappers launch the kernels' *_slots forms for a table with a
    leaf of SLOTS_MIN triangles or more, and notice a table changed in
    place."""
    lib = SimpleNamespace(yrt_occluded_wide='words',
                          yrt_occluded_wide_slots='slots')
    nodes4 = torch.as_tensor(colonnade_nodes4.copy())
    assert wide._entry(lib, 'yrt_occluded_wide', nodes4) == 'words'
    nodes4.view(-1, 4, 8)[:, :, 7].clamp_(max=wide.SLOTS_MIN - 1)
    assert wide._entry(lib, 'yrt_occluded_wide', nodes4) == 'words'
    leaf = torch.nonzero(nodes4.view(-1, 4, 8)[:, :, 7] > 0)[0]
    nodes4.view(-1, 4, 8)[leaf[0], leaf[1], 7] = float(wide.SLOTS_MIN)
    assert wide._entry(lib, 'yrt_occluded_wide', nodes4) == 'slots'
    big = bs.colonnade(cols_x=3, cols_z=2, tess=(8, 10)).commit(
        device='cpu', leaf_size=512).nodes4
    assert wide._entry(lib, 'yrt_occluded_wide', big) == 'slots'


def test_check_packed_accepts_the_colonnade(colonnade_nodes4):
    tags = colonnade_nodes4.reshape(-1, 4, 8)[:, :, 7]
    assert wide._check_packed(colonnade_nodes4, 4) is colonnade_nodes4
    assert 0 < tags.max() <= 32


@pytest.mark.parametrize('tree', ['pallas_scene', 'reduced_colonnade',
                                  'colonnade'])
def test_pack_nodes4_rows_are_breadth_first(tables, colonnade_nodes4, tree):
    """pack_nodes4 emits a tree (one parent for every row but the root)
    level by level: every interior child row after its parent, and no
    row above a row of a shallower level."""
    out = {'pallas_scene': lambda: tables['nodes4'].numpy(),
           'reduced_colonnade': lambda: bs.colonnade(
               cols_x=3, cols_z=2, tess=(8, 10)).commit(
                   device='cpu', leaf_size=32).nodes4.numpy(),
           'colonnade': lambda: colonnade_nodes4}[tree]()
    slots = out.reshape(-1, 4, 8)
    parent = np.full(out.shape[0], -1)
    for w, k in np.argwhere(slots[:, :, 7] < 0):
        child = int(slots[w, k, 6])
        assert parent[child] == -1              # a tree: one parent each
        parent[child] = w
    assert out.shape[0] > 1
    assert parent[0] == -1 and np.all(parent[1:] >= 0)
    assert np.all(parent[1:] < np.arange(1, out.shape[0]))
    depth = np.zeros(out.shape[0], int)
    for w in range(1, out.shape[0]):
        depth[w] = depth[parent[w]] + 1
    assert np.all(np.diff(depth) >= 0)


@pytest.mark.parametrize('which', ['dense', 'wide'])
def test_kernel_wrappers_bound_the_ray_count(tables, which):
    """A batch the kernels cannot index raises before any launch (meta
    tensors carry the shape without memory)."""
    n = cb.MAX_RAYS
    rays = (torch.empty((n, 3), device='meta'),
            torch.empty((n, 3), device='meta'),
            torch.empty((n,), device='meta'), torch.empty((n,), device='meta'))
    tabs = ((tables['tris'].to('meta'),) if which == 'dense' else
            (tables['nodes4'].to('meta'), tables['tris'].to('meta')))
    fns = ((dense.intersect_dense, dense.occluded_dense) if which == 'dense'
           else (wide.intersect_packet4, wide.occluded_packet4))
    for fn in fns:
        with pytest.raises(ValueError, match='exceed one launch'):
            fn(*tabs, *rays)


def test_woop_reference_and_post_intersect_match():
    js = jbs.cornell_box().commit()
    geom = {k: torch.as_tensor(np.array(js.geom[k]))
            for k in ('woop', 'ng', 'cull', 'shade_tab')}
    rs = np.random.RandomState(9)
    n = 2048
    org = (rs.randn(n, 3) * 150 + [278, 273, 280]).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.full((n,), 1e-3, np.float32)
    tf = np.full((n,), np.inf, np.float32)
    jr = tuple(jnp.asarray(x) for x in (org, d, tn, tf))
    tr = tuple(torch.as_tensor(x) for x in (org, d, tn, tf))
    ref = jops.intersect_woop(js.geom, *jr)
    got = ops.intersect_woop(geom, *tr)
    # the reference transforms rays by a matmul, which sums in another
    # order: with cornell's ~500-unit coordinates the cancellation in
    # o'_w leaves t within 2e-4 relative (measured max 6e-5)
    both = (got.tri.numpy() == np.asarray(ref.tri)) & (got.tri.numpy() >= 0)
    assert both.mean() >= 0.999 * (np.asarray(ref.tri) >= 0).mean()
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=2e-4)
    np.testing.assert_array_equal(
        ops.occluded_woop(geom, *tr[:3], torch.full((n,), 200.0)).numpy(),
        np.asarray(jops.occluded_woop(js.geom, *jr[:3],
                                      jnp.full((n,), 200.0))))
    # post_intersect on the same hits (a fraction miss)
    jd = jops.post_intersect(js.geom, jr[0], jr[1], ref)
    td = ops.post_intersect(geom, tr[0], tr[1], ops.Hit(
        *(torch.as_tensor(np.array(x)) for x in ref)))
    for k, v in td.items():
        if k in jd:
            np.testing.assert_allclose(v.numpy(), np.asarray(jd[k]),
                                       atol=1e-5, rtol=1e-6, err_msg=k)


def test_lib_path_follows_the_sources(tmp_path):
    """A copy of the kernel sources in another directory maps to the same
    library as the package's; an edited copy to a library of its own."""
    for fn in os.listdir(cb.CSRC):
        shutil.copy(os.path.join(cb.CSRC, fn), tmp_path / fn)
    assert cb.lib_path('wide', str(tmp_path)) == cb.lib_path('wide')
    with open(tmp_path / 'wide.cu', 'a') as f:
        f.write('\n')
    assert cb.lib_path('wide', str(tmp_path)) != cb.lib_path('wide')
    assert cb.lib_path('dense', str(tmp_path)) == cb.lib_path('dense')


def test_ray_sets_on_cornell():
    """The ray sets the kernels are timed on: camera rays in tile order,
    hemisphere rays leaving each hit on the incoming ray's side (dead
    lanes where the camera ray missed), and shadow rays light-major,
    each ending eps short of a point on its light."""
    dev = torch.device('cpu')
    sc = bs.cornell_box().commit(device=dev)
    org, d, tm = raysets.camera_rays(sc, bs.cornell_camera(16, 16), 16, 16,
                                     dev, 3)
    assert org.shape == d.shape == (256, 3) and tm is None
    zeros = torch.zeros(256)
    hit = dense.intersect_dense(sc.tris, org, d, zeros,
                                torch.full_like(zeros, float('inf')))
    gen = torch.Generator().manual_seed(3)
    ho, hd, htn, htf, dg, eps = raysets.hemisphere_rays(sc, org, d, hit,
                                                        gen, dev)
    valid = hit.valid
    assert bool(valid.any()) and torch.equal(htf < 0, ~valid)
    torch.testing.assert_close(hd.norm(dim=-1), torch.ones(256))
    facing = torch.where(((dg['Ng'] * d).sum(-1) > 0)[:, None], -dg['Ng'],
                         dg['Ng'])
    assert bool(((hd * facing).sum(-1)[valid] >= 0).all())
    so, sd, stn, stf = raysets.shadow_rays(sc, dg, eps, valid, gen, dev)
    n_lights = len(sc.lights)
    assert so.shape == (256 * n_lights, 3) and n_lights > 0
    assert torch.equal(stf < 0, ~valid.repeat(n_lights))
    assert torch.equal(stn, eps.repeat(n_lights))
    occ = raysets.scattered_rays(sc, 100, gen, dev)
    assert occ[0].shape == (100, 3) and occ[4].shape == (100,)


def test_frame_dense_calls_record_every_call():
    """raysets.frame_dense_calls on cornell records one entry per K1/K2
    call of one bounce-1 trace, in order: each bounce's closest call on
    the pass's rays, then the any-hit call on every light's shadow rays;
    the plain versions reproduce each call's results, the wrappers are
    back after the block, and no launch is counted on the CPU.  A scene
    traced otherwise is refused."""
    sc = bs.cornell_box().commit(device='cpu')
    launches = (dense.intersect_dense.launches,
                dense.occluded_dense.launches)
    calls = raysets.frame_dense_calls(sc, bs.cornell_camera(16, 16), 16, 16,
                                      spp=2)
    assert [c['kernel'] for c in calls] == ['intersect_dense',
                                            'occluded_dense'] * 2
    plain = {'intersect_dense': dense.intersect_dense_plain,
             'occluded_dense': dense.occluded_dense_plain}
    for c in calls:
        tris, org, dirn, tnear, tfar = c['args']
        n = 512 * (len(sc.lights) if c['kernel'] == 'occluded_dense' else 1)
        assert tris is sc.tris and org.shape == (n, 3) and tfar.shape == (n,)
        ref = plain[c['kernel']](*c['args'])
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (ref, c['out']))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(getattr(dense, k).__name__ == k for k in plain)
    assert (dense.intersect_dense.launches,
            dense.occluded_dense.launches) == launches
    with pytest.raises(ValueError, match="'dense'"):
        raysets.frame_dense_calls(
            bs.colonnade(cols_x=3, cols_z=2, tess=(8, 10)).commit(
                device='cpu'), bs.colonnade_camera(8, 8), 8, 8)


@pytest.fixture(scope='module')
def cornell_sets():
    """Cornell on the CPU and its dense entry sets at 16^2 (seed 3):
    {'camera', 'hemisphere', 'shadow'} ray tuples."""
    sc = bs.cornell_box().commit(device='cpu')
    closest, shadow = raysets.dense_entry_rays(
        sc, bs.cornell_camera(16, 16), 16, torch.device('cpu'),
        torch.Generator().manual_seed(3), 3)
    return sc, {'camera': tuple(x[:256] for x in closest),
                'hemisphere': tuple(x[256:] for x in closest),
                'shadow': shadow}


def _table_with_rows(live):
    """A (4, 128) table (32 rows) whose rows `live` hold cornell's first
    triangles and whose other rows are zero."""
    src = dense._rows(bs.cornell_box().commit(device='cpu').tris)
    out = torch.zeros((32, 16))
    out[live] = src[:len(live)]
    return out.reshape(4, 128)


@pytest.mark.parametrize('case', ['cornell', 'last_live', 'interior_zero',
                                  'all_zero'])
def test_live_rows_count_up_to_the_last_live_row(case):
    """live_rows, the rows the dense kernels test: up to the last row that
    is not all zero (cornell: 32 of 128), every row where the last is
    live, past a zero row inside the table, none of an all-zero table;
    counted again after the table changes in place."""
    if case == 'cornell':
        tris, want = bs.cornell_box().commit(device='cpu').tris, 32
        assert dense._rows(tris).shape[0] == 128
    elif case == 'last_live':
        tris, want = _table_with_rows([0, 5, 31]), 32
    elif case == 'interior_zero':
        tris, want = _table_with_rows([0, 1, 2, 4, 9]), 10
        assert not bool(dense._rows(tris)[3].any())
    else:
        tris, want = torch.zeros((4, 128)), 0
    assert dense.live_rows(tris) == want
    dense._rows(tris)[want:] = 0
    tris.view(-1)[-1] = -0.0           # a -0.0 field is zero too
    assert dense.live_rows(tris) == want
    tris.view(-1)[-1] = 1.0
    assert dense.live_rows(tris) == dense._rows(tris).shape[0]


@pytest.mark.parametrize('rays', ['camera', 'hemisphere', 'shadow'])
def test_plain_dense_over_live_rows_equals_all_rows(cornell_sets, rays):
    """On cornell's camera, hemisphere and shadow rays the plain sweeps
    over the live rows alone give the same closest hits (t, tri, u, v)
    and occlusion as over every row: the rows left out never hit."""
    sc, sets = cornell_sets
    rows = dense._rows(sc.tris)
    live = rows[:dense.live_rows(sc.tris)]
    got, ref = (ops.closest_rows(live, *sets[rays]),
                ops.closest_rows(rows, *sets[rays]))
    assert bool((ref.tri >= 0).any())
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    occ = ops.any_rows(rows, *sets[rays])
    if rays == 'shadow':
        assert 0 < int(occ.sum()) < occ.numel()
    np.testing.assert_array_equal(ops.any_rows(live, *sets[rays]).numpy(),
                                  occ.numpy())


def _kernel_stages(rows, rays, closest):
    """The stages of the Woop tests a dense kernel makes over rows (T, 16)
    in order, a row at a time for every ray: {'pair': stage 1, 'stage2':
    its plane distance in (tnear, limit), 'stage3': inside the triangle on
    a row with cull flag 1}.  The limit is the best t so far (closest;
    tfar before the first hit) or tfar, and an any-hit ray stops at its
    first hit."""
    org, dirn, tnear, tfar = rays
    limit = tfar.clone()
    done = torch.zeros(org.shape[0], dtype=torch.bool)
    counts = {'pair': 0, 'stage2': 0, 'stage3': 0}
    for row in rows:
        th, uh, vh, hit = ops.woop_test(row, org, dirn, tnear, limit)
        dwp = dirn[:, 0] * row[2] + dirn[:, 1] * row[5] + dirn[:, 2] * row[8]
        plane = ~done & (dwp.abs() > 1e-12) & (th > tnear) & (th < limit)
        inside = plane & (uh >= -ops.BARY_EPS) & (vh >= -ops.BARY_EPS) & (
            uh + vh <= 1.0 + ops.BARY_EPS)
        counts['pair'] += int((~done).sum())
        counts['stage2'] += int(plane.sum())
        counts['stage3'] += int(inside.sum()) if row[15] == 1.0 else 0
        if closest:
            limit = torch.where(hit, th, limit)
        else:
            done |= hit
    return counts


@pytest.mark.parametrize('rays,cull', [('camera', False),
                                       ('hemisphere', False),
                                       ('shadow', False), ('hemisphere', True),
                                       ('shadow', True)],
                         ids=['camera', 'hemisphere', 'shadow',
                              'hemisphere-culled', 'shadow-culled'])
def test_plain_dense_counts_the_kernels_tests(cornell_sets, rays, cull):
    """With counts, the plain versions give the staged tests the kernels
    make on the live rows (a row-by-row loop here): K1 (camera and
    hemisphere rays) every ray against every live row, K2 (shadow rays)
    each ray up to its first hit; with every other row's cull flag set,
    stage 3 runs.  An all-zero table makes none."""
    sc, sets = cornell_sets
    tris = sc.tris.clone()
    live = dense.live_rows(tris)
    if cull:
        dense._rows(tris)[:live:2, 15] = 1.0
    closest = rays != 'shadow'
    plain = (dense.intersect_dense_plain if closest
             else dense.occluded_dense_plain)
    counts = {}
    out = plain(tris, *sets[rays], counts=counts)
    want = _kernel_stages(dense._rows(tris)[:live], sets[rays], closest)
    assert {k: int(v) for k, v in counts.items()} == want
    n = sets[rays][0].shape[0]
    if closest:
        assert want['pair'] == n * live
    else:
        assert 0 < int(out.sum()) and want['pair'] < n * live
    assert 0 < want['stage2'] < want['pair']
    assert (want['stage3'] > 0) == cull
    assert dense.staged_flops(counts) == (
        want['pair'] * 18 + want['stage2'] * 31 + want['stage3'] * 6)
    counts = {}
    plain(torch.zeros((2, 128)), *sets[rays], counts=counts)
    assert counts == {}


def test_run_turns_alternates_and_holds_the_libraries_equal(monkeypatch,
                                                             capsys):
    """The turns driver of every family of the turns tool: it
    first requires both libraries' outputs bit-equal on every set, then
    times this checkout's first on even rounds and the other's first on
    odd ones, then each extra timed step; a set's summary has each
    library's median and spread, the rounds this one won, the extra
    steps' medians and extra()'s keys, and one [turns] line is printed
    per set, ending with extra()'s numbers."""
    order = []
    times = {'this': iter([1.0, 3.0, 1.0]), 'other': iter([2.0, 2.0, 2.0]),
             'step': iter([0.5, 0.25, 0.75])}

    def fake_median_ms(fn):
        fn()
        return next(times[order[-1]])
    monkeypatch.setattr(turns, 'median_ms', fake_median_ms)

    def run(k, calls):
        order.append(k)
        return [(torch.arange(3) * c,) for c in calls]

    def extra(what, calls, outs, med):
        assert torch.equal(outs[1][0], torch.arange(3) * 2)
        return {'note': med['other'] / med['this'], 'by': 'bytes'}
    summary, outs = turns.run_turns(
        {'set': [1, 2]}, run, 3, 'a card', len,
        also={'step': lambda calls: order.append('step')}, extra=extra)
    assert order == ['this', 'other'] + ['this', 'other', 'step',
                                         'other', 'this', 'step',
                                         'this', 'other', 'step']
    s = summary['set']
    assert (s['calls'], s['rays'], s['this_faster_rounds']) == (2, 2, 2)
    assert s['this']['median_ms'] == 1.0 and s['this']['max_ms'] == 3.0
    assert s['other']['median_ms'] == 2.0 and s['other_over_this'] == 2.0
    assert s['step_ms'] == 0.5 and s['note'] == 2.0
    assert len(outs['set']) == 2
    line = capsys.readouterr().out.strip()
    assert line.startswith('[turns] set on 2 rays, 3 rounds: this median')
    assert line.endswith('; step alone 0.5000 ms; note 2; by bytes; a card')

    def disagree(k, calls):
        return [(torch.tensor([k == 'this']),)]
    with pytest.raises(AssertionError, match='disagree'):
        turns.run_turns({'set': [1]}, disagree, 1, 'a card', len)
