"""The torch port's committed tables held against the JAX package's:
packed triangle rows, BVH4 nodes and every array of a committed scene must
be equal."""
import numpy as np
import pytest
import torch

from yulio_raytracer_tpu.geometry import mesh as jmesh, bvh as jbvh
from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.ops import pallas_wide as pw

from yulio_raytracer_tpu_torch.geometry import mesh, bvh
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.ops import wide
from yulio_raytracer_tpu_torch import scene as tscene

torch.set_num_threads(2)


def test_pack_tables_match_on_reduced_colonnade():
    kw = dict(cols_x=3, cols_z=2, tess=(8, 10))
    jpk = jmesh.pack_meshes(jbs.colonnade(**kw).meshes)
    pk = mesh.pack_meshes(bs.colonnade(**kw).meshes)
    for k in jbvh._PER_TRIANGLE_KEYS:
        a, b = getattr(jpk, k, None), getattr(pk, k, None)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=k)
    jtree = jbvh.build(jpk.v0, jpk.e1, jpk.e2, jpk.valid, leaf_size=32,
                       quality='high')
    tree = bvh.build(pk.v0, pk.e1, pk.e2, pk.valid, leaf_size=32)
    np.testing.assert_array_equal(wide.pack_nodes4(tree),
                                  pw.pack_nodes4(jtree))


def _numpy_leaves(js):
    """A committed JAX TpuScene's leaves as numpy, with device='cpu' (what
    from_numpy_scene takes)."""
    def np_(d):
        return {k: np_(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in (d or {}).items()}
    lights = [{k: (v if isinstance(v, (str, int, float)) else np.asarray(v))
               for k, v in l.items()} for l in js.lights]
    return dict(geom=np_(js.geom), packet=np_(js.packet),
                materials=np_(js.materials), textures=np_(js.textures),
                lights=lights, leaf_size=js.leaf_size, bbox_lo=js.bbox_lo,
                bbox_hi=js.bbox_hi, num_triangles=js.num_triangles,
                lobe_types=js.lobe_types, accel=js.accel, device='cpu')


def _assert_scenes_equal(a, b):
    """a (carried from the reference) holds b's (the port's own) arrays."""
    for k in ('leaf_size', 'bbox_lo', 'bbox_hi', 'num_triangles',
              'lobe_types', 'accel'):
        assert getattr(a, k) == getattr(b, k), k
    pairs = [(k, getattr(a, k), getattr(b, k))
             for k in ('nodes4', 'nodes', 'tris_mb')]
    if b.tris is None:
        assert a.tris is None
    else:
        # the reference's rows end in zero rows only its TPU kernels read
        g = b.tris.shape[0]
        assert not a.tris[g:].any()
        pairs.append(('tris', a.tris[:g], b.tris))
    for grp in ('geom', 'materials', 'textures', 'motion', 'grid',
                'treelets'):
        ga, gb = getattr(a, grp), getattr(b, grp)
        if ga is None or gb is None:
            assert ga is None and gb is None, grp
            continue
        assert ga.keys() == gb.keys(), grp
        pairs += [(f'{grp}.{k}', ga[k], gb[k]) for k in ga]
    assert len(a.lights) == len(b.lights)
    for i, (la, lb_) in enumerate(zip(a.lights, b.lights)):
        assert la.keys() == lb_.keys()
        for k in la:
            if isinstance(la[k], torch.Tensor):
                pairs.append((f'light{i}.{k}', la[k], lb_[k]))
            else:
                assert la[k] == lb_[k], (i, k)
    for name, x, y in pairs:
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


@pytest.mark.parametrize('which', ['cornell', 'colonnade_reduced'])
def test_from_numpy_scene_equals_own_commit(which):
    if which == 'cornell':
        js = jbs.cornell_box().commit()
        own = bs.cornell_box().commit(device='cpu')
    else:
        kw = dict(cols_x=3, cols_z=2, tess=(8, 10))
        js = jbs.colonnade(**kw).commit(leaf_size=32)
        own = bs.colonnade(**kw).commit(device='cpu', leaf_size=32)
    assert own.accel == ('dense' if which == 'cornell' else 'bvh4')
    carried = tscene.from_numpy_scene(**_numpy_leaves(js))
    _assert_scenes_equal(carried, own)


def test_commit_device_argument():
    sc = bs.cornell_box().commit(device='cpu')
    assert sc.device == torch.device('cpu')
    assert all(t.device == sc.device for t in
               [sc.tris, *sc.geom.values(), *sc.materials.values()])
