"""Random-scene stress generator -- the `-regression` fuzzer.

Counterpart of `yulio_raytracer_tpu/utils/regression.py` (:1-109), the
intent of `devices/renderer/regression.cpp:32-226`: randomized scenes
(random meshes, tessellated spheres, random textures, one material of
each preset in the pool, an ambient dome and maybe a point and a
triangle light), drawn from `np.random.RandomState(seed)` in the
reference's order so both packages stage the same scene, pushed
through the full commit and render path to shake out crashes and NaNs.
Used by the CLI's `-regression` and the viewer's `t` mode.
"""
from __future__ import annotations

import numpy as np

from ..geometry import mesh as gmesh
from ..geometry import primitives
from ..shading import materials as gmat
from ..lights import lights as glights
from ..scene import SceneBuilder

_MATERIAL_POOL = [
    ('matte', lambda r: {'reflectance': r.rand(3)}),
    ('plastic', lambda r: {'pigmentColor': r.rand(3),
                           'eta': 1.1 + r.rand(),
                           'roughness': float(r.rand() * 0.5)}),
    ('glass', lambda r: {'etaOutside': 1.0, 'etaInside': 1.2 + r.rand()}),
    ('thindielectric', lambda r: {'transmission': r.rand(3),
                                  'eta': 1.2 + r.rand(),
                                  'transparency': float(r.rand())}),
    ('mirror', lambda r: {'reflectance': r.rand(3)}),
    ('metal', lambda r: {'reflectance': r.rand(3),
                         'eta': 1.0 + r.rand(3),
                         'k': r.rand(3) * 3,
                         'roughness': float(r.rand() * 0.4)}),
    ('brushedmetal', lambda r: {'reflectance': r.rand(3),
                                'eta': 1.0 + r.rand(3), 'k': r.rand(3),
                                'roughnessX': float(r.rand() * 0.3),
                                'roughnessY': float(r.rand() * 0.3)}),
    ('metallicpaint', lambda r: {'shadeColor': r.rand(3),
                                 'glitterColor': r.rand(3),
                                 'glitterSpread': float(0.1 + r.rand()),
                                 'eta': 1.2 + r.rand()}),
    ('mattetextured', lambda r: {'s0': (0.0, 0.0), 'ds': (1.0, 1.0)}),
    ('uber', lambda r: {'diffuse': r.rand(3),
                        'roughness': float(r.rand()),
                        'reflectivity': float(r.rand() * 0.5),
                        'eta': 1.2 + r.rand()}),
    ('obj', lambda r: {'d': float(0.5 + 0.5 * r.rand()), 'Kd': r.rand(3),
                       'Ks': r.rand(3) * 0.5,
                       'Ns': float(1 + r.rand() * 64)}),
    ('velvet', lambda r: {'reflectance': r.rand(3),
                          'backScattering': float(r.rand()),
                          'horizonScatteringColor': r.rand(3),
                          'horizonScatteringFallOff': float(r.rand() * 10)}),
]


def random_texture(rs: np.random.RandomState) -> np.ndarray:
    """Random image like createRandomImage (regression.cpp)."""
    h, w = rs.randint(4, 32), rs.randint(4, 32)
    img = rs.rand(h, w, 4).astype(np.float32)
    img[..., 3] = np.clip(img[..., 3] + 0.3, 0, 1)
    return img


def random_mesh(rs: np.random.RandomState, material: int) -> gmesh.HostMesh:
    nv = rs.randint(4, 40)
    pos = (rs.randn(nv, 3) * rs.uniform(0.5, 3)
           + rs.randn(3) * 4).astype(np.float32)
    nt = rs.randint(2, 40)
    tri = rs.randint(0, nv, (nt, 3)).astype(np.int32)
    nrm = rs.randn(nv, 3).astype(np.float32)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    uv = rs.rand(nv, 2).astype(np.float32)
    return gmesh.HostMesh(pos, tri, nrm, uv, material=material,
                          cull=int(rs.rand() < 0.3))


def create_random_scene(seed: int, num_shapes: int = 8) -> SceneBuilder:
    """createRandomScene (regression.cpp:203-226): random materials across
    every preset, random meshes + tessellated spheres, random lights."""
    rs = np.random.RandomState(seed)
    sb = SceneBuilder()
    mat_ids = []
    for name, gen in _MATERIAL_POOL:
        p = gen(rs)
        tex = -1
        if name in ('mattetextured', 'uber', 'obj') and rs.rand() < 0.8:
            tex = sb.textures.add(random_texture(rs))
        mat_ids.append(sb.add_material(gmat.make_material(
            name, {k: (tuple(v) if isinstance(v, np.ndarray) else v)
                   for k, v in p.items()}, tex_id=tex)))
    for i in range(num_shapes):
        m = mat_ids[rs.randint(len(mat_ids))]
        if rs.rand() < 0.3:
            sb.add_mesh(primitives.tessellate_sphere(
                rs.randn(3) * 4, rs.uniform(0.3, 2),
                rs.randint(4, 12), rs.randint(4, 12), material=m))
        else:
            sb.add_mesh(random_mesh(rs, m))
    # random light mix
    sb.add_light(glights.ambient(rs.rand(3)))
    if rs.rand() < 0.5:
        sb.add_light(glights.point(rs.randn(3) * 5 + [0, 8, 0],
                                   rs.rand(3) * 50))
    if rs.rand() < 0.3:
        p = rs.randn(3) * 3 + [0, 6, 0]
        sb.add_light(glights.triangle(p, p + [1, 0, 0], p + [0, 0, 1],
                                      rs.rand(3) * 20))
    return sb
