"""Built-in test and benchmark scenes.

Counterpart of `yulio_raytracer_tpu/io/builtin_scenes.py` (the cornell
box, the colonnade and the motion field with their cameras, and the
cornell stereo face): the same meshes, materials and lights in the same
order, so both packages commit equal tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..geometry.mesh import HostMesh
from ..geometry import primitives
from ..shading import materials as gmat
from ..lights import lights as glights
from ..scene import SceneBuilder
from ..cameras import cameras as cam


def _quad_mesh(a, b, c, d, material):
    pos = np.asarray([a, b, c, d], np.float32)
    tri = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return HostMesh(pos, tri, material=material)


def cornell_box(with_boxes: bool = True) -> SceneBuilder:
    """The canonical Cornell box: white floor/ceiling/back, red left wall
    (x=552), green right wall (x=0), the ceiling quad light, and the two
    boxes (camera: cornell_camera)."""
    sb = SceneBuilder()
    white = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.73, 0.73, 0.73)}))
    red = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.61, 0.062, 0.062)}))
    green = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.117, 0.435, 0.115)}))

    # floor, ceiling, back wall (canonical coordinates)
    sb.add_mesh(_quad_mesh([552.8, 0, 0], [0, 0, 0], [0, 0, 559.2],
                           [549.6, 0, 559.2], white))
    sb.add_mesh(_quad_mesh([556, 548.8, 0], [556, 548.8, 559.2],
                           [0, 548.8, 559.2], [0, 548.8, 0], white))
    sb.add_mesh(_quad_mesh([549.6, 0, 559.2], [0, 0, 559.2],
                           [0, 548.8, 559.2], [556, 548.8, 559.2], white))
    # left wall (x ~ 552): red; right wall (x = 0): green
    sb.add_mesh(_quad_mesh([552.8, 0, 0], [549.6, 0, 559.2],
                           [556, 548.8, 559.2], [556, 548.8, 0], red))
    sb.add_mesh(_quad_mesh([0, 0, 559.2], [0, 0, 0],
                           [0, 548.8, 0], [0, 548.8, 559.2], green))

    if with_boxes:
        def box(verts):
            v = np.asarray(verts, np.float32)
            for q in range(0, 20, 4):
                sb.add_mesh(_quad_mesh(v[q], v[q + 1], v[q + 2], v[q + 3],
                                       white))
        # short block
        box([[130, 165, 65], [82, 165, 225], [240, 165, 272],
             [290, 165, 114],
             [290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272],
             [130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114],
             [82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65],
             [240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]])
        # tall block
        box([[423, 330, 247], [265, 330, 296], [314, 330, 456],
             [472, 330, 406],
             [423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406],
             [472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456],
             [314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296],
             [265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]])

    # quadlight of models/cornell_box.ecs:2: p=(213, 548.77, 227),
    # dx=(130,0,0), dy=(0,0,105), L=(50,50,50)
    add_quad_light(sb, [213.0, 548.77, 227.0], [130.0, 0.0, 0.0],
                   [0.0, 0.0, 105.0], (50.0, 50.0, 50.0))
    return sb


def add_quad_light(sb: SceneBuilder, p, dx, dy, L):
    """`-quadlight P U V L`: two triangle lights with the reference's
    winding (renderer.cpp:1118-1141), (P+U+V, P+U, P) and
    (P+U+V, P, P+V)."""
    p = np.asarray(p, np.float64)
    u = np.asarray(dx, np.float64)
    v = np.asarray(dy, np.float64)
    sb.add_light(glights.triangle(p + u + v, p + u, p, L))
    sb.add_light(glights.triangle(p + u + v, p, p + v, L))


def cornell_camera(width: int = 512, height: int = 512):
    l2w = cam.look_at((278.0, 273.0, -800.0), (278.0, 273.0, 0.0),
                      (0.0, 1.0, 0.0))
    return cam.Pinhole(l2w, angle=37.0, aspect=width / height)


def cornell_stereo_camera(width: int = 64, height: int = 64,
                          face: int = 7):
    """One face of a production stereo rig inside the Cornell box (the
    stereo_64 golden; default face 7, the right face's right eye).  The
    rig sits inside the box, which is open at z < 0."""
    l2w = cam.look_at((278.0, 273.0, 150.0), (278.0, 273.0, 559.0),
                      (0.0, 1.0, 0.0))
    return cam.make_stereo_rig(l2w, scene_scale=10.0)[face]


def colonnade(cols_x: int = 8, cols_z: int = 4, tess=(16, 24),
              clutter: int = 24, seed: int = 7) -> SceneBuilder:
    """Sponza-scale procedural interior (~92k triangles at the defaults):
    a 20 x 6 x 10 hall with a grid of stacked sphere columns, random
    clutter spheres and two ceiling quad lights -- a deep BVH, heavy
    occlusion, coherent primaries and long shadow rays."""
    sb = SceneBuilder()
    rs = np.random.RandomState(seed)
    hx, hy, hz = 10.0, 3.0, 5.0
    white = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.70, 0.68, 0.64)}))
    red = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.55, 0.10, 0.08)}))
    blue = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.10, 0.18, 0.50)}))

    # floor / ceiling / walls (inward-facing)
    sb.add_mesh(_quad_mesh([-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz],
                           [-hx, 0, hz], white))
    sb.add_mesh(_quad_mesh([-hx, 2 * hy, -hz], [-hx, 2 * hy, hz],
                           [hx, 2 * hy, hz], [hx, 2 * hy, -hz], white))
    sb.add_mesh(_quad_mesh([-hx, 0, -hz], [-hx, 0, hz], [-hx, 2 * hy, hz],
                           [-hx, 2 * hy, -hz], red))
    sb.add_mesh(_quad_mesh([hx, 0, -hz], [hx, 2 * hy, -hz], [hx, 2 * hy, hz],
                           [hx, 0, hz], blue))
    sb.add_mesh(_quad_mesh([-hx, 0, -hz], [-hx, 2 * hy, -hz],
                           [hx, 2 * hy, -hz], [hx, 0, -hz], white))
    sb.add_mesh(_quad_mesh([-hx, 0, hz], [hx, 0, hz], [hx, 2 * hy, hz],
                           [-hx, 2 * hy, hz], white))

    nt, np_ = tess
    # columns: stacks of 3 spheres from floor to ceiling
    for x in np.linspace(-hx * 0.8, hx * 0.8, cols_x):
        for z in np.linspace(-hz * 0.7, hz * 0.7, cols_z):
            for k in range(3):
                sb.add_mesh(primitives.tessellate_sphere(
                    [x, 1.0 + 2.0 * k, z], 0.55, nt, np_, material=white))
    # clutter: random small spheres on the floor
    for _ in range(clutter):
        cx = rs.uniform(-hx * 0.9, hx * 0.9)
        cz = rs.uniform(-hz * 0.9, hz * 0.9)
        r = rs.uniform(0.15, 0.45)
        sb.add_mesh(primitives.tessellate_sphere(
            [cx, r, cz], r, nt, np_, material=(red, blue)[int(rs.rand() < .5)]))

    # two ceiling quad lights (long shadow rays through the columns)
    add_quad_light(sb, (-6.0, 2 * hy - 0.01, -1.0), (2.0, 0, 0), (0, 0, 2.0),
                   (40.0, 38.0, 34.0))
    add_quad_light(sb, (4.0, 2 * hy - 0.01, -1.0), (2.0, 0, 0), (0, 0, 2.0),
                   (34.0, 36.0, 40.0))
    return sb


def colonnade_camera(width: int = 1024, height: int = 1024):
    """Down-the-hall view: coherent primaries, deep occlusion."""
    l2w = cam.look_at((-9.0, 2.2, 0.0), (10.0, 1.6, 0.0), (0.0, 1.0, 0.0))
    return cam.Pinhole(l2w, angle=65.0, aspect=width / height)


def motion_field(n_spheres: int = 16, tess=(10, 12), seed: int = 11
                 ) -> SceneBuilder:
    """Motion-blur scene: a field of spheres, each moving at its own
    constant velocity (per-vertex linear motion), over a ground plane
    under a quad light; ~3.5k triangles at the defaults, so commit builds
    the union-bounds tree and the motion kernel traces it."""
    sb = SceneBuilder()
    rs = np.random.RandomState(seed)
    grey = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.6, 0.6, 0.6)}))
    hue = [sb.add_material(gmat.make_material('matte', {'reflectance': c}))
           for c in ((0.7, 0.2, 0.15), (0.2, 0.45, 0.7), (0.75, 0.65, 0.2))]
    sb.add_mesh(_quad_mesh([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8],
                           grey))
    nt, np_ = tess
    for i in range(n_spheres):
        c = [rs.uniform(-6, 6), rs.uniform(0.6, 2.5), rs.uniform(-6, 6)]
        m = primitives.tessellate_sphere(c, rs.uniform(0.3, 0.7), nt, np_,
                                         material=hue[i % 3])
        vel = rs.uniform(-2.5, 2.5, size=3).astype(np.float32)
        sb.add_mesh(dataclasses.replace(
            m, motions=np.tile(vel, (len(m.positions), 1))))
    add_quad_light(sb, (-1.5, 7.0, -1.5), (3.0, 0, 0), (0, 0, 3.0),
                   (60.0, 60.0, 60.0))
    return sb


def motion_field_camera(width: int = 512, height: int = 512):
    l2w = cam.look_at((0.0, 6.0, -10.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    return cam.Pinhole(l2w, angle=55.0, aspect=width / height)
