"""Built-in test and benchmark scenes.

Counterpart of `yulio_raytracer_tpu/io/builtin_scenes.py` (the cornell
box, the colonnade, the textured sponza_like atrium and the motion field
with their cameras, and the cornell stereo face): the same meshes,
materials, textures and lights in the same order, and the same random
draws in the same order, so both packages commit equal tables.
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


# the cornell box's two blocks, five quads each (top and four sides)
SHORT_BOX = ([130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114],
             [290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272],
             [130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114],
             [82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65],
             [240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225])
TALL_BOX = ([423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406],
            [423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406],
            [472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456],
            [314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296],
            [265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247])


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
        for verts in (SHORT_BOX, TALL_BOX):
            v = np.asarray(verts, np.float32)
            for q in range(0, 20, 4):
                sb.add_mesh(_quad_mesh(v[q], v[q + 1], v[q + 2], v[q + 3],
                                       white))

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


def _textured_quad(a, b, c, d, material, uv_scale=(1.0, 1.0)):
    pos = np.asarray([a, b, c, d], np.float32)
    su, sv = uv_scale
    uv = np.asarray([[0, 0], [su, 0], [su, sv], [0, sv]], np.float32)
    tri = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return HostMesh(pos, tri, texcoords=uv, material=material)


def _cylinder(base, radius, height, nseg, nh, material):
    """Open cylinder column (y-up), uv wrapped around the shaft."""
    base = np.asarray(base, np.float64)
    ph = np.arange(nseg + 1) * (2.0 * np.pi / nseg)
    ys = np.linspace(0.0, height, nh + 1)
    P = np.stack(np.meshgrid(ph, ys, indexing='xy'), axis=-1)  # (nh+1,ns+1,2)
    pos = np.stack([base[0] + radius * np.cos(P[..., 0]),
                    base[1] + P[..., 1],
                    base[2] + radius * np.sin(P[..., 0])],
                   axis=-1).reshape(-1, 3)
    nrm = np.stack([np.cos(P[..., 0]), np.zeros_like(P[..., 0]),
                    np.sin(P[..., 0])], axis=-1).reshape(-1, 3)
    uv = np.stack([P[..., 0] / (2.0 * np.pi) * 4.0,
                   P[..., 1] / max(height, 1e-9)], axis=-1).reshape(-1, 2)
    i = np.arange(nh)[:, None]
    j = np.arange(nseg)[None, :]
    v00 = i * (nseg + 1) + j
    v01 = v00 + 1
    v10 = v00 + (nseg + 1)
    v11 = v10 + 1
    t1 = np.stack([v00, v10, v01], axis=-1).reshape(-1, 3)
    t2 = np.stack([v01, v10, v11], axis=-1).reshape(-1, 3)
    return HostMesh(pos.astype(np.float32),
                    np.concatenate([t1, t2]).astype(np.int32),
                    nrm.astype(np.float32), uv.astype(np.float32),
                    material=material)


def _procedural_texture(rs, kind: int, res: int = 64) -> np.ndarray:
    """20 deterministic texture families: checkers, stripes, noise,
    gradients — stand-ins for Sponza's albedo atlas."""
    u, v = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                      indexing='xy')
    c0 = rs.uniform(0.2, 0.9, 3)
    c1 = rs.uniform(0.05, 0.8, 3)
    f = int(rs.randint(2, 9))
    m = kind % 5
    if m == 0:      # checker
        mask = ((u * f).astype(int) + (v * f).astype(int)) % 2
    elif m == 1:    # stripes
        mask = (u * f * 2).astype(int) % 2
    elif m == 2:    # smooth noise (few octaves of random harmonics)
        mask = np.zeros_like(u)
        for k in range(1, 4):
            a, b = rs.uniform(0, 2 * np.pi, 2)
            mask += np.sin(2 * np.pi * k * f * u / 3 + a) \
                * np.sin(2 * np.pi * k * f * v / 3 + b) / k
        mask = (mask - mask.min()) / max(np.ptp(mask), 1e-9)
    elif m == 3:    # radial gradient
        mask = np.clip(np.hypot(u - 0.5, v - 0.5) * 2, 0, 1)
    else:           # brick
        row = (v * f).astype(int)
        uu = u + (row % 2) * 0.5 / f
        mask = (((uu * f) % 1.0 > 0.08) & ((v * f) % 1.0 > 0.12))
    mask = np.asarray(mask, np.float64)[..., None]
    img = c0[None, None] * mask + c1[None, None] * (1 - mask)
    return img.astype(np.float32)


def sponza_like(stories: int = 2, cols_x: int = 10, cols_z: int = 4,
                clutter: int = 80, num_textures: int = 20,
                seed: int = 11) -> SceneBuilder:
    """Sponza-class textured benchmark scene (~260k triangles, 20
    textures): a two-story colonnaded atrium with textured floor, walls,
    column shafts, hanging banners and clutter.  Procedurally rebuilds
    the *load* of the reference's Sponza benchmark entry (models/
    directory; geometry blobs stripped from the mirror): deep BVH,
    heavy occlusion, and per-hit texture-atlas gathers at scale.
    Hall is 40 x (8*stories) x 20, centred on x/z."""
    sb = SceneBuilder()
    rs = np.random.RandomState(seed)
    tex = [sb.textures.add(_procedural_texture(rs, k))
           for k in range(num_textures)]

    def tex_mat(k, extra_scale=1.0):
        return sb.add_material(gmat.make_material(
            'mattetextured', {'ds': (extra_scale, extra_scale)},
            tex_id=tex[k % len(tex)]))

    hx, hz = 20.0, 10.0
    sh = 8.0                         # story height
    hy = sh * stories
    floor = tex_mat(0)
    wallm = [tex_mat(1), tex_mat(2), tex_mat(3), tex_mat(4)]
    ceil = sb.add_material(gmat.make_material(
        'matte', {'reflectance': (0.8, 0.78, 0.75)}))

    sb.add_mesh(_textured_quad([-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz],
                               [-hx, 0, hz], floor, uv_scale=(16, 8)))
    sb.add_mesh(_textured_quad([-hx, hy, -hz], [-hx, hy, hz],
                               [hx, hy, hz], [hx, hy, -hz], ceil))
    sb.add_mesh(_textured_quad([-hx, 0, -hz], [-hx, 0, hz],
                               [-hx, hy, hz], [-hx, hy, -hz],
                               wallm[0], uv_scale=(8, 4)))
    sb.add_mesh(_textured_quad([hx, 0, -hz], [hx, hy, -hz], [hx, hy, hz],
                               [hx, 0, hz], wallm[1], uv_scale=(8, 4)))
    sb.add_mesh(_textured_quad([-hx, 0, -hz], [-hx, hy, -hz],
                               [hx, hy, -hz], [hx, 0, -hz],
                               wallm[2], uv_scale=(16, 4)))
    sb.add_mesh(_textured_quad([-hx, 0, hz], [hx, 0, hz], [hx, hy, hz],
                               [-hx, hy, hz], wallm[3], uv_scale=(16, 4)))

    xs = np.linspace(-hx * 0.82, hx * 0.82, cols_x)
    zs = np.linspace(-hz * 0.72, hz * 0.72, cols_z)
    for s in range(stories):
        y0 = s * sh
        for ci, x in enumerate(xs):
            for cj, z in enumerate(zs):
                shaft = tex_mat(5 + (ci + cj + s) % 10)
                sb.add_mesh(_cylinder([x, y0 + 0.4, z], 0.45, sh - 1.6,
                                      64, 12, shaft))
                # capital + base (untextured spheres)
                cap = sb.add_material(gmat.make_material(
                    'plastic', {'pigmentColor': tuple(
                        rs.uniform(0.4, 0.8, 3))}))
                sb.add_mesh(primitives.tessellate_sphere(
                    [x, y0 + sh - 1.0, z], 0.62, 10, 20, material=cap))
                sb.add_mesh(primitives.tessellate_sphere(
                    [x, y0 + 0.25, z], 0.62, 10, 20, material=cap))
        # story floor slabs between columns (walkway ring)
        if s > 0:
            ring = tex_mat(15 + s)
            sb.add_mesh(_textured_quad(
                [-hx, y0, -hz], [hx, y0, -hz],
                [hx, y0, -hz * 0.55], [-hx, y0, -hz * 0.55],
                ring, uv_scale=(16, 2)))
            sb.add_mesh(_textured_quad(
                [-hx, y0, hz * 0.55], [hx, y0, hz * 0.55],
                [hx, y0, hz], [-hx, y0, hz], ring, uv_scale=(16, 2)))

    # hanging banners down the hall (thin textured quads)
    for k in range(16):
        bx = rs.uniform(-hx * 0.7, hx * 0.7)
        bz = rs.uniform(-hz * 0.5, hz * 0.5)
        top = hy - 0.5
        wdt, hgt = 1.2, 3.0
        sb.add_mesh(_textured_quad(
            [bx - wdt / 2, top - hgt, bz], [bx + wdt / 2, top - hgt, bz],
            [bx + wdt / 2, top, bz], [bx - wdt / 2, top, bz],
            tex_mat(k % num_textures)))

    for _ in range(clutter):
        cx = rs.uniform(-hx * 0.9, hx * 0.9)
        cz = rs.uniform(-hz * 0.9, hz * 0.9)
        r = rs.uniform(0.2, 0.6)
        sb.add_mesh(primitives.tessellate_sphere(
            [cx, r, cz], r, 16, 24,
            material=tex_mat(int(rs.randint(num_textures)))))

    add_quad_light(sb, (-12.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                   (60.0, 57.0, 51.0))
    add_quad_light(sb, (2.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                   (51.0, 54.0, 60.0))
    add_quad_light(sb, (12.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                   (57.0, 60.0, 54.0))
    return sb


def sponza_like_camera(width: int = 1024, height: int = 1024):
    """Down-the-atrium view through both column rows."""
    l2w = cam.look_at((-18.5, 4.0, 0.0), (20.0, 3.2, 0.0), (0.0, 1.0, 0.0))
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
