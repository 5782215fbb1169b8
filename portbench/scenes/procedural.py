"""Frozen copies of the port's procedural benchmark scenes
(`yulio_raytracer_tpu_torch/io/builtin_scenes.py` colonnade and
sponza_like, with `geometry/primitives.py` tessellate_sphere): the same
meshes, materials, textures and lights in the same order, with the
random draws taken from a seed given (the port's scenes are seeds 7 and
11).  The counts of triangles, materials and textures depend on the
parameters alone, never on the seed.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(int(seed) % (2 ** 32))


def _mesh(positions, triangles, material, normals=None, texcoords=None):
    return {'positions': np.asarray(positions, np.float32),
            'triangles': np.asarray(triangles, np.int32),
            'normals': (None if normals is None
                        else np.asarray(normals, np.float32)),
            'texcoords': (None if texcoords is None
                          else np.asarray(texcoords, np.float32)),
            'material': int(material)}


def _quad(a, b, c, d, material, uv_scale=None):
    pos = np.asarray([a, b, c, d], np.float32)
    uv = None
    if uv_scale is not None:
        su, sv = uv_scale
        uv = np.asarray([[0, 0], [su, 0], [su, sv], [0, sv]], np.float32)
    return _mesh(pos, [[0, 1, 2], [0, 2, 3]], material, texcoords=uv)


def _sphere_eval(theta, phi):
    return np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                     np.sin(theta) * np.sin(phi)], axis=-1)


def sphere(center, radius, num_theta: int, num_phi: int, material):
    """Sphere::triangulate's mesh: per-vertex normals from the
    parameterization's derivatives, (phi, theta) texcoords."""
    center = np.asarray(center, np.float32)
    nt, nph = num_theta, num_phi
    itv = np.arange(nt + 1, dtype=np.float64)[:, None]
    ipv = np.arange(nph, dtype=np.float64)[None, :]
    th, ph = np.broadcast_arrays(itv * np.pi / nt, ipv * 2.0 * np.pi / nph)
    th_u = np.broadcast_to((itv + 0.001) * np.pi / nt, th.shape)
    ph_v = np.broadcast_to((ipv + 0.001) * 2.0 * np.pi / nph, ph.shape)
    p = _sphere_eval(th, ph)
    dpdu = _sphere_eval(th_u, ph) - p
    dpdv = _sphere_eval(th, ph_v) - p
    positions = (radius * p + center).reshape(-1, 3)
    n = np.cross(dpdv, dpdu)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    texcoords = np.stack(np.broadcast_arrays(ipv / nph, itv / nt),
                         axis=-1).reshape(-1, 2)
    iti = np.arange(1, nt + 1, dtype=np.int64)[:, None]
    ipi = np.arange(1, nph + 1, dtype=np.int64)[None, :]
    p00 = (iti - 1) * nph + ipi - 1
    p01 = (iti - 1) * nph + ipi % nph
    p10 = iti * nph + ipi - 1
    p11 = iti * nph + ipi % nph
    both = np.stack([np.stack([p10, p00, p01], axis=-1),
                     np.stack([p11, p10, p01], axis=-1)],
                    axis=2).reshape(nt, nph * 2, 3)
    keep = np.stack([np.broadcast_to(iti > 1, p00.shape),
                     np.broadcast_to(iti < nt, p00.shape)],
                    axis=2).reshape(nt, nph * 2)
    return _mesh(positions, both[keep], material, n.reshape(-1, 3),
                 texcoords)


def _cylinder(base, radius, height, nseg, nh, material):
    """Open y-up column, uv wrapped four times around the shaft."""
    base = np.asarray(base, np.float64)
    ph = np.arange(nseg + 1) * (2.0 * np.pi / nseg)
    ys = np.linspace(0.0, height, nh + 1)
    P = np.stack(np.meshgrid(ph, ys, indexing='xy'), axis=-1)
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
    return _mesh(pos, np.concatenate([t1, t2]), material, nrm, uv)


def _texture(rs, kind: int, res: int = 64) -> np.ndarray:
    """One of five texture families (checker, stripes, smooth noise,
    radial gradient, brick) in two random colours, res x res; built
    from a row and a column where the family allows."""
    u = np.linspace(0, 1, res)[None, :]           # varies along x
    v = np.linspace(0, 1, res)[:, None]           # varies along y
    c0 = rs.uniform(0.2, 0.9, 3)
    c1 = rs.uniform(0.05, 0.8, 3)
    f = int(rs.randint(2, 9))
    m = kind % 5
    if m == 0:
        mask = ((u * f).astype(int) + (v * f).astype(int)) % 2
    elif m == 1:
        mask = np.broadcast_to((u * f * 2).astype(int) % 2, (res, res))
    elif m == 2:
        mask = np.zeros((res, res))
        for k in range(1, 4):
            a, b = rs.uniform(0, 2 * np.pi, 2)
            mask += np.sin(2 * np.pi * k * f * u / 3 + a) \
                * (np.sin(2 * np.pi * k * f * v / 3 + b) / k)
        mask = (mask - mask.min()) / max(np.ptp(mask), 1e-9)
    elif m == 3:
        mask = np.clip(np.hypot(u - 0.5, v - 0.5) * 2, 0, 1)
    else:
        row = (v * f).astype(int)
        uu = u + (row % 2) * 0.5 / f
        mask = (((uu * f) % 1.0 > 0.08) & ((v * f) % 1.0 > 0.12))
    mask = np.asarray(mask, np.float32)[..., None]
    c0, c1 = c0.astype(np.float32), c1.astype(np.float32)
    return c1 + (c0 - c1) * mask


def _light(p, dx, dy, L):
    return {'p': np.asarray(p, np.float64), 'dx': np.asarray(dx, np.float64),
            'dy': np.asarray(dy, np.float64), 'L': np.asarray(L, np.float32)}


def colonnade(seed: int, cols_x: int = 8, cols_z: int = 4, tess=(16, 24),
              clutter: int = 24, roof_opening: float = 0.0,
              quad_lights: bool = True, ambient=None) -> dict:
    """A 20 x 6 x 10 hall: a grid of stacked sphere columns, clutter
    spheres on the floor (positions, radii and colours from the seed)
    and two ceiling quad lights; 86,416 triangles at the defaults (the
    port's scene).  roof_opening > 0 opens that share of the roof's
    depth, centred over the nave, to the sky (the roof then is two
    strips); quad_lights=False leaves the quad lights out; ambient, an
    rgb, adds the dome (an ambient light) of that radiance."""
    rs = _rng(seed)
    hx, hy, hz = 10.0, 3.0, 5.0
    mats = [{'type': 'matte', 'reflectance': (0.70, 0.68, 0.64)},
            {'type': 'matte', 'reflectance': (0.55, 0.10, 0.08)},
            {'type': 'matte', 'reflectance': (0.10, 0.18, 0.50)}]
    white, red, blue = 0, 1, 2
    if roof_opening > 0:
        zo = hz * roof_opening
        roof = [_quad([-hx, 2 * hy, -hz], [-hx, 2 * hy, -zo],
                      [hx, 2 * hy, -zo], [hx, 2 * hy, -hz], white),
                _quad([-hx, 2 * hy, zo], [-hx, 2 * hy, hz], [hx, 2 * hy, hz],
                      [hx, 2 * hy, zo], white)]
    else:
        roof = [_quad([-hx, 2 * hy, -hz], [-hx, 2 * hy, hz], [hx, 2 * hy, hz],
                      [hx, 2 * hy, -hz], white)]
    meshes = [
        _quad([-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz], white),
        *roof,
        _quad([-hx, 0, -hz], [-hx, 0, hz], [-hx, 2 * hy, hz],
              [-hx, 2 * hy, -hz], red),
        _quad([hx, 0, -hz], [hx, 2 * hy, -hz], [hx, 2 * hy, hz],
              [hx, 0, hz], blue),
        _quad([-hx, 0, -hz], [-hx, 2 * hy, -hz], [hx, 2 * hy, -hz],
              [hx, 0, -hz], white),
        _quad([-hx, 0, hz], [hx, 0, hz], [hx, 2 * hy, hz],
              [-hx, 2 * hy, hz], white)]
    nt, np_ = tess
    for x in np.linspace(-hx * 0.8, hx * 0.8, cols_x):
        for z in np.linspace(-hz * 0.7, hz * 0.7, cols_z):
            for k in range(3):
                meshes.append(sphere([x, 1.0 + 2.0 * k, z], 0.55, nt, np_,
                                     white))
    for _ in range(clutter):
        cx = rs.uniform(-hx * 0.9, hx * 0.9)
        cz = rs.uniform(-hz * 0.9, hz * 0.9)
        r = rs.uniform(0.15, 0.45)
        meshes.append(sphere([cx, r, cz], r, nt, np_,
                             (red, blue)[int(rs.rand() < .5)]))
    lights = [_light((-6.0, 2 * hy - 0.01, -1.0), (2.0, 0, 0), (0, 0, 2.0),
                     (40.0, 38.0, 34.0)),
              _light((4.0, 2 * hy - 0.01, -1.0), (2.0, 0, 0), (0, 0, 2.0),
                     (34.0, 36.0, 40.0))]
    return {'meshes': meshes, 'materials': mats, 'textures': [],
            'quad_lights': lights if quad_lights else [],
            'ambient': None if ambient is None else np.asarray(ambient,
                                                               np.float32)}


def sponza_like(seed: int, stories: int = 2, cols_x: int = 10,
                cols_z: int = 4, clutter: int = 80, num_textures: int = 20,
                shaft=(64, 12), cap_tess=(10, 20),
                clutter_tess=(16, 24), texture_size: int = 64,
                shared_materials: bool = False) -> dict:
    """A two-story textured atrium, 40 x 16 x 20: textured floor, walls,
    column shafts, walkways, banners and clutter, plastic capitals and
    bases, three ceiling quad lights; 238,134 triangles (238,208 packed
    to rows of 128), 269 materials and 20 textures of 64^2 at the
    defaults (the port's scene).  texture_size sets each texture's
    side.  shared_materials=True gives each texture one material (the
    ceiling takes the last texture) and every capital and base one
    plastic: num_textures + 1 materials.  Texture colours, capital
    colours, banner and clutter placement come from the seed."""
    rs = _rng(seed)
    textures = [_texture(rs, k, texture_size) for k in range(num_textures)]
    mats = []

    def add(m):
        mats.append(m)
        return len(mats) - 1

    shared = ([add({'type': 'mattetextured', 'texture': k})
               for k in range(num_textures)] if shared_materials else None)

    def tex_mat(k):
        if shared is not None:
            return shared[k % num_textures]
        return add({'type': 'mattetextured', 'texture': k % num_textures})

    def plastic():
        return add({'type': 'plastic', 'pigmentColor': tuple(
            float(c) for c in rs.uniform(0.4, 0.8, 3))})

    hx, hz = 20.0, 10.0
    sh = 8.0
    hy = sh * stories
    floor = tex_mat(0)
    wallm = [tex_mat(1), tex_mat(2), tex_mat(3), tex_mat(4)]
    ceil = (tex_mat(num_textures - 1) if shared is not None else
            add({'type': 'matte', 'reflectance': (0.8, 0.78, 0.75)}))
    capital = plastic() if shared is not None else None
    meshes = [
        _quad([-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz], floor,
              (16, 8)),
        _quad([-hx, hy, -hz], [-hx, hy, hz], [hx, hy, hz], [hx, hy, -hz],
              ceil, (1, 1)),
        _quad([-hx, 0, -hz], [-hx, 0, hz], [-hx, hy, hz], [-hx, hy, -hz],
              wallm[0], (8, 4)),
        _quad([hx, 0, -hz], [hx, hy, -hz], [hx, hy, hz], [hx, 0, hz],
              wallm[1], (8, 4)),
        _quad([-hx, 0, -hz], [-hx, hy, -hz], [hx, hy, -hz], [hx, 0, -hz],
              wallm[2], (16, 4)),
        _quad([-hx, 0, hz], [hx, 0, hz], [hx, hy, hz], [-hx, hy, hz],
              wallm[3], (16, 4))]
    xs = np.linspace(-hx * 0.82, hx * 0.82, cols_x)
    zs = np.linspace(-hz * 0.72, hz * 0.72, cols_z)
    for s in range(stories):
        y0 = s * sh
        for ci, x in enumerate(xs):
            for cj, z in enumerate(zs):
                shaft_mat = tex_mat(5 + (ci + cj + s) % 10)
                meshes.append(_cylinder([x, y0 + 0.4, z], 0.45, sh - 1.6,
                                        *shaft, shaft_mat))
                cap = capital if capital is not None else plastic()
                meshes.append(sphere([x, y0 + sh - 1.0, z], 0.62, *cap_tess,
                                     cap))
                meshes.append(sphere([x, y0 + 0.25, z], 0.62, *cap_tess,
                                     cap))
        if s > 0:
            ring = tex_mat(15 + s)
            meshes.append(_quad([-hx, y0, -hz], [hx, y0, -hz],
                                [hx, y0, -hz * 0.55], [-hx, y0, -hz * 0.55],
                                ring, (16, 2)))
            meshes.append(_quad([-hx, y0, hz * 0.55], [hx, y0, hz * 0.55],
                                [hx, y0, hz], [-hx, y0, hz], ring, (16, 2)))
    for k in range(16):
        bx = rs.uniform(-hx * 0.7, hx * 0.7)
        bz = rs.uniform(-hz * 0.5, hz * 0.5)
        top = hy - 0.5
        wdt, hgt = 1.2, 3.0
        meshes.append(_quad(
            [bx - wdt / 2, top - hgt, bz], [bx + wdt / 2, top - hgt, bz],
            [bx + wdt / 2, top, bz], [bx - wdt / 2, top, bz],
            tex_mat(k % num_textures), (1, 1)))
    for _ in range(clutter):
        cx = rs.uniform(-hx * 0.9, hx * 0.9)
        cz = rs.uniform(-hz * 0.9, hz * 0.9)
        r = rs.uniform(0.2, 0.6)
        meshes.append(sphere([cx, r, cz], r, *clutter_tess,
                             tex_mat(int(rs.randint(num_textures)))))
    lights = [_light((-12.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                     (60.0, 57.0, 51.0)),
              _light((2.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                     (51.0, 54.0, 60.0)),
              _light((12.0, hy - 0.02, -2.0), (3.0, 0, 0), (0, 0, 3.0),
                     (57.0, 60.0, 54.0))]
    return {'meshes': meshes, 'materials': mats, 'textures': textures,
            'quad_lights': lights}
