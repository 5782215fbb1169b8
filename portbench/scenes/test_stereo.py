"""The reference renderer's stereo test field (models/test_stereo.xml, the
scene test_stereo.ecs renders; assets/scenes/test_stereo.xml in this
repository) as plain data, in the order its XML loader stages it:

  three MetallicPaint spheres (numTheta = numPhi = 50; eta 1.45; red at
  (0, 100, 300) r 10, green at (0, 800, 10000) r 100, blue at (0, 0, 150)
  r 10), an Uber billboard (Kd lines.ppm, s0 0 0, ds 1 1) over x in
  [-100, 100], y in [0, 100] at z = 100, a MatteTextured ground (lines.ppm,
  s0 0 0, ds 1 1) over [-1000, 1000]^2 at y = 0, and an HDRILight (lines.ppm,
  L 0, identity AffineSpace); then test_stereo_view.ecs's ambient light
  (.83, .95, .98).

The description adds to the keys of scenes/__init__.py:
  materials   {'type': 'metallicpaint', 'eta', 'shadeColor'} |
              {'type': 'uber', 'texture', 's0', 'ds'} |
              {'type': 'mattetextured', 'texture', 's0', 'ds'}
  lights      in the loaders' order: {'kind': 'hdri', 'image' (H, W, 3)
              f32, 'L' (3,), 'local2world' (4, 3) rows [vx; vy; vz; p]},
              {'kind': 'ambient', 'L' (3,)}
and leaves quad_lights empty.  The scene is fixed: the seed is unused.
"""
from __future__ import annotations

import os

import numpy as np

from portbench.scenes.procedural import _mesh, sphere

HERE = os.path.dirname(os.path.abspath(__file__))
TEXTURE = os.path.join(HERE, 'lines.ppm')
# the CPU tests' reduced spheres
TINY = {'tess': [8, 8]}
AMBIENT = (0.83, 0.95, 0.98)
SPHERES = (((0.0, 100.0, 300.0), 10.0, (1.0, 0.0, 0.0)),
           ((0.0, 800.0, 10000.0), 100.0, (0.0, 1.0, 0.0)),
           ((0.0, 0.0, 150.0), 10.0, (0.0, 0.0, 1.0)))
PAINT_ETA = 1.45


def read_ppm(path: str) -> np.ndarray:
    """A binary (P6) PPM as (H, W, 3) float32, each byte / maxval (the
    port's io/image.py reading)."""
    with open(path, 'rb') as f:
        raw = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while raw[pos:pos + 1].isspace():
            pos += 1
        if raw[pos:pos + 1] == b'#':
            pos = raw.index(b'\n', pos) + 1
            continue
        end = pos
        while not raw[end:end + 1].isspace():
            end += 1
        fields.append(raw[pos:end])
        pos = end
    if fields[0] != b'P6':
        raise ValueError(f"{path}: not a binary PPM")
    w, h, maxval = (int(x) for x in fields[1:])
    data = np.frombuffer(raw, np.uint8, count=w * h * 3, offset=pos + 1)
    return data.reshape(h, w, 3).astype(np.float32) / maxval


def _loaded_normals(n):
    """Normals as the XML loader bakes its (identity, float32) transform
    into a mesh: times the inverse, renormalized (HostMesh.transformed),
    all in float32."""
    eye = np.eye(3, dtype=np.float32)
    n = np.asarray(n, np.float32) @ np.linalg.inv(eye)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                           1e-20)).astype(np.float32)


def _quad(positions, normal, material):
    return _mesh(positions, [[0, 1, 2], [2, 3, 0]], material,
                 normals=_loaded_normals([normal] * 4),
                 texcoords=[[0, 0], [1, 0], [1, 1], [0, 1]])


def generate(seed=0, tess=(50, 50), hdri_L=(0.0, 0.0, 0.0)):
    """The scene: tess, the spheres' (numTheta, numPhi); hdri_L, the
    HDRI's radiance scale (0 as the source has it)."""
    del seed
    image = read_ppm(TEXTURE)
    meshes, materials = [], []
    for center, radius, color in SPHERES:
        m = sphere(center, radius, tess[0], tess[1], len(materials))
        m['normals'] = _loaded_normals(m['normals'])
        meshes.append(m)
        materials.append({'type': 'metallicpaint', 'eta': PAINT_ETA,
                          'shadeColor': color})
    materials.append({'type': 'uber', 'texture': 0, 's0': (0.0, 0.0),
                      'ds': (1.0, 1.0)})
    meshes.append(_quad([[-100, 0, 100], [100, 0, 100], [100, 100, 100],
                         [-100, 100, 100]], [0, 0, 1], len(materials) - 1))
    materials.append({'type': 'mattetextured', 'texture': 0,
                      's0': (0.0, 0.0), 'ds': (1.0, 1.0)})
    meshes.append(_quad([[-1000, 0, -1000], [1000, 0, -1000],
                         [1000, 0, 1000], [-1000, 0, 1000]], [0, 1, 0],
                        len(materials) - 1))
    identity = np.concatenate([np.eye(3), np.zeros((1, 3))]).astype(
        np.float32)
    lights = [{'kind': 'hdri', 'image': image,
               'L': np.asarray(hdri_L, np.float32), 'local2world': identity},
              {'kind': 'ambient', 'L': np.asarray(AMBIENT, np.float32)}]
    return {'meshes': meshes, 'materials': materials, 'textures': [image],
            'lights': lights, 'quad_lights': []}
