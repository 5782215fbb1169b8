"""Frozen scene generators: each returns a plain scene description
(numpy arrays and numbers, no object of the port), drawn from a seed.

A description is a dict:
  meshes       [{'positions' (V, 3) f32, 'triangles' (T, 3) i32,
                 'normals' (V, 3) f32 | None, 'texcoords' (V, 2) f32 |
                 None, 'material' int}]
  materials    [{'type': 'matte', 'reflectance': (3,)} |
                {'type': 'mattetextured', 'texture': int} |
                {'type': 'plastic', 'pigmentColor': (3,)}]
  textures     [(H, W, 3) f32 images, bilinear, wrapped]
  quad_lights  [{'p', 'dx', 'dy', 'L'}: each two triangle lights
                (p+dx+dy, p+dx, p) and (p+dx+dy, p, p+dy)]
  ambient      (3,) f32 radiance of the dome (an ambient light); None
               or absent for none
The port gets it through its SceneBuilder (portbench/port.py), the
plain reference reads it directly (portbench/reference/scene.py).  A
generator of scenes/<name>.py may add keys of its own; its
configuration then names its own reference and adapter, which read
them (portbench/spec.py).
"""
from types import SimpleNamespace

from .. import spec
from .procedural import colonnade, sponza_like

GENERATORS = {'colonnade': colonnade, 'sponza_like': sponza_like}


def num_triangles(desc) -> int:
    """The scene's triangles, the two of each quad light included."""
    return (sum(len(m['triangles']) for m in desc['meshes'])
            + 2 * len(desc['quad_lights']))


def generator(name: str):
    """The generator a configuration's "generator" names, with its
    generate(seed, **params), num_triangles(desc) and TINY (the CPU
    tests' reduced params; None for the frozen two): a frozen one of
    GENERATORS, else scenes/<name>.py loaded by path, whose
    num_triangles defaults to this module's."""
    if name in GENERATORS:
        return SimpleNamespace(generate=GENERATORS[name],
                               num_triangles=num_triangles, TINY=None)
    mod = spec.load('scenes', name)
    return SimpleNamespace(
        generate=mod.generate, TINY=mod.TINY,
        num_triangles=getattr(mod, 'num_triangles', num_triangles))
