"""The materials probe: the cornell box with both blocks in one material
preset, bound to a 16^2 procedural texture, built through either package
(the JAX reference or the torch port) from that package's own modules.

The block faces carry uvs over [0, 2]^2, so the fetch wraps; the camera
is the package's cornell_camera."""
import numpy as np

from yulio_raytracer_tpu_torch.io.builtin_scenes import SHORT_BOX, TALL_BOX

# a material preset of each of the reference's 14 types, with parameters
# that reach its lobes' branches
PROBE_PRESETS = {
    'matte': {'reflectance': (0.6, 0.5, 0.4)},
    'mattetextured': {'ds': (2.0, 3.0), 's0': (0.25, 0.5)},
    'plastic': {'pigmentColor': (0.7, 0.2, 0.2), 'roughness': 0.05},
    'dielectric': {'etaInside': 1.5, 'transmission': (0.9, 0.8, 0.7)},
    'glass': {},
    'thindielectric': {'transmission': (0.8, 0.9, 0.7), 'transparency': 0.7,
                       'thickness': 0.2},
    'thinglass': {'eta': 1.3},
    'mirror': {'reflectance': (0.9, 0.9, 0.8)},
    'metal': {'reflectance': (0.9, 0.7, 0.4), 'eta': (0.2, 0.9, 1.1),
              'k': (3.9, 2.4, 2.2), 'roughness': 0.1},
    'brushedmetal': {'reflectance': (0.8, 0.8, 0.8), 'roughnessX': 0.05,
                     'roughnessY': 0.3},
    'metallicpaint': {'shadeColor': (0.3, 0.1, 0.1),
                      'glitterColor': (0.8, 0.8, 0.6), 'glitterSpread': 0.2},
    'uber': {'diffuse': (0.6, 0.6, 0.3), 'roughness': 0.2},
    'obj': {'d': 0.8, 'Kd': (0.6, 0.4, 0.3), 'Ks': (0.3, 0.3, 0.3),
            'Ns': 40.0},
    'velvet': {'reflectance': (0.5, 0.2, 0.3), 'backScattering': 0.6,
               'horizonScatteringColor': (0.9, 0.8, 0.9),
               'horizonScatteringFallOff': 3.0},
}


def materials_probe(preset, builtin_scenes, materials, mesh):
    """The probe's SceneBuilder in preset, from one package's
    builtin_scenes, shading.materials and geometry.mesh modules."""
    sb = builtin_scenes.cornell_box(with_boxes=False)
    tid = sb.textures.add(builtin_scenes._procedural_texture(
        np.random.RandomState(3), 0, res=16))
    m = sb.add_material(materials.make_material(
        preset, PROBE_PRESETS[preset], tex_id=tid))
    uv = np.float32([[0, 0], [2, 0], [2, 2], [0, 2]])
    for verts in (SHORT_BOX, TALL_BOX):
        v = np.asarray(verts, np.float32)
        for q in range(0, 20, 4):
            sb.add_mesh(mesh.HostMesh(
                v[q:q + 4], np.int32([[0, 1, 2], [0, 2, 3]]), texcoords=uv,
                material=m))
    return sb
