"""The stereo test field staged in the port as its own loaders stage
test_stereo.ecs (io/xml_scene.py, io/ecs.py): each material through
make_material by its preset's name, the map once in the atlas (bilinear),
the meshes as HostMesh, the lights in their order (the HDRI, then the
ambient dome); the camera a face of the rig `-stereo` builds at the
view's camera (api/cli.py stereo_rigs); PTParams as
api/output.params_from_settings makes them from the view's settings.
Public API only; the rest is port.py's."""
from __future__ import annotations

from portbench import port


def commit(desc: dict, device, leaf_size: int):
    from yulio_raytracer_tpu_torch.geometry.mesh import HostMesh
    from yulio_raytracer_tpu_torch.lights import lights as glights
    from yulio_raytracer_tpu_torch.scene import SceneBuilder
    from yulio_raytracer_tpu_torch.shading import materials as gmat
    from yulio_raytracer_tpu_torch.shading import textures as gtex

    sb = SceneBuilder()
    tex_ids = [sb.textures.add(img, gtex.FILTER_BILINEAR)
               for img in desc['textures']]
    for m in desc['materials']:
        parms = {k: v for k, v in m.items() if k not in ('type', 'texture')}
        tid = tex_ids[m['texture']] if 'texture' in m else -1
        sb.add_material(gmat.make_material(m['type'], parms, tex_id=tid))
    for m in desc['meshes']:
        sb.add_mesh(HostMesh(m['positions'], m['triangles'], m['normals'],
                             m['texcoords'], material=m['material']))
    for light in desc['lights']:
        if light['kind'] == 'hdri':
            sb.add_light(glights.hdri(light['image'], light['L'],
                                      light['local2world']))
        else:
            sb.add_light(glights.ambient(light['L']))
    # the production path commits with its settings' accel, 'default'
    return sb.commit(device=device, leaf_size=leaf_size, accel='default')


def camera(spec: dict, width: int, height: int):
    """Face spec['face'] of the rig at spec's camera, with its eye
    separation, zero parallax and toe-in."""
    from yulio_raytracer_tpu_torch.cameras import cameras as cam
    if spec['kind'] != 'stereo_cube':
        return port.camera(spec, width, height)
    l2w = cam.look_at(spec['eye'], spec['look'], spec['up'])
    return cam.make_stereo_rig(
        l2w, up=tuple(spec['up']), scene_scale=spec['scene_scale'],
        eye_separation=spec['eye_separation'],
        zero_parallax=spec['zero_parallax'],
        toe_in=spec['toe_in'])[spec['face']]


def params(config: dict, traffic: dict):
    """The traffic's depth; the view's shadow cap, its jitter, the
    minimum contribution and its up (-vu)."""
    from yulio_raytracer_tpu_torch.integrator.pathtracer import PTParams
    return PTParams(max_depth=traffic['max_depth'],
                    min_contribution=config['min_contribution'],
                    t_max_shadow_ray=config['t_max_shadow_ray'],
                    t_max_shadow_jitter=config['t_max_shadow_jitter'],
                    up=tuple(float(x) for x in config['up']))


def span_names() -> dict:
    """port.py's ranges, and the lobes', the environment's and the
    camera rays'."""
    from yulio_raytracer_tpu_torch.utils import profiling as prof
    return dict(port.span_names(), lobes=prof.LOBES, env=prof.ENV,
                raygen=prof.RAYGEN)
