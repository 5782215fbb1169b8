"""The system under test: yulio_raytracer_tpu_torch, reached through its
public API only (SceneBuilder and commit, the cameras, PTParams,
render_frame, the film and the tonemapper).  The port is imported
inside the functions, so that loading this module imports nothing.
"""
from __future__ import annotations

import numpy as np


def commit(desc: dict, device, leaf_size: int):
    """Stage a plain scene description (portbench/scenes) in the port's
    SceneBuilder and commit it on `device`."""
    from yulio_raytracer_tpu_torch.geometry.mesh import HostMesh
    from yulio_raytracer_tpu_torch.lights import lights as glights
    from yulio_raytracer_tpu_torch.scene import SceneBuilder
    from yulio_raytracer_tpu_torch.shading import materials as gmat

    sb = SceneBuilder()
    tex_ids = [sb.textures.add(img) for img in desc['textures']]
    for m in desc['materials']:
        if m['type'] == 'mattetextured':
            spec = gmat.make_material('mattetextured', {},
                                      tex_id=tex_ids[m['texture']])
        else:
            spec = gmat.make_material(
                m['type'], {k: v for k, v in m.items() if k != 'type'})
        sb.add_material(spec)
    for m in desc['meshes']:
        sb.add_mesh(HostMesh(m['positions'], m['triangles'], m['normals'],
                             m['texcoords'], material=m['material']))
    for q in desc['quad_lights']:
        p, u, v = q['p'], q['dx'], q['dy']
        sb.add_light(glights.triangle(p + u + v, p + u, p, q['L']))
        sb.add_light(glights.triangle(p + u + v, p, p + v, q['L']))
    if desc.get('ambient') is not None:
        sb.add_light(glights.ambient(desc['ambient']))
    return sb.commit(device=device, leaf_size=leaf_size)


def camera(spec: dict, width: int, height: int):
    """The port's camera for a configuration's camera entry: a pinhole
    ({'kind': 'pinhole', 'eye', 'look', 'up', 'fov'}) or one StereoCube
    face ({'kind': 'stereo_cube', 'eye', 'look', 'up', 'face',
    'scene_scale'})."""
    from yulio_raytracer_tpu_torch.cameras import cameras as cam
    l2w = cam.look_at(spec['eye'], spec['look'], spec['up'])
    if spec['kind'] == 'pinhole':
        return cam.Pinhole(l2w, angle=spec['fov'], aspect=width / height)
    if spec['kind'] == 'stereo_cube':
        return cam.make_stereo_rig(
            l2w, scene_scale=spec['scene_scale'])[spec['face']]
    raise ValueError(f"unknown camera kind {spec['kind']!r}")


def params(config: dict, traffic: dict):
    """PTParams of a cell: the traffic's max_depth and the
    configuration's shadow cap (null: no cap), every other field at the
    port's default."""
    from yulio_raytracer_tpu_torch.integrator.pathtracer import PTParams
    cap = config.get('t_max_shadow_ray')
    return PTParams(max_depth=traffic['max_depth'],
                    t_max_shadow_ray=float('inf') if cap is None else cap)


def render(scene, cam, prm, traffic: dict, seed: int, film=None,
           iteration: int = 0):
    """One render_frame call of the traffic's frame or refinement;
    returns (film, FrameStats)."""
    from yulio_raytracer_tpu_torch import renderer
    w, h = traffic['width'], traffic['height']
    return renderer.render_frame(
        scene, cam, prm, w, h, spp=traffic['spp'], seed=seed,
        compaction=traffic['compaction'],
        pixel_filter=traffic['pixel_filter'], film=film,
        iteration=iteration, accumulate=film is not None)


def present(film, gamma: float) -> np.ndarray:
    """The viewer's image of a film: resolved, tonemapped, quantized to
    8 bits and copied to the host, (H, W, 3) uint8."""
    from yulio_raytracer_tpu_torch.film import accum, tonemap
    return tonemap.to_srgb_u8(tonemap.tonemap(
        accum.resolve(film), gamma=gamma)).cpu().numpy()


def span_names() -> dict:
    """The port's profiler ranges that per-layer metrics read: the
    texture fetch and the light samples."""
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.shading import textures as gtex
    return {'fetch': gtex.SPAN_FETCH, 'lights': pt.SPAN_LIGHTS}
