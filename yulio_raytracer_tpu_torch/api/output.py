"""Output mode: the mono frame and the stereoscopic cube-map pipelines.

Counterpart of `yulio_raytracer_tpu/api/output.py`: the function
equivalents of `renderer.cpp` outputMode (:508-905): render, tonemap,
watermark, strip assembly and file naming, shared by the CLI and the
StartRT session.  Every entry point renders on the card unless the
caller passes another device (device='cpu' runs the plain torch
versions).  `settings.devices` fans every frame out over a mesh of
devices (settings_mesh), and render_stereo renders each face over TCP
render servers when it is given a client (parallel/network.py).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import renderer as grenderer
from .. import scene as gscene
from ..cameras import cameras as gcam
from ..film import accum, stereo_strip, tonemap
from ..integrator import pathtracer as pt
from ..io import ecs as gecs
from ..io import image as gimage
from ..utils import logging as glog


def params_from_settings(settings: gecs.RenderSettings) -> pt.PTParams:
    return pt.PTParams(
        max_depth=settings.depth if settings.depth >= 0 else 10,
        min_contribution=settings.min_contribution,
        t_max_shadow_ray=settings.t_max_shadow_ray,
        t_max_shadow_jitter=settings.t_max_shadow_jitter,
        up=tuple(settings.cam_up),
    )


def settings_mesh(settings: gecs.RenderSettings, device=None):
    """The device mesh of the render paths (the -devices seam,
    renderer.cpp:948-956) for frames on `device` (None: the card):
    settings.devices 1 renders on one device (None), 0 over every
    visible card, N over the first N cards, capped at those visible; on
    the CPU, N > 1 makes N CPU slots (0 and 1: one device)."""
    n = settings.devices
    if n == 1:
        return None
    from ..parallel import sharding
    device = gscene.resolve_device(device)
    if device.type == 'cpu':
        return sharding.make_mesh(devices=['cpu'] * n) if n > 1 else None
    avail = torch.cuda.device_count()
    n = min(n if n > 0 else avail, avail)
    return sharding.make_mesh(n) if n > 1 else None


def mono_camera(settings: gecs.RenderSettings):
    """createCamera (renderer.cpp:310-349): pinhole, or DoF when radius>0."""
    l2w = gcam.look_at(settings.cam_pos, settings.cam_look_at,
                       settings.cam_up)
    aspect = settings.width / settings.height
    if settings.cam_radius == 0.0:
        return gcam.Pinhole(l2w, angle=settings.fov, aspect=aspect)
    return gcam.DepthOfField(l2w, angle=settings.fov, aspect=aspect,
                             lens_radius=settings.cam_radius,
                             focal_distance=settings.focal_distance)


def _bp(settings):
    if settings.backplate is None:
        return None
    return np.asarray(settings.backplate[..., :3], np.float32)


def _image(film, settings) -> np.ndarray:
    """The film tonemapped, as an (H, W, 3) float32 array on the host."""
    return tonemap.tonemap(accum.resolve(film), gamma=settings.gamma,
                           vignetting=settings.vignetting).cpu().numpy()


def render_mono(scene, settings: gecs.RenderSettings, out_file: str,
                seed: int = 0, progress_cb=None, stop_flag=None,
                device=None):
    """outputMode's mono path (renderer.cpp:882-904): settings.num_frames
    progressive frames (each the next iteration, accumulated while
    settings.accumulate), tonemapped and stored to out_file when it is
    not empty.  The scene must live on `device` (None: the card); the
    frames fan out over settings_mesh.  Returns (image (H, W, 3)
    float32, the last frame's FrameStats)."""
    device = gscene.resolve_device(device)
    mesh = settings_mesh(settings, device)
    camera = mono_camera(settings)
    params = params_from_settings(settings)
    film = None
    stats_total = None
    for frame in range(max(settings.num_frames, 1)):
        film, stats = grenderer.render_frame(
            scene, camera, params, settings.width, settings.height,
            settings.spp, film=film, iteration=frame,
            accumulate=bool(settings.accumulate) or frame == 0,
            seed=seed, backplate=_bp(settings),
            pixel_filter=settings.pixel_filter, sampler=settings.sampler,
            progress_cb=progress_cb, stop_flag=stop_flag, device=device,
            mesh=mesh)
        stats_total = stats
    img = _image(film, settings)
    if out_file:
        gimage.store(out_file, img, jpeg_quality=settings.jpeg_quality)
    return img, stats_total


def render_rig_faces(scene, settings: gecs.RenderSettings, cams,
                     camera_name: str = 'view',
                     watermark: Optional[np.ndarray] = None, seed: int = 0,
                     rig_index: int = 0, total_faces: int = 12,
                     stage_cb: Optional[Callable] = None,
                     progress_cb: Optional[Callable] = None,
                     stop_flag: Optional[Callable] = None,
                     mesh=None, client=None, origin=None,
                     device=None):
    """The 12 faces of one rig (renderer.cpp:560-660) on the committed
    scene's device (over `mesh` when one is given), or through the TCP
    render servers of `client` (parallel/network.py NetworkClient, its
    scene set; scene None, each face rendered at the rig's `origin` and
    tonemapped on `device`, None: the card): each square face (max(width,
    height)) rendered, tonemapped and watermarked (the four side faces,
    when watermark is not None).  A face is the retry unit: one that raises is rendered
    once more (deterministic seeding makes the retry the face an
    untroubled run gives), and a second failure propagates.

    stage_cb(stage, total_faces) is called before each face, stage
    rig_index * 12 + face; progress_cb(fraction) with the whole job's
    fraction after each pass; stop_flag() ends the rig before a face or a
    pass.  Returns (faces, stats): the faces rendered, each an (S, S, 3)
    float32 array (12 unless stopped), and each one's FrameStats (None
    over TCP).  A client renders with the stateless sampler alone: it
    raises ValueError for settings.sampler 'precomputed'."""
    if client is not None and settings.sampler != 'stateless':
        raise ValueError(f"sampler {settings.sampler!r} is not carried by "
                         "the render protocol; TCP renders use the "
                         "stateless sampler")
    size = max(settings.width, settings.height)
    params = params_from_settings(settings)
    film_dev = (gscene.resolve_device(device) if client is not None
                else scene.device)
    faces, stats = [], []
    for face_index in range(12):
        if stop_flag is not None and stop_flag():
            break
        stage = rig_index * 12 + face_index
        if stage_cb is not None:
            stage_cb(stage, total_faces)
        cam = cams[face_index]
        if settings.toe_in and not cam.toe_in:
            cam = gcam.StereoCube(
                cam.local2world, cam.cube_face_index, cam.origin, cam.up,
                cam.scene_scale, cam.eye_separation, cam.zero_parallax,
                True, cam.falloff_angle)

        def face(cam=cam, stage=stage):
            if client is not None:
                # every server renders its 4-row bands; the merged sums
                # are the film
                rgb_sum, weight = client.render(
                    cam, params, size, size, settings.spp, seed=seed,
                    pixel_filter=settings.pixel_filter,
                    backplate=settings.backplate, view_pos=origin,
                    view_up=tuple(settings.cam_up))
                if progress_cb is not None:
                    progress_cb((stage + 1) / total_faces)
                return accum.Film(torch.as_tensor(rgb_sum, device=film_dev),
                                  torch.as_tensor(weight, device=film_dev)),\
                    None
            return grenderer.render_frame(
                scene, cam, params, size, size, settings.spp, seed=seed,
                backplate=_bp(settings), pixel_filter=settings.pixel_filter,
                sampler=settings.sampler,
                progress_cb=(lambda f: progress_cb((stage + f) / total_faces))
                if progress_cb else None,
                stop_flag=stop_flag, mesh=mesh)

        try:
            film, st = face()
        except Exception as e:
            if settings.log_display:
                glog.warning("face %d of camera %r failed (%s); retrying "
                             "once" % (face_index, camera_name, e))
            film, st = face()
        faces.append(stereo_strip.apply_watermark(_image(film, settings),
                                                  watermark, face_index))
        stats.append(st)
    return faces, stats


def render_stereo(sb, settings: gecs.RenderSettings, rigs,
                  scene_base: str, out_dir: str = '.',
                  watermark: Optional[np.ndarray] = None,
                  seed: int = 0,
                  stage_cb: Optional[Callable] = None,
                  progress_cb: Optional[Callable] = None,
                  stop_flag: Optional[Callable] = None,
                  debug_faces: bool = False,
                  client=None, device=None):
    """The stereoscopic outputMode (renderer.cpp:508-736) on `device`
    (None: the card).

    sb: the SceneBuilder, uncommitted: a scene with camera-aligned
    billboards is committed again for each rig's viewpoint (rtUpdate-
    Primitive + rtCommit, renderer.cpp:550-559), others once.  rigs: a
    list of (camera_name, [12 StereoCube cameras]).  The watermark is the
    package's (stereo_strip.load_watermark) when settings.watermark is
    set and none is given, and none when it is not set.  Each rig's 12
    faces (render_rig_faces) become `<scene_base>_<camera>.jpg` in
    out_dir, and with debug_faces each face its own file too.  Frames
    fan out over settings_mesh; with a client (parallel/network.py
    NetworkClient, its scene already set) every face renders on its TCP
    render servers instead, at the rig's origin, and is tonemapped on
    `device`.  Returns (the strips written, every file written)."""
    device = gscene.resolve_device(device)
    mesh = None if client is not None else settings_mesh(settings, device)
    if settings.watermark and watermark is None:
        watermark = stereo_strip.load_watermark()
    if not settings.watermark:
        watermark = None

    written, saved = [], []
    total_faces = max(len(rigs) * 12, 1)
    scene = None
    for ci, (camera_name, cams) in enumerate(rigs):
        if stop_flag is not None and stop_flag():
            break
        origin = np.asarray(cams[0].local2world[3])
        if client is None and (sb.has_billboards() or scene is None):
            scene = sb.commit(device=device, view_pos=origin,
                              view_up=settings.cam_up, accel=settings.accel)
        faces, _ = render_rig_faces(
            scene, settings, cams, camera_name, watermark, seed, ci,
            total_faces, stage_cb, progress_cb, stop_flag, mesh, client,
            origin, device)
        if debug_faces:
            for face_index, img in enumerate(faces):
                fn = os.path.join(out_dir, stereo_strip.face_filename(
                    scene_base, camera_name, face_index))
                gimage.store(fn, img, jpeg_quality=settings.jpeg_quality)
                saved.append(fn)
        if len(faces) == 12:
            fn = os.path.join(out_dir, stereo_strip.strip_filename(
                scene_base, camera_name))
            gimage.store(fn, stereo_strip.assemble_strip(faces),
                         jpeg_quality=settings.jpeg_quality)
            written.append(fn)
            saved.append(fn)
    return written, saved
