"""Command-line renderer: `python -m yulio_raytracer_tpu_torch.api.cli ...`.

Counterpart of `yulio_raytracer_tpu/api/cli.py`.  Argv is the same token
language as `.ecs` files (renderer.cpp:1406-1474):

  cli -c scene.ecs -o out.ppm                # mono render of a scene
  cli -i scene.obj -vp .. -vi .. -spp 64 -o out.jpg
  cli -c scene.ecs -stereo                   # the 12-face strip, one rig
                                             # at the camera
  cli scene.dae                              # the Yulio FPR stereo pipeline
                                             # (renderer.cpp:1410-1436)
  cli -c scene.ecs -display -frames 8        # progressive, display.png
  cli -c scene.ecs -viewer 8265              # the web viewer on that port
  cli -regression -size 32 32                # endless random scenes
  cli -c scene.ecs -devices 2 -o out.ppm     # frames over two cards
  cli -c scene.ecs -connect host:8282 host2:8282 -o out.ppm
                                             # over TCP render servers
                                             # (parallel/network.py)

It renders on the card; main(argv, device='cpu') runs the plain torch
versions (-devices N then makes N CPU slots).  `-connect` renders every
frame on the render servers named, mono or stereo, and tonemaps the
merged frame on the device.
"""
from __future__ import annotations

import copy
import itertools
import os
import sys
import time

import numpy as np
import torch

_USAGE = """\
yulio-raytracer-tpu renderer (PyTorch/CUDA port)

usage: python -m yulio_raytracer_tpu_torch.api.cli [flags | file.ecs |
                                                    file.dae]

common flags (full set in io/ecs.py; argv and .ecs files share one
token language, recursively includable via -c):
  -c FILE.ecs            include a command file
  -i SCENE               load scene (.obj/.xml/.dae)
  -o OUT.ppm|png|jpg     render to file (mono)
  -stereo                12-face stereo cube-map pipeline
  -size W H  -spp N  -depth N  -gamma G
  -vp/-vi/-vu/-fov       camera
  -ambientlight R G B    dome light (plus point/spot/directional/
                         distant/triangle/quad/hdri light flags)
  -renderer pathtracer { spp = N depth = N sampler = precomputed ... }
  -display [-viewer P]   progressive view (web viewer on port P)
  -frames N              frames of -display / -viewer (0: endless)
  -regression            random-scene stress loop
"""


def main(argv=None, device=None):
    """Run the command line `argv` (default: sys.argv[1:]) on `device`
    (None: the card).  Returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or '-h' in argv or '-help' in argv or '--help' in argv:
        print(_USAGE)
        return 0
    if '-version' in argv or '--version' in argv:
        from .. import __version__
        print(f"yulio-raytracer-tpu-torch {__version__}")
        return 0

    from ..io import ecs as gecs
    from ..scene import SceneBuilder, resolve_device
    from ..utils import logging as glog

    device = resolve_device(device)
    # bare `file.dae` argument -> FPR pipeline with a renderer_settings
    # sidecar (renderer.cpp:1410-1436)
    if len(argv) == 1 and argv[0].lower().endswith('.dae'):
        return _fpr_pipeline(argv[0], device)

    settings = gecs.RenderSettings()
    sb = SceneBuilder()
    gecs.parse(gecs.TokenStream.from_argv(argv), settings, sb, '.')
    glog.log_display = settings.log_display
    if '-regression' in argv:
        return _regression_loop(settings, device)
    if settings.stereo:
        # settings.scene_file = last -i path, argv or included .ecs alike
        return _stereo_from_settings(settings, sb, settings.scene_file,
                                     device)
    if settings.connect:
        return _connect_mode(settings, sb, device)
    if settings.display:
        return _display_mode(settings, sb, device)
    from . import output as goutput
    scene = sb.commit(device=device, accel=settings.accel)
    out = settings.out_file or 'out.png'
    t0 = time.time()
    img, stats = goutput.render_mono(scene, settings, out, device=device)
    if stats:
        # fps/ms/mrps line (integratorrenderer.cpp:101-111)
        dt = stats.seconds
        print(f"render  {1.0 / max(dt, 1e-9):.2f} fps, "
              f"{dt * 1000.0:.2f} ms, {stats.mrps:.3f} mrps")
    print(f"wrote {out} ({settings.width}x{settings.height}, "
          f"{settings.spp} spp) in {time.time() - t0:.1f}s")
    return 0


def _make_client(settings):
    """A NetworkClient of the -connect servers (host[:port], 8282 by
    default).  Raises ValueError for -sampler precomputed, which the
    render protocol does not carry."""
    from ..parallel import network as gnet

    def addr(tok):
        host, _, port = tok.partition(':')
        return (host, int(port) if port else 8282)

    if settings.sampler != 'stateless':
        raise ValueError(
            "-sampler %s is not carried by the render protocol; "
            "distributed renders use the stateless sampler"
            % settings.sampler)
    return gnet.NetworkClient([addr(t) for t in settings.connect])


def _connect_mode(settings, sb, device=None):
    """-connect host[:port] ...: one frame rendered by the TCP render
    servers (the reference's network device, renderer.cpp:948-956), each
    rendering its interleaved 4-row bands; the merged frame is tonemapped
    on `device` and written locally, as render_mono writes its own."""
    from ..film import accum
    from ..io import image as gimage
    from . import output as goutput

    if settings.num_frames > 1:
        raise ValueError("-frames N accumulates locally only; a TCP render "
                         "renders one frame a request")
    camera = goutput.mono_camera(settings)
    params = goutput.params_from_settings(settings)
    client = _make_client(settings)
    t0 = time.time()
    try:
        client.set_scene(sb)
        rgb_sum, weight = client.render(
            camera, params, settings.width, settings.height, settings.spp,
            seed=0, pixel_filter=settings.pixel_filter,
            backplate=settings.backplate)
    finally:
        client.close()
    film = accum.Film(torch.as_tensor(rgb_sum, device=device),
                      torch.as_tensor(weight, device=device))
    out = settings.out_file or 'out.png'
    gimage.store(out, goutput._image(film, settings),
                 jpeg_quality=settings.jpeg_quality)
    print(f"wrote {out} ({settings.width}x{settings.height}, "
          f"{settings.spp} spp, {len(settings.connect)} servers) in "
          f"{time.time() - t0:.1f}s")
    return 0


def _display_mode(settings, sb, device=None):
    """-display: the progressive refinement loop (glutdisplay.cpp
    analog), writing the -o file (display.png by default) each frame;
    -viewer P: the interactive web viewer on port P with the mouse
    camera and the reference's keys, its 't' mode cycling random
    scenes.  Both run settings.num_frames frames (the viewer: endless at
    1 or fewer, until 'q')."""
    from . import display as gdisplay
    from . import output as goutput
    scene = sb.commit(device=device, accel=settings.accel)
    camera = goutput.mono_camera(settings)
    params = goutput.params_from_settings(settings)
    if settings.viewer_port:
        from ..utils import regression as greg
        from . import viewer as gviewer
        l2w = camera.local2world.cpu().numpy().astype(np.float64)
        ctl = gviewer.CameraController(
            pos=l2w[3], lookat=l2w[3] + l2w[2] * 10.0, up=l2w[1],
            angle=getattr(camera, 'angle', 64.0),
            aspect=settings.width / settings.height)
        gviewer.interactive_loop(
            scene, ctl, params, settings.width, settings.height,
            spp_per_frame=settings.spp, port=settings.viewer_port,
            max_frames=settings.num_frames if settings.num_frames > 1
            else 0, gamma=settings.gamma,
            scene_factory=lambda i: greg.create_random_scene(i).commit(
                device=device))
        return 0
    gdisplay.display_loop(scene, camera, params, settings.width,
                          settings.height, spp_per_frame=settings.spp,
                          max_frames=settings.num_frames,
                          gamma=settings.gamma,
                          refine=bool(settings.accumulate),
                          out_path=settings.out_file or 'display.png')
    return 0


def _regression_loop(settings, device=None):
    """-regression: the endless random-scene stress mode
    (regression.cpp): scene k is create_random_scene(k), rendered with
    seed k from the fixed view of gecs_default_view.  Returns 1 at the
    first non-finite image."""
    from .. import renderer as grenderer
    from ..film import accum
    from ..utils import regression
    from . import output as goutput
    camera = goutput.mono_camera(gecs_default_view(settings))
    params = goutput.params_from_settings(settings)
    for seed in itertools.count():
        scene = regression.create_random_scene(seed).commit(device=device)
        film, stats = grenderer.render_frame(
            scene, camera, params, settings.width, settings.height,
            max(settings.spp, 1), seed=seed)
        ok = bool(torch.isfinite(accum.resolve(film)).all())
        print(f"regression scene {seed}: "
              f"{'ok' if ok else 'NON-FINITE OUTPUT'} "
              f"({stats.mrps:.2f} mrps)", flush=True)
        if not ok:
            return 1
    return 0


def gecs_default_view(settings):
    """Regression scenes use a fixed orbit camera."""
    s = copy.copy(settings)
    s.cam_pos = (0.0, 3.0, -12.0)
    s.cam_look_at = (0.0, 0.0, 0.0)
    s.fov = 60.0
    return s


def stereo_rigs(settings):
    """Stereo without Collada cameras: one rig at the settings' camera."""
    from ..cameras import cameras as gcam
    l2w = gcam.look_at(settings.cam_pos, settings.cam_look_at,
                       settings.cam_up)
    return [("view", gcam.make_stereo_rig(
        l2w, up=tuple(settings.cam_up),
        eye_separation=settings.eye_separation,
        zero_parallax=settings.zero_parallax,
        toe_in=settings.toe_in))]


def _stereo_from_settings(settings, sb, scene_file, device=None):
    from . import output as goutput
    scene_file = scene_file or settings.scene_file
    base = (os.path.splitext(os.path.basename(scene_file))[0]
            if scene_file else 'stereo')
    # the TCP servers serve every output mode, stereo included
    # (renderer.cpp:948-956: the device is chosen before outputMode)
    client = _make_client(settings) if settings.connect else None
    try:
        if client is not None:
            client.set_scene(sb)
        written, _ = goutput.render_stereo(
            sb, settings, stereo_rigs(settings), base, '.',
            debug_faces=settings.debug, client=client, device=device)
    finally:
        if client is not None:
            client.close()
    for w in written:
        print(f"wrote {w}")
    return 0


def read_sidecar(dae_path: str, params):
    """The `renderer_settings` file beside a bare .dae, when there is one
    (renderer.cpp:1410-1436): `key value` lines, '#' comments."""
    sidecar = os.path.join(os.path.dirname(os.path.abspath(dae_path)),
                           'renderer_settings')
    if not os.path.exists(sidecar):
        return params
    with open(sidecar) as f:
        for line in f:
            tok = line.split('#')[0].split()
            if len(tok) < 2:
                continue
            key, val = tok[0], tok[1]
            if key in ('size', 'depth', 'spp', 'jpegQuality'):
                setattr(params, {'jpegQuality': 'jpeg_quality'}.get(
                    key, key), int(val))
            elif key == 'tMaxShadowRay':
                params.t_max_shadow_ray = float(val)
            elif key == 'waterMark':
                params.watermark = val in ('1', 'true')
            elif key == 'devices':
                params.devices = int(val)
    return params


def _fpr_pipeline(dae_path: str, device=None):
    """Bare-DAE mode: the renderer_settings sidecar, then the full stereo
    pipeline through the session API."""
    from .session import ParamsRT, RenderSession
    session = RenderSession()
    if not session.start(dae_path, read_sidecar(dae_path, ParamsRT()),
                         device=device):
        print(f"error: {session.last_error().name}", file=sys.stderr)
        return 1
    last = -1.0
    while True:
        st = session.status()
        if st.progress != last:
            print(f"\r[{st.state.name}] {st.progress * 100:5.1f}%",
                  end='', flush=True)
            last = st.progress
        if st.state.name in ('Done', 'Stopped'):
            break
        time.sleep(0.5)
    session.wait()
    print()
    for w in session.written_files:
        print(f"wrote {w}")
    return 0 if session.status().state.name == 'Done' else 1


if __name__ == '__main__':
    sys.exit(main())
