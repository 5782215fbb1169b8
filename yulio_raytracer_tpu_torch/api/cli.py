"""Command-line renderer: `python -m yulio_raytracer_tpu_torch.api.cli ...`.

Counterpart of `yulio_raytracer_tpu/api/cli.py`.  Argv is the same token
language as `.ecs` files (renderer.cpp:1406-1474):

  cli -c scene.ecs -o out.ppm                # mono render of a scene
  cli -i scene.obj -vp .. -vi .. -spp 64 -o out.jpg
  cli -c scene.ecs -stereo                   # the 12-face strip, one rig
                                             # at the camera
  cli scene.dae                              # the Yulio FPR stereo pipeline
                                             # (renderer.cpp:1410-1436)

It renders on the card; main(argv, device='cpu') runs the plain torch
versions.  `-connect` and `-devices` (ROADMAP A8), `-display`,
`-viewer` and `-regression` (A7) are not ported yet and raise
NotImplementedError.
"""
from __future__ import annotations

import os
import sys
import time

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
  -renderer pathtracer { spp = N depth = N ... }
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
        raise NotImplementedError("-regression: the random-scene stress "
                                  "loop is not ported yet (ROADMAP A7)")
    if settings.connect:
        raise NotImplementedError("-connect: the TCP render servers are "
                                  "not ported yet (ROADMAP A8)")
    if settings.display:
        raise NotImplementedError("-display / -viewer: the progressive "
                                  "display and the web viewer are not "
                                  "ported yet (ROADMAP A7)")
    if settings.stereo:
        # settings.scene_file = last -i path, argv or included .ecs alike
        return _stereo_from_settings(settings, sb, settings.scene_file,
                                     device)

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
    written, _ = goutput.render_stereo(sb, settings, stereo_rigs(settings),
                                       base, '.', debug_faces=settings.debug,
                                       device=device)
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
