"""Interactive viewer -- the GLUTDisplay interaction layer, in a browser.

Counterpart of `yulio_raytracer_tpu/api/viewer.py` (:1-449).  The
reference opens a GLUT window with mouse camera control and key bindings
(`devices/renderer/glutdisplay.cpp:100-130,342-441`).  Render hosts are
headless, so the "window" is a small built-in web viewer: a background
HTTP server streams progressively refined frames to a page and feeds
mouse and key events back to the render loop.  The frames are PNGs the
port encodes itself (io/image.encode_png), so the viewer needs no
Pillow; the reference's JPEG frames need it and go empty without it.
The camera math (`CameraController`, a float64 numpy copy of the
reference's: rotate / pan / dolly / roll, shift-click re-centring
through `renderer.pick`, arrow keys, speed keys) replicates `clickFunc` /
`motionFunc` / `keyboardFunc` / `specialFunc`.

Key bindings (keyboardFunc, glutdisplay.cpp:100-130):
  space  pause/resume            c  print -vp/-vi/-vu camera line
  r      toggle refine           t  toggle regression-test scenes
  l / L  lens radius -/+ 1       f  fullscreen (client-side)
  q/ESC  quit                    arrows  move / rotate (alt = strafe)
  Home/End  speed x1.2 / /1.2    PgUp/PgDn  pitch

Mouse (clickFunc/motionFunc, glutdisplay.cpp:200-330):
  LMB drag      rotate around look-at point (fixed up-vector)
  MMB drag      pan            RMB drag   dolly
  ALT+LMB drag  roll           Shift+LMB click  re-center on picked point
"""
from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..io import image as gimage


def _norm(v):
    return v / max(float(np.linalg.norm(v)), 1e-30)


def _rot(axis, angle):
    """3x3 rotation about `axis` (Rodrigues), matching
    AffineSpace3f::rotate's linear part."""
    a = _norm(np.asarray(axis, np.float64))
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(a, a)


@dataclass
class CameraController:
    """Host-side orbit-camera state machine: the g_camPos / g_camLookAt /
    g_camUp globals plus every mouse/key handler of glutdisplay.cpp."""
    pos: np.ndarray
    lookat: np.ndarray
    up: np.ndarray
    angle: float = 64.0          # vertical field of view (deg)
    aspect: float = 1.0
    speed: float = 1.0           # g_speed
    radius: float = 0.0          # g_camRadius (DoF lens radius)
    psi: float = 0.0             # roll accumulator

    def __post_init__(self):
        self.pos = np.asarray(self.pos, np.float64).copy()
        self.lookat = np.asarray(self.lookat, np.float64).copy()
        self.up = _norm(np.asarray(self.up, np.float64))

    # -- mouse ---------------------------------------------------------
    def rotate(self, dx: float, dy: float):
        """LMB drag (motionFunc mouseMode==1, fixed-upvector variant):
        orbit pos around lookat; dx/dy in pixels (click - current)."""
        sp = 0.05 / 180.0 * np.pi
        theta, phi = dx * sp, dy * sp
        view = _norm(self.lookat - self.pos)
        dist = float(np.linalg.norm(self.lookat - self.pos))
        d_x = _norm(np.cross(view, self.up))
        d_y = _norm(np.cross(view, d_x))
        # camPos = lookAt - dist * xfmVector(camSpace, (0,0,1)) with the
        # camera frame rotated about lookAt by dX then dY
        r = _rot(d_y, theta) @ _rot(d_x, phi)
        self.pos = self.lookat - dist * _norm(r @ view)

    def pan(self, dx: float, dy: float):
        """MMB drag (mouseMode==2)."""
        pan_speed = 0.00025
        dist = float(np.linalg.norm(self.lookat - self.pos))
        view = _norm(self.lookat - self.pos)
        strafe = np.cross(self.up, view)
        delta = (strafe * pan_speed * dist * dx
                 + self.up * pan_speed * dist * (-dy))
        self.pos += delta
        self.lookat += delta

    def dolly(self, dx: float, dy: float):
        """RMB drag (mouseMode==3)."""
        delta = dx if abs(dx) > abs(dy) else -dy
        k = (1 - 0.01) ** delta
        dist = float(np.linalg.norm(self.lookat - self.pos))
        view = _norm(self.lookat - self.pos)
        self.pos += dist * (1 - k) * view

    def roll(self, dx: float, dy: float = 0.0):
        """ALT+LMB drag (mouseMode==4)."""
        self.psi -= dx * 0.1 / 180.0 * np.pi
        view = _norm(self.lookat - self.pos)
        approx_up = np.array([0.0, 1.0, 0.0])
        right = _norm(np.cross(view, approx_up))
        self.up = _rot(view, self.psi) @ np.cross(right, view)

    def recenter(self, p: np.ndarray):
        """Shift+LMB click on a picked world point (clickFunc GLUT_UP):
        look at p, sliding the eye parallel to the view plane."""
        p = np.asarray(p, np.float64)
        delta = p - self.lookat
        right = np.cross(_norm(self.up), _norm(self.lookat - self.pos))
        offset = (np.dot(delta, right) * right
                  + np.dot(delta, self.up) * self.up)
        self.lookat = p
        self.pos = self.pos + offset

    def refocus(self, p: np.ndarray):
        """Ctrl+Shift+LMB click: move lookat onto the view ray at the
        picked point's depth (keeps orientation, changes focus depth)."""
        p = np.asarray(p, np.float64)
        v = _norm(self.lookat - self.pos)
        d = p - self.pos
        self.lookat = self.pos + v * float(np.dot(d, v))

    # -- keys ----------------------------------------------------------
    def key(self, k: str, alt: bool = False) -> Optional[str]:
        """keyboardFunc/specialFunc.  Returns an action string for keys
        the render loop must handle ('pause', 'refine', 'regression',
        'quit', 'camera-line'), else None (camera already updated)."""
        if k == ' ':
            return 'pause'
        if k == 'r':
            return 'refine'
        if k == 't':
            return 'regression'
        if k in ('q', 'Q', 'Escape'):
            return 'quit'
        if k == 'c':
            return 'camera-line'
        if k == 'l':
            self.radius = max(0.0, self.radius - 1)
            return None
        if k == 'L':
            self.radius += 1
            return None
        view = _norm(self.lookat - self.pos)
        if k == 'ArrowLeft':
            if alt:
                self._translate(np.array([-self.speed, 0, 0]))
            else:
                self._yaw(-0.05)
        elif k == 'ArrowRight':
            if alt:
                self._translate(np.array([self.speed, 0, 0]))
            else:
                self._yaw(0.05)
        elif k == 'ArrowUp':
            self._translate(np.array([0, self.speed, 0]) if alt
                            else np.array([0, 0, self.speed]))
        elif k == 'ArrowDown':
            self._translate(np.array([0, -self.speed, 0]) if alt
                            else np.array([0, 0, -self.speed]))
        elif k == 'PageUp':
            self._pitch(-0.05)
        elif k == 'PageDown':
            self._pitch(0.05)
        elif k == 'Home':
            self.speed *= 1.2
        elif k == 'End':
            self.speed /= 1.2
        return None

    def _frame(self):
        z = _norm(self.lookat - self.pos)
        x = _norm(np.cross(self.up, z))
        y = _norm(np.cross(z, x))
        return x, y, z

    def _translate(self, local):
        """camSpace * translate(v): v in camera-local axes, moving both
        eye and look-at (specialFunc non-rotate branches)."""
        x, y, z = self._frame()
        d = local[0] * x + local[1] * y + local[2] * z
        self.pos += d
        self.lookat += d

    def _yaw(self, a):
        """rotate(camSpace.p, up, a) * camSpace: eye fixed, view spun."""
        r = _rot(self.up, a)
        self.lookat = self.pos + r @ (self.lookat - self.pos)

    def _pitch(self, a):
        x, _, _ = self._frame()
        r = _rot(x, a)
        self.lookat = self.pos + r @ (self.lookat - self.pos)

    # -- output --------------------------------------------------------
    def camera_line(self) -> str:
        """The 'c' key's -vp/-vi/-vu echo (keyboardFunc case 'c')."""
        f = lambda v: " ".join("%g" % x for x in v)
        return ("-vp %s\n-vi %s\n-vu %s" % (f(self.pos), f(self.lookat),
                                            f(self.up)))

    def camera(self):
        """Build the render camera (Pinhole, or DepthOfField when the
        l/L keys set a lens radius — createCamera, glutdisplay.cpp:67)."""
        from ..cameras import cameras as cam
        l2w = cam.look_at(self.pos.astype(np.float32),
                          self.lookat.astype(np.float32),
                          self.up.astype(np.float32))
        if self.radius > 0:
            focal = float(np.linalg.norm(self.lookat - self.pos))
            return cam.DepthOfField(l2w, angle=self.angle,
                                    aspect=self.aspect,
                                    lens_radius=float(self.radius),
                                    focal_distance=focal)
        return cam.Pinhole(l2w, angle=self.angle, aspect=self.aspect)


_PAGE = """<!DOCTYPE html>
<html><head><title>yulio-raytracer-tpu-torch</title><style>
 body { margin:0; background:#111; color:#ccc; font:12px monospace; }
 #hud { position:fixed; left:8px; top:8px; pointer-events:none;
        text-shadow:0 0 3px #000; white-space:pre; }
 img  { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head><body>
<div id="hud"></div><img id="v" draggable="false">
<script>
const img = document.getElementById('v'), hud = document.getElementById('hud');
let since = -1, mode = 0, cx = 0, cy = 0;
function post(ev) { fetch('/event', {method:'POST', body:JSON.stringify(ev)}); }
async function poll() {
  for (;;) {
    try {
      const r = await fetch('/frame?since=' + since);
      const j = await r.json();
      if (j.i !== since) { img.src = 'data:image/png;base64,' + j.png;
                           hud.textContent = j.hud; since = j.i; }
    } catch (e) { await new Promise(s => setTimeout(s, 500)); }
  }
}
img.addEventListener('mousedown', e => {
  e.preventDefault();
  if (e.button === 0 && e.shiftKey) {
    const b = img.getBoundingClientRect();
    post({type: e.ctrlKey ? 'refocus' : 'pick',
          x: (e.clientX - b.left) / b.width,
          y: (e.clientY - b.top) / b.height});
    return;
  }
  cx = e.clientX; cy = e.clientY;
  if (e.button === 0 && e.altKey) mode = 4;
  else if (e.button === 0) mode = 1;
  else if (e.button === 1) mode = 2;
  else if (e.button === 2) mode = 3;
});
window.addEventListener('mouseup', () => mode = 0);
window.addEventListener('mousemove', e => {
  if (!mode) return;
  const dx = cx - e.clientX, dy = cy - e.clientY;
  cx = e.clientX; cy = e.clientY;
  post({type: ['', 'rotate', 'pan', 'dolly', 'roll'][mode], dx: dx, dy: dy});
});
img.addEventListener('contextmenu', e => e.preventDefault());
window.addEventListener('keydown', e => {
  if (e.key === 'f') { document.documentElement.requestFullscreen(); return; }
  post({type: 'key', k: e.key, alt: e.altKey});
});
poll();
</script></body></html>"""


class ViewerServer:
    """Threaded HTTP server on 127.0.0.1:port (0: a free port, then
    `self.port`): serves the page, streams frames (GET /frame?since=i
    waits up to 10 s for a frame newer than i and answers JSON {'i',
    'hud', 'png': base64}, or 204 while no frame has been published, so
    no empty frame is ever sent), and queues the JSON events POSTed to
    /event for the render loop (a malformed one is answered with
    400)."""

    def __init__(self, port: int = 8265):
        self._events = []
        self._lock = threading.Lock()
        self._frame = (0, b'', '')       # (index, png bytes, hud text)
        self._cond = threading.Condition(self._lock)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype='text/html'):
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith('/frame'):
                    since = -1
                    if 'since=' in self.path:
                        try:
                            since = int(self.path.split('since=')[1])
                        except ValueError:
                            pass
                    with viewer._cond:
                        viewer._cond.wait_for(
                            lambda: viewer._frame[0] not in (0, since),
                            timeout=10.0)
                        i, png, hud = viewer._frame
                    if i == 0:
                        self._send(204, b'', 'application/json')
                        return
                    body = json.dumps({
                        'i': i, 'hud': hud,
                        'png': base64.b64encode(png).decode(),
                    }).encode()
                    self._send(200, body, 'application/json')
                else:
                    self._send(200, _PAGE.encode())

            def do_POST(self):
                n = int(self.headers.get('Content-Length', 0))
                try:
                    ev = json.loads(self.rfile.read(n))
                except ValueError:
                    self._send(400, b'{}', 'application/json')
                    return
                with viewer._lock:
                    viewer._events.append(ev)
                self._send(200, b'{}', 'application/json')

        self._httpd = ThreadingHTTPServer(('127.0.0.1', port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def submit_frame(self, img_u8: np.ndarray, hud: str = ''):
        """Publish a tonemapped (H, W, 3) u8 frame to connected pages."""
        png = gimage.encode_png(img_u8)
        with self._cond:
            self._frame = (self._frame[0] + 1, png, hud)
            self._cond.notify_all()

    def drain_events(self) -> list:
        with self._lock:
            evs, self._events = self._events, []
        return evs

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def interactive_loop(scene, controller: CameraController, params,
                     width: int, height: int, spp_per_frame: int = 1,
                     port: int = 8265, max_frames: int = 0,
                     gamma: float = 1.0, seed: int = 0,
                     server: Optional[ViewerServer] = None,
                     scene_factory=None):
    """The displayFunc/idleFunc loop: apply the queued input, render a
    frame on the scene's device, publish it.

    Events: {'type': 'rotate' | 'pan' | 'dolly' | 'roll', 'dx', 'dy'}
    move the camera; {'type': 'pick' | 'refocus', 'x', 'y'} re-centre or
    refocus on the point `renderer.pick` hits; {'type': 'key', 'k',
    'alt'} as CameraController.key.  A move restarts the accumulation.
    scene_factory(frame_index) -> committed scene enables the 't'
    regression mode (a random scene each frame, glutdisplay.cpp:347).
    Without a server one is started on `port` (and closed at the end).
    Returns the final Film.  Blocks until 'q' or max_frames.
    """
    from .. import renderer as grenderer
    from ..film import accum, tonemap

    own = server is None
    if own:
        server = ViewerServer(port)
        print("viewer: http://127.0.0.1:%d/" % server.port, flush=True)
    film = None
    frame = 0
    paused = False
    refine = True
    regression = False
    fps_avg = None
    base_scene = scene
    try:
        while max_frames <= 0 or frame < max_frames:
            moved = False
            for ev in server.drain_events():
                typ = ev.get('type')
                if typ in ('rotate', 'pan', 'dolly', 'roll'):
                    getattr(controller, typ)(float(ev.get('dx', 0)),
                                             float(ev.get('dy', 0)))
                    moved = True
                elif typ in ('pick', 'refocus'):
                    ok, p = grenderer.pick(scene, controller.camera(),
                                           float(ev.get('x', .5)),
                                           float(ev.get('y', .5)))
                    if ok:
                        (controller.recenter if typ == 'pick'
                         else controller.refocus)(p)
                        moved = True
                elif typ == 'key':
                    act = controller.key(ev.get('k', ''),
                                         bool(ev.get('alt')))
                    moved = True      # g_resetAccumulation = true
                    if act == 'pause':
                        paused = not paused
                        moved = False
                    elif act == 'refine':
                        refine = not refine
                    elif act == 'regression':
                        regression = not regression
                        scene = base_scene
                    elif act == 'camera-line':
                        print(controller.camera_line(), flush=True)
                        moved = False
                    elif act == 'quit':
                        return film
            if moved:
                film = None           # camera moved -> restart accumulation
            if paused:                # displayFunc early-out on g_pause
                time.sleep(0.05)
                continue
            if regression and scene_factory is not None:
                scene = scene_factory(frame)
                film = None
            t0 = time.perf_counter()
            film, stats = grenderer.render_frame(
                scene, controller.camera(), params, width, height,
                spp_per_frame, film=film if refine else None,
                iteration=frame, accumulate=refine, seed=seed)
            dt = time.perf_counter() - t0
            fps = 1.0 / max(dt, 1e-9)
            fps_avg = fps if fps_avg is None else 0.8 * fps_avg + 0.2 * fps
            img = tonemap.to_srgb_u8(tonemap.tonemap(
                accum.resolve(film), gamma=gamma)).cpu().numpy()
            hud = ("%.2f fps (avg %.2f), %.1f ms, %dx%d, %.2f mrps"
                   % (fps, fps_avg, dt * 1e3, width, height, stats.mrps))
            server.submit_frame(img, hud)
            frame += 1
    finally:
        if own:
            server.close()
    return film
