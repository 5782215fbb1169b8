"""Async render sessions: the YulioRT DLL API surface in Python.

Counterpart of `yulio_raytracer_tpu/api/session.py`.  The state machine,
error codes, progress semantics and defaults replicate
`devices/renderer/YulioRT.h` and the `StartRT/WaitRT/StopRT/
GetLastErrorRT/GetCurrentStatusRT` implementations (`renderer.cpp:
1523-1656`) with the stage-based `YulioStatusTracker` (`renderer.cpp:
99-233`): one stage per cube-face render, sub-progress from the frame's
pass fraction, an error history, and `StopRT(keep_results=False)`
deleting partial outputs (renderer.cpp:727-736).  A session renders on
the device it is started with: None is the card, and starting without
one raises; device='cpu' runs the plain torch versions.
"""
from __future__ import annotations

import enum
import os
import threading
from dataclasses import dataclass
from typing import Optional

from ..scene import resolve_device


class ErrorCodeRT(enum.IntEnum):          # YulioRT.h:11-19
    NoError = 0
    RenderingIsInProgress = 1
    MissingColladaFile = 2
    InvalidColladaFormat = 3
    UnitializedRenderer = 4
    FailedToPopulateStatus = 5
    UnknownError = 1000


class StateRT(enum.IntEnum):              # YulioRT.h:21-27
    Inactive = 0
    Initialiazing = 1
    Rendering = 2
    Stopped = 3
    Done = 4


@dataclass
class StatusRT:                            # YulioRT.h:29-34
    state: StateRT = StateRT.Inactive
    progress: float = 0.0
    last_error: ErrorCodeRT = ErrorCodeRT.NoError


@dataclass
class ParamsRT:
    """Defaults from YulioRT.h:36-51."""
    renderer: str = "pathtracer"
    size: int = 1536
    depth: int = 10
    t_max_shadow_ray: float = 120.0
    spp: int = 256
    ambientlight: tuple = (0.83, 0.95, 0.98)
    eye_separation: float = 2.5
    toe_in: bool = True
    zero_parallax: float = 75.0
    jpeg_quality: int = 90
    debug: bool = False
    threads_priority: int = 0      # accepted for parity; unused
    watermark: bool = False
    face_culling_mode: str = "default"
    # multi-device pixel fan-out (api/output.py settings_mesh): 1 = one
    # device, 0 = every visible card, N = the first N (on the CPU, N
    # CPU slots)
    devices: int = 1


class _Tracker:
    """YulioStatusTracker (renderer.cpp:99-233)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages = 0
        self._stage = 0
        self._sub = 0.0
        self._state = StateRT.Inactive
        self._errors: list[ErrorCodeRT] = []

    def init(self, stages: int):
        with self._lock:
            self._stages = max(stages, 1)
            self._stage = 0
            self._sub = 0.0

    def set_state(self, s: StateRT):
        with self._lock:
            self._state = s

    def set_stage(self, stage: int, total: Optional[int] = None):
        with self._lock:
            if total:
                self._stages = total
            self._stage = stage
            self._sub = 0.0

    def set_progress(self, frac: float):
        with self._lock:
            self._sub = frac

    def add_error(self, e: ErrorCodeRT):
        with self._lock:
            self._errors.append(e)

    def status(self) -> StatusRT:
        with self._lock:
            if self._state == StateRT.Done:
                p = 1.0
            elif self._stages:
                p = min((self._stage + min(self._sub, 1.0)) / self._stages,
                        1.0)
            else:
                p = 0.0
            return StatusRT(self._state, p,
                            self._errors[-1] if self._errors
                            else ErrorCodeRT.NoError)

    def last_error(self) -> ErrorCodeRT:
        with self._lock:
            return self._errors[-1] if self._errors else ErrorCodeRT.NoError


class RenderSession:
    """One StartRT-style render: worker thread + status/stop plumbing."""

    def __init__(self):
        self._tracker = _Tracker()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._keep_results = True
        self._written: list[str] = []

    # ------------------------------------------------ API entry points
    def start(self, collada_file: str, params: Optional[ParamsRT] = None,
              device=None) -> bool:
        """StartRT (renderer.cpp:1523-1612) on `device` (None: the card;
        raises RuntimeError without one)."""
        params = params or ParamsRT()
        device = resolve_device(device)
        if self._thread is not None and self._thread.is_alive():
            self._tracker.add_error(ErrorCodeRT.RenderingIsInProgress)
            return False
        if (not collada_file
                or os.path.splitext(collada_file)[1].lower() != '.dae'
                or not os.path.exists(collada_file)):
            self._tracker.add_error(ErrorCodeRT.MissingColladaFile)
            return False

        self._stop.clear()
        self._tracker.set_state(StateRT.Initialiazing)
        self._thread = threading.Thread(
            target=self._worker, args=(collada_file, params, device),
            daemon=True)
        self._thread.start()
        return True

    def wait(self) -> bool:
        """WaitRT (renderer.cpp:1614-1626)."""
        if self._thread is None:
            return False
        self._thread.join()
        return True

    def stop(self, keep_results: bool = True) -> bool:
        """StopRT (renderer.cpp:1628-1641)."""
        if self._thread is None:
            return False
        self._keep_results = keep_results
        self._stop.set()
        self._thread.join()
        return True

    def status(self) -> StatusRT:
        """GetCurrentStatusRT (renderer.cpp:1643-1656)."""
        return self._tracker.status()

    def last_error(self) -> ErrorCodeRT:
        return self._tracker.last_error()

    @property
    def written_files(self) -> list:
        return list(self._written)

    # ------------------------------------------------ worker
    def _worker(self, collada_file: str, p: ParamsRT, device):
        """workerThreadRT (renderer.cpp:1490-1520): load scene, synthesize
        settings, run the stereo output mode."""
        from . import output as goutput
        try:
            settings, sb, rigs = collada_job(collada_file, p)
            if not rigs:
                # InvalidColladaFormat when no cameras (renderer.cpp:1499)
                self._tracker.add_error(ErrorCodeRT.InvalidColladaFormat)
                self._tracker.set_state(StateRT.Stopped)
                return
            self._tracker.init(len(rigs) * 12)
            self._tracker.set_state(StateRT.Rendering)

            base = os.path.splitext(os.path.basename(collada_file))[0]
            out_dir = os.path.dirname(os.path.abspath(collada_file))
            written, saved = goutput.render_stereo(
                sb, settings, rigs, base, out_dir,
                stage_cb=lambda s, t: self._tracker.set_stage(s, t),
                progress_cb=lambda f: self._tracker.set_progress(f),
                stop_flag=self._stop.is_set,
                debug_faces=p.debug,
                seed=0, device=device)
            self._written = written
            if self._stop.is_set():
                if not self._keep_results:
                    for f in saved:
                        try:
                            os.remove(f)
                        except OSError:
                            pass
                self._tracker.set_state(StateRT.Stopped)
            else:
                self._tracker.set_state(StateRT.Done)
        except Exception:
            self._tracker.add_error(ErrorCodeRT.UnknownError)
            self._tracker.set_state(StateRT.Stopped)
            if int(os.environ.get('YULIO_RT_DEBUG', '0')):
                raise


def collada_job(collada_file: str, p: ParamsRT):
    """What the StartRT worker renders: (settings, SceneBuilder, rigs) of
    a Collada file under params p, with the ambient light p.ambientlight
    and tMaxShadowRay scaled by the scene scale (renderer.cpp:1238); rigs
    the (camera name, 12 StereoCube cameras) of each FPR viewpoint, none
    when the file has no camera."""
    from ..io import collada as gcollada
    from ..io import ecs as gecs
    from ..lights import lights as glights
    from ..scene import SceneBuilder
    settings = gecs.RenderSettings(
        stereo=True,
        width=p.size, height=p.size,
        depth=p.depth,
        spp=p.spp,
        jpeg_quality=p.jpeg_quality,
        toe_in=p.toe_in,
        eye_separation=p.eye_separation,
        zero_parallax=p.zero_parallax,
        watermark=p.watermark,
        face_culling_mode=p.face_culling_mode,
        gamma=1.0,
        devices=p.devices,
    )
    sb = SceneBuilder()
    result = gcollada.load_dae(collada_file, settings, sb,
                               face_culling_mode=p.face_culling_mode,
                               toe_in=p.toe_in)
    settings.t_max_shadow_ray = p.t_max_shadow_ray * result.scene_scale
    sb.add_light(glights.ambient(p.ambientlight))
    return settings, sb, gcollada.make_stereo_cameras(result,
                                                      toe_in=p.toe_in)


# ---------------------------------------------------------------- module API
# (the C-style singleton surface of YulioRT.h:53-57)
_session = RenderSession()


def StartRT(collada_file: str, params: Optional[ParamsRT] = None,
            device=None) -> bool:
    return _session.start(collada_file, params, device)


def WaitRT() -> bool:
    return _session.wait()


def StopRT(keep_results: bool = True) -> bool:
    return _session.stop(keep_results)


def GetLastErrorRT() -> ErrorCodeRT:
    return _session.last_error()


def GetCurrentStatusRT() -> StatusRT:
    return _session.status()
