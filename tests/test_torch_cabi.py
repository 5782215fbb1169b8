"""The port's C ABI (yulio_raytracer_tpu_torch/native/yuliort_shim.cpp):
the YulioRT surface (StartRT/WaitRT/StopRT/GetLastErrorRT/
GetCurrentStatusRT, YulioRT.h:53-57) exported from the library that
native/build.py compiles, driven by the C host examples/rt_test_host.c.
As the JAX package's test_cabi.py, a test skips where g++, cc or
python3-config is missing or the build fails.

The host runs in a subprocess (the shim embeds its own CPython) with
YRT_DEVICE=cpu; its strip must be the bytes that session.StartRT(...,
device='cpu') writes from Python.
"""
import ctypes
import os
import shutil
import subprocess

import pytest

from yulio_raytracer_tpu_torch.api import session
from yulio_raytracer_tpu_torch.native import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAE = os.path.join(ROOT, 'assets', 'scenes', 'test_room.dae')
SYMBOLS = ('StartRT', 'WaitRT', 'StopRT', 'GetLastErrorRT',
           'GetCurrentStatusRT')


def _built():
    try:
        return build.shim(), build.host()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"the C ABI cannot be built here: {e}")


def test_shim_exports_c_surface():
    shim, _ = _built()
    lib = ctypes.CDLL(shim)
    for sym in SYMBOLS:
        assert hasattr(lib, sym), sym


def test_shim_imports_only_the_port_session():
    with open(build.SHIM_SRC) as f:
        src = f.read()
    assert '"yulio_raytracer_tpu_torch.api.session"' in src
    assert 'import jax' not in src
    assert 'yulio_raytracer_tpu.api' not in src


def test_c_host_renders_end_to_end(tmp_path):
    """rt_test_host on test_room.dae at 32^2, 1 spp on the CPU: state Done
    (4), no error, and the strip StartRT writes from Python, byte for
    byte."""
    shim, host = _built()
    for d in ('c', 'py'):
        (tmp_path / d).mkdir()
        shutil.copy(DAE, tmp_path / d / 'test_room.dae')
    env = dict(os.environ, YRT_DEVICE='cpu')
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([host, str(tmp_path / 'c' / 'test_room.dae'), shim,
                        '32', '1'], cwd=tmp_path / 'c', env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert 'done: state=4' in r.stdout             # StateRT.Done
    assert 'lastError=0' in r.stdout               # ErrorCodeRT.NoError
    outs = sorted(p.name for p in (tmp_path / 'c').glob('*.jpg'))
    assert outs == ['test_room_Scene_1.jpg']

    # the host's parameters (examples/rt_test_host.c) from Python
    s = session.RenderSession()
    p = session.ParamsRT(size=32, depth=2, t_max_shadow_ray=120.0, spp=1,
                         ambientlight=(0.83, 0.95, 0.98), eye_separation=2.5,
                         toe_in=True, zero_parallax=75.0, jpeg_quality=90,
                         watermark=False)
    assert s.start(str(tmp_path / 'py' / 'test_room.dae'), p, device='cpu')
    assert s.wait() and s.status().state == session.StateRT.Done
    with open(tmp_path / 'c' / outs[0], 'rb') as f, \
            open(s.written_files[0], 'rb') as g:
        assert f.read() == g.read()
