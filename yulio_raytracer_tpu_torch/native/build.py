"""Build the C ABI shim and the C host that drives it, at first use.

    python -m yulio_raytracer_tpu_torch.native.build

`shim()` compiles yuliort_shim.cpp with g++ against this interpreter's
embedding flags (python3-config --includes, --ldflags --embed) into
build/native/libyuliort_torch.so; `host()` compiles the C host
examples/rt_test_host.c with cc -ldl into build/native/rt_test_host.
Each output's name carries a hash of its source and command, so an
edited source builds again.  Run the host as

    PYTHONPATH=<repo> [YRT_DEVICE=cpu] build/native/rt_test_host \\
        scene.dae build/native/libyuliort_torch-<hash>.so [size] [spp]

Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(ROOT, 'build', 'native')
SHIM_SRC = os.path.join(_HERE, 'yuliort_shim.cpp')
HOST_SRC = os.path.join(ROOT, 'examples', 'rt_test_host.c')


def _tool(*names) -> str:
    """The first of the programs `names` found (a name or a path)."""
    for n in names:
        path = shutil.which(n)
        if path:
            return path
    raise RuntimeError(f"none of {names} found: the C ABI cannot be built")


def _python_config() -> list:
    """This interpreter's python-config --includes and --ldflags --embed
    flags."""
    cfg = _tool(sys.executable + '-config',
                f'python{sys.version_info.major}.{sys.version_info.minor}'
                '-config', 'python3-config')
    flags = []
    for args in (['--includes'], ['--ldflags', '--embed']):
        out = subprocess.run([cfg, *args], capture_output=True, text=True,
                             check=True).stdout
        flags += out.split()
    return flags


def _build(src: str, stem: str, suffix: str, cmd: list) -> str:
    """Run cmd (its output path as '{out}') unless its output,
    <stem>-<hash><suffix>, exists; returns the output's path."""
    with open(src, 'rb') as f:
        h = hashlib.sha1(f.read() + ' '.join(cmd).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f'{stem}-{h}{suffix}')
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp{suffix}'
    proc = subprocess.run([c.format(out=tmp) for c in cmd],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {os.path.basename(src)} failed:\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def shim() -> str:
    """The built shim library's path (libyuliort_torch-<hash>.so)."""
    py = _python_config()
    inc = [f for f in py if f.startswith('-I')]
    ld = [f for f in py if not f.startswith('-I')]
    return _build(SHIM_SRC, 'libyuliort_torch', '.so', [
        _tool('g++', 'c++'), '-O2', '-fPIC', '-shared', '-std=c++17',
        '-Wall', *inc, '-o', '{out}', SHIM_SRC, *ld])


def host() -> str:
    """The built C host's path (rt_test_host-<hash>)."""
    return _build(HOST_SRC, 'rt_test_host', '', [
        _tool('cc', 'gcc'), '-O2', '-Wall', '-o', '{out}', HOST_SRC, '-ldl'])


if __name__ == '__main__':
    print(shim())
    print(host())
