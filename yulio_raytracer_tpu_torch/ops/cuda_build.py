"""Build, load and launch the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc alone into a shared library
with a plain C interface, `build/kernels/lib<name>-<hash>.so` under the
repository root (the hash covers the sources and flags, so an edited
source rebuilds), and loaded with ctypes at first use.  Every C entry
point returns `cudaGetLastError()` after its launch; `launch` raises on a
nonzero code.

Every kernel is launched through a torch operator that `operator`
declares: the one route from a wrapper to a kernel.  Declaring runs
nothing on a device and builds nothing; nvcc runs at an operator's first
call.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# rays per launch: the kernels hold a ray index, and the block count
# times the block size, in an int
MAX_RAYS = 1 << 30

_LIBS: dict = {}
# the library of the port's operators: torch.library.Library, not
# custom_op, whose first call imports some 800 modules, seconds of a
# run's set-up
_OPS_LIB = torch.library.Library('yrt', 'FRAGMENT')

# every operator this copy of the package declared: {name: (operator, its
# C entry point, the function that launches it)}
OPERATORS: dict = {}
# the schemas' common parts: a ray batch (ray_args), the outputs of a
# closest-hit kernel (empty_hit) and of an any-hit kernel
RAYS = 'Tensor org, Tensor dirn, Tensor tnear, Tensor tfar'
HIT = 'Tensor(a!) t, Tensor(b!) tri, Tensor(c!) u, Tensor(d!) v'
OCC = 'Tensor(a!) occ'


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def lib_path(name: str, csrc: str = CSRC) -> str:
    """Path of the built library for <csrc>/<name>.cu at its current
    sources."""
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(csrc)):
        if fn == name + '.cu' or fn.endswith('.cuh'):
            with open(os.path.join(csrc, fn), 'rb') as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:12]}.so')


def build(name: str, csrc: str = CSRC) -> str:
    """Compile <csrc>/<name>.cu (the package's csrc unless another source
    directory is given) unless its library exists; returns the path.  The
    compiler's output (with ptxas register counts) is kept beside the
    library as a .log file."""
    out = lib_path(name, csrc)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(csrc, name + '.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    with open(out[:-3] + '.log', 'w') as f:
        f.write(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str, signatures: dict, csrc: str = CSRC) -> ctypes.CDLL:
    """The loaded library for <csrc>/<name>.cu (built on first use), with
    `signatures` {function: [argtypes]} declared; every function returns
    a C int (a cudaError_t)."""
    lib = _LIBS.get((name, csrc))
    if lib is None:
        lib = ctypes.CDLL(build(name, csrc))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name, csrc] = lib
    return lib


def launch(fn, what: str, device, *args):
    """Call the C entry point fn on `device`'s current stream: tensors go
    as pointers, ints as ints, the stream last; raise if the launch
    failed."""
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*ptrs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def operator(name, schema, launch, library, counted):
    """Declare the torch operator yrt::<name><schema> and return it.  Its
    CUDA implementation is launch(library(), 'yrt_' + name, *args), the C
    entry point of that name in the loaded library, then a bump of the
    wrapper `counted` as its module holds it at the call (a recorder may
    stand in for it: raysets._recorded); it has no other, so CPU tensors
    raise NotImplementedError.  Through the operator a profiler links the
    kernel to the span open around the call (a kernel launched straight
    from a profiler range is linked to nothing).  A second copy of the
    package in one process (the turns tool imports another checkout's)
    declares name + '_', so that each copy runs its own kernels."""
    entry = 'yrt_' + name
    module = sys.modules[counted.__module__]

    def impl(*args):
        launch(library(), entry, *args)
        bump(getattr(module, counted.__name__))
    while hasattr(torch.ops.yrt, name):
        name += '_'
    _OPS_LIB.define(name + schema)
    _OPS_LIB.impl(name, impl, 'CUDA')
    op = getattr(torch.ops.yrt, name)
    OPERATORS[name] = (op, entry, launch)
    return op


@functools.cache
def kernel_names(csrc: str = CSRC) -> frozenset:
    """The __global__ names the sources in csrc define."""
    names = set()
    for fn in os.listdir(csrc):
        if fn.endswith('.cu'):
            with open(os.path.join(csrc, fn)) as f:
                names.update(re.findall(
                    r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?'
                    r'(\w+)\s*\(', f.read()))
    return frozenset(names)


def ray_args(org, dirn, tnear, tfar, *time):
    """One ray batch for a kernel (with its per-ray `time` for a motion
    kernel): checked to hold fewer than MAX_RAYS rays, made contiguous,
    then checked to be (R, 3) / (R,) f32 CUDA tensors on one device."""
    r = org.shape[0]
    if r >= MAX_RAYS:
        raise ValueError(f"{r} rays exceed one launch ({MAX_RAYS})")
    xs = tuple(x.contiguous() for x in (org, dirn, tnear, tfar, *time))
    for name, x in zip(('org', 'dirn', 'tnear', 'tfar', 'time'), xs):
        shape = (r, 3) if name in ('org', 'dirn') else (r,)
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != org.device or not x.is_cuda):
            raise ValueError(f"{name}: expected a float32 CUDA tensor of "
                             f"shape {shape} on {org.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return xs


def table_arg(name, x, width, device):
    """Check a packed table: contiguous f32 (N, width) on `device`,
    16-byte aligned for the kernels' vector loads."""
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != width
            or not x.is_contiguous() or x.device != device
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         f"float32 (N, {width}) tensor on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x


_BUMP_LOCK = threading.Lock()


def bump(wrapper):
    """Add one to wrapper.launches, the launch count of its kernel (under
    a lock: a mesh's slots on distinct cards launch from threads of their
    own)."""
    with _BUMP_LOCK:
        wrapper.launches += 1


def count(counts, key, n):
    """Add n (an int, or a tensor summed without a device sync) to
    counts[key] unless counts is None: the plain versions gather the
    pair and box tests their kernels make this way."""
    if counts is not None:
        counts[key] = counts.get(key, 0) + n


def empty_hit(r: int, device):
    """Uninitialized (t, tri, u, v) outputs for r rays."""
    return (torch.empty((r,), dtype=torch.float32, device=device),
            torch.empty((r,), dtype=torch.int32, device=device),
            torch.empty((r,), dtype=torch.float32, device=device),
            torch.empty((r,), dtype=torch.float32, device=device))


def closest(op, *args):
    """(t, tri, u, v) that op, a closest-hit kernel's operator, writes
    for the rays of args (org third)."""
    hit = empty_hit(args[2].shape[0], args[2].device)
    op(*args, *hit)
    return hit


def occluded(op, *args):
    """The (R,) bool occlusion that op, an any-hit kernel's operator,
    writes for the rays of args (org third)."""
    occ = torch.empty((args[2].shape[0],), dtype=torch.bool,
                      device=args[2].device)
    op(*args, occ)
    return occ
