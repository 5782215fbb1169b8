"""Counter-based, stateless RNG (the lowbias32 mixer), bit-exact.

Counterpart of `yulio_raytracer_tpu/core/rng.py`: every random number is
a pure function of (seed, pixel_id, sample_id, dimension), so renders are
deterministic and layout-independent, and both packages draw the same
bits.

On CUDA tensors `uniform1/2/3` and `hash_u32` launch the kernel of
csrc/rng.cu (F3), one thread a lane, in native u32 with one float32 (or,
for the hash, int64) write a value; on CPU tensors they run the plain
versions `_uniform1_plain` ... `_hash_u32_plain`, whose int64 arithmetic
the kernel repeats bit for bit.  There u32 arithmetic is carried in int64
tensors: torch on the CPU has no right shift for uint32, so every product
is reduced modulo 2^32.  The 32x32-bit products are split into 16-bit
halves so that no int64 intermediate overflows.

Each of the four streams is a host int or a tensor of the lanes' shape;
the dim may also be a sequence of k host ints (the lights of an NEE
group), which leads the result with an axis of k, as the (k, 1) tensor of
them would.  Every draw is a `yrt.rng` span, which records its lanes
(k x the lanes' count) under the tracer.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build as cb
from ..utils import profiling as prof

_MASK = 0xFFFFFFFF
_INV_2_32 = float(2.0 ** -32)
# _key's multipliers of the four streams
_MULS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def _u32(x, like=None):
    """int64 tensor holding x mod 2^32 (x: tensor, int or numpy, or a
    sequence of k host ints, made a (k, 1) column)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if like is not None else None
    if isinstance(x, (list, tuple)):
        return torch.tensor([int(v) & _MASK for v in x], dtype=torch.int64,
                            device=device)[:, None]
    return torch.as_tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _mul(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) and a constant c."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h):
    """lowbias32 finalizer (rng.py:30-37)."""
    h = h ^ (h >> 16)
    h = _mul(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _key(a, b, c, d):
    """Combine four u32 streams (rng.py:40-47)."""
    ref = _lanes(a, b, c, d)
    a, b, c, d = (_u32(x, ref) for x in (a, b, c, d))
    h = (_mul(a, _MULS[0]) ^ _mul(b, _MULS[1]) ^ _mul(c, _MULS[2])
         ^ _mul(d, _MULS[3]))
    return _mix(h)


def pcg4d(a, b, c, d):
    """Four decorrelated u32 streams (as int64 tensors in [0, 2^32))."""
    h = _key(a, b, c, d)
    return (_mix(h ^ 0x632BE59B), _mix(h ^ 0x85EBCA6B),
            _mix(h ^ 0xC2B2AE35), _mix(h ^ 0x27D4EB2F))


def _to_unit_float(u):
    """u32 -> float32 in [0, 1]: round-to-nearest conversion, then an
    exact scale, as jnp's uint32 -> float32 cast."""
    return u.to(torch.float32) * _INV_2_32


def _uniform1_plain(seed, pixel_id, sample_id, dim):
    _count_cuda(_uniform1_plain, seed, pixel_id, sample_id, dim)
    return _to_unit_float(_key(seed, pixel_id, sample_id, dim))


def _uniform2_plain(seed, pixel_id, sample_id, dim):
    _count_cuda(_uniform2_plain, seed, pixel_id, sample_id, dim)
    h = _key(seed, pixel_id, sample_id, dim)
    return torch.stack([_to_unit_float(_mix(h ^ 0x632BE59B)),
                        _to_unit_float(_mix(h ^ 0x85EBCA6B))], dim=-1)


def _uniform3_plain(seed, pixel_id, sample_id, dim):
    _count_cuda(_uniform3_plain, seed, pixel_id, sample_id, dim)
    h = _key(seed, pixel_id, sample_id, dim)
    return torch.stack([_to_unit_float(_mix(h ^ 0x632BE59B)),
                        _to_unit_float(_mix(h ^ 0x85EBCA6B)),
                        _to_unit_float(_mix(h ^ 0xC2B2AE35))], dim=-1)


def _hash_u32_plain(a, b=0, c=0, d=0):
    _count_cuda(_hash_u32_plain, a, b, c, d)
    return _key(a, b, c, d)


# the plain version of each kind of draw: 0 the key itself, n the floats
# a draw
PLAIN = {0: _hash_u32_plain, 1: _uniform1_plain, 2: _uniform2_plain,
         3: _uniform3_plain}


def uniform1(seed, pixel_id, sample_id, dim):
    """One float32 in [0, 1] a draw."""
    return _draw(1, seed, pixel_id, sample_id, dim)


def uniform2(seed, pixel_id, sample_id, dim):
    """Two float32 in [0, 1] a draw, on a last axis of 2."""
    return _draw(2, seed, pixel_id, sample_id, dim)


def uniform3(seed, pixel_id, sample_id, dim):
    """Three float32 in [0, 1] a draw, on a last axis of 3."""
    return _draw(3, seed, pixel_id, sample_id, dim)


def hash_u32(a, b=0, c=0, d=0):
    """A single decorrelated u32 (int64 in [0, 2^32))."""
    return _draw(0, a, b, c, d)


def _lanes(*streams):
    """The first tensor of the streams (the lanes), or None."""
    for x in streams:
        if isinstance(x, torch.Tensor):
            return x
    return None


def _count_cuda(plain, *streams):
    lanes = _lanes(*streams)
    if lanes is not None and lanes.is_cuda:
        plain.cuda_calls += 1


def _draw(n, a, b, c, d):
    """The draws of kind n (PLAIN's keys) of the key (a, b, c, d) in a
    yrt.rng span: the kernel on CUDA tensors, else the plain version."""
    with prof.span(prof.RNG) as rec:
        lanes = _lanes(a, b, c, d)
        out = (draw(n, a, b, c, d) if lanes is not None and lanes.is_cuda
               else PLAIN[n](a, b, c, d))
        if prof.tracer_on():
            rec.set(lanes=out.numel() // max(n, 1))
        return out


def _host_mul(x, m: int) -> int:
    return ((int(x) & _MASK) * m) & _MASK


def draw(n, a, b, c, d):
    """F3 (csrc/rng.cu): the draws of kind n of the key (a, b, c, d) on
    the card.  a, b, c, d: host ints or int64 tensors of one shape S on
    one device; d may also be a sequence of k host ints.  Returns S
    (+ (n,) for n >= 2), led by k for a sequence: float32, or int64 for
    n = 0."""
    ref = _lanes(a, b, c, d)
    dims = d if isinstance(d, (list, tuple)) else None
    streams, host = [], 0
    for x, m in zip((a, b, c, d), _MULS):
        if not isinstance(x, torch.Tensor):
            streams.append(None)
            if x is not dims:
                host ^= _host_mul(x, m)
            continue
        if x.shape != ref.shape or x.device != ref.device:
            raise ValueError(f"the RNG kernel takes streams of one shape on "
                             f"one device (dims as host ints), got "
                             f"{tuple(x.shape)} on {x.device} beside "
                             f"{tuple(ref.shape)} on {ref.device}")
        streams.append(x.to(torch.int64).contiguous())
    terms = ([host] if dims is None else
             [host ^ _host_mul(v, _MULS[3]) for v in dims])
    shape = (() if dims is None else (len(dims),)) + tuple(ref.shape) + (
        (n,) if n >= 2 else ())
    out = torch.empty(shape, dtype=torch.int64 if n == 0 else torch.float32,
                      device=ref.device)
    if out.numel():
        _uniform_op(*streams, terms, n, out)
    return out


_SIGNATURES = {
    'yrt_rng_uniform': [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
}


def launch_uniform(lib, entry, s0, s1, s2, s3, terms, n, out):
    """F3 (yrt_rng_uniform) of lib over the lanes of the streams s0..s3
    (contiguous int64 tensors of one shape, or None) for the host terms,
    into out."""
    r = next(x for x in (s0, s1, s2, s3) if x is not None).numel()
    k = len(terms)
    cb.launch(getattr(lib, entry), entry, out.device, s0, s1, s2, s3, r,
              (ctypes.c_longlong * k)(*terms), k, n, out)


def _lib():
    return cb.library('rng', _SIGNATURES)


_uniform_op = cb.operator(
    'rng_uniform', '(Tensor? s0, Tensor? s1, Tensor? s2, Tensor? s3, '
    'int[] terms, int n, Tensor(a!) out) -> ()', launch_uniform, _lib, draw)

# launch counts: the kernel's, and the plain versions' calls on CUDA
# tensors
draw.launches = 0
for _f in PLAIN.values():
    _f.cuda_calls = 0
del _f
