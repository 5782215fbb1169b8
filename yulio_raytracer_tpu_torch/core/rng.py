"""Counter-based, stateless RNG (the lowbias32 mixer), bit-exact.

Counterpart of `yulio_raytracer_tpu/core/rng.py`: every random number is
a pure function of (seed, pixel_id, sample_id, dimension), so renders are
deterministic and layout-independent, and both packages draw the same
bits.  u32 arithmetic is carried in int64 tensors: torch on the CPU has
no right shift for uint32, so every product is reduced modulo 2^32.  The
32x32-bit products are split into 16-bit halves so that no int64
intermediate overflows.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_INV_2_32 = float(2.0 ** -32)


def _u32(x, like=None):
    """int64 tensor holding x mod 2^32 (x: tensor, int or numpy)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if like is not None else None
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
    ref = next((x for x in (a, b, c, d) if isinstance(x, torch.Tensor)),
               None)
    a, b, c, d = (_u32(x, ref) for x in (a, b, c, d))
    h = (_mul(a, 0x9E3779B1) ^ _mul(b, 0x85EBCA77)
         ^ _mul(c, 0xC2B2AE3D) ^ _mul(d, 0x27D4EB2F))
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


def uniform1(seed, pixel_id, sample_id, dim):
    return _to_unit_float(_key(seed, pixel_id, sample_id, dim))


def uniform2(seed, pixel_id, sample_id, dim):
    h = _key(seed, pixel_id, sample_id, dim)
    return torch.stack([_to_unit_float(_mix(h ^ 0x632BE59B)),
                        _to_unit_float(_mix(h ^ 0x85EBCA6B))], dim=-1)


def uniform3(seed, pixel_id, sample_id, dim):
    h = _key(seed, pixel_id, sample_id, dim)
    return torch.stack([_to_unit_float(_mix(h ^ 0x632BE59B)),
                        _to_unit_float(_mix(h ^ 0x85EBCA6B)),
                        _to_unit_float(_mix(h ^ 0xC2B2AE35))], dim=-1)


def hash_u32(a, b=0, c=0, d=0):
    """A single decorrelated u32."""
    return _key(a, b, c, d)
