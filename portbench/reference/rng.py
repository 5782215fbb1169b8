"""The renderer's stateless random numbers, from their definition: the
lowbias32 mixer over (seed, pixel id, sample id, dimension), u32
arithmetic held in int64 tensors (products split into 16-bit halves,
so nothing overflows), and u32 -> float by a round-to-nearest cast and
an exact scale by 2^-32.  Floats come out in the dtype asked for.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def _mul(h, c: int):
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & MASK


def _mix(h):
    h = h ^ (h >> 16)
    h = _mul(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul(h, 0x846CA68B)
    return h ^ (h >> 16)


def _u32(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.full_like(like, int(x) & MASK)


def key(a, b, c, d):
    """The mixed u32 of four u32 streams (tensors or ints)."""
    like = next(x for x in (a, b, c, d) if isinstance(x, torch.Tensor))
    like = like.to(torch.int64)
    a, b, c, d = (_u32(x, like) for x in (a, b, c, d))
    return _mix(_mul(a, 0x9E3779B1) ^ _mul(b, 0x85EBCA77)
                ^ _mul(c, 0xC2B2AE3D) ^ _mul(d, 0x27D4EB2F))


def to_unit(u, dtype):
    return u.to(torch.float32).to(dtype) * (2.0 ** -32)


def uniform1(seed, pid, sid, dim, dtype):
    return to_unit(key(seed, pid, sid, dim), dtype)


def uniform2(seed, pid, sid, dim, dtype):
    h = key(seed, pid, sid, dim)
    return torch.stack([to_unit(_mix(h ^ 0x632BE59B), dtype),
                        to_unit(_mix(h ^ 0x85EBCA6B), dtype)], dim=-1)
