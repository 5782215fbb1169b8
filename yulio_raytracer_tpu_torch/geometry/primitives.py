"""Analytic primitive tessellation (sphere / single triangle / quad).

The sphere, triangle and quad of `yulio_raytracer_tpu/geometry/
primitives.py`: same vertex and triangle order, so scenes built by either
package pack identically.
"""
from __future__ import annotations

import numpy as np

from .mesh import HostMesh


def _sphere_eval(theta, phi):
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.cos(theta),
                     np.sin(theta) * np.sin(phi)], axis=-1)


def tessellate_sphere(center, radius, num_theta: int, num_phi: int,
                      **mesh_kw) -> HostMesh:
    """Mirror of Sphere::triangulate (shapes/sphere.h:51-87), vectorized
    (same vertex/triangle ordering and float arithmetic as the original
    per-vertex loops; the loops cost ~1 s/sphere on a 1-core host)."""
    center = np.asarray(center, np.float32)
    nt, nph = num_theta, num_phi
    itv = np.arange(nt + 1, dtype=np.float64)[:, None]     # (nt+1, 1)
    ipv = np.arange(nph, dtype=np.float64)[None, :]        # (1, nph)
    th, ph = np.broadcast_arrays(itv * np.pi / nt,
                                 ipv * 2.0 * np.pi / nph)
    th_u = np.broadcast_to((itv + 0.001) * np.pi / nt, th.shape)
    ph_v = np.broadcast_to((ipv + 0.001) * 2.0 * np.pi / nph, ph.shape)
    p = _sphere_eval(th, ph)                               # (nt+1, nph, 3)
    dpdu = _sphere_eval(th_u, ph) - p
    dpdv = _sphere_eval(th, ph_v) - p
    positions = (radius * p + center).reshape(-1, 3)
    n = np.cross(dpdv, dpdu)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    normals = n.reshape(-1, 3)
    texcoords = np.stack(np.broadcast_arrays(ipv / nph, itv / nt),
                         axis=-1).reshape(-1, 2)

    # triangles: row it in 1..nt, column ip in 1..nph, interleaved
    # [upper, lower] per column (upper skipped at the north cap it==1,
    # lower skipped at the south cap it==nt) — the loop's exact order
    iti = np.arange(1, nt + 1, dtype=np.int64)[:, None]
    ipi = np.arange(1, nph + 1, dtype=np.int64)[None, :]
    p00 = (iti - 1) * nph + ipi - 1
    p01 = (iti - 1) * nph + ipi % nph
    p10 = iti * nph + ipi - 1
    p11 = iti * nph + ipi % nph
    t1 = np.stack([p10, p00, p01], axis=-1)
    t2 = np.stack([p11, p10, p01], axis=-1)
    both = np.stack([t1, t2], axis=2).reshape(nt, nph * 2, 3)
    keep = np.stack([np.broadcast_to(iti > 1, p00.shape),
                     np.broadcast_to(iti < nt, p00.shape)],
                    axis=2).reshape(nt, nph * 2)
    tris = both[keep]
    return HostMesh(positions.astype(np.float32),
                    tris.astype(np.int32),
                    normals.astype(np.float32),
                    texcoords.astype(np.float32), **mesh_kw)


def single_triangle(v0, v1, v2, **mesh_kw) -> HostMesh:
    pos = np.asarray([v0, v1, v2], np.float32)
    return HostMesh(pos, np.asarray([[0, 1, 2]], np.int32), **mesh_kw)


def quad(v0, v1, v2, v3, **mesh_kw) -> HostMesh:
    """Two-triangle quad (used by TriangleLight::createShape for quadlights)."""
    pos = np.asarray([v0, v1, v2, v3], np.float32)
    return HostMesh(pos, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), **mesh_kw)
