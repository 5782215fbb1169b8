"""The plain reference of the stereo test field (configuration
test_stereo): plain torch, importing nothing of the program; it borrows
from portbench/reference/ the random numbers, the triangle tables and
their brute-force closest and any-hit tests, the StereoCube's side
faces and the lobes that configuration's scenes share (the Lambertian,
the dielectric layer and the microfacet dielectric).  What it adds:
tables.py (the paint, Uber and MatteTextured lobe slots, texture
coordinates s0 / ds, the HDRI's 2D distribution) and paths.py (the
b-spline film points, the paint's delta reflection, the Uber's straight
transmission, the HDRI's samples and its radiance along escaped rays,
both environment lights in one RNG layout).  TF32 is off, so that no
product is rounded below float32.  pixels() is the entry the harness
calls."""
from __future__ import annotations

import torch

from . import paths, tables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pixels(prep, traffic: dict, cam: dict, seeds, pids, spp: int,
           first_sample: int = 0, block: int = 1 << 14):
    """Radiance of every sample first_sample .. first_sample + spp - 1 of
    pixels pids (N,) under render seeds seeds (N,) (int64 tensors on the
    tables' device): (N, spp, 3) float32, each sample's own, traced in
    blocks of `block` paths."""
    dev = prep['device']
    n = pids.shape[0]
    pid = pids.to(dev).repeat_interleave(spp)
    seed = seeds.to(dev).repeat_interleave(spp)
    sid = (first_sample + torch.arange(spp, device=dev)).repeat(n)
    out = torch.empty((n * spp, 3), dtype=torch.float32, device=dev)
    for b0 in range(0, n * spp, block):
        sl = slice(b0, b0 + block)
        out[sl] = paths.trace(prep, traffic, cam, seed[sl], pid[sl],
                              sid[sl])
    return out.reshape(n, spp, 3)


prepare = tables.prepare
