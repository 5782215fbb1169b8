"""The plain reference: plain torch and numpy, importing nothing of the
program.  scene.prepare works out its tables from a plain scene
description; render.trace follows each path.  pixels() is the entry the
harness calls."""
from __future__ import annotations

import torch

from . import render, scene


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
        out[sl] = render.trace(prep, traffic, cam, seed[sl], pid[sl],
                               sid[sl])
    return out.reshape(n, spp, 3)


prepare = scene.prepare
