"""Profiling and tracing hooks.

Counterpart of `yulio_raytracer_tpu/utils/profiling.py` (:23-60): the
reference's per-frame fps/ms/mrps prints live in `renderer.FrameStats`;
here

* `trace(log_dir)` wraps `torch.profiler.profile` (with the card's
  activity when there is a card) and writes a Chrome trace (a
  `trace*.json` in log_dir, viewable in Perfetto or chrome://tracing)
  whose events name the kernels and the bounce's `yrt.*` ranges;
* `annotate(name)` labels a region inside a trace
  (`torch.profiler.record_function`);
* `CommitStats` / `committed_stats` record scene-commit metrics (the
  Embree BENCHMARK_BUILD analog): triangles, BVH nodes, leaf size, the
  BVH build's seconds and the whole commit's.  The reference leaves
  bvh_seconds at 0; the port fills it.  The reference's `packet_hbm` (a
  TPU memory-placement flag) has no counterpart and is dropped.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace into log_dir (made if
    missing) as trace.json, or trace_<k>.json beside earlier ones.
    Yields the torch profiler; its `trace_path` attribute names the file
    once the block has ended."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    k, path = 0, os.path.join(log_dir, 'trace.json')
    while os.path.exists(path):
        k += 1
        path = os.path.join(log_dir, f'trace_{k}.json')
    prof.export_chrome_trace(path)
    prof.trace_path = path


def annotate(name: str):
    """Label a region inside an active trace."""
    return torch.profiler.record_function(name)


@dataclass
class CommitStats:
    """Scene-commit metrics (Embree BENCHMARK_BUILD analog)."""
    triangles: int = 0
    bvh_nodes: int = 0
    leaf_size: int = 0
    bvh_seconds: float = 0.0
    total_seconds: float = 0.0


def committed_stats(builder, **commit_kw) -> tuple:
    """Commit a SceneBuilder (with commit_kw) while measuring build
    metrics; bvh_nodes counts the binary tree's nodes (0 without a
    BVH).  Returns (scene, CommitStats)."""
    t0 = time.perf_counter()
    scene = builder.commit(**commit_kw)
    total = time.perf_counter() - t0
    return scene, CommitStats(
        triangles=scene.num_triangles,
        bvh_nodes=0 if scene.nodes is None else int(scene.nodes.shape[0]),
        leaf_size=scene.leaf_size,
        bvh_seconds=scene.bvh_seconds,
        total_seconds=total,
    )
