"""Profiling and tracing hooks.

Counterpart of `yulio_raytracer_tpu/utils/profiling.py` (:23-60): the
reference's per-frame fps/ms/mrps prints live in `renderer.FrameStats`;
here

* `span(name, **attrs)` marks a region of the render path (SPANS, the
  tree below).  With no torch profiler running and the tracer off it is
  one shared no-op context: it enters no `record_function`, keeps no
  record, allocates no tensor, launches nothing and syncs nothing.  Under a torch profiler it enters
  `torch.profiler.record_function(name)`, so the span lies in the
  profiler's trace beside the device's activities, on their clock.
  Under `tracing()` it also keeps a host record (`Span`);
* `tracing()` turns the port's tracer on for a block:

      with profiling.tracing() as t:
          render_frame(...)
      for s in t.spans(): ...     # name, start, end, parent, frame, ...

  Each record holds its name, its `time.perf_counter_ns` start and end,
  the span open around it on its thread (`parent`), the serial of the
  render_frame it belongs to (`frame`), its thread and its attributes.
  A bounce's record also counts its lanes (`width`), the rays it traced
  (`rays`), its shadow candidates (`shadow`) and, compacted, the lanes
  live after it (`live`), and a bounce's yrt.env record the rays that
  missed every triangle (`escaped`), and a yrt.lobes record the lanes
  its call evaluates or samples (`lanes`: hits x lights for an eval,
  hits for a sample; a host int), and a yrt.rng record the draws of
  its call (`lanes`: dims x lanes; a host int); tensor counts are read
  with the frame's own ray count (`settle`), so tracing adds no host
  sync;
* `trace(log_dir)` wraps `torch.profiler.profile` (with the card's
  activity when there is a card) and writes a Chrome trace (a
  `trace*.json` in log_dir, viewable in Perfetto or chrome://tracing)
  whose events name the kernels and the span tree;
* `CommitStats` / `committed_stats` record scene-commit metrics (the
  Embree BENCHMARK_BUILD analog): triangles, BVH nodes, leaf size, the
  BVH build's seconds and the whole commit's.  The reference leaves
  bvh_seconds at 0; the port fills it.  The reference's `packet_hbm` (a
  TPU memory-placement flag) has no counterpart and is dropped.

The span tree of one frame (a mesh's slots each root their passes on
their own thread):

    yrt.frame             renderer._frame: width, height, spp
      yrt.pass            renderer._render_pass: rays
        yrt.raygen        the pass's sample sets and camera rays
          yrt.rng         one call of the RNG (core/rng.py): lanes
        yrt.bounce        one call of the bounce: depth, width
          yrt.intersect   closest hits and their differential geometry
          yrt.env         the escaped rays' environment and backplate;
                          escaped
          yrt.shade_context > yrt.texture_fetch
          yrt.nee         light samples and shadow rays
            yrt.rng, yrt.light_sample, yrt.lobes
            yrt.occluded  the shadow rays' any-hit
          yrt.scatter     roulette, the lobe sample (its yrt.rng and
                          yrt.lobes), Beer, the state update
        yrt.compact       trace_compacted's live count and gather
          yrt.sync        the live count read on the host
      yrt.film            the pass's radiance into the film, the weight
      yrt.sync            the frame's ray count read on the host
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass

import torch

FRAME = 'yrt.frame'
PASS = 'yrt.pass'
RAYGEN = 'yrt.raygen'
BOUNCE = 'yrt.bounce'
INTERSECT = 'yrt.intersect'
ENV = 'yrt.env'
SHADE = 'yrt.shade_context'
FETCH = 'yrt.texture_fetch'
NEE = 'yrt.nee'
LIGHTS = 'yrt.light_sample'
LOBES = 'yrt.lobes'
OCCLUDED = 'yrt.occluded'
SCATTER = 'yrt.scatter'
RNG = 'yrt.rng'
COMPACT = 'yrt.compact'
SYNC = 'yrt.sync'
FILM = 'yrt.film'
# the registry of span names, outermost first
SPANS = (FRAME, PASS, RAYGEN, BOUNCE, INTERSECT, ENV, SHADE, FETCH, NEE,
         LIGHTS, LOBES, OCCLUDED, SCATTER, RNG, COMPACT, SYNC, FILM)

_profiling = torch.autograd._profiler_enabled
_tracer = None                  # the Tracer of the open tracing() block
_local = threading.local()      # each thread's stack of open Spans


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Tracer:
    """What one tracing() block keeps: every thread's span records in
    the order they opened, and the frame serials."""

    def __init__(self):
        self._spans = []
        self._held = []         # records holding tensor counts
        self._lock = threading.Lock()
        self._frames = itertools.count()
        self.frame = None       # the serial of the open frame

    def spans(self) -> list:
        """The records (Span) kept so far, in the order they opened."""
        return list(self._spans)

    def _hold(self, span):
        with self._lock:
            self._held.append(span)

    def _take(self, frame=None) -> list:
        """The records holding tensor counts (of one frame serial),
        taken off the list."""
        with self._lock:
            if frame is None:
                out, self._held = self._held, []
            else:
                out = [s for s in self._held if s.frame == frame]
                self._held = [s for s in self._held if s.frame != frame]
        return out


class Span:
    """One span: a context manager, and its record once entered.  name;
    start, end (time.perf_counter_ns); parent (the Span open around it
    on its thread, or None); frame (the serial of its render_frame under
    the tracer, else None); thread (threading.get_ident()); attrs (the
    attributes given and the counts set())."""
    __slots__ = ('name', 'attrs', 'start', 'end', 'parent', 'frame',
                 'thread', '_tracer', '_mark', '_held')

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.start = self.end = self.parent = self.frame = None
        self.thread = self._tracer = self._mark = None
        self._held = False

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        tracer = _tracer
        self.parent, self.thread, self._tracer = (
            parent, threading.get_ident(), tracer)
        if tracer is not None:
            if self.name == FRAME:
                self.frame = tracer.frame = next(tracer._frames)
            else:
                self.frame = tracer.frame if parent is None else parent.frame
            tracer._spans.append(self)
        if _profiling():
            self._mark = torch.autograd.profiler.record_function(self.name)
            self._mark.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self.name == FRAME and self._tracer is not None:
            self._tracer.frame = (None if self.parent is None
                                  else self.parent.frame)
        if self._mark is not None:
            self._mark.__exit__(*exc)
            self._mark = None
        return None

    def set(self, **counts):
        """Add counts to the record: host ints, or 0-d tensors the
        program already made, read at the frame's end (settle)."""
        self.attrs.update(counts)
        if (self._tracer is not None and not self._held
                and any(isinstance(v, torch.Tensor)
                        for v in counts.values())):
            self._held = True
            self._tracer._hold(self)


class _Off:
    """The span of the off path: enters nothing, keeps nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **counts):
        pass


OFF = _Off()


def span(name: str, **attrs):
    """A region of the render path named `name` (one of SPANS): OFF
    with the tracer off and no torch profiler running, else a Span."""
    if _tracer is None and not _profiling():
        return OFF
    return Span(name, **attrs)


def tracer_on() -> bool:
    """Whether a tracing() block is open: counts that cost a launch are
    made only then, never under a bare profiler."""
    return _tracer is not None


@contextlib.contextmanager
def tracing():
    """Turn the port's tracer on for the block; yields the Tracer, whose
    spans() are every thread's records.  One block at a time.  Counts
    that no frame's end read (spans outside a render_frame) are read
    when the block ends."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("profiling.tracing() is already on")
    tracer = _tracer = Tracer()
    try:
        yield tracer
    finally:
        _tracer = None
        _read(tracer._take())


def settle(total) -> float:
    """float(total): a frame's ray count read from the device.  Under the
    tracer, the tensor counts held by the frame's records are read in the
    same copy and become numbers: tracing adds no host sync."""
    tracer = _tracer
    if tracer is None:
        return float(total)
    return _read(tracer._take(tracer.frame), total)


def _read(spans, total=None):
    """One copy to the host of total (a 0-d tensor, or None) and the
    spans' tensor counts, each put back as an int or a float; returns
    float(total)."""
    keys = [(s, k) for s in spans for k, v in s.attrs.items()
            if isinstance(v, torch.Tensor)]
    vals = ([] if total is None else [total]) + [s.attrs[k] for s, k in keys]
    if not vals:
        return None
    dev = vals[0].device
    got = torch.stack([v.reshape(()).to(dev, torch.float64)
                       for v in vals]).tolist()
    for (s, k), x in zip(keys, got[len(got) - len(keys):]):
        s.attrs[k] = x if s.attrs[k].is_floating_point() else int(x)
    return None if total is None else got[0]


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
