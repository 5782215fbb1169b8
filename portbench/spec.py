"""Where the benchmark's parts live, and the rules their names keep.

Everything belonging to one cell, configuration or traffic mix is a
file of its own, and so is each reader of per-layer metrics, found by
name:
  BENCHMARK.json        (the repository root) the cells, metrics, bounds
  cells/<cell>.json     config, traffic, why, and the limits of the
                        numbers that decide `correct`
  configs/<config>.json the scene generator and its parameters, the
                        cameras, the shadow cap (t_max_shadow_ray, null
                        for none), the source's settings and what was
                        cut
  traffic/<traffic>.json mode (frames | progressive), camera, width,
                        height, spp, max_depth, pixel_filter, compaction,
                        gamma (progressive); check
                        (frames, pixels, pixel_sets); trace_frames; and
                        optionally min_frames
  metrics/<base>.py     read(ctx) -> float | None, the reader of every
                        per-layer metric named <base> or <base>.<suffix>
                        (glue_ms.frame and glue_ms.refine read alike)
BENCHMARK.json alone holds each metric's unit, layer, moves, source and
cells.  Adding a cell, a configuration, a traffic mix or a reader adds
files; a cell that reports a metric already read adds only its name to
the metric's cells in BENCHMARK.json.  No file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT_RE = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"illegal {kind} name {name!r}")
    return name


def cell(name: str) -> dict:
    return _json('cells', _named('cell', name) + '.json')


def config(name: str) -> dict:
    return _json('configs', _named('config', name) + '.json')


def traffic(name: str) -> dict:
    return _json('traffic', _named('traffic', name) + '.json')


def reader_name(metric_name: str) -> str:
    """The reader file's name of a metric: its name up to the first
    dot."""
    return _named('metric', metric_name).split('.')[0]


def metric(name: str):
    """The module of metrics/<base>.py that reads metric `name` (loaded
    by path)."""
    base = reader_name(name)
    path = os.path.join(HERE, 'metrics', base + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + base.replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list:
    """The names of every file of cells, configs, traffic or metrics."""
    ext = '.py' if kind == 'metrics' else '.json'
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(ext) and not f.startswith('_'))
