"""Where the benchmark's parts live, and the rules their names keep.

Everything belonging to one cell, configuration or traffic mix is a
file of its own, and so is each reader of per-layer metrics, each scene
generator, each plain reference and each adapter to the program, found
by name:
  BENCHMARK.json        (the repository root) the cells, metrics, bounds
  cells/<cell>.json     config, traffic, why, and the limits of the
                        numbers that decide `correct`
  configs/<config>.json the scene generator and its parameters, the
                        cameras, the shadow cap (t_max_shadow_ray, null
                        for none), the source's settings and what was
                        cut; optionally "reference" and "port", the
                        names of its own plain reference and adapter
  traffic/<traffic>.json mode (frames | progressive), camera, width,
                        height, spp, max_depth, pixel_filter, compaction,
                        gamma (progressive); check
                        (frames, pixels, pixel_sets); trace_frames; and
                        optionally min_frames
  metrics/<base>.py     read(ctx) -> float | None, the reader of every
                        per-layer metric named <base> or <base>.<suffix>
                        (glue_ms.frame and glue_ms.refine read alike)
  scenes/<g>.py         a generator other than the frozen colonnade and
                        sponza_like: generate(seed, **generator_params)
                        -> a plain description, optionally
                        num_triangles(desc), and TINY, the reduced
                        generator_params of the CPU tests
  references/<r>/       a package, the plain reference of configurations
                        naming "reference": <r>: prepare(desc, device,
                        dtype=torch.float32) and pixels(prep, traffic,
                        cam, seeds, pids, spp), as reference/ has them;
                        plain float32 torch that may import reference/
                        and nothing of the program or of JAX
  ports/<p>.py          the adapter of configurations naming "port": <p>:
                        any of PORT_PARTS, each as port.py has it; what
                        it leaves out is port.py's
A configuration naming neither uses reference/ and port.py, and its
scene description holds only the keys those read (harness.parts).
BENCHMARK.json alone holds each metric's unit, layer, moves, source and
cells.  Adding a cell, a configuration, a traffic mix, a reader, a
generator, a reference or an adapter adds files; a cell that reports a
metric already read adds only its name to the metric's cells in
BENCHMARK.json.  No file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT_RE = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
# what an adapter (ports/<p>.py) may define in port.py's place
PORT_PARTS = ('commit', 'camera', 'params', 'render', 'present',
              'span_names')


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


def load(kind: str, name: str, package: bool = False):
    """The module <kind>/<name>.py, or with package=True the package
    <kind>/<name>/, loaded by path and anew on every call."""
    mod_name = f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    path = os.path.join(HERE, kind, _named(kind, name))
    if package:
        # a package's own modules load with it, never from an earlier
        # load of the same name
        for m in [m for m in sys.modules
                  if m == mod_name or m.startswith(mod_name + '.')]:
            del sys.modules[m]
        found = importlib.util.spec_from_file_location(
            mod_name, os.path.join(path, '__init__.py'),
            submodule_search_locations=[path])
    else:
        found = importlib.util.spec_from_file_location(mod_name,
                                                       path + '.py')
    if found is None or not os.path.exists(found.origin):
        raise FileNotFoundError(f"no {kind} named {name!r} at {path}")
    mod = importlib.util.module_from_spec(found)
    if package:
        sys.modules[mod_name] = mod
    found.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The module of metrics/<base>.py that reads metric `name`."""
    return load('metrics', reader_name(name))


def reference(name=None):
    """The plain reference a configuration's "reference" names: the
    package references/<name>/, or reference/ where it names none."""
    if name is None:
        from . import reference as default
        return default
    return load('references', name, package=True)


def port(name=None):
    """The adapter to the program a configuration's "port" names: each
    of PORT_PARTS from ports/<name>.py where it defines it, else from
    port.py (name None: port.py's alone)."""
    from . import port as default
    own = load('ports', name) if name is not None else None
    return SimpleNamespace(**{k: getattr(own, k, getattr(default, k))
                              for k in PORT_PARTS})


def names(kind: str) -> list:
    """The names of every file of cells, configs, traffic or metrics."""
    ext = '.py' if kind == 'metrics' else '.json'
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(ext) and not f.startswith('_'))
