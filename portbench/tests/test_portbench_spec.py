"""The benchmark's files: every one loads, agrees with BENCHMARK.json
and keeps the contract's rules; a cell, configuration, metric,
generator, reference or adapter is added by adding files; the scenes'
sizes; no JAX anywhere."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, run, scenes, spec
from portbench.tests import tiny

KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}
E2E = {'frame_s', 'face_s', 'refine_ms_p95', 'setup_s'}


@pytest.fixture(scope='module')
def bench():
    return spec.benchmark()


def test_every_file_loads():
    for kind, load in (('cells', spec.cell), ('configs', spec.config),
                       ('traffic', spec.traffic), ('metrics', spec.metric)):
        names = spec.names(kind)
        assert names, kind
        for n in names:
            assert load(n) is not None


def test_benchmark_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert bench['paths'] == ['portbench']
    assert bench['command'] == ['python3', 'portbench/run.py']
    rs = bench['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024
    four = sum(w['chips'] == 4 for w in bench['workloads'])
    assert four <= max(1, len(bench['workloads']) // 4)


def test_names_and_units_are_legal(bench):
    names = ([c['name'] for c in bench['configs']]
             + [w['name'] for w in bench['workloads']]
             + [w['traffic'] for w in bench['workloads']]
             + [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
             + [k for c in bench['configs'] for k in c['reduced']])
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in bench['end_to_end'] + bench['per_layer']:
        assert spec.UNIT_RE.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        ns = [x['name'] for x in bench[group]]
        assert len(ns) == len(set(ns)), group
    for text in ([w['why'] for w in bench['workloads']]
                 + [c['why'] for c in bench['configs']]
                 + [c['source'] for c in bench['configs']]
                 + [m['layer'] for m in bench['per_layer']]):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_end_to_end_metrics(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert set(e2e) == E2E
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
    assert e2e['setup_s']['bound'] == 0.25


def test_cells_match_their_files(bench):
    assert {w['name'] for w in bench['workloads']} == set(spec.names('cells'))
    for w in bench['workloads']:
        c = spec.cell(w['name'])
        assert (c['config'], c['traffic'], c['why']) == (
            w['config'], w['traffic'], w['why'])
        assert w['chips'] == 1
        assert set(c['limits']) >= set(
            ('u8_off_share', 'film_rel_median', 'film_rel_l1')
            if spec.traffic(w['traffic'])['mode'] == 'progressive'
            else ('rel_median', 'off_share', 'rel_l1'))


def test_configs_match_their_files(bench):
    used = {w['config'] for w in bench['workloads']}
    assert {c['name'] for c in bench['configs']} == used
    files = [c['file'] for c in bench['configs']]
    assert len(files) == len(set(files))
    for c in bench['configs']:
        assert c['file'] == f"portbench/configs/{c['name']}.json"
        f = spec.config(c['name'])
        assert (f['source'], f['reduced'], f['why']) == (
            c['source'], c['reduced'], c['why'])
        for k in c['reduced']:
            assert k in f['source_settings'], k
            assert not k.endswith(('_dim', '_rank'))


def test_metrics_have_readers_and_report_what_they_move(bench):
    """BENCHMARK.json alone holds a metric's unit, layer, moves, source
    and cells; metrics/<base>.py only reads it, for every suffix."""
    e2e = {m['name']: m for m in bench['end_to_end']}
    cells = {w['name'] for w in bench['workloads']}
    bases = {spec.reader_name(m['name']) for m in bench['per_layer']}
    assert bases == set(spec.names('metrics'))
    layers = {}
    for m in bench['per_layer']:
        mod = spec.metric(m['name'])
        assert callable(mod.read)
        assert not {'UNIT', 'LAYER', 'MOVES', 'SOURCE', 'WORKLOADS'} & set(
            vars(mod)), m['name']
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        # each cell a metric reads reports the metric it moves
        moved = e2e[m['moves']].get('workloads', sorted(cells))
        assert m['workloads'] and set(m['workloads']) <= set(moved) & cells, \
            m['name']
        assert spec.NAME_RE.match(m['name'])
        layers.setdefault(m['layer'], set()).add(m['name'])
    assert set(layers) == {'frame', 'present', 'bounce', 'shading',
                           'lights', 'traversal kernels', 'device'}
    for w in bench['workloads']:
        assert any(w['name'] in m['workloads'] for m in bench['per_layer'])
    assert spec.metric('glue_ms.frame') is not spec.metric('glue_ms.refine')
    assert spec.metric('glue_ms.refine').read.__code__.co_filename.endswith(
        os.path.join('metrics', 'glue_ms.py'))


def test_scenes_hold_their_sizes():
    for seed in (0, 2 ** 31 + 12345):
        col = scenes.GENERATORS['colonnade'](seed)
        sp = scenes.GENERATORS['sponza_like'](seed)
        # the port's own scenes at the generators' defaults
        assert scenes.num_triangles(col) == 86416
        # 238,208 once padded to a multiple of 128 rows, as the port's
        # commit packs them
        assert scenes.num_triangles(sp) == 238134
        assert -(-scenes.num_triangles(sp) // 128) * 128 == 238208
        # the renderer adds a material for each triangle light
        assert len(sp['materials']) + 2 * len(sp['quad_lights']) == 269
        assert len(sp['textures']) == 20
        assert {t.shape for t in sp['textures']} == {(64, 64, 3)}
    # as the configurations run them
    c = spec.config('colonnade')
    col = scenes.GENERATORS['colonnade'](c['scene_seed'],
                                         **c['generator_params'])
    assert scenes.num_triangles(col) == c['triangles'] == 86414
    assert col['quad_lights'] == [] and c['t_max_shadow_ray'] == 120
    assert list(col['ambient']) == pytest.approx(c['ambient'])
    c = spec.config('sponza')
    sp = scenes.GENERATORS['sponza_like'](c['scene_seed'],
                                          **c['generator_params'])
    assert scenes.num_triangles(sp) == c['triangles'] == 238134
    assert len(sp['materials']) == c['materials'] == 25
    assert len(sp['textures']) == c['textures'] == 24
    assert {t.shape for t in sp['textures']} == {(1024, 1024, 3)}
    used = {m['texture'] for m in sp['materials'] if 'texture' in m}
    assert used == set(range(24))
    a = scenes.GENERATORS['colonnade'](5)
    b = scenes.GENERATORS['colonnade'](5)
    c = scenes.GENERATORS['colonnade'](6)
    assert all((x['positions'] == y['positions']).all()
               for x, y in zip(a['meshes'], b['meshes']))
    assert not all(x['positions'].shape == y['positions'].shape
                   and (x['positions'] == y['positions']).all()
                   for x, y in zip(a['meshes'], c['meshes']))


def test_an_added_cell_config_and_metric_need_no_edit(tmp_path, monkeypatch):
    """New files alone: a configuration, a traffic mix, a cell and a
    per-layer metric, with their BENCHMARK.json entries, are found by
    name and run."""
    pb = tmp_path / 'portbench'
    for kind in ('cells', 'configs', 'traffic', 'metrics'):
        shutil.copytree(os.path.join(spec.HERE, kind), pb / kind)
    cfg = spec.config('colonnade')
    cfg['name'] = 'hall_small'
    cfg['generator_params'] = {'cols_x': 2, 'cols_z': 1, 'clutter': 2}
    (pb / 'configs' / 'hall_small.json').write_text(json.dumps(cfg))
    tr = dict(spec.traffic('frame_1024'), width=12, height=12, spp=2,
              max_depth=2, check={'frames': 1, 'pixels': 16})
    (pb / 'traffic' / 'tiny_frame.json').write_text(json.dumps(tr))
    cell = {'config': 'hall_small', 'traffic': 'tiny_frame',
            'why': 'added', 'limits': {'rel_median': 1.0, 'off_share': 1.0,
                                       'rel_l1': 1.0}}
    (pb / 'cells' / 'hall_small.tiny_frame.json').write_text(
        json.dumps(cell))
    (pb / 'metrics' / 'frames_traced.py').write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    b = spec.benchmark()
    b['workloads'].append({'name': 'hall_small.tiny_frame',
                           'config': 'hall_small', 'traffic': 'tiny_frame',
                           'chips': 1, 'why': 'added'})
    next(m for m in b['end_to_end'] if m['name'] == 'frame_s')[
        'workloads'].append('hall_small.tiny_frame')
    b['per_layer'].append({'name': 'frames_traced.frame', 'unit': 'frames',
                           'better': 'higher', 'source': 'program_counter',
                           'layer': 'frame', 'moves': 'frame_s',
                           'workloads': ['hall_small.tiny_frame']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    monkeypatch.setattr(spec, 'HERE', str(pb))
    monkeypatch.setattr(spec, 'ROOT', str(tmp_path))
    assert 'hall_small.tiny_frame' in spec.names('cells')
    out = harness.run('hall_small.tiny_frame', 7, 0.01, True, device='cpu')
    assert out['correct']
    assert out['metrics']['frames_traced.frame']['value'] == tr['trace_frames']
    assert set(out['metrics']) == {'frames_traced.frame'}
    assert list(out)[-1] == 'compared'
    out = harness.run('hall_small.tiny_frame', 8, 0.01, False, device='cpu')
    assert set(out['metrics']) == {'frame_s', 'setup_s'}


def test_an_added_cell_reports_existing_metrics(tmp_path, monkeypatch):
    """A new cell that reports metrics already read (and one more name
    of an existing reader) adds its cell file and BENCHMARK.json entries
    only: no metric file is edited or added."""
    pb = tmp_path / 'portbench'
    for kind in ('cells', 'configs', 'traffic', 'metrics'):
        shutil.copytree(os.path.join(spec.HERE, kind), pb / kind)
    before = sorted(os.listdir(pb / 'metrics'))
    tr = dict(spec.traffic('frame_1024'), width=12, height=12, spp=2,
              max_depth=2, check={'frames': 1, 'pixels': 16})
    (pb / 'traffic' / 'tiny_frame.json').write_text(json.dumps(tr))
    cell = {'config': 'colonnade', 'traffic': 'tiny_frame', 'why': 'added',
            'limits': {'rel_median': 1.0, 'off_share': 1.0, 'rel_l1': 1.0}}
    (pb / 'cells' / 'colonnade.tiny_frame.json').write_text(json.dumps(cell))
    name = 'colonnade.tiny_frame'
    b = spec.benchmark()
    b['workloads'].append({'name': name, 'config': 'colonnade',
                           'traffic': 'tiny_frame', 'chips': 1,
                           'why': 'added'})
    next(m for m in b['end_to_end'] if m['name'] == 'frame_s')[
        'workloads'].append(name)
    for m in b['per_layer']:
        if m['moves'] == 'frame_s':
            m['workloads'].append(name)
    b['per_layer'].append(dict(next(m for m in b['per_layer']
                                    if m['name'] == 'mrays_s.frame'),
                               name='mrays_s.hall', workloads=[name]))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    monkeypatch.setattr(spec, 'HERE', str(pb))
    monkeypatch.setattr(spec, 'ROOT', str(tmp_path))
    ov = {'config': {'generator_params': dict(
        spec.config('colonnade')['generator_params'], cols_x=2, cols_z=1,
        clutter=2)}}
    out = harness.run(name, 9, 0.01, True, device='cpu', overrides=ov)
    assert out['correct']
    # the CPU has no device trace: the device metrics find nothing and
    # are left out; the window's rays are read by both names
    assert set(out['metrics']) == {'mrays_s.frame', 'mrays_s.hall'}
    assert out['metrics']['mrays_s.hall'] == out['metrics']['mrays_s.frame']
    assert sorted(os.listdir(pb / 'metrics')) == before


TINTED_SCENE = '''"""The colonnade with a tint of each material: a key of the
description that port.py and reference/ do not read."""
from portbench.scenes.procedural import colonnade

TINY = {'cols_x': 2, 'cols_z': 1, 'clutter': 2, 'tess': [6, 8]}


def generate(seed, tint=(1.0, 1.0, 1.0), **params):
    desc = colonnade(seed, **params)
    desc['tint'] = [tuple(tint) for _ in desc['materials']]
    return desc
'''
TINTED_REFERENCE = '''"""The plain reference of the tinted colonnade."""
import torch

from portbench import reference as plain

from . import tint


def prepare(desc, device, dtype=torch.float32):
    return plain.prepare(tint.applied(desc), device, dtype)


pixels = plain.pixels
'''
TINT = '''"""A description's tints multiplied into its materials."""


def applied(desc):
    mats = [dict(m, reflectance=tuple(r * t for r, t in zip(
        m['reflectance'], tint))) for m, tint in zip(desc['materials'],
                                                    desc['tint'])]
    return dict({k: v for k, v in desc.items() if k != 'tint'},
                materials=mats)
'''
TINTED_PORT = '''"""The tinted colonnade staged in the port: the tints taken into the
materials, the rest as port.py stages it."""
from portbench import port


def commit(desc, device, leaf_size):
    mats = [dict(m, reflectance=tuple(r * t for r, t in zip(
        m['reflectance'], tint))) for m, tint in zip(desc['materials'],
                                                    desc['tint'])]
    return port.commit(dict(desc, materials=mats), device, leaf_size)
'''
UNTINTED_PORT = '''"""The tinted colonnade staged with its tints left out."""
from portbench import port


def commit(desc, device, leaf_size):
    return port.commit(desc, device, leaf_size)
'''


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), 'rb').read()
            for d, _, files in os.walk(root) for f in files
            if '__pycache__' not in d}


def test_a_configuration_of_a_new_kind_is_new_files(tmp_path, monkeypatch):
    """A configuration whose scene has a key of its own (a tint of each
    material) brings its generator, plain reference and adapter as new
    files: its cell runs and is correct; with the adapter's handling of
    the tint left out it is not; without its own adapter and reference
    it cannot run; and no file of portbench/ that was there changes
    (BENCHMARK.json gains its entries)."""
    pb = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, pb,
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    before = _tree(pb)
    (pb / 'scenes' / 'tinted_hall.py').write_text(TINTED_SCENE)
    (pb / 'references' / 'tinted').mkdir(parents=True)
    (pb / 'references' / 'tinted' / '__init__.py').write_text(
        TINTED_REFERENCE)
    (pb / 'references' / 'tinted' / 'tint.py').write_text(TINT)
    (pb / 'ports').mkdir()
    (pb / 'ports' / 'tinted.py').write_text(TINTED_PORT)
    (pb / 'ports' / 'untinted.py').write_text(UNTINTED_PORT)
    cfg = dict(spec.config('colonnade'), name='tinted_hall',
               generator='tinted_hall', reference='tinted', port='tinted')
    cfg['generator_params'] = dict(cfg['generator_params'],
                                   tint=[0.5, 0.9, 1.0])
    (pb / 'configs' / 'tinted_hall.json').write_text(json.dumps(cfg))
    name = 'tinted_hall.frame_1024'
    cell = dict(spec.cell('colonnade.stereo_face_1536'), config='tinted_hall',
                traffic='frame_1024', why='added')
    (pb / 'cells' / f'{name}.json').write_text(json.dumps(cell))
    b = spec.benchmark()
    b['configs'].append({k: cfg[k] for k in ('name', 'source', 'reduced',
                                             'why')}
                        | {'file': 'portbench/configs/tinted_hall.json'})
    b['workloads'].append({'name': name, 'config': 'tinted_hall',
                           'traffic': 'frame_1024', 'chips': 1,
                           'why': 'added'})
    next(m for m in b['end_to_end'] if m['name'] == 'frame_s')[
        'workloads'].append(name)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    monkeypatch.setattr(spec, 'HERE', str(pb))
    monkeypatch.setattr(spec, 'ROOT', str(tmp_path))
    _keeps_the_import_rules(str(pb))

    ov = tiny.overrides(name)
    assert ov['config']['generator_params']['cols_z'] == 1  # its TINY
    out = harness.run(name, 11, 0.01, False, device='cpu', overrides=ov)
    assert out['correct'], out['compared']
    assert set(out['metrics']) == {'frame_s', 'setup_s'}
    out = harness.run(name, 11, 0.01, False, device='cpu',
                      overrides=dict(ov, config=dict(ov['config'],
                                                     port='untinted')))
    assert not out['correct'], out['compared']
    for drop in (('port',), ('reference',), ('port', 'reference')):
        c = {k: v for k, v in cfg.items() if k not in drop}
        with pytest.raises(ValueError, match='tint'):
            harness.parts(c)
    # the tinted reference sees the configuration; reference/ does not
    assert harness.reference_traffic(cfg, {})['config'] is cfg
    assert 'config' not in harness.reference_traffic(
        spec.config('colonnade'), {})
    after = _tree(pb)
    assert {k: after.get(k) for k in before} == before


def _imports(path):
    """Every module a file imports by its whole dotted name (an imported
    name counts as a module: `from a import b` gives a.b), and each
    relative one with its leading dots."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = '.' * node.level + (node.module or '')
            names |= {base + ('' if base.endswith('.') else '.') + a.name
                      for a in node.names}
    return names


def _keeps_the_import_rules(here):
    """No file under `here` imports JAX or the JAX package, by the whole
    top-level name; the plain references (reference/ and every package
    of references/) import nothing of the program, nor of the benchmark
    but reference/."""
    banned = set(run.FORBIDDEN)
    for dirpath, _, files in os.walk(here):
        kind = os.path.relpath(dirpath, here).split(os.sep)[0]
        for f in files:
            if not f.endswith('.py'):
                continue
            got = _imports(os.path.join(dirpath, f))
            tops = {g.split('.')[0] for g in got if not g.startswith('.')}
            assert not tops & banned, (f, tops & banned)
            if kind in ('reference', 'references'):
                assert 'yulio_raytracer_tpu_torch' not in tops, f
                assert not any(g.startswith('..') for g in got), f
                assert all(g == 'portbench.reference'
                           or g.startswith('portbench.reference.')
                           for g in got if g.split('.')[0] == 'portbench'), f


def test_no_jax_and_a_reference_apart_from_the_program():
    _keeps_the_import_rules(spec.HERE)
    # what a run loads, compared whole by the top-level name
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, run\n"
        "from portbench.tests import tiny\n"
        "w = 'colonnade.progressive_1024'\n"
        "out = harness.run(w, 3, 0.01, False, device='cpu',\n"
        "                  overrides=tiny.overrides(w, 8))\n"
        "assert 'yulio_raytracer_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n" % spec.ROOT)
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == '[]'
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import reference, scenes\n"
            "import torch\n"
            "d = scenes.GENERATORS['colonnade'](1, cols_x=1, cols_z=1,"
            " clutter=1)\n"
            "p = reference.prepare(d, 'cpu')\n"
            "cam = {'kind': 'pinhole', 'eye': [-9, 2.2, 0],"
            " 'look': [10, 1.6, 0], 'up': [0, 1, 0], 'fov': 65.0}\n"
            "tr = {'width': 4, 'height': 4, 'spp': 1, 'max_depth': 2}\n"
            "reference.pixels(p, tr, cam, torch.zeros(16, dtype=torch.long),"
            " torch.arange(16), 1)\n"
            "print(sorted(m for m in sys.modules if m.startswith('yulio')))\n"
            % spec.ROOT)
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'yulio_raytracer_tpu_torch_fake', sys)
    assert 'yulio_raytracer_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'yulio_raytracer_tpu.fake', sys)
    assert run.forbidden_modules() == ['yulio_raytracer_tpu']


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    """No CUDA device here, and in a directory holding only
    BENCHMARK.json and portbench/ the program is missing: either way
    the run exits non-zero and prints no result."""
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for root in (spec.ROOT, str(tmp_path)):
        r = subprocess.run(
            [sys.executable, 'portbench/run.py', '--workload',
             'sponza.frame_1024', '--seed', str(2 ** 31 + 5), '--seconds',
             '1', '--trace', '0'], capture_output=True, text=True,
            timeout=300, cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
        assert r.returncode != 0
        assert r.stdout.strip() == ''


def test_frozen_scenes_are_the_ports_at_its_seeds():
    """At the configurations' scene seeds the frozen generators give the
    port's own colonnade and sponza_like, mesh for mesh."""
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    for cfg, ours in (('colonnade', bs.colonnade),
                      ('sponza', bs.sponza_like)):
        c = spec.config(cfg)
        desc = scenes.GENERATORS[c['generator']](c['scene_seed'])
        sb = ours()
        theirs = [m for m in sb.meshes if m.light < 0]
        assert len(theirs) == len(desc['meshes'])
        for a, b in zip(desc['meshes'], theirs):
            assert (a['positions'] == b.positions).all()
            assert (a['triangles'] == b.triangles).all()
            assert a['material'] == b.material
        assert len(sb.textures.datas) == len(desc['textures'])


def test_trace_reduction_counts_launches_not_range_markers():
    """A profiler range shows on the device under its own name: that
    marker is neither busy time nor a launch; the port's kernels are
    told apart by their __global__ names, mangled or not; idle gaps go
    to the innermost host event open in them."""
    from types import SimpleNamespace as NS

    from portbench import tracing
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)

    def avg(key, dev, n, self_us, total_us=0.0):
        return NS(key=key, device_type=dev, count=n,
                  self_device_time_total=self_us,
                  device_time_total=total_us)

    def ev(name, dev, start, end):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=start, end=end))

    class Prof:
        def key_averages(self):
            return [avg('yrt.texture_fetch', cpu, 2, 0.0, 300.0),
                    avg('yrt.texture_fetch', cuda, 2, 500.0),
                    avg('aten::mul', cpu, 9, 0.0),
                    avg('_Z20occluded_wide_kernelILb0ELi4EEvPK6float4', cuda,
                        4, 100.0),
                    avg('void intersect_wide_kernel<false, 4>(float4 const*)',
                        cuda, 4, 50.0),
                    avg('void at::native::elementwise_kernel<128, 2>', cuda,
                        10, 250.0)]

        def events(self):
            return [ev('aten::mul', cpu, 0, 100),
                    ev('yrt.texture_fetch', cpu, 0, 100),
                    ev('cudaLaunchKernel', cpu, 40, 60),
                    ev('yrt.texture_fetch', cuda, 0, 100),
                    ev('k', cuda, 0, 30), ev('k', cuda, 70, 90)]

    red = tracing.reduce(Prof(), {'yrt.texture_fetch'})
    assert red['busy_us'] == 400.0 and red['launches'] == 18
    assert red['kernel_us'] == 150.0 and red['kernel_calls'] == 8
    assert red['span_us'] == {'yrt.texture_fetch': 300.0}
    assert red['device_ops'][0] == [
        'void at::native::elementwise_kernel<128, 2>', 250e-6]
    (name, seconds), = tracing.idle_gaps(Prof())
    assert name == 'cudaLaunchKernel' and seconds == pytest.approx(40e-6)
