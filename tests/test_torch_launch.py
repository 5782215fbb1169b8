"""The port's one launch route, on the CPU: every kernel of csrc/ is
launched through a torch operator that ops/cuda_build.operator declares,
writing its outputs alone, with a CUDA implementation only; every
cb.launch call lies in a launch function an operator runs; the
kernel-name list read from csrc/; and the turns tool's command line
without a card."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from portbench import tracing
from yulio_raytracer_tpu_torch import profile_frame
from yulio_raytracer_tpu_torch import proto_sublane_sweep as sweep
from yulio_raytracer_tpu_torch import turns
from yulio_raytracer_tpu_torch.core import rng
from yulio_raytracer_tpu_torch.ops import cuda_build as cb
from yulio_raytracer_tpu_torch.ops import (dense, grid, pairs, splitleaf,
                                           traverse, wide)
from yulio_raytracer_tpu_torch.shading import lobes, textures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'yulio_raytracer_tpu_torch')
HIT = ('t', 'tri', 'u', 'v')
# every operator of the port and the outputs it writes
OPERATORS = {
    'intersect_dense': HIT, 'occluded_dense': ('occ',),
    'intersect_wide': HIT, 'occluded_wide': ('occ',),
    'intersect_wide8': HIT, 'occluded_wide8': ('occ',),
    'intersect_binary': HIT, 'occluded_binary': ('occ',),
    'intersect_motion': HIT, 'occluded_motion': ('occ',),
    'bin_pairs': ('scratch', 't', 'slot', 'occ'),
    'intersect_pairs': ('t', 'slot'), 'occluded_pairs': ('occ',),
    'grid_march': ('t', 'slot'), 'intersect_split': HIT,
    'sweep_rows': ('keys', 't', 'tri'), 'sweep_tiles': ('keys', 't', 'tri'),
    'texture_fetch': ('out',), 'lobes_eval': ('out',),
    'lobes_sample': ('wi', 'pdf', 'weight', 'type_bits', 'eta_out',
                     'valid'),
    'rng_uniform': ('out',),
}
# each module's C entry points, by the source they are built from
SIGNATURES = {'dense': dense._SIGNATURES, 'wide': wide._SIGNATURES,
              'binary': traverse._SIGNATURES, 'grid': pairs._SIGNATURES,
              'splitleaf': splitleaf._SIGNATURES, 'sweep': sweep._SIGNATURES,
              'texture': textures._SIGNATURES, 'lobes': lobes._SIGNATURES,
              'rng': rng._SIGNATURES}
# entry points that launch nothing: they return a size to the host
QUERIES = {'yrt_pairs_scratch', 'yrt_sweep_block_rays'}
MODULES = (dense, wide, traverse, pairs, grid, splitleaf, sweep, textures,
           lobes, rng)


def _launch_counts():
    """Every wrapper's launch count in the declaring modules."""
    return {(m.__name__, k): v.launches for m in MODULES
            for k, v in vars(m).items() if hasattr(v, 'launches')}


@pytest.fixture(scope='module')
def second_copy():
    """The operators' names in a process that imports the package, then a
    second copy of it under the package name `_other_yrt`."""
    code = ("import importlib, importlib.util, os, sys\n"
            f"mods = {[m.__name__.split('.', 1)[1] for m in MODULES]!r}\n"
            "for m in mods:\n"
            "    importlib.import_module('yulio_raytracer_tpu_torch.' + m)\n"
            f"pkg = {PKG!r}\n"
            "spec = importlib.util.spec_from_file_location('_other_yrt', "
            "os.path.join(pkg, '__init__.py'), "
            "submodule_search_locations=[pkg])\n"
            "sys.modules['_other_yrt'] = importlib.util.module_from_spec("
            "spec)\n"
            "spec.loader.exec_module(sys.modules['_other_yrt'])\n"
            "for m in mods:\n"
            "    importlib.import_module('_other_yrt.' + m)\n"
            "from yulio_raytracer_tpu_torch.ops import cuda_build as a\n"
            "b = importlib.import_module('_other_yrt.ops.cuda_build')\n"
            "print(' '.join(str(d[0]) for d in a.OPERATORS.values()))\n"
            "print(' '.join(str(d[0]) for d in b.OPERATORS.values()))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    first, second = out.stdout.splitlines()
    return first.split(), second.split()


def test_the_operators_are_the_ports_kernels():
    assert set(cb.OPERATORS) == set(OPERATORS)


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_ops_are_declared_for_cuda_alone(name, second_copy):
    """Each operator is declared at import as yrt::<name>, writing its
    outputs alone, with a CUDA implementation only: CPU tensors raise
    NotImplementedError and bump no launch count.  A second copy of the
    package in one process declares yrt::<name>_ of its own."""
    op, entry, _ = cb.OPERATORS[name]
    assert str(op) == f'yrt.{name}' and entry == f'yrt_{name}'
    args = op.default._schema.arguments
    assert tuple(a.name for a in args
                 if a.alias_info and a.alias_info.is_write) == OPERATORS[name]
    assert all(a.alias_info is None for a in args
               if a.name not in OPERATORS[name])
    cpu = [0 if str(a.type) == 'int' else [0] if str(a.type) == 'List[int]'
           else torch.zeros(1) for a in args]
    before = _launch_counts()
    with pytest.raises(NotImplementedError):
        op(*cpu)
    assert _launch_counts() == before
    first, second = second_copy
    assert f'yrt.{name}' in first and f'yrt.{name}_' in second


@pytest.mark.parametrize('source', sorted(SIGNATURES))
def test_every_entry_point_is_launched_by_an_operator(source):
    """Every C entry point of a source that launches a kernel is an
    operator's, or its *_slots form, which the operator's launch picks;
    the operator's launch function is that of the module holding the
    wrapper it counts."""
    entries = {entry for _, entry, _ in cb.OPERATORS.values()}
    for fn in set(SIGNATURES[source]) - QUERIES:
        assert fn.removesuffix('_slots') in entries, fn
    for _, entry, launch in cb.OPERATORS.values():
        if entry in SIGNATURES[source]:
            assert launch.__name__.startswith('launch')


def _calls(tree, attr, owner=None):
    """The (enclosing function, call) pairs of calls of `.attr` (on the
    name owner, where given) in a module's tree."""
    found = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(child, ast.FunctionDef)
                     else func)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == attr
                    and (owner is None or (isinstance(child.func.value,
                                                      ast.Name)
                                           and child.func.value.id == owner))):
                found.append((func, child))
            walk(child, inner)
    walk(tree, None)
    return found


def test_kernels_launch_through_the_launch_functions_alone():
    """Outside ops/cuda_build.py no module of the package calls cb.launch
    but in a launch function an operator runs, nor a C entry point that
    launches a kernel straight from ctypes; torch.library.Library is made
    once."""
    launches = {(fn.__module__, fn.__name__)
                for _, _, fn in cb.OPERATORS.values()}
    entries = set().union(*SIGNATURES.values()) - QUERIES
    libraries = 0
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                text = fh.read()
            libraries += text.count('torch.library.Library(')
            if path.endswith(os.path.join('ops', 'cuda_build.py')):
                continue
            tree = ast.parse(text)
            module = 'yulio_raytracer_tpu_torch.' + os.path.relpath(
                path, PKG)[:-3].replace(os.sep, '.')
            for func, _ in _calls(tree, 'launch', 'cb'):
                assert (module, func) in launches, (module, func)
            for entry in entries:
                assert not _calls(tree, entry), (module, entry)
    assert libraries == 1


def test_kernel_names_are_read_from_the_sources():
    """cuda_build.kernel_names holds the benchmark's kernel list and the
    texture fetch's, the lobes' and the RNG's kernels, and profile_frame
    counts each by its mangled or demangled name."""
    names = cb.kernel_names()
    shading = {'texture_fetch_kernel', 'lobes_eval_kernel',
               'lobes_sample_kernel', 'rng_uniform_kernel'}
    assert names >= set(tracing.KERNELS) | shading
    assert profile_frame.kernel_of('_Z20texture_fetch_kernelPK6float4') == (
        'texture_fetch_kernel')
    assert profile_frame.kernel_of('void lobes_eval_kernel(EvalArgs)') == (
        'lobes_eval_kernel')
    assert profile_frame.kernel_of('void at::native::elementwise_kernel<128'
                                   ', 4>(int)') is None


@pytest.mark.parametrize('family, flags', [
    ('wide', []), ('pairs', ['--spp', '4', '--bounds']),
    ('binary', ['--bounds', '--sets', 'motion']), ('dense', ['--bounds']),
    ('incoherent', ['--bounds', '--sets', 'split']),
    ('sweep', ['--bounds', '--sass-dir', 'x'])])
def test_turns_needs_a_card(family, flags, tmp_path):
    """Each family of the turns tool takes its flags and exits 1 without a
    CUDA device, before it builds or imports anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert turns.main([family, str(tmp_path), '--rounds', '3', *flags]) == 1
