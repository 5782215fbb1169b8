"""The RNG's dispatch on the CPU (core/rng.py): CPU tensors take the plain
int64 versions, whose bits tests/test_torch_core.py holds against the JAX
package; the host side of the card's kernel F3 (csrc/rng.cu), its terms
and streams, run through a numpy model of the kernel's u32 arithmetic
and held bit for bit to the plain versions; the kernel's declaration;
dims as host ints against their (k, 1) tensor form; the yrt.rng span;
and a first call that loads no module."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu_torch import profile_frame
from yulio_raytracer_tpu_torch.core import rng
from yulio_raytracer_tpu_torch.ops import cuda_build as cb
from yulio_raytracer_tpu_torch.utils import profiling as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 1001
# ids at the edges of the u32 mask: 0, 2^32 - 1, 2^32 and 2^40
EDGES = [0, 2**32 - 1, 2**32, 2**40]
SEED = 2**31 + 12345


def _ids(seed, n=R):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 2**62, (n,), generator=g, dtype=torch.int64)
    x[:len(EDGES)] = torch.tensor(EDGES)
    return x


def _mix(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def _unit(u):
    return u.astype(np.float32) * np.float32(2.0 ** -32)


def _kernel(s0, s1, s2, s3, terms, n, out):
    """csrc/rng.cu's arithmetic in numpy u32, over the same arguments as
    the operator yrt::rng_uniform."""
    streams = [x.numpy().astype(np.uint32) for x in (s0, s1, s2, s3)
               if x is not None]
    muls = [m for x, m in zip((s0, s1, s2, s3), rng._MULS) if x is not None]
    with np.errstate(over='ignore'):
        h = np.zeros(streams[0].shape, np.uint32)
        for x, m in zip(streams, muls):
            h ^= x * np.uint32(m)
        rows = []
        for t in terms:
            key = _mix(h ^ np.uint32(t))
            if n == 0:
                rows.append(key.astype(np.int64))
            elif n == 1:
                rows.append(_unit(key))
            else:
                rows.append(np.stack(
                    [_unit(_mix(key ^ np.uint32(s))) for s in
                     (0x632BE59B, 0x85EBCA6B, 0xC2B2AE35)[:n]], -1))
    got = np.stack(rows).reshape(out.shape)
    out.copy_(torch.from_numpy(got))


# every form of a draw the port's callers make, by kind n: (seed, pixel,
# sample, dim) for the uniforms, (a, b, c, d) for the hash
FORMS = {
    'nee_6': (2, lambda p, s: (SEED, p, s, [24 + li for li in range(6)])),
    'nee_1': (2, lambda p, s: (SEED, p, s, [24])),
    'shadow_2': (1, lambda p, s: (SEED, p, s, [19, 20])),
    'lights_20': (2, lambda p, s: (SEED, p, s, list(range(23, 43)))),
    'lights_70': (1, lambda p, s: (7, p, s, list(range(3, 73)))),
    'scatter': (2, lambda p, s: (SEED, p, s, 16)),
    'scatter_type': (1, lambda p, s: (SEED, p, s, 17)),
    'debug': (2, lambda p, s: (0, p, 0, 8 + 3)),
    'bspline': (2, lambda p, s: (42, p, s, [0x5F375A86, 0x2545F491,
                                             0x9E3779B9])),
    'uniform3': (3, lambda p, s: (SEED, p, s, 5)),
    'uniform3_dims': (3, lambda p, s: (SEED, p, s, [5, 2**32 + 6])),
    'scramble': (0, lambda p, s: (p, 0, SEED, 0x9E3779B9)),
    'all_lanes': (1, lambda p, s: (p, s, p ^ s, s)),
}


@pytest.mark.parametrize('form', sorted(FORMS))
def test_kernel_host_side_matches_plain(form, monkeypatch):
    """draw's terms and streams, through a numpy model of the kernel, give
    the plain versions' bits and shapes on every form: ids at 0, 2^32 - 1,
    2^32 and 2^40, a seed above 2^31, 1 to 70 dims (the kernel launches
    once for each 64), an int sample and a lane tensor in every place."""
    monkeypatch.setattr(rng, '_uniform_op', _kernel)
    n, make = FORMS[form]
    args = make(_ids(1), _ids(2))
    got = rng.draw(n, *args)
    ref = rng.PLAIN[n](*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors every draw runs the plain version (never the
    kernel's wrapper) with its bits; the plain versions count no CUDA
    call."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")
    monkeypatch.setattr(rng, 'draw', refuse)
    p, s = _ids(3), _ids(4)
    cuda_calls = [f.cuda_calls for f in rng.PLAIN.values()]
    for fn, n in (('uniform1', 1), ('uniform2', 2), ('uniform3', 3)):
        for dim in (9, [9, 10, 11]):
            got = getattr(rng, fn)(SEED, p, s, dim)
            assert torch.equal(got, rng.PLAIN[n](SEED, p, s, dim))
    assert torch.equal(rng.hash_u32(p, 0, SEED, 0x9E3779B9),
                       rng._hash_u32_plain(p, 0, SEED, 0x9E3779B9))
    assert [f.cuda_calls for f in rng.PLAIN.values()] == cuda_calls


@pytest.mark.parametrize('k', [1, 2, 6, 20])
@pytest.mark.parametrize('fn', ['uniform1', 'uniform2', 'uniform3'])
def test_host_int_dims_match_the_tensor_form(fn, k):
    """Dims given as k host ints draw the bits of the (k, 1) tensor of
    them, as the NEE and the shadow cap built it before."""
    p, s = _ids(5), _ids(6)
    dims = [(2**32 - 3 + 5 * i) & rng._MASK for i in range(k)]
    got = getattr(rng, fn)(SEED, p, s, dims)
    ref = getattr(rng, fn)(SEED, p, s, torch.tensor(dims)[:, None])
    assert got.shape[:2] == (k, R)
    assert torch.equal(got, ref)


def test_the_kernel_is_declared():
    """rng.cu's kernel is among the sources' kernels (profile_frame names
    its template instances), launched through the operator yrt::rng_uniform
    that cuda_build.operator declared, counted on rng.draw."""
    assert 'rng_uniform_kernel' in cb.kernel_names()
    assert profile_frame.kernel_of(
        '_Z18rng_uniform_kernelILi2EEvPKxS1_S1_S1_x5Termsi') == (
            'rng_uniform_kernel')
    assert profile_frame.kernel_of(
        'void rng_uniform_kernel<1>(long long const*, long long const*, '
        'long long const*, long long const*, long long, Terms, int, void*)'
    ) == 'rng_uniform_kernel'
    op, entry, launch = cb.OPERATORS['rng_uniform']
    assert op is rng._uniform_op and entry == 'yrt_rng_uniform'
    assert launch is rng.launch_uniform and hasattr(rng.draw, 'launches')
    assert set(rng._SIGNATURES) == {entry}


def test_rng_span_records_lanes_under_the_tracer():
    """Every draw is a yrt.rng span: under tracing() it records its lanes,
    k x R as a host int; with the tracer off and no profiler the span is
    the shared OFF and nothing is kept; under a profiler it is a range."""
    p, s = _ids(7, 50), _ids(8, 50)
    with prof.tracing() as t:
        rng.uniform2(1, p, s, [3, 4, 5])
        rng.uniform1(1, p, s, 3)
        rng.hash_u32(p, 0, 1, 0x9E3779B9)
    spans = t.spans()
    assert [(x.name, x.attrs) for x in spans] == [
        (prof.RNG, {'lanes': 150}), (prof.RNG, {'lanes': 50}),
        (prof.RNG, {'lanes': 50})]
    assert all(type(x.attrs['lanes']) is int for x in spans)
    assert prof.span(prof.RNG) is prof.OFF
    rng.uniform2(1, p, s, 3)
    assert prof._tracer is None and prof._stack() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as pr:
        rng.uniform2(1, p, s, 3)
    assert prof.RNG in {e.name for e in pr.events()}


def test_first_call_loads_no_module():
    """The dispatch's first call of each form imports nothing (a lazy
    import there, as torch.broadcast_shapes' of sympy, is seconds of a
    run's set-up)."""
    code = (
        "import sys, torch\n"
        "from yulio_raytracer_tpu_torch import renderer\n"
        "from yulio_raytracer_tpu_torch.core import rng\n"
        "p = torch.arange(64, dtype=torch.int64)\n"
        "before = set(sys.modules)\n"
        "rng.uniform2(3, p, p, [1, 2, 3])\n"
        "rng.uniform1(3, p, 0, 4)\n"
        "rng.uniform3(3, p, p, 5)\n"
        "rng.hash_u32(p, 0, 3, 0x9E3779B9)\n"
        "print(sorted(set(sys.modules) - before))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'


def test_frame_rng_calls_record_every_draw():
    """raysets.frame_rng_calls: a frame's draws in order, the camera
    samples (the stratum's scramble, its jitter, the lens) then, each
    bounce, one light-sample draw a light group with its lights' dims as
    host ints, and the scatter's 2D and 1D samples; each result is the
    plain version's on the recorded arguments, and rng._draw is put
    back."""
    from yulio_raytracer_tpu_torch import raysets
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    scene = bs.sponza_like(stories=1, cols_x=2, cols_z=2, clutter=4,
                           num_textures=3).commit(device='cpu', leaf_size=32)
    fn = rng._draw
    calls = raysets.frame_rng_calls(scene, bs.sponza_like_camera(8, 8), 8, 8,
                                    spp=2, max_depth=3, seed=SEED)
    assert rng._draw is fn
    groups = len({l['kind'] for l in scene.lights})
    kinds = [(c['args'][0], isinstance(c['args'][4], list)) for c in calls]
    assert kinds == [(0, False), (2, False), (2, False)] + (
        [(2, True)] * groups + [(2, False), (1, False)]) * 3
    for c in calls:
        n, *args = c['args']
        assert torch.equal(c['out'], rng.PLAIN[n](*args))
        assert c['args'][1 if n else 3] == SEED


def test_rng_spans_of_a_frame():
    """Under the tracer every draw of a frame is a yrt.rng record inside
    the raygen, the NEE or the scatter, its lanes the pass's rays there,
    a multiple of its bounce's width in the NEE (the lights of a group,
    the shadow cap's jitter) and the width in the scatter; profile_frame
    counts them and sums their lanes."""
    from yulio_raytracer_tpu_torch import renderer
    from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
    from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
    scene = bs.colonnade(cols_x=2, cols_z=2, tess=(8, 10)).commit(
        device='cpu', leaf_size=32)
    params = pt.PTParams(max_depth=6, rr_depth=2, t_max_shadow_ray=120.0)
    with prof.tracing() as t:
        renderer.render_frame(scene, bs.colonnade_camera(8, 8), params, 8, 8,
                              spp=2, seed=SEED, compaction='on')
    spans = t.spans()
    draws = [s for s in spans if s.name == prof.RNG]
    where = {prof.RAYGEN: 0, prof.NEE: 0, prof.SCATTER: 0}
    for s in draws:
        where[s.parent.name] += 1
        if s.parent.name == prof.RAYGEN:
            assert s.attrs['lanes'] == 8 * 8 * 2
            continue
        width = s.parent.parent.attrs['width']
        if s.parent.name == prof.SCATTER:
            assert s.attrs['lanes'] == width
        else:
            assert s.attrs['lanes'] % width == 0
    bounces = sum(s.name == prof.BOUNCE for s in spans)
    assert where[prof.RAYGEN] == 3 and where[prof.NEE] >= 2 * bounces
    summ = profile_frame.span_summary(spans, 1)
    assert summ['rng_calls'] == len(draws)
    assert summ['rng_lanes'] == sum(s.attrs['lanes'] for s in draws)
