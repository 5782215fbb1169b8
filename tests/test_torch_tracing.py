"""The port's tracer (utils/profiling.py) on the CPU: the span tree of a
frame with its parents and frame serials, under `trace` and
`trace_compacted`; the off path, which enters no record_function and
keeps nothing; the spans as torch.profiler ranges with the tracer off;
films bit-equal with the tracer on and off; the bounce counts against
FrameStats.num_rays; a two-thread mesh frame, one tree a thread;
bounce_stats read from the bounce records; the texture fetch's slot
counts, the lobes' lanes and the environment's escaped rays, made only
under the tracer; the plain lobes on CPU tensors; and profile_frame's
readings of a trace (idle_by_span, span_summary) on synthetic events."""
import os
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace as NS

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from yulio_raytracer_tpu_torch import profile_frame, raysets, renderer
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.parallel import sharding
from yulio_raytracer_tpu_torch.ops import cuda_build as cb
from yulio_raytracer_tpu_torch.shading import lobes as lb
from yulio_raytracer_tpu_torch.shading import materials as mat
from yulio_raytracer_tpu_torch.shading import textures as tex
from yulio_raytracer_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)
RES, SPP = 10, 2
# the spans each span opens inside (utils/profiling.py's tree)
PARENTS = {prof.FRAME: {None}, prof.PASS: {prof.FRAME},
           prof.RAYGEN: {prof.PASS}, prof.BOUNCE: {prof.PASS},
           prof.INTERSECT: {prof.BOUNCE}, prof.ENV: {prof.BOUNCE},
           prof.SHADE: {prof.BOUNCE}, prof.FETCH: {prof.SHADE},
           prof.NEE: {prof.BOUNCE}, prof.LIGHTS: {prof.NEE},
           prof.LOBES: {prof.NEE, prof.SCATTER}, prof.OCCLUDED: {prof.NEE},
           prof.SCATTER: {prof.BOUNCE},
           prof.RNG: {prof.RAYGEN, prof.NEE, prof.SCATTER},
           prof.COMPACT: {prof.PASS},
           prof.SYNC: {prof.COMPACT, prof.FRAME}, prof.FILM: {prof.FRAME}}


@pytest.fixture(scope='module')
def colonnade():
    return bs.colonnade(cols_x=2, cols_z=2, tess=(8, 10)).commit(
        device='cpu', leaf_size=32)


@pytest.fixture(scope='module')
def textured():
    return bs.sponza_like(stories=1, cols_x=2, cols_z=2, clutter=4,
                          num_textures=3).commit(device='cpu', leaf_size=32)


def _frame(scene, camera, compaction, seed=3, **kw):
    return renderer.render_frame(scene, camera(RES, RES),
                                 pt.PTParams(max_depth=6, rr_depth=2),
                                 RES, RES, spp=SPP, seed=seed,
                                 compaction=compaction, **kw)


def _parent(s):
    return None if s.parent is None else s.parent.name


def _root(s):
    while s.parent is not None:
        s = s.parent
    return s


@pytest.mark.parametrize('compaction', ['off', 'on'])
def test_span_tree(colonnade, compaction):
    """Two frames under the tracer: every span opens inside the span the
    tree names, each frame is one tree whose spans share its serial, a
    pass holds its bounces (and, compacted, a compaction after each but
    the last), and a frame ends with its film and its sync."""
    with prof.tracing() as t:
        for seed in (3, 4):
            _frame(colonnade, bs.colonnade_camera, compaction, seed)
    spans = t.spans()
    assert {s.name for s in spans} >= set(prof.SPANS) - {
        prof.FETCH, prof.ENV} - ({prof.COMPACT} if compaction == 'off'
                                 else set())
    for s in spans:
        assert _parent(s) in PARENTS[s.name], (s.name, _parent(s))
        assert s.start <= s.end and s.frame == _root(s).frame
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    frames = [s for s in spans if s.name == prof.FRAME]
    assert [f.frame for f in frames] == [0, 1]
    assert frames[0].attrs == {'width': RES, 'height': RES, 'spp': SPP}
    passes = [s for s in spans if s.name == prof.PASS]
    assert [p.attrs['rays'] for p in passes] == [RES * RES * SPP] * 2
    for p in passes:
        kids = [s.name for s in spans if s.parent is p]
        assert kids[0] == prof.RAYGEN
        bounces = kids[1:]
        if compaction == 'on':
            assert bounces[1::2] == [prof.COMPACT] * (len(bounces) // 2)
            bounces = bounces[::2]
        assert bounces == [prof.BOUNCE] * 6
    for f in frames:
        assert [s.name for s in spans if s.parent is f][-3:] == [
            prof.FILM, prof.FILM, prof.SYNC]
    depths = [s.attrs['depth'] for s in spans if s.name == prof.BOUNCE]
    assert depths == list(range(6)) * 2


def test_off_path_enters_nothing(colonnade, monkeypatch):
    """With the tracer off and no profiler a span is the shared no-op
    context: a frame enters no record_function and leaves no span open,
    and a span with counts runs no torch op.  A profiler turns the
    ranges on."""
    entered = []
    base = torch.autograd.profiler.record_function

    class Counting(base):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', Counting)
    assert prof.span(prof.BOUNCE, depth=0, width=8) is prof.OFF
    _frame(colonnade, bs.colonnade_camera, 'on')
    assert entered == [] and prof._stack() == [] and prof._tracer is None

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.ones(4)
    with Ops():
        with prof.span(prof.BOUNCE, depth=0, width=4) as s:
            s.set(rays=x, live=4)
    assert Ops.n == 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _frame(colonnade, bs.colonnade_camera, 'on')
    assert set(entered) >= {prof.FRAME, prof.BOUNCE, prof.COMPACT}


def test_profiler_ranges_nest_with_the_tracer_off(colonnade):
    """Under a CPU torch.profiler, with the tracer off, every span is a
    yrt.* range, each inside a range of the span the tree names on its
    thread, and nothing is kept."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        _frame(colonnade, bs.colonnade_camera, 'on')
    assert prof._tracer is None
    ev = [(e.name, e.time_range.start, e.time_range.end, e.thread)
          for e in p.events() if e.name in prof.SPANS]
    assert {e[0] for e in ev} >= {prof.FRAME, prof.PASS, prof.BOUNCE,
                                  prof.COMPACT, prof.SYNC, prof.NEE}
    for name, s, e, th in ev:
        if name == prof.FRAME:
            continue
        # the innermost range around it: the latest started that holds it
        around = [o for o in ev if o[3] == th and o[1] <= s and e <= o[2]
                  and o != (name, s, e, th)]
        assert around, name
        assert max(around, key=lambda o: o[1])[0] in PARENTS[name], name


@pytest.mark.parametrize('which', ['compacted', 'uncompacted', 'textured'])
def test_film_bit_equal_with_the_tracer(which, colonnade, textured):
    """The tracer changes no op of the render: the film and the ray count
    with it on equal those with it off, bit for bit."""
    scene, camera, how = {
        'compacted': (colonnade, bs.colonnade_camera, 'on'),
        'uncompacted': (colonnade, bs.colonnade_camera, 'off'),
        'textured': (textured, bs.sponza_like_camera, 'on')}[which]
    off, st_off = _frame(scene, camera, how)
    with prof.tracing() as t:
        on, st_on = _frame(scene, camera, how)
    assert torch.equal(off.rgb_sum, on.rgb_sum)
    assert torch.equal(off.weight, on.weight)
    assert st_off.num_rays == st_on.num_rays
    if which == 'textured':
        fetches = [s for s in t.spans() if s.name == prof.FETCH]
        assert fetches and all(_parent(s) in PARENTS[prof.FETCH]
                               for s in fetches)


@pytest.mark.parametrize('compaction', ['off', 'on'])
def test_bounce_counts_add_up_to_num_rays(colonnade, compaction):
    """Each bounce's rays and shadow candidates, numbers once the frame
    has ended, add up to FrameStats.num_rays; a compacted bounce's live
    lanes are the next bounce's width, every one of them traced."""
    with prof.tracing() as t:
        _, st = _frame(colonnade, bs.colonnade_camera, compaction)
    b = [s for s in t.spans() if s.name == prof.BOUNCE]
    assert all(type(v) in (int, float) for s in t.spans()
               for v in s.attrs.values())
    assert sum(s.attrs['rays'] + s.attrs.get('shadow', 0)
               for s in b) == st.num_rays
    assert all(0 <= s.attrs['rays'] <= s.attrs['width'] for s in b)
    if compaction == 'on':
        for s, nxt in zip(b, b[1:]):
            assert nxt.attrs['width'] == s.attrs['live'] == nxt.attrs['rays']
        assert 'live' not in b[-1].attrs
    else:
        assert {s.attrs['width'] for s in b} == {RES * RES * SPP}
    summ = profile_frame.span_summary(t.spans(), 1)
    assert summ['bounces'] == 6
    assert summ['live_pct'] == pytest.approx(
        100 * sum(s.attrs['rays'] for s in b)
        / sum(s.attrs['width'] for s in b))
    assert summ['enqueue_ms'] == pytest.approx(
        sum(s.end - s.start for s in b) / 1e6)


def test_mesh_frame_one_tree_per_thread(colonnade):
    """A frame over two CPU slots on threads of their own: the frame's
    tree on the calling thread, each slot's pass a tree of its own
    thread, all of one frame serial; the film is the one-device film."""
    mesh = sharding.make_mesh(devices=['cpu', 'cpu:0'])
    one, _ = _frame(colonnade, bs.colonnade_camera, 'on')
    with prof.tracing() as t:
        two, st = _frame(colonnade, bs.colonnade_camera, 'on', mesh=mesh)
    assert torch.equal(one.rgb_sum, two.rgb_sum)
    spans = t.spans()
    roots = {}
    for s in spans:
        if s.parent is None:
            roots.setdefault(s.thread, []).append(s.name)
        else:
            assert s.parent.thread == s.thread
    assert len(roots) == 3 and sorted(roots.values()) == [
        [prof.FRAME], [prof.PASS], [prof.PASS]]
    assert {s.frame for s in spans} == {0}
    b = [s for s in spans if s.name == prof.BOUNCE]
    assert len({s.thread for s in b}) == 2
    assert sum(s.attrs['rays'] + s.attrs['shadow'] for s in b) == st.num_rays


def test_bounce_stats_read_from_the_bounce_records(colonnade):
    """bounce_stats' dicts carry the bounce records' depth, width and
    live count, with the tracer on or off."""
    stats_off, stats_on = [], []
    _frame(colonnade, bs.colonnade_camera, 'on', bounce_stats=stats_off)
    with prof.tracing() as t:
        _frame(colonnade, bs.colonnade_camera, 'on', bounce_stats=stats_on)
    b = [s.attrs for s in t.spans() if s.name == prof.BOUNCE]
    assert [(d['depth'], d['width'], d['live']) for d in stats_on] == [
        (a['depth'], a['width'], a['live']) for a in b]
    assert [(d['depth'], d['width'], d['live']) for d in stats_off] == [
        (d['depth'], d['width'], d['live']) for d in stats_on]
    assert all(d['seconds'] > 0 for d in stats_off + stats_on)


def test_tracing_is_one_block_at_a_time():
    with prof.tracing() as t:
        with pytest.raises(RuntimeError):
            with prof.tracing():
                pass
        with prof.span(prof.FRAME, width=1) as f:
            with prof.span(prof.SYNC) as s:
                s.set(n=torch.tensor(3))
    assert t.spans() == [f, s] and s.parent is f and s.frame == f.frame == 0
    assert s.attrs == {'n': 3}
    assert prof._tracer is None and prof.span(prof.SYNC) is prof.OFF


def _atlas_and_slots(n=64):
    """A two-map atlas and (n, 4) ids (some < 0) with an (n, 2) uv."""
    b = tex.TextureTableBuilder()
    b.add(torch.rand(4, 5, 3, generator=torch.Generator().manual_seed(1))
          .numpy())
    b.add(torch.rand(3, 3, generator=torch.Generator().manual_seed(2))
          .numpy(), filter=tex.FILTER_NEAREST)
    atlas = {k: torch.as_tensor(v) for k, v in b.build().items()}
    g = torch.Generator().manual_seed(3)
    tid = torch.randint(-1, 2, (n, 4), generator=g)
    uv = torch.rand((n, 2), generator=g) * 3 - 1
    return atlas, tid, uv[:, None, :].expand(n, 4, 2)


class _Ops(TorchDispatchMode):
    """The aten ops run inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_fetch_counts_slots_under_the_tracer():
    """Under the tracer a fetch's span counts its slots (a host int) and
    those with an id >= 0 (a tensor until the frame's settle reads it);
    the result is the fetch's without the tracer."""
    atlas, tid, uv = _atlas_and_slots()
    off = tex.fetch(atlas, tid, uv)
    with prof.tracing() as t:
        with prof.span(prof.FRAME, width=8):
            on = tex.fetch(atlas, tid, uv)
            rec = [s for s in t.spans() if s.name == prof.FETCH][0]
            assert rec.attrs['slots'] == tid.numel() == 256
            assert isinstance(rec.attrs['texel_slots'], torch.Tensor)
            prof.settle(torch.tensor(1.0))
        assert rec.attrs['texel_slots'] == int((tid >= 0).sum())
        assert type(rec.attrs['texel_slots']) is int
        # a fetch outside any frame: read when the block ends
        tex.fetch(atlas, tid[:5, 0], uv[:5, 0])
    bump = [s for s in t.spans() if s.name == prof.FETCH][1]
    assert bump.attrs == {'slots': 5, 'texel_slots': int((tid[:5, 0]
                                                          >= 0).sum())}
    assert torch.equal(off, on)


def test_fetch_counts_no_slots_off_the_tracer():
    """With the tracer off, and under a bare profiler, a fetch makes no
    count: none of the tracer's ops (ge, sum) runs and its span keeps
    no attribute; under the tracer they run."""
    atlas, tid, uv = _atlas_and_slots()
    launches = tex.fetch.launches
    for how in ('off', 'profiler', 'tracer'):
        ops = _Ops()
        if how == 'profiler':
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as p:
                with ops:
                    tex.fetch(atlas, tid, uv)
            assert [e for e in p.events() if e.name == prof.FETCH]
        elif how == 'tracer':
            with prof.tracing() as t:
                with ops:
                    tex.fetch(atlas, tid, uv)
            assert set(t.spans()[0].attrs) == {'slots', 'texel_slots'}
        else:
            with ops:
                tex.fetch(atlas, tid, uv)
        counted = {'ge', 'sum'} & set(ops.names)
        assert counted == ({'ge', 'sum'} if how == 'tracer' else set()), how
    assert tex.fetch.launches == launches


def test_textured_frame_counts_its_fetches(textured):
    """A textured frame under the tracer: every fetch span carries its
    slots (4 a hit for the lobes' maps) and the slots that bind a map,
    numbers once the frame has ended, no more than its slots."""
    with prof.tracing() as t:
        _frame(textured, bs.sponza_like_camera, 'on')
    fetches = [s for s in t.spans() if s.name == prof.FETCH]
    assert fetches
    for s in fetches:
        assert s.attrs['slots'] % 4 == 0
        assert type(s.attrs['texel_slots']) is int
        assert 0 < s.attrs['texel_slots'] <= s.attrs['slots']


def test_textures_import_without_cuda():
    """textures.py imports, and fetches on the CPU, where no card is
    visible, building and loading no library."""
    code = ("import torch\n"
            "from yulio_raytracer_tpu_torch.ops import cuda_build as cb\n"
            "from yulio_raytracer_tpu_torch.shading import textures as t\n"
            "b = t.TextureTableBuilder()\n"
            "a = {k: torch.as_tensor(v) for k, v in b.build().items()}\n"
            "c = t.fetch(a, torch.tensor([0, -1]), torch.zeros(2, 2))\n"
            "assert torch.equal(c, torch.ones(2, 4)), c\n"
            "assert not torch.cuda.is_available()\n"
            "assert t.fetch.launches == 0 and cb._LIBS == {}\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_frame_fetch_calls_record_each_bounce(textured):
    """raysets.frame_fetch_calls: one call a bounce, over the (R, 4) lobe
    slots with the hits' (R, 2) uv expanded, not copied; each call's
    result is the fetch's on its arguments, and the fetch is put back."""
    fetch = tex.fetch
    calls = raysets.frame_fetch_calls(textured, bs.sponza_like_camera(16, 16),
                                      16, 16, spp=1, seed=5)
    assert tex.fetch is fetch and len(calls) == 2
    for c in calls:
        table, tid, uv = c['args']
        assert c['kernel'] == 'fetch' and tid.dim() == 2
        assert tid.shape[1] == 4 and bool((tid >= 0).any())
        assert uv.shape == tid.shape + (2,) and uv.stride(1) == 0
        assert torch.equal(c['out'], tex.fetch(table, tid, uv))


def test_frame_lobe_calls_record_each_bounce(textured):
    """raysets.frame_lobe_calls: each bounce's eval (NEE, one a light
    group, wi (lights, R, 3)) then its sample (the scatter), every
    argument by name with the defaults filled in; each call's result is
    the function's on its arguments, the functions and their launch
    counts are put back, and no plain call on CUDA tensors is counted."""
    fns = (lb.eval_lobes, lb.sample_lobes)
    counts = (lb.eval_lobes.launches, lb.sample_lobes.launches)
    calls = raysets.frame_lobe_calls(textured, bs.sponza_like_camera(16, 16),
                                     16, 16, spp=1, max_depth=3, seed=5)
    assert (lb.eval_lobes, lb.sample_lobes) == fns
    assert (lb.eval_lobes.launches, lb.sample_lobes.launches) == counts
    assert [c['kernel'] for c in calls] == ['eval_lobes',
                                            'sample_lobes'] * 3
    for c in calls:
        a = c['args']
        r = a['lobes']['type'].shape[0]
        assert a['types_present'] == textured.lobe_types
        if c['kernel'] == 'eval_lobes':
            assert a['type_mask'] == lb.DIFFUSE
            assert a['wi'].shape[1:] == (r, 3)
            assert torch.equal(c['out'], lb.eval_lobes(**a))
        else:
            assert a['type_mask'] == lb.ALL and a['s1'].shape == (r,)
            ref = lb.sample_lobes(**a)
            assert all(torch.equal(c['out'][k], ref[k]) for k in ref)
    assert lb._eval_lobes.cuda_calls == lb._sample_lobes.cuda_calls == 0


def _lobe_record(n=64, seed=4):
    """A lobe record of every type in every slot (a quarter NONE), with
    the hits' normals, directions, samples and tangents, on the CPU."""
    g = torch.Generator().manual_seed(seed)

    def unit(k):
        v = torch.randn((k, 3), generator=g)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)
    t = torch.randint(0, lb.NUM_LOBE_TYPES, (n, 4), generator=g)
    lobes = {'type': t, 'color': torch.rand((n, 4, 3), generator=g),
             'eta': 0.4 + 2 * torch.rand((n, 4), generator=g),
             'exp': 100 * torch.rand((n, 4), generator=g),
             'ceta': 0.2 + 2 * torch.rand((n, 4, 3), generator=g),
             'ck': 3 * torch.rand((n, 4, 3), generator=g)}
    return (lobes, unit(n), unit(n), unit(n), torch.rand((n, 2), generator=g),
            torch.rand((n,), generator=g), unit(n), unit(n))


def test_lobes_take_the_plain_path_on_the_cpu():
    """On CPU tensors eval_lobes and sample_lobes are their plain versions
    (equal results, with and without types_present), launch no kernel,
    load no library, and count no plain call on CUDA tensors."""
    lobes, ns, ng, wo, s2, s1, tx, ty = _lobe_record()
    wi = torch.stack([ns, wo, -ns])
    counts = (lb.eval_lobes.launches, lb.sample_lobes.launches,
              lb._eval_lobes.cuda_calls, lb._sample_lobes.cuda_calls)
    present = tuple(range(1, lb.NUM_LOBE_TYPES))
    for types_present in (None, present):
        assert torch.equal(
            lb.eval_lobes(lobes, ns, ng, wo, wi, lb.DIFFUSE, types_present),
            lb._eval_lobes(lobes, ns, ng, wo, wi, lb.DIFFUSE, types_present))
        got = lb.sample_lobes(lobes, ns, ng, wo, s2, s1, lb.ALL, tx, ty,
                              types_present)
        ref = lb._sample_lobes(lobes, ns, ng, wo, s2, s1, lb.ALL, tx, ty,
                               types_present)
        assert set(got) == set(ref)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert (lb.eval_lobes.launches, lb.sample_lobes.launches,
            lb._eval_lobes.cuda_calls, lb._sample_lobes.cuda_calls) == counts
    assert counts[2:] == (0, 0)
    assert not any(name == 'lobes' for name, _ in cb._LIBS)


def test_lobe_kernel_arguments_are_views_of_the_record(monkeypatch):
    """The kernels' wrappers hand their operators the record as (R, L)
    and (R, L, 3) rows read through the shade context's strides (no copy
    of a view into the material rows), wi as (lights, R, 3), s1 as (R,),
    and a frame's null tangents as None; what the operators write is what
    the calls return.  Checked on the CPU with the operators replaced by
    the plain versions over the same arguments."""
    seen = {}

    def fake_eval(ltype, color, eta, exp, ns, wo, wi, mask, out):
        seen['eval'] = (ltype, color, exp, wi, mask)
        out.copy_(lb._eval_lobes({'type': ltype, 'color': color, 'eta': eta,
                                  'exp': exp}, ns, None, wo, wi,
                                 mask).reshape(out.shape))

    def fake_sample(ltype, color, eta, exp, ceta, ck, ns, ng, wo, s2, s1,
                    tx, ty, mask, *outs):
        seen['sample'] = (ltype, exp, ceta, s1, tx, ty, mask)
        ref = lb._sample_lobes({'type': ltype, 'color': color, 'eta': eta,
                                'exp': exp, 'ceta': ceta, 'ck': ck}, ns, ng,
                               wo, s2, s1, mask, tx, ty)
        for o, k in zip(outs, ('wi', 'pdf', 'weight', 'type_bits', 'eta',
                               'valid')):
            o.copy_(ref[k])
    monkeypatch.setattr(lb, '_eval_op', fake_eval)
    monkeypatch.setattr(lb, '_sample_op', fake_sample)
    lobes, ns, ng, wo, s2, s1, tx, ty = _lobe_record()
    tab = torch.rand((64, 78))                   # material rows, as views
    lobes = dict(lobes, exp=tab[:, 24:28],
                 ceta=tab[:, 28:40].reshape(64, 4, 3))
    wi = torch.stack([ns, wo])
    got = lb._eval_kernel(lobes, ns, wo, wi, lb.DIFFUSE)
    ltype, color, exp, wi_arg, mask = seen['eval']
    assert ltype.shape == (64, 4) and color.shape == (64, 4, 3)
    assert exp.data_ptr() == tab[:, 24].data_ptr() and exp.stride() == (78, 1)
    assert wi_arg.shape == (2, 64, 3) and mask == lb.DIFFUSE
    assert torch.equal(got, lb._eval_lobes(lobes, ns, ng, wo, wi, lb.DIFFUSE))
    one = lb._eval_kernel(lobes, ns, wo, wo, lb.ALL)
    assert seen['eval'][3].shape == (1, 64, 3) and one.shape == (64, 3)
    for frame in ((tx, ty), (None, None)):
        got = lb._sample_kernel(lobes, ns, ng, wo, s2, s1, lb.ALL, *frame)
        ref = lb._sample_lobes(lobes, ns, ng, wo, s2, s1, lb.ALL, *frame)
        _, exp, ceta, s1_arg, tx_arg, ty_arg, _ = seen['sample']
        assert ceta.data_ptr() == tab[:, 28].data_ptr()
        assert ceta.stride() == (78, 3, 1) and s1_arg.shape == (64,)
        assert (tx_arg is None) == (frame[0] is None) == (ty_arg is None)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError):
        lb._eval_kernel(lobes, ns.double(), wo, wi, lb.DIFFUSE)
    with pytest.raises(ValueError):
        lb._sample_kernel(dict(lobes, type=lobes['type'][:, :0]), ns, ng, wo,
                          s2, s1, lb.ALL, None, None)


@pytest.mark.parametrize('bad', ['record', 'ns', 'wi', 's1', 'tx'])
def test_lobe_kernels_take_the_pathtracer_shapes_alone(bad, monkeypatch):
    """The kernels' wrappers take an (R, L) record, (R, 3) vectors, wi as
    (R, 3) or (nl, R, 3) and s1 as (R,), and raise ValueError, before any
    launch, on any other shape: a record with hit axes of its own, a
    vector broadcast over the hits, wi with two light axes, s1 of (R, 1),
    a tangent of another R."""
    monkeypatch.setattr(lb, '_eval_op', lambda *a: pytest.fail('launched'))
    monkeypatch.setattr(lb, '_sample_op', lambda *a: pytest.fail('launched'))
    lobes, ns, ng, wo, s2, s1, tx, ty = _lobe_record()
    wi = torch.stack([ns, wo])
    if bad == 'record':
        lobes = {k: v[None] for k, v in lobes.items()}
    elif bad == 'ns':
        ns = ns[:1]
    elif bad == 'wi':
        wi = wi[None]
    elif bad == 's1':
        s1 = s1[:, None]
    else:
        tx = tx[1:]
    with pytest.raises(ValueError):
        if bad in ('s1', 'tx'):
            lb._sample_kernel(lobes, ns, ng, wo, s2, s1, lb.ALL, tx, ty)
        else:
            lb._eval_kernel(lobes, ns, wo, wi, lb.DIFFUSE)
    if bad in ('record', 'ns'):
        with pytest.raises(ValueError):
            lb._sample_kernel(lobes, ns, ng, wo, s2, s1, lb.ALL, tx, ty)


def test_material_table_refuses_a_lobe_type_past_the_table():
    """materials.build_table, the one place lobe ids enter a scene, raises
    on an id outside 0..NUM_LOBE_TYPES-1, so no such id reaches a kernel
    (which reads one as a dead slot)."""
    for t in (-1, lb.NUM_LOBE_TYPES):
        spec = mat.MaterialSpec(lobes=[mat.LobeSpec(type=lb.LAMBERTIAN),
                                       mat.LobeSpec(type=t)])
        with pytest.raises(ValueError, match='lobe 1'):
            mat.build_table([spec])
    table = mat.build_table([mat.MaterialSpec(lobes=[
        mat.LobeSpec(type=lb.NUM_LOBE_TYPES - 1)])])
    assert table['lobe_type'][0, 0] == lb.NUM_LOBE_TYPES - 1


def test_lobe_kernel_wrappers_import_nothing_at_their_first_call():
    """The kernels' wrappers load no module at their first call (as
    torch.broadcast_shapes' first call would: sympy and some 500 modules,
    seconds of every run's set-up): a fresh process that runs both
    wrappers, their operators replaced, loads none."""
    code = ("import sys, torch\n"
            "import yulio_raytracer_tpu_torch.shading.lobes as lb\n"
            "lb._eval_op = lb._sample_op = lambda *a: None\n"
            "t = torch.zeros((4, 4), dtype=torch.int64)\n"
            "v, s = torch.zeros((4, 4)), torch.zeros((4, 4, 3))\n"
            "lobes = {'type': t, 'color': s, 'eta': v, 'exp': v, "
            "'ceta': s, 'ck': s}\n"
            "n, u = torch.ones((4, 3)), torch.zeros((4, 2))\n"
            "before = set(sys.modules)\n"
            "lb._eval_kernel(lobes, n, n, torch.stack([n, n]), lb.DIFFUSE)\n"
            "lb._sample_kernel(lobes, n, n, n, u, u[:, 0], lb.ALL, n, n)\n"
            "print(sorted(set(sys.modules) - before))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'


def test_lobes_count_lanes_under_the_tracer(textured, monkeypatch):
    """Under the tracer each yrt.lobes record carries its call's lanes, a
    host int: the bounce's width times the lights of the group for an
    eval (in yrt.nee), the bounce's width for a sample (in yrt.scatter);
    profile_frame sums them.  A bare profiler and the tracer off set no
    lanes."""
    with prof.tracing() as t:
        _frame(textured, bs.sponza_like_camera, 'on')
    spans = t.spans()
    lobes = [s for s in spans if s.name == prof.LOBES]
    assert lobes and all(type(s.attrs['lanes']) is int for s in lobes)
    for s in lobes:
        width = _root_bounce(s).attrs['width']
        if _parent(s) == prof.SCATTER:
            assert s.attrs['lanes'] == width
        else:
            assert s.attrs['lanes'] % width == 0 and s.attrs['lanes'] > width
    summ = profile_frame.span_summary(spans, 1)
    assert summ['lobe_calls'] == len(lobes)
    assert summ['lobe_lanes'] == sum(s.attrs['lanes'] for s in lobes)
    counted = []
    base = prof.Span.set

    def count(self, **counts):
        counted.extend(counts)
        return base(self, **counts)
    monkeypatch.setattr(prof.Span, 'set', count)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _frame(textured, bs.sponza_like_camera, 'on')
    _frame(textured, bs.sponza_like_camera, 'on')
    assert counted and 'lanes' not in counted


def _root_bounce(s):
    while s.name != prof.BOUNCE:
        s = s.parent
    return s


@pytest.fixture(scope='module')
def test_stereo():
    """test_stereo.ecs (an HDRI and the dome) as -stereo commits it, and
    face 2 of its rig."""
    from yulio_raytracer_tpu_torch.api import cli
    from yulio_raytracer_tpu_torch.io import ecs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    settings, sb = ecs.parse_ecs(os.path.join(root, 'assets', 'scenes',
                                              'test_stereo.ecs'))
    return (sb.commit(device='cpu', accel=settings.accel),
            cli.stereo_rigs(settings)[0][1][2])


def _stereo_frame(scene_cam):
    scene, camera = scene_cam
    return renderer.render_frame(
        scene, camera, pt.PTParams(max_depth=6, rr_depth=2,
                                   t_max_shadow_ray=120.0),
        RES, RES, spp=SPP, seed=3, compaction='on', pixel_filter='bspline')


def test_env_counts_the_escaped_rays(test_stereo, monkeypatch):
    """Under the tracer each bounce's yrt.env record counts the rays that
    missed (`escaped`, a number once the frame has ended): bounce for
    bounce, the misses counted from each closest-hit call's own result
    (live lanes, tfar > 0, without a hit); profile_frame's escaped share
    is their sum over the rays traced."""
    calls = []
    closest = pt._intersect

    def counted(scene, org, dirn, tnear, tfar, *args, **kw):
        hit = closest(scene, org, dirn, tnear, tfar, *args, **kw)
        calls.append(int(torch.sum((tfar > 0) & ~hit.valid)))
        return hit
    monkeypatch.setattr(pt, '_intersect', counted)
    with prof.tracing() as t:
        _stereo_frame(test_stereo)
    env = [s for s in t.spans() if s.name == prof.ENV]
    b = [s for s in t.spans() if s.name == prof.BOUNCE]
    assert len(env) == len(b) == len(calls) > 1
    assert all(_parent(s) == prof.BOUNCE and type(s.attrs['escaped']) is int
               for s in env)
    assert [s.attrs['escaped'] for s in env] == calls
    rays = sum(s.attrs['rays'] for s in b)
    assert 0 < sum(calls) < rays
    assert profile_frame.span_summary(t.spans(), 1)['escaped_pct'] == \
        pytest.approx(100.0 * sum(calls) / rays)


def test_env_count_adds_no_op_off_the_tracer(test_stereo):
    """With the tracer off the frame runs the aten ops it runs under a
    bare profiler (which adds its ranges' enter and exit alone), and the
    tracer adds only its counts: a sum a yrt.env record (over the misses'
    mask the escaped radiance takes, made once), a ge and a sum a fetch,
    and the frame's one read of them all."""
    runs = {}
    for how in ('off', 'profiler', 'tracer'):
        ops = _Ops()
        if how == 'profiler':
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]):
                with ops:
                    _stereo_frame(test_stereo)
        elif how == 'tracer':
            with prof.tracing() as t:
                with ops:
                    _stereo_frame(test_stereo)
        else:
            with ops:
                _stereo_frame(test_stereo)
        runs[how] = ops.names
    assert [n for n in runs['profiler']
            if not n.startswith('_record_function')] == runs['off']
    n_env = sum(s.name == prof.ENV for s in t.spans())
    n_fetch = sum(s.name == prof.FETCH for s in t.spans())
    assert n_env > 1 and n_fetch > 1
    extra = Counter(runs['tracer']) - Counter(runs['off'])
    assert extra['sum'] == n_env + n_fetch and extra['ge'] == n_fetch
    assert set(extra) <= {'sum', 'ge', 'stack', '_to_copy', 'view'}
    assert Counter(runs['off']) - Counter(runs['tracer']) == Counter(
        {'_local_scalar_dense': 1})


def test_idle_by_span_on_synthetic_events():
    """Each idle gap goes to the class of the spans open at its middle;
    the classes add up to the gaps' total; a gap under a long-open outer
    span, hundreds of host events after it opened, is still found; the
    spans' device markers are no activity."""
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)

    def ev(name, dev, start, end):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=start, end=end))

    host = [ev(prof.FRAME, cpu, 0, 10000), ev(prof.PASS, cpu, 100, 9000),
            ev(prof.BOUNCE, cpu, 200, 3000), ev(prof.COMPACT, cpu, 3000, 3500),
            ev(prof.SYNC, cpu, 3400, 3500), ev(prof.BOUNCE, cpu, 3500, 6000),
            ev(prof.FILM, cpu, 9000, 9500)]
    host += [ev('aten::mul', cpu, 6000 + 5 * i, 6002 + 5 * i)
             for i in range(600)]
    dev = [ev('k', cuda, a, b) for a, b in (
        (0, 1100), (1300, 3100), (1400, 1500), (3300, 6500), (6700, 9600),
        (9800, 10100), (10300, 10400))]
    dev += [ev(prof.BOUNCE, cuda, 200, 6000), ev(prof.FRAME, cuda, 0, 10400)]

    class Prof:
        def events(self):
            return host + dev

    got = profile_frame.idle_by_span(Prof())
    want = {'bounce': 200e-6, 'compact': 200e-6, 'frame': 400e-6,
            'outside': 200e-6}
    assert got == pytest.approx(dict(want, total=1000e-6))
    assert sum(got[c] for c in profile_frame.IDLE_CLASSES) == pytest.approx(
        got['total'])
