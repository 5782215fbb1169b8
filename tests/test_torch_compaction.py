"""The torch port's production bounce on the CPU: the dome shadow cap and
Russian roulette held against the JAX package (images >= 60 dB, equal ray
counts), and live-ray compaction (`trace_compacted`) held bit-equal to
`trace`, with its per-bounce stats and the 'auto' gate mirroring the JAX
package's tests (tests/test_integrator.py)."""
import numpy as np
import pytest
import torch

from yulio_raytracer_tpu.io import builtin_scenes as jbs
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum

from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.sampling import patterns

torch.set_num_threads(2)
COLONNADE_SMALL = dict(cols_x=3, cols_z=2, tess=(8, 10))


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _against_jax(scene, jscene, cam, jcam, res, spp, **params):
    """Port and JAX render_frame (each with its default compaction) on the
    same config: (PSNR, port rays, JAX rays)."""
    film, stats = renderer.render_frame(scene, cam, pt.PTParams(**params),
                                        res, res, spp=spp, seed=42)
    jfilm, jstats = jrenderer.render_frame(
        jscene, jcam, jpt.PTParams(**params), res, res, spp=spp, seed=42)
    img = accum.resolve(film).numpy()
    assert np.isfinite(img).all()
    return (_psnr(img, np.asarray(jaccum.resolve(jfilm))), stats.num_rays,
            jstats.num_rays)


def _colonnade():
    return (bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                   leaf_size=32),
            jbs.colonnade(**COLONNADE_SMALL).commit(leaf_size=32))


@pytest.mark.parametrize('cap,jitter', [(4.0, 0.15), (4.0, 0.0),
                                        (120.0, 0.15)])
def test_shadow_cap_matches_jax(cap, jitter):
    """A finite cap (shorter than the way to the lights, and the
    production 120, which reaches past them) on the reduced colonnade at
    depth 3 (no roulette, no compaction): >= 60 dB, equal rays."""
    scene, jscene = _colonnade()
    db, n, jn = _against_jax(scene, jscene, bs.colonnade_camera(16, 16),
                             jbs.colonnade_camera(16, 16), 16, 2,
                             max_depth=3, t_max_shadow_ray=cap,
                             t_max_shadow_jitter=jitter)
    assert db >= 60.0 and n == jn


@pytest.mark.parametrize('which', ['cornell', 'colonnade'])
def test_russian_roulette_matches_jax(which):
    """Roulette on (depth past rr_depth 5): cornell 16^2, depth 8, 4 spp
    (dense: trace) and the reduced colonnade 16^2, depth 7, 2 spp (BVH4:
    trace_compacted in both packages), >= 60 dB with equal ray counts."""
    if which == 'cornell':
        scene, jscene = (bs.cornell_box().commit(device='cpu'),
                         jbs.cornell_box().commit())
        cams, spp, depth = (bs.cornell_camera(16, 16),
                            jbs.cornell_camera(16, 16)), 4, 8
    else:
        scene, jscene = _colonnade()
        cams, spp, depth = (bs.colonnade_camera(16, 16),
                            jbs.colonnade_camera(16, 16)), 2, 7
    db, n, jn = _against_jax(scene, jscene, *cams, 16, spp, max_depth=depth)
    assert db >= 60.0 and n == jn


def _stats_shape(stats):
    """The checks of the JAX package's compaction test on one pass's
    per-bounce stats."""
    lives = [s['live'] for s in stats]
    widths = [s['width'] for s in stats]
    assert [s['depth'] for s in stats] == list(range(len(stats)))
    assert lives == sorted(lives, reverse=True)
    assert widths == sorted(widths, reverse=True)
    assert all(w >= l for w, l in zip(widths[1:], lives[:-1])), \
        "a bounce ran narrower than its live count"
    assert all(w == l for w, l in zip(widths[1:], lives[:-1]) if l), \
        "a bounce ran wider than the live count"
    # roulette from rr_depth collapses the live set
    assert lives[-1] < lives[0] // 4
    assert all(s['seconds'] >= 0.0 for s in stats)


def test_compaction_on_matches_off():
    """'on' and 'off' films bit-equal with equal rays on the reduced
    colonnade at depth 10 with the cap, at 17 x 13 x 2 spp (442 rays a
    pass: no multiple of 32 or 1024); one stats entry a bounce."""
    scene = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                   leaf_size=32)
    cam = bs.colonnade_camera(17, 13)
    params = pt.PTParams(max_depth=10, t_max_shadow_ray=4.0)
    f_off, s_off = renderer.render_frame(scene, cam, params, 17, 13, spp=2,
                                         seed=3, compaction='off')
    stats = []
    f_on, s_on = renderer.render_frame(scene, cam, params, 17, 13, spp=2,
                                       seed=3, compaction='on',
                                       bounce_stats=stats)
    assert torch.equal(f_off.rgb_sum, f_on.rgb_sum)
    assert s_off.num_rays == s_on.num_rays
    assert stats[0]['width'] == 17 * 13 * 2
    _stats_shape(stats)


def test_trace_compacted_matches_trace_per_ray():
    """Per ray on a motion scene (the rays' times ride the gather) and on
    the dense cornell, called directly."""
    for scene, cam, res in (
            (bs.motion_field(n_spheres=4, tess=(6, 8)).commit(device='cpu'),
             bs.motion_field_camera(9, 7), (9, 7)),
            (bs.cornell_box().commit(device='cpu'), bs.cornell_camera(9, 7),
             (9, 7))):
        w, h = res
        pid = torch.arange(w * h).repeat(3)
        sid = torch.arange(3).repeat_interleave(w * h)
        org, dirn, tm = renderer._gen_rays(scene, cam, w, h,
                                           patterns.grid_scalars(3), pid,
                                           sid, 5)
        params = pt.PTParams(max_depth=8)
        ref, nref = pt.trace(scene, params, org, dirn, 5, pid, sid, tm)
        stats = []
        got, n = pt.trace_compacted(scene, params, org, dirn, 5, pid, sid,
                                    tm, stats)
        assert torch.equal(got, ref) and float(n) == float(nref)
        assert len(stats) == params.max_depth or stats[-1]['live'] == 0
        _stats_shape(stats)


def test_compact_is_a_stable_partition():
    """The kept lanes are the live ones in their order; the others'
    radiance lands in the output by ray id."""
    rs = np.random.RandomState(9)
    live = torch.as_tensor(rs.rand(1001) < 0.3)
    n = int(live.sum())
    state = {'rid': torch.as_tensor(rs.permutation(1001)),
             'L': torch.as_tensor(rs.rand(1001, 3).astype(np.float32)),
             'time': None, 'num_rays': torch.tensor(7.0)}
    l_out = torch.zeros((1001, 3))
    out = pt._compact(state, live, n, l_out)
    assert torch.equal(out['rid'], state['rid'][live])
    assert torch.equal(out['L'], state['L'][live])
    assert out['time'] is None and out['num_rays'] is state['num_rays']
    assert torch.equal(l_out[state['rid'][~live]], state['L'][~live])
    assert not l_out[state['rid'][live]].any()


def test_compaction_auto_gate():
    """'auto' compacts only past the roulette start on a BVH scene, 'on'
    at any depth > 1, never on the dense cornell, 'off' never; another
    value raises."""
    scene = bs.colonnade(**COLONNADE_SMALL).commit(device='cpu',
                                                   leaf_size=32)
    cam = bs.colonnade_camera(8, 8)
    shallow = pt.PTParams(max_depth=4)            # <= rr_depth (5)
    stats = []
    f_auto, _ = renderer.render_frame(scene, cam, shallow, 8, 8, spp=2,
                                      seed=7, compaction='auto',
                                      bounce_stats=stats)
    assert stats == [], "'auto' compacted a config without roulette"
    f_on, _ = renderer.render_frame(scene, cam, shallow, 8, 8, spp=2, seed=7,
                                    compaction='on', bounce_stats=stats)
    assert len(stats) == shallow.max_depth
    assert torch.equal(f_auto.rgb_sum, f_on.rgb_sum)
    deep = pt.PTParams(max_depth=6)
    for how, engaged in (('auto', True), ('off', False)):
        stats = []
        renderer.render_frame(scene, cam, deep, 8, 8, spp=1, seed=7,
                              compaction=how, bounce_stats=stats)
        assert bool(stats) == engaged, how
    stats = []
    cornell = bs.cornell_box().commit(device='cpu')
    renderer.render_frame(cornell, bs.cornell_camera(8, 8), deep, 8, 8,
                          spp=1, seed=7, compaction='on', bounce_stats=stats)
    assert stats == [], "compacted on the dense scene"
    assert not renderer.compacts(scene, pt.PTParams(max_depth=1), 'on')
    with pytest.raises(ValueError):
        renderer.render_frame(scene, cam, shallow, 8, 8, spp=1, seed=7,
                              compaction='yes')
