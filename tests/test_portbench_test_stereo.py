"""The benchmark's test_stereo configuration on the CPU: its generator
describes the production scene that test_stereo.ecs loads, its adapter
stages that scene and camera as the port's own loaders and `-stereo`
do, its plain reference draws the b-spline film points the port draws
and follows the port's paths to rounding (the HDRI dark, as deployed,
and lit), and one tiny whole run of its cell is correct where the
bfloat16 control is not."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.tests import tiny
from yulio_raytracer_tpu_torch.api import cli, output
from yulio_raytracer_tpu_torch.io import ecs
from yulio_raytracer_tpu_torch.sampling import patterns

torch.set_num_threads(2)
CONFIG = 'test_stereo'
CELL = 'test_stereo.strip_face_800'
ECS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'assets', 'scenes', 'test_stereo.ecs')
SEED = 2 ** 31 + 4099
# a close view of the spheres and the billboard's back, behind them
CLOSE = {'kind': 'pinhole', 'eye': [40.0, 45.0, 420.0],
         'look': [0.0, 40.0, 200.0], 'up': [0.0, 1.0, 0.0], 'fov': 40.0}


@pytest.fixture(scope='module')
def production():
    """test_stereo.ecs as the port loads it: (settings, SceneBuilder)."""
    return ecs.parse_ecs(ECS)


@pytest.fixture(scope='module')
def parts():
    return harness.parts(spec.config(CONFIG))


def test_the_description_is_the_production_scene(production, parts):
    """The same 14,704 triangles (positions, normals and uvs to 1e-6),
    the same texels, and once the adapter stages it, the same lobe
    table and lights in the same order as test_stereo.ecs loaded."""
    settings, sb = production
    gen, desc, _, adapter = parts
    cfg = spec.config(CONFIG)
    assert gen.num_triangles(desc) == cfg['triangles'] == 14704
    assert len(desc['meshes']) == len(sb.meshes) == 5
    for d, m in zip(desc['meshes'], sb.meshes):
        assert d['material'] == m.material
        assert np.array_equal(d['triangles'], m.triangles)
        for key in ('positions', 'normals', 'texcoords'):
            np.testing.assert_allclose(d[key], getattr(m, key), rtol=0,
                                       atol=1e-6, err_msg=key)
    ours = adapter.commit(desc, 'cpu', cfg['leaf_size'])
    theirs = sb.commit(device='cpu', accel=settings.accel)
    assert ours.accel == theirs.accel == 'bvh4'
    assert ours.num_triangles == theirs.num_triangles
    for key in ('tris', 'geom'):
        a, b = getattr(ours, key), getattr(theirs, key)
        assert all(torch.equal(a[k], b[k]) for k in b) if isinstance(
            b, dict) else torch.equal(a, b), key
    for key, val in theirs.materials.items():
        assert torch.equal(ours.materials[key], val), key
    assert (ours.lobe_types, ours.tex_modes) == (theirs.lobe_types,
                                                 theirs.tex_modes)
    for key, val in theirs.textures.items():
        assert torch.equal(ours.textures[key], val), key
    assert [l['kind'] for l in ours.lights] == ['hdri', 'ambient'] == [
        l['kind'] for l in theirs.lights]
    for a, b in zip(ours.lights, theirs.lights):
        for key, val in b.items():
            got = a[key]
            if isinstance(val, torch.Tensor):
                assert torch.equal(got, val), key
            elif isinstance(val, tuple):       # the HDRI's distribution
                assert all(torch.equal(x, y) for x, y in zip(got, val)), key
            else:
                assert np.array_equal(np.asarray(got), np.asarray(val)), key


def test_the_settings_and_camera_are_the_productions(production, parts):
    """The cell's PTParams are the ones -stereo renders with, its source
    settings the view's, and its camera's rays those of face 2 of the
    rig `-stereo` builds."""
    settings, _ = production
    _, _, _, adapter = parts
    cfg = spec.config(CONFIG)
    tr = spec.traffic(spec.cell(CELL)['traffic'])
    assert adapter.params(cfg, tr) == output.params_from_settings(settings)
    src = cfg['source_settings']
    assert (src['width'], src['height'], src['spp'], src['max_depth'],
            src['t_max_shadow_ray'], src['pixel_filter']) == (
        settings.width, settings.height, settings.spp, settings.depth,
        settings.t_max_shadow_ray, settings.pixel_filter)
    assert (tr['width'], tr['height'], tr['spp'], tr['max_depth'],
            tr['pixel_filter']) == (src['width'], src['height'], src['spp'],
                                    src['max_depth'], src['pixel_filter'])
    uv = torch.rand((4096, 2), generator=torch.Generator().manual_seed(5))
    uv = uv * 1.2 - 0.1                 # b-spline points pass the edges
    want = cli.stereo_rigs(settings)[0][1][2].ray(uv, torch.zeros_like(uv))
    got = adapter.camera(cfg['cameras']['back'], 800, 800).ray(
        uv, torch.zeros_like(uv))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bspline_film_points_match_the_port(parts):
    """The reference's b-spline film points are the stateless sampler's
    (patterns.pixel_sample_bspline) to 1e-6 on 4,096 samples."""
    _, _, reference, _ = parts
    w = h = 800
    g = torch.Generator().manual_seed(9)
    pid = torch.randint(0, w * h, (4096,), generator=g)
    sid = torch.randint(0, 64, (4096,), generator=g)
    seed = torch.full_like(pid, SEED & 0xFFFFFFFF)
    juv = patterns.pixel_sample_bspline(seed, pid, sid,
                                        patterns.grid_scalars(64))
    want = torch.stack([((pid % w).float() + juv[:, 0]) / w,
                        ((pid // w).float() + juv[:, 1]) / h], dim=-1)
    got = reference.paths.film_points(seed, pid, sid, 64, w, h,
                                      torch.float32, 'bspline')
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    # the filter reaches past the pixel, as the cubic B-spline's support
    off = got * w - torch.stack([(pid % w).float(), (pid // w).float()], -1)
    assert float(off.min()) < -0.2 and float(off.max()) > 1.2


@pytest.mark.parametrize('hdri_L', [0.0, 0.5])
@pytest.mark.parametrize('view', ['back', 'close'])
def test_reference_matches_the_ports_plain_path(view, hdri_L):
    """Every pixel of a 16^2 frame, 4 spp, depth 6, b-spline, of the
    reduced scene (the whole one through the back face, so that the
    port takes its BVH4 and compacted path), drawn by the generator and
    rendered by the adapter and by the reference: the paths agree to
    rounding, save the few that part at an edge.  The HDRI dark, as
    deployed, and lit (where a wrong HDRI would show)."""
    cfg = spec.config(CONFIG)
    if view == 'close':
        cfg['generator_params'] = dict(tiny.scene_params(cfg['generator']))
    cfg['generator_params'] = dict(cfg['generator_params'],
                                   hdri_L=[hdri_L] * 3)
    _, desc, reference, adapter = harness.parts(cfg)
    cam_spec = cfg['cameras'].get(view, CLOSE)
    tr = harness.reference_traffic(cfg, {
        'width': 16, 'height': 16, 'spp': 4, 'max_depth': 6,
        'pixel_filter': 'bspline', 'compaction': 'auto'})
    sc = adapter.commit(desc, 'cpu', cfg['leaf_size'])
    assert sc.accel == ('dense' if view == 'close' else 'bvh4')
    film, _ = adapter.render(sc, adapter.camera(cam_spec, 16, 16),
                             adapter.params(cfg, tr), tr, 12345)
    prep = reference.prepare(desc, 'cpu')
    ref = reference.pixels(prep, tr, cam_spec,
                           torch.full((256,), 12345, dtype=torch.int64),
                           torch.arange(256), 4).sum(dim=1)
    p = film.rgb_sum.reshape(-1, 3).numpy().astype(np.float64)
    r = ref.numpy().astype(np.float64)
    assert r.sum() > 0
    e = np.abs(p - r).sum(1) / np.maximum(np.abs(r).sum(1), 1e-30)
    assert np.median(e[r.sum(1) > 0]) < 1e-4
    assert np.mean(e > 0.05) < 0.05


def test_a_tiny_run_is_correct_and_the_control_is_not():
    ov = tiny.overrides(CELL)
    ok = harness.run(CELL, SEED, 0.01, False, device='cpu', overrides=ov)
    assert ok['correct'], ok['compared']
    assert set(ok['metrics']) == {'face_s', 'setup_s'}
    bad = harness.run(CELL, SEED, 0.01, False, device='cpu', overrides=ov,
                      control=True)
    assert not bad['correct'], bad['compared']
