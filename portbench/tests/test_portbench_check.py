"""The check that decides `correct`, on the CPU at a size a test run
holds: the plain reference against the port's plain torch path, the
cells' limits passing the program, and failing the control (the
reference in bfloat16 in the program's place) and each fault a run can
have, planted under the timed path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, port, spec
from portbench.reference import render as rr
from portbench.tests import tiny

CELLS = spec.names('cells')
SEED = 2 ** 31 + 777
# what each cell compared at the tiny overrides and SEED on the CPU
# before the generator, reference and adapter were found by name
PINNED = {
    'sponza.frame_1024': {'rel_median': 8.548490828991222e-07,
                          'rel_l1': 4.672662174932036e-06,
                          'off_share': 0.0},
    'colonnade.stereo_face_1536': {'rel_median': 0.0,
                                   'rel_l1': 9.596173201607372e-09,
                                   'off_share': 0.0},
    'colonnade.progressive_1024': {'u8_off_share': 0.0,
                                   'film_rel_median': 0.0,
                                   'film_rel_l1': 1.0771224465242878e-09},
}


@pytest.mark.parametrize('camera', ['view', 'stereo_face_1'])
def test_camera_rays_match_the_port(camera):
    spec_ = spec.config('colonnade')['cameras'][camera]
    w = h = 32
    uv = torch.rand((500, 2), generator=torch.Generator().manual_seed(1))
    org, d = port.camera(spec_, w, h).ray(uv, torch.zeros_like(uv))
    rorg, rd = rr.camera_rays(spec_, uv, w, h)
    assert torch.allclose(org, rorg, atol=1e-5, rtol=0)
    assert torch.allclose(d, rd, atol=1e-6, rtol=0)


def _views():
    """(configuration, camera, depth up to 8, pixel filter) of every
    cell."""
    out = set()
    for name in CELLS:
        c = spec.cell(name)
        tr = spec.traffic(c['traffic'])
        out.add((c['config'], tr['camera'], min(tr['max_depth'], 8),
                 tr['pixel_filter']))
    return sorted(out)


@pytest.mark.parametrize('config,cam,depth,pixel_filter', _views())
def test_reference_matches_the_ports_plain_path(config, cam, depth,
                                                pixel_filter):
    """Every pixel of a small frame of a reduced scene, drawn by the
    configuration's own generator and rendered by its own adapter and
    reference: the paths agree to rounding, save the few that part at
    an edge."""
    cfg = spec.config(config)
    cfg['generator_params'] = dict(cfg['generator_params'],
                                   **tiny.scene_params(cfg['generator']))
    cfg['scene_seed'] = SEED
    _, desc, reference, adapter = harness.parts(cfg)
    cam_spec = cfg['cameras'][cam]
    tr = harness.reference_traffic(cfg, {
        'width': 16, 'height': 16, 'spp': 2, 'max_depth': depth,
        'pixel_filter': pixel_filter, 'compaction': 'auto'})
    sc = adapter.commit(desc, 'cpu', 32)
    film, _ = adapter.render(sc, adapter.camera(cam_spec, 16, 16),
                             adapter.params(cfg, tr), tr, 12345)
    prep = reference.prepare(desc, 'cpu')
    ref = reference.pixels(prep, tr, cam_spec,
                           torch.full((256,), 12345, dtype=torch.int64),
                           torch.arange(256), 2).sum(dim=1)
    p = film.rgb_sum.reshape(-1, 3).numpy().astype(np.float64)
    r = ref.numpy().astype(np.float64)
    assert r.sum() > 0
    e = np.abs(p - r).sum(1) / np.maximum(np.abs(r).sum(1), 1e-30)
    assert np.median(e[r.sum(1) > 0]) < 1e-4
    assert np.mean(e > 0.05) < 0.05


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.01, False, device='cpu',
                       overrides=tiny.overrides(cell), **kw)


@pytest.mark.parametrize('cell', CELLS)
def test_the_program_passes_and_the_control_fails(cell):
    ok = _run(cell)
    assert ok['correct'], ok['compared']
    assert list(ok) [-1] == 'compared'
    bad = _run(cell, control=True)
    assert not bad['correct'], bad['compared']


@pytest.mark.parametrize('cell', sorted(PINNED))
def test_the_lookups_by_name_move_no_number(cell):
    """The cells that were there before the lookups by name compare
    exactly what they compared without them."""
    out = _run(cell)
    assert {k: v['value'] for k, v in out['compared'].items()} == \
        PINNED[cell]


def _unchanged(render):
    """A step that returns its state unchanged: a frame's film as it
    was handed in (empty), a refinement's film without its samples."""
    def broken(scene, cam, prm, tr, seed, film=None, iteration=0):
        out, stats = render(scene, cam, prm, tr, seed, film, iteration)
        if film is not None:
            return film, stats
        return out._replace(rgb_sum=torch.zeros_like(out.rgb_sum)), stats
    return broken


def _half_batch(render):
    """Half of each pixel's samples left out, the mean taken over the
    rest: half the spp counted twice; a refinement of one sample
    repeats the sample of the one before it."""
    def broken(scene, cam, prm, tr, seed, film=None, iteration=0):
        if tr['spp'] == 1:
            return render(scene, cam, prm, tr, seed, film, iteration // 2 * 2)
        out, stats = render(scene, cam, prm, dict(tr, spp=tr['spp'] // 2),
                            seed, film, iteration)
        return out._replace(rgb_sum=out.rgb_sum * 2.0,
                            weight=out.weight * 2.0), stats
    return broken


def _altered(render):
    """Every pixel's new radiance altered by 1% where it is produced."""
    def broken(scene, cam, prm, tr, seed, film=None, iteration=0):
        out, stats = render(scene, cam, prm, tr, seed, film, iteration)
        prev = 0.0 if film is None else film.rgb_sum
        return out._replace(rgb_sum=out.rgb_sum + 0.01 * (out.rgb_sum - prev)
                            ), stats
    return broken


@pytest.mark.parametrize('fault', [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize('cell', CELLS)
def test_each_fault_fails(cell, fault):
    out = _run(cell, fault=fault)
    assert not out['correct'], out['compared']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_on_the_card(cell):
    """The cell at its own size, a short window: correct, and the
    control not."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    out = harness.run(cell, SEED, 2.0, False)
    assert out['correct'], out['compared']
    assert not harness.run(cell, SEED + 1, 2.0, False,
                           control=True)['correct']
