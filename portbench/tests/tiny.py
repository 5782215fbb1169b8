"""Tiny overrides that let a whole run of a cell go through on the CPU:
small frames, few samples, scenes with fewer columns and clutter, a
short check.  The cell's limits stay as they are.  A generator other
than the frozen two gives its reduced params as its own TINY."""
from __future__ import annotations

SCENES = {
    'colonnade': {'cols_x': 2, 'cols_z': 2, 'clutter': 4, 'tess': [6, 8]},
    'sponza_like': {'stories': 1, 'cols_x': 2, 'cols_z': 2, 'clutter': 6,
                    'num_textures': 6, 'texture_size': 16, 'shaft': [12, 3],
                    'cap_tess': [4, 6], 'clutter_tess': [6, 8]},
}


def scene_params(generator: str) -> dict:
    """A generator's reduced params: SCENES', else its own TINY."""
    from portbench import scenes
    if generator in SCENES:
        return SCENES[generator]
    return scenes.generator(generator).TINY


def overrides(workload: str, width: int = 20) -> dict:
    from portbench import spec
    c = spec.cell(workload)
    cfg = spec.config(c['config'])
    tr = spec.traffic(c['traffic'])
    traffic = {'width': width, 'height': width, 'trace_frames': 1,
               'min_frames': 4,
               'max_depth': min(tr['max_depth'], 6)}
    if tr['mode'] == 'progressive':
        traffic['check'] = {'pixels': 24}
    else:
        traffic['spp'] = max(2, min(tr['spp'], 4))
        traffic['check'] = {'frames': 2, 'pixels': 64, 'pixel_sets': 2}
    params = dict(cfg['generator_params'], **scene_params(cfg['generator']))
    return {'config': {'generator_params': params}, 'traffic': traffic}
