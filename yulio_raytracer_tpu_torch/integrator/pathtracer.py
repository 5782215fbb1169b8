"""Wavefront path-trace integrator.

Counterpart of `yulio_raytracer_tpu/integrator/pathtracer.py` (`trace`
and its bounce, pathtracer.py:299-694): the whole ray batch is the state
and every branch of the reference's per-pixel loop is a masked tensor
op.  The reference's `lax.scan` over bounces is a Python loop here.

Kept from the reference, deliberately: decorrelated RNG streams per
(pixel, sample, bounce, purpose) with its dimension layout; Russian
roulette divides surviving throughput by q; every light's shadow rays
go through one any-hit call per bounce (cut into whole-light launches
only where one launch could not index them); dead lanes carry tfar = -1
so the kernels reject them at once; a motion scene's paths keep their
camera ray's time.

Ray binning on bounces >= 1 (the reference's `sort_rays`, off on bounce
0) runs a static BVH scene's closest and any-hit calls, in the
reference's order, through: 'grid', the uniform grid (ops/grid.py: DDA
rounds of the pair kernels, then the binary BVH kernels for the rays
still marching); 'dense', rounds of the pair kernels over each ray's
nearest treelet's tiles, then the binary kernels (ops/treelets.py
intersect_dense_binned); 'treelet', rounds of the binary kernels from
each ray's nearest treelet's root, then the whole tree
(ops/treelets.py intersect_packet_binned).  Bounce 0 keeps the scene's
accel.  'morton' and 'none' both trace unsorted: the reference's sort
serves its 1024-ray packets, which one ray per thread does not have.  A
motion scene, and a dense one, never take a binning.

A finite `t_max_shadow_ray` takes the Yulio dome trick: every light
sample's shadow ray gets the cap, jittered by +-t_max_shadow_jitter on
its own RNG dim and lengthened up to 100x below the horizon (`up`).  As
in the reference, the cap replaces the tmax of area lights too, so such
a ray reports what lies behind the light.  An infinite cap (the
default) runs the bounce without it.

`trace_compacted` (the reference's pathtracer.py:862-931) runs the same
bounce one at a time and, where rays died, flushes their radiance and
gathers the live rays to a prefix in their order, so later bounces run
at the live width; it is bit-identical per ray to `trace`.

Escaped rays take the environment lights' radiance (the ambient dome,
HDRI maps) unless the previous bounce sampled a diffuse lobe; with a
backplate, rays that no bounce has bent take its texel at their camera
uv instead.  A scene without environment lights, rendered without a
backplate, runs no op for them.

Not in this slice: ray sorting under 'morton', the precomputed sampler,
the triangle-sharded mesh axis.
"""
from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass

import torch

from ..core import math as vm
from ..core import rng
from ..lights import lights as glights
from ..ops import cuda_build as cb
from ..ops import dense, traverse, treelets, wide
from ..ops import grid as ggrid
from ..ops import intersect as ops_i
from ..shading import lobes as lb
from ..shading import materials as gmat

# the reference assigns ULP twice (pathtracer.py:44-46); this value wins
ULP = 1.1920929e-7
# PTParams.ray_binning: the reference's five
BINNINGS = ('morton', 'none', 'grid', 'dense', 'treelet')
# profiler ranges of the bounce (profile_frame reads their device time):
# the shade context (its texture fetches included), the lobes' eval and
# sampling, the light samples of the NEE and the escaped rays' radiance
SPAN_SHADE = 'yrt.shade_context'
SPAN_LOBES = 'yrt.lobes'
SPAN_LIGHTS = 'yrt.light_sample'
SPAN_ENV = 'yrt.env'



@dataclass(frozen=True)
class PTParams:
    """Defaults match pathtraceintegrator.cpp:24-32."""
    max_depth: int = 10
    rr_depth: int = 5
    min_contribution: float = 0.02
    epsilon: float = 32.0 * ULP
    # the dome shadow cap: inf disables it
    t_max_shadow_ray: float = float('inf')
    t_max_shadow_jitter: float = 0.15
    up: tuple = (0.0, 1.0, 0.0)
    # bounces >= 1: 'grid', 'dense' and 'treelet' trace through the
    # scene's grid or treelets; 'morton' (the reference's default) and
    # 'none' both trace unsorted
    ray_binning: str = 'morton'

    def __post_init__(self):
        if self.ray_binning not in BINNINGS:
            raise ValueError(f"unknown ray_binning={self.ray_binning!r}: "
                             f"expected one of {BINNINGS}")


# RNG dimension layout per bounce d: base = stride + stride * d
_DIM_SCATTER = 0        # 2D lobe directional sample
_DIM_SCATTER_TYPE = 1   # 1D lobe selection
_DIM_RR = 2             # 1D russian roulette
_DIM_SHADOW = 3         # 1D shadow tMax jitter (+light)
_DIM_LIGHT = 8          # 2D light sample (+light)


def _dim_layout(n_lights: int):
    """(dim_light, stride) for n_lights: the historical layout for <= 5
    lights, widened beyond so light and jitter dims never collide."""
    if n_lights <= 5:
        return _DIM_LIGHT, 16
    dim_light = _DIM_SHADOW + n_lights
    return dim_light, dim_light + n_lights


def _bounce_dims(depth: int, stride: int = 16) -> int:
    return (stride + stride * depth) & rng._MASK


def _binned(scene, sort_rays, binning):
    """The binning that traces a static scene's sorted rays ('grid',
    'dense' or 'treelet' where the scene has its tables), or None."""
    if not sort_rays or scene.nodes is None:
        return None
    if binning == 'grid' and scene.grid is not None:
        return 'grid'
    tl = scene.treelets
    if binning == 'dense' and tl is not None and 'planes_rows' in tl:
        return 'dense'
    if binning == 'treelet' and tl is not None:
        return 'treelet'
    return None


def _intersect(scene, org, dirn, tnear, tfar, time=None, sort_rays=False,
               binning='morton'):
    """Closest hits, in the reference's order: a motion scene traces at
    each ray's time; sorted rays under binning 'grid', 'dense' or
    'treelet' take it where the scene has its tables; else the traversal
    scene.accel names."""
    if scene.accel == 'bvh4mb':
        return traverse.intersect_packet_mb(scene.nodes, scene.tris_mb, org,
                                            dirn, tnear, tfar, time)
    if scene.motion is not None:
        return ops_i.intersect_brute(scene.motion, org, dirn, tnear, tfar,
                                     time=time)
    how, tl = _binned(scene, sort_rays, binning), scene.treelets
    if how == 'grid':
        return ggrid.intersect_grid(scene.grid, scene.nodes, scene.tris, org,
                                    dirn, tnear, tfar)
    if how == 'dense':
        return treelets.intersect_dense_binned(
            scene.nodes, scene.tris, tl['planes_rows'], tl['treelet_boxes'],
            tl['treelet_tile_lo'], tl['treelet_tile_hi'], org, dirn, tnear,
            tfar)
    if how == 'treelet':
        return treelets.intersect_packet_binned(
            scene.nodes, scene.tris, tl['treelet_roots'], tl['treelet_boxes'],
            org, dirn, tnear, tfar)
    if scene.accel == 'bvh4':
        return wide.intersect_packet4(scene.nodes4, scene.tris, org, dirn,
                                      tnear, tfar)
    if scene.accel == 'bvh2':
        return traverse.intersect_packet(scene.nodes, scene.tris, org, dirn,
                                         tnear, tfar)
    return dense.intersect_dense(scene.tris, org, dirn, tnear, tfar)


def _occluded(scene, org, dirn, tnear, tfar, time=None, sort_rays=False,
              binning='morton'):
    """Any-hit of each ray segment (as _intersect)."""
    if scene.accel == 'bvh4mb':
        return traverse.occluded_packet_mb(scene.nodes, scene.tris_mb, org,
                                           dirn, tnear, tfar, time)
    if scene.motion is not None:
        return ops_i.occluded_brute(scene.motion, org, dirn, tnear, tfar,
                                    time=time)
    how, tl = _binned(scene, sort_rays, binning), scene.treelets
    if how == 'grid':
        return ggrid.occluded_grid(scene.grid, scene.nodes, scene.tris, org,
                                   dirn, tnear, tfar)
    if how == 'dense':
        return treelets.occluded_dense_binned(
            scene.nodes, scene.tris, tl['planes_rows'], tl['treelet_boxes'],
            tl['treelet_tile_lo'], tl['treelet_tile_hi'], org, dirn, tnear,
            tfar)
    if how == 'treelet':
        return treelets.occluded_packet_binned(
            scene.nodes, scene.tris, tl['treelet_roots'], tl['treelet_boxes'],
            org, dirn, tnear, tfar)
    if scene.accel == 'bvh4':
        return wide.occluded_packet4(scene.nodes4, scene.tris, org, dirn,
                                     tnear, tfar)
    if scene.accel == 'bvh2':
        return traverse.occluded_packet(scene.nodes, scene.tris, org, dirn,
                                        tnear, tfar)
    return dense.occluded_dense(scene.tris, org, dirn, tnear, tfar)


def _occluded_lights(scene, p, wi, tnear, tfar, time, sort_rays, binning):
    """Any-hit of every light's shadow rays: p, tnear, time (R,...) are
    shared by the lights, wi (nl, R, 3) and tfar (nl, R) are per light;
    sort_rays and binning choose the traversal as in _occluded.
    Each launch takes whole lights, fewer than cuda_build.MAX_RAYS rays
    in all, so any light count traces; the result does not depend on
    the split.  Returns (nl * R,) bool, light-major."""
    nl, r = tfar.shape
    per = max(1, (cb.MAX_RAYS - 1) // r)
    occ = []
    for l0 in range(0, nl, per):
        k = min(per, nl - l0)
        occ.append(_occluded(
            scene, p.repeat(k, 1), wi[l0:l0 + k].reshape(k * r, 3),
            tnear.repeat(k), tfar[l0:l0 + k].reshape(k * r),
            None if time is None else time.repeat(k), sort_rays, binning))
    return torch.cat(occ)


def _init_state(org, dirn, pixel_id, sample_id, time=None, pixel_uv=None):
    """Fresh wavefront state for primary rays (with each ray's time in a
    motion scene, and its camera uv and unbent flag under a
    backplate)."""
    r, dev = org.shape[0], org.device
    ones = torch.ones((r,), device=dev)
    state = {
        'org': org,
        'dir': dirn,
        'L': torch.zeros((r, 3), device=dev),
        'throughput': torch.ones((r, 3), device=dev),
        'active': torch.ones((r,), dtype=torch.bool, device=dev),
        'ignore_vl': torch.zeros((r,), dtype=torch.bool, device=dev),
        'medium_eta': ones,
        'medium_trans': torch.ones((r, 3), device=dev),
        'eta_rr': ones,
        'num_rays': torch.zeros((), device=dev),
        'pid': pixel_id,
        'sid': sample_id,
        'time': time,
    }
    if pixel_uv is not None:
        state['uv'] = pixel_uv
        state['unbent'] = torch.ones((r,), dtype=torch.bool, device=dev)
    return state


def _light_groups(lights):
    """NEE groups, in the reference's order (pathtracer.py:359-367): the
    lights keyed by kind, and an HDRI by (kind, width, height), in order
    of each key's first light.  A group samples its lights in one
    batched call with their parameters stacked to (nk, 1, ...); an HDRI
    light, whose tables do not stack, is sampled alone, unstacked.  Each
    group carries its light indices (the RNG dims)."""
    groups = {}
    for li, l in enumerate(lights):
        key = ((l['kind'], l['width'], l['height']) if l['kind'] == 'hdri'
               else l['kind'])
        groups.setdefault(key, []).append(li)
    out = []
    for key, idxs in groups.items():
        if isinstance(key, tuple):          # HDRI lights of one map size
            out.extend(([li], lights[li], [lights[li]['illum_mask']
                                           & rng._MASK]) for li in idxs)
            continue
        stacked = {'kind': key}
        for k, val in lights[idxs[0]].items():
            if isinstance(val, torch.Tensor):
                stacked[k] = torch.stack(
                    [lights[i][k] for i in idxs])[:, None]
        masks = [lights[i]['illum_mask'] & rng._MASK for i in idxs]
        out.append((idxs, stacked, masks))
    return out


def _live(state, params):
    """Lanes that the next bounce traces (the bounce's own predicate)."""
    return state['active'] & (torch.amax(state['throughput'], dim=-1)
                              >= params.min_contribution)


def _shadow_cap(params, seed, pixel_id, sample_id, wi, dims):
    """The Yulio dome trick (pathtracer.py:497-513, cpp:148-157): the
    shadow tmax of light samples wi (nk, R, 3) becomes the cap jittered
    by +-t_max_shadow_jitter (u on dims (nk, 1)), lengthened by up to
    100 caps where wi points at or below the horizon."""
    cap, jit = params.t_max_shadow_ray, params.t_max_shadow_jitter
    u = rng.uniform1(seed, pixel_id, sample_id, dims)
    tmax = cap + (2.0 * cap * jit * u - cap * jit)
    dot_up = vm.dot(wi, torch.tensor(params.up, dtype=torch.float32,
                                     device=wi.device))
    return tmax + torch.where(
        dot_up <= 0.0, cap * 100.0 * vm.smoothstep(0.0, 1.0,
                                                   torch.abs(dot_up)), 0.0)


def _escaped(state, miss, wo, env_lights, backplate):
    """Radiance of the escaped rays (miss) along wo (cpp:79-92): a
    backplate's texel at the camera uv for rays no bounce has bent,
    else the environment lights' unless the last bounce sampled a
    diffuse lobe (ignore_vl)."""
    env = sum(glights.le_env(l, wo) for l in env_lights) if env_lights \
        else torch.zeros_like(wo)
    seen = ~state['ignore_vl']
    env_l = 0.0
    if backplate is not None:
        bp_h, bp_w = backplate.shape[0], backplate.shape[1]
        uv = state['uv']
        bx = torch.clamp((uv[:, 0] * bp_w).to(torch.int64), 0, bp_w - 1)
        by = torch.clamp((uv[:, 1] * bp_h).to(torch.int64), 0, bp_h - 1)
        env_l = torch.where(state['unbent'][:, None], backplate[by, bx], 0.0)
        seen = seen & ~state['unbent']
    env_l = env_l + torch.where(seen[:, None], env, 0.0)
    return torch.where(miss[:, None], state['throughput'] * env_l, 0.0)


def _make_bounce(scene, params: PTParams, seed, backplate=None):
    """The per-bounce wavefront body: bounce(state, depth) -> state.
    backplate: an optional (H, W, 3) image that the state's unbent rays
    see where they escape (the state then carries 'uv' and 'unbent')."""
    lights = scene.lights
    env_lights = scene.env_lights
    dim_light, dim_stride = _dim_layout(len(lights))
    groups = _light_groups(lights)
    has_shadow_cap = math.isfinite(params.t_max_shadow_ray)

    def bounce(state, depth: int):
        r, dev = state['org'].shape[0], state['org'].device
        # the reference bins rays on every bounce after the first
        binned = (depth > 0, params.ray_binning)
        pixel_id, sample_id = state['pid'], state['sid']
        base = _bounce_dims(depth, dim_stride)
        org, dirn = state['org'], state['dir']
        thr, L = state['throughput'], state['L']

        # terminate low-contribution paths (pathtraceintegrator.cpp:66-67)
        active = _live(state, params)
        # dead lanes get tfar < tnear: every kernel rejects them at once
        tfar_live = torch.where(active, float('inf'), -1.0)
        hit = _intersect(scene, org, dirn, torch.zeros((r,), device=dev),
                         tfar_live, state['time'], *binned)
        state = dict(state)
        state['num_rays'] = state['num_rays'] + torch.sum(active)
        dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
        wo = -dirn
        if env_lights or backplate is not None:
            with torch.profiler.record_function(SPAN_ENV):
                L = L + _escaped(state, active & ~hit.valid, wo, env_lights,
                                 backplate)
        active = active & hit.valid

        # face-forward normals (cpp:94-98)
        backfacing = vm.dot(dg['Ng'], dirn) > 0.0
        ng = torch.where(backfacing[:, None], -dg['Ng'], dg['Ng'])
        ns = torch.where(backfacing[:, None], -dg['Ns'], dg['Ns'])

        # shade: material -> lobe context (cpp:108-111), with the
        # bump-mapped shading normal where a material binds a bump map
        with torch.profiler.record_function(SPAN_SHADE):
            lobed, aux = gmat.shade_context(
                scene.materials, scene.textures, dg['mat_id'], dg['st'],
                state['medium_eta'], state['medium_trans'], ns=ns,
                tx=dg['Tx'], ty=dg['Ty'], tex_modes=scene.tex_modes,
                bump=scene.bump)
        ns = aux.get('ns', ns)

        # area-light emission (cpp:113-115)
        for li, l in enumerate(lights):
            if l['kind'] != 'triangle':
                continue
            is_hit_light = (active & (dg['light_id'] == li) & ~backfacing
                            & ~state['ignore_vl'])
            L = L + torch.where(is_hit_light[:, None],
                                thr * glights.le_area(l, backfacing), 0.0)

        # NEE: shadow rays to every light, all occlusion tests in one
        # call (split into whole-light launches only past a launch's rays)
        use_dl = lb.has_type(lobed, lb.DIFFUSE) & active
        err_eps = dg['error'] * params.epsilon
        cand_gs, contrib_gs, wi_gs, tfar_gs = [], [], [], []
        illum = dg['illum_mask'] & rng._MASK
        for idxs, light, masks in groups:
            dims = torch.tensor([(base + dim_light + li) & rng._MASK
                                 for li in idxs], device=dev)[:, None]
            mask_ok = (torch.tensor(masks, device=dev)[:, None] & illum) != 0
            u2 = rng.uniform2(seed, pixel_id, sample_id, dims)  # (nk, R, 2)
            with torch.profiler.record_function(SPAN_LIGHTS):
                le, wi, pdf, tmax = glights.sample(light, dg['P'], ns, u2)
            cand = (use_dl & mask_ok & (pdf > 0.0)
                    & torch.any(le > 0.0, dim=-1))
            with torch.profiler.record_function(SPAN_LOBES):
                brdf = lb.eval_lobes(lobed, ns, ng, wo, wi, lb.DIFFUSE,
                                     types_present=scene.lobe_types)
            cand = cand & torch.any(brdf > 0.0, dim=-1)
            if has_shadow_cap:
                tmax = _shadow_cap(params, seed, pixel_id, sample_id, wi,
                                   torch.tensor([(base + _DIM_SHADOW + li)
                                                 & rng._MASK for li in idxs],
                                                device=dev)[:, None])
            contrib = thr * le * brdf / torch.clamp(pdf, min=1e-20)[..., None]
            cand_gs.append(cand)
            contrib_gs.append(contrib)
            wi_gs.append(wi)
            tfar_gs.append(torch.where(cand, tmax - err_eps, -1.0))
        if cand_gs:
            cand_all = torch.cat(cand_gs)              # (nl, R)
            nl = cand_all.shape[0]
            state['num_rays'] = state['num_rays'] + torch.sum(cand_all)
            occ_all = _occluded_lights(scene, dg['P'], torch.cat(wi_gs),
                                       err_eps, torch.cat(tfar_gs),
                                       state['time'], *binned)
            lit = cand_all & ~occ_all.reshape(nl, r)
            L = L + torch.sum(torch.where(lit[:, :, None],
                                          torch.cat(contrib_gs), 0.0), dim=0)

        # depth cut (cpp:169-170)
        cont = active & (depth < params.max_depth - 1)

        # russian roulette (cpp:172-182, with 1/q compensation)
        q = torch.clamp(torch.amax(thr, dim=-1) * state['eta_rr'] ** 2,
                        max=0.95)
        rr_on = depth >= params.rr_depth - 1
        if rr_on:
            rr_u = rng.uniform1(seed, pixel_id, sample_id, base + _DIM_RR)
            cont = cont & ~(rr_u >= q)
            rr_scale = 1.0 / torch.clamp(q, min=1e-3)
        else:
            rr_scale = torch.ones_like(q)

        # GI: sample one lobe (cpp:184-213)
        s2 = rng.uniform2(seed, pixel_id, sample_id, base + _DIM_SCATTER)
        s1 = rng.uniform1(seed, pixel_id, sample_id,
                          base + _DIM_SCATTER_TYPE)
        with torch.profiler.record_function(SPAN_LOBES):
            samp = lb.sample_lobes(lobed, ns, ng, wo, s2, s1, lb.ALL,
                                   tx=dg['Tx'], ty=dg['Ty'],
                                   types_present=scene.lobe_types)
        cont = (cont & samp['valid'] & (samp['pdf'] > 0.0)
                & torch.any(samp['weight'] > 0.0, dim=-1))

        # Beer attenuation through the current medium (cpp:197-201)
        trans_med = state['medium_trans']
        absorbing = torch.any(trans_med < 1.0, dim=-1)
        beer = torch.where(absorbing[:, None],
                           torch.pow(torch.clamp(trans_med, min=1e-20),
                                     hit.t[:, None]), 1.0)
        w = samp['weight'] * beer / torch.clamp(samp['pdf'], min=1e-20)[:, None]
        new_thr = thr * w * rr_scale[:, None]

        # medium transition on sampled transmission (cpp:203-206)
        trans_bit = (samp['type_bits'] & lb.TRANSMISSION_BITS) != 0
        new_eta_m, new_trans_m = gmat.next_medium(
            aux, trans_bit, state['medium_eta'], state['medium_trans'])

        # new ray from the hit point, pushed by the error-scaled epsilon
        # (cpp:210: Ray(dg.P, dir, err*eps, inf)) with tnear = 0
        new_dir = samp['wi']
        new_org = dg['P'] + new_dir * err_eps[:, None]
        # diffuse-sampled -> ignore directly visible lights next bounce
        new_ignore = (samp['type_bits'] & lb.DIFFUSE) != 0

        state['org'] = torch.where(cont[:, None], new_org, org)
        state['dir'] = torch.where(cont[:, None], new_dir, dirn)
        state['throughput'] = torch.where(cont[:, None], new_thr, thr)
        state['L'] = L
        state['active'] = cont
        state['ignore_vl'] = torch.where(cont, new_ignore,
                                         state['ignore_vl'])
        state['medium_eta'] = torch.where(cont, new_eta_m,
                                          state['medium_eta'])
        state['medium_trans'] = torch.where(cont[:, None], new_trans_m,
                                            state['medium_trans'])
        state['eta_rr'] = torch.where(cont, state['eta_rr'] * samp['eta'],
                                      state['eta_rr'])
        if 'unbent' in state:
            state['unbent'] = state['unbent'] & torch.all(
                torch.abs(state['dir'] - dirn) < 1e-12, dim=-1)
        return state

    return bounce


def _backplate_uv(pixel_uv, backplate):
    """The camera uv the state carries: only under a backplate."""
    if backplate is None:
        return None
    if pixel_uv is None:
        raise ValueError("a backplate needs each ray's pixel_uv")
    return pixel_uv


def trace(scene, params: PTParams, org, dirn, seed, pixel_id, sample_id,
          time=None, pixel_uv=None, backplate=None):
    """Radiance along primary rays.  org/dirn: (R, 3) f32; pixel_id,
    sample_id: (R,) int64 holding u32 RNG keys; time: (R,) f32 in [0, 1]
    for a motion scene (every bounce and shadow ray of a path keeps it);
    backplate: an optional (H, W, 3) f32 image on the rays' device, seen
    by escaped rays that no bounce bent at their pixel_uv (R, 2) in
    [0, 1)^2.  Returns (L (R, 3), num_rays (scalar tensor: closest-hit
    rays plus shadow candidates))."""
    state = _init_state(org, dirn, pixel_id, sample_id, time,
                        _backplate_uv(pixel_uv, backplate))
    bounce = _make_bounce(scene, params, seed, backplate)
    for depth in range(params.max_depth):
        state = bounce(state, depth)
    return state['L'], state['num_rays']


def _compact(state, live, n, l_out):
    """Flush the radiance of the lanes that are not live into l_out by
    their ray ids and keep the n live lanes, in their order: a stable
    partition built from live's running count (no sort, no sync).
    Dropped lanes are dead, so their L is final."""
    w = live.shape[0]
    lane = torch.arange(w, device=live.device)
    before = torch.cumsum(live, 0) - live.long()
    # live lanes to [0, n) and the others to [n, w), each in lane order
    dest = torch.where(live, before, n + lane - before)
    perm = torch.empty_like(lane).scatter_(0, dest, lane)
    kept, dropped = perm[:n], perm[n:]
    l_out.index_copy_(0, state['rid'][dropped], state['L'][dropped])
    return {k: (v[kept] if isinstance(v, torch.Tensor) and v.dim() >= 1
                else v) for k, v in state.items()}


def trace_compacted(scene, params: PTParams, org, dirn, seed, pixel_id,
                    sample_id, time=None, bounce_stats=None, pixel_uv=None,
                    backplate=None):
    """trace() one bounce at a time with live-ray compaction between
    bounces (pathtracer.py:862-931): after each bounce the live count is
    read (one host sync), and where it is below the width the dead
    lanes' radiance is flushed by ray id and the live lanes are gathered
    to a prefix in their order, so the next bounce runs at the live
    width.  Bit-identical per ray to trace().

    bounce_stats: an optional list; one {'depth', 'width', 'live',
    'seconds'} dict is appended a bounce: the width it ran at, the live
    count entering the next bounce, and the seconds since the previous
    entry, which end with the device synchronised.  Returns (L (R, 3),
    num_rays) as trace()."""
    r = org.shape[0]
    state = _init_state(org, dirn, pixel_id, sample_id, time,
                        _backplate_uv(pixel_uv, backplate))
    state['rid'] = torch.arange(r, device=org.device)
    bounce = _make_bounce(scene, params, seed, backplate)
    l_out = torch.zeros((r, 3), device=org.device)
    t0 = _time.perf_counter()
    for depth in range(params.max_depth):
        state = bounce(state, depth)
        last = depth == params.max_depth - 1
        if last and bounce_stats is None:
            break
        live = _live(state, params)
        n = int(torch.sum(live))             # the bounce's one sync
        if bounce_stats is not None:
            t1 = _time.perf_counter()
            bounce_stats.append({'depth': depth, 'width': live.shape[0],
                                 'live': n, 'seconds': t1 - t0})
            t0 = t1
        if last or n == 0:
            break
        if n < live.shape[0]:
            state = _compact(state, live, n, l_out)
    l_out.index_copy_(0, state['rid'], state['L'])
    return l_out, state['num_rays']
