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

Under the precomputed sampler (`samples`, the reference's
pathtracer.py:324-326, 395-401, 593-605) each ray carries its sample set
and index ('sset', 'ssidx', gathered by compaction as every lane's
state), and a bounce at depth d takes the shared NEE light sample from
2D dim 0, the scatter direction from 2D dim 1 + d and the scatter type
from 1D dim d, which Russian roulette reuses, as the reference does;
the shadow cap's jitter stays on the stateless hash.

A triangle-sharded scene (parallel/sharding.py render_frame_sharded
with a 'tri' axis) traces every shard's triangles through the dense
kernels on the shard's device; _intersect takes the nearest shard's hit
and _occluded the OR of the shards'.

Not ported: ray sorting under 'morton'.
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
from ..utils import profiling as prof
from ..utils.profiling import span

# the reference assigns ULP twice (pathtracer.py:44-46); this value wins
ULP = 1.1920929e-7
# PTParams.ray_binning: the reference's five
BINNINGS = ('morton', 'none', 'grid', 'dense', 'treelet')
# spans of the bounce that readers of a trace name (utils/profiling.py
# has the tree): the shade context (its texture fetches included), the
# lobes' eval and sampling and the light samples of the NEE
SPAN_SHADE = prof.SHADE
SPAN_LOBES = prof.LOBES
SPAN_LIGHTS = prof.LIGHTS


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
    scene.accel names; a triangle-sharded scene's shards through the
    dense kernels, combined (_intersect_shards)."""
    if scene.tri_shards is not None:
        return _intersect_shards(scene.tri_shards, org, dirn, tnear, tfar)
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


def _intersect_shards(shards, org, dirn, tnear, tfar):
    """Closest hits over triangle shards ((start, rows), each on its own
    device; the counterpart of the reference's cross-shard argmin,
    pathtracer.py:194-214): the hit of least t, the first shard's where
    several share it (the lowest global triangle id), its triangle id
    offset by its shard's start.  The scene's shading table is indexed by
    those global ids, so post_intersect reads the winner's record."""
    dev = org.device
    parts = []
    for start, rows in shards:
        d = rows.device
        h = dense.intersect_dense(rows, org.to(d), dirn.to(d), tnear.to(d),
                                  tfar.to(d))
        tri = torch.where(h.tri >= 0, h.tri + start, -1).to(torch.int32)
        parts.append([x.to(dev) for x in (h.t, tri, h.u, h.v)])
    win = torch.argmin(torch.stack([p[0] for p in parts]), dim=0,
                       keepdim=True)
    return ops_i.Hit(*(torch.gather(torch.stack([p[i] for p in parts]), 0,
                                    win)[0] for i in range(4)))


def _occluded(scene, org, dirn, tnear, tfar, time=None, sort_rays=False,
              binning='morton'):
    """Any-hit of each ray segment (as _intersect; over triangle shards,
    the OR of theirs)."""
    if scene.tri_shards is not None:
        occ = torch.zeros(org.shape[:1], dtype=torch.bool, device=org.device)
        for _, rows in scene.tri_shards:
            d = rows.device
            occ |= dense.occluded_dense(rows, org.to(d), dirn.to(d),
                                        tnear.to(d), tfar.to(d)).to(org.device)
        return occ
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


def _init_state(org, dirn, pixel_id, sample_id, time=None, pixel_uv=None,
                samples=None):
    """Fresh wavefront state for primary rays (with each ray's time in a
    motion scene, its camera uv and unbent flag under a backplate, and
    its precomputed sample set and index under that sampler)."""
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
    if samples is not None:
        state['sset'] = samples['set']
        state['ssidx'] = samples['sidx']
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
    by +-t_max_shadow_jitter (u on dims, the nk lights' host ints),
    lengthened by up to 100 caps where wi points at or below the
    horizon."""
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


def _make_bounce(scene, params: PTParams, seed, backplate=None,
                 samples=None):
    """The per-bounce wavefront body: bounce(state, depth) -> state.
    backplate: an optional (H, W, 3) image that the state's unbent rays
    see where they escape (the state then carries 'uv' and 'unbent').
    samples: the precomputed sampler's tables, whose 's1d' (sets, spp,
    >= max_depth) and 's2d' (sets, spp, >= 1 + max_depth, 2) replace the
    bounce's stateless draws at the state's 'sset' and 'ssidx'."""
    lights = scene.lights
    env_lights = scene.env_lights
    dim_light, dim_stride = _dim_layout(len(lights))
    groups = _light_groups(lights)
    has_shadow_cap = math.isfinite(params.t_max_shadow_ray)

    def bounce(state, depth: int, rec=prof.OFF):
        """One bounce; rec, its yrt.bounce span, gets the rays it traced
        ('rays') and its shadow candidates ('shadow'); under the tracer
        its yrt.env span gets the rays that missed ('escaped')."""
        r, dev = state['org'].shape[0], state['org'].device
        # the reference bins rays on every bounce after the first
        binned = (depth > 0, params.ray_binning)
        pixel_id, sample_id = state['pid'], state['sid']
        base = _bounce_dims(depth, dim_stride)
        org, dirn = state['org'], state['dir']
        thr, L = state['throughput'], state['L']
        if samples is not None:
            pick = state['sset'], state['ssidx']
            nee_u2 = samples['s2d'][pick + (0,)]
            pre_s1 = samples['s1d'][pick + (depth,)]
            pre_s2 = samples['s2d'][pick + (1 + depth,)]

        # terminate low-contribution paths (pathtraceintegrator.cpp:66-67)
        active = _live(state, params)
        # dead lanes get tfar < tnear: every kernel rejects them at once
        tfar_live = torch.where(active, float('inf'), -1.0)
        with span(prof.INTERSECT):
            hit = _intersect(scene, org, dirn, torch.zeros((r,), device=dev),
                             tfar_live, state['time'], *binned)
            dg = ops_i.post_intersect(scene.geom, org, dirn, hit)
        state = dict(state)
        traced = torch.sum(active)
        state['num_rays'] = state['num_rays'] + traced
        rec.set(rays=traced)
        wo = -dirn
        if env_lights or backplate is not None:
            with span(prof.ENV) as env_rec:
                miss = active & ~hit.valid
                if prof.tracer_on():
                    env_rec.set(escaped=torch.sum(miss))
                L = L + _escaped(state, miss, wo, env_lights, backplate)
        active = active & hit.valid

        # face-forward normals (cpp:94-98)
        backfacing = vm.dot(dg['Ng'], dirn) > 0.0
        ng = torch.where(backfacing[:, None], -dg['Ng'], dg['Ng'])
        ns = torch.where(backfacing[:, None], -dg['Ns'], dg['Ns'])

        # shade: material -> lobe context (cpp:108-111), with the
        # bump-mapped shading normal where a material binds a bump map
        with span(prof.SHADE):
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
        with span(prof.NEE):
            use_dl = lb.has_type(lobed, lb.DIFFUSE) & active
            err_eps = dg['error'] * params.epsilon
            cand_gs, contrib_gs, wi_gs, tfar_gs = [], [], [], []
            illum = dg['illum_mask'] & rng._MASK
            for idxs, light, masks in groups:
                dims = [(base + dim_light + li) & rng._MASK for li in idxs]
                mask_ok = (torch.tensor(masks, device=dev)[:, None]
                           & illum) != 0
                u2 = (nee_u2.expand(len(idxs), r, 2) if samples is not None
                      else rng.uniform2(seed, pixel_id, sample_id, dims))
                with span(prof.LIGHTS):
                    le, wi, pdf, tmax = glights.sample(light, dg['P'], ns, u2)
                cand = (use_dl & mask_ok & (pdf > 0.0)
                        & torch.any(le > 0.0, dim=-1))
                with span(prof.LOBES) as lobes_rec:
                    if prof.tracer_on():
                        lobes_rec.set(lanes=wi.numel() // 3)
                    brdf = lb.eval_lobes(lobed, ns, ng, wo, wi, lb.DIFFUSE,
                                         types_present=scene.lobe_types)
                cand = cand & torch.any(brdf > 0.0, dim=-1)
                if has_shadow_cap:
                    tmax = _shadow_cap(
                        params, seed, pixel_id, sample_id, wi,
                        [(base + _DIM_SHADOW + li) & rng._MASK
                         for li in idxs])
                contrib = (thr * le * brdf
                           / torch.clamp(pdf, min=1e-20)[..., None])
                cand_gs.append(cand)
                contrib_gs.append(contrib)
                wi_gs.append(wi)
                tfar_gs.append(torch.where(cand, tmax - err_eps, -1.0))
            if cand_gs:
                cand_all = torch.cat(cand_gs)              # (nl, R)
                nl = cand_all.shape[0]
                shadow = torch.sum(cand_all)
                state['num_rays'] = state['num_rays'] + shadow
                rec.set(shadow=shadow)
                with span(prof.OCCLUDED):
                    occ_all = _occluded_lights(
                        scene, dg['P'], torch.cat(wi_gs), err_eps,
                        torch.cat(tfar_gs), state['time'], *binned)
                lit = cand_all & ~occ_all.reshape(nl, r)
                L = L + torch.sum(torch.where(lit[:, :, None],
                                              torch.cat(contrib_gs), 0.0),
                                  dim=0)

        with span(prof.SCATTER):
            # depth cut (cpp:169-170)
            cont = active & (depth < params.max_depth - 1)

            # russian roulette (cpp:172-182, with 1/q compensation)
            q = torch.clamp(torch.amax(thr, dim=-1) * state['eta_rr'] ** 2,
                            max=0.95)
            rr_on = depth >= params.rr_depth - 1
            if rr_on:
                rr_u = (pre_s1 if samples is not None else
                        rng.uniform1(seed, pixel_id, sample_id,
                                     base + _DIM_RR))
                cont = cont & ~(rr_u >= q)
                rr_scale = 1.0 / torch.clamp(q, min=1e-3)
            else:
                rr_scale = torch.ones_like(q)

            # GI: sample one lobe (cpp:184-213)
            if samples is not None:
                s2, s1 = pre_s2, pre_s1      # s1 is roulette's u, as cpp:179
            else:
                s2 = rng.uniform2(seed, pixel_id, sample_id,
                                  base + _DIM_SCATTER)
                s1 = rng.uniform1(seed, pixel_id, sample_id,
                                  base + _DIM_SCATTER_TYPE)
            with span(prof.LOBES) as lobes_rec:
                if prof.tracer_on():
                    lobes_rec.set(lanes=r)
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
            w = (samp['weight'] * beer
                 / torch.clamp(samp['pdf'], min=1e-20)[:, None])
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
          time=None, pixel_uv=None, backplate=None, samples=None):
    """Radiance along primary rays.  org/dirn: (R, 3) f32; pixel_id,
    sample_id: (R,) int64 holding u32 RNG keys; time: (R,) f32 in [0, 1]
    for a motion scene (every bounce and shadow ray of a path keeps it);
    backplate: an optional (H, W, 3) f32 image on the rays' device, seen
    by escaped rays that no bounce bent at their pixel_uv (R, 2) in
    [0, 1)^2; samples: the precomputed sampler's tables with each ray's
    'set' and 'sidx' (R,) int64 (renderer._pass_samples), or None for
    the stateless draws.  Returns (L (R, 3), num_rays (scalar tensor:
    closest-hit rays plus shadow candidates))."""
    state = _init_state(org, dirn, pixel_id, sample_id, time,
                        _backplate_uv(pixel_uv, backplate), samples)
    bounce = _make_bounce(scene, params, seed, backplate, samples)
    for depth in range(params.max_depth):
        with span(prof.BOUNCE, depth=depth, width=org.shape[0]) as rec:
            state = bounce(state, depth, rec)
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
                    backplate=None, samples=None):
    """trace() one bounce at a time with live-ray compaction between
    bounces (pathtracer.py:862-931): after each bounce the live count is
    read (one host sync), and where it is below the width the dead
    lanes' radiance is flushed by ray id and the live lanes are gathered
    to a prefix in their order, so the next bounce runs at the live
    width.  Bit-identical per ray to trace().

    bounce_stats: an optional list; one {'depth', 'width', 'live',
    'seconds'} dict is appended a bounce, read from its yrt.bounce and
    yrt.sync spans: the width it ran at, the live count entering the
    next bounce, and the seconds since the previous entry, which end
    with the device synchronised (the last bounce's count is then read
    too).  Returns (L (R, 3), num_rays) as trace()."""
    r = org.shape[0]
    state = _init_state(org, dirn, pixel_id, sample_id, time,
                        _backplate_uv(pixel_uv, backplate), samples)
    state['rid'] = torch.arange(r, device=org.device)
    bounce = _make_bounce(scene, params, seed, backplate, samples)
    l_out = torch.zeros((r, 3), device=org.device)
    # bounce_stats reads the records, so they are kept without a tracer
    keep = bounce_stats is not None
    opened = prof.Span if keep else span
    t0 = _time.perf_counter_ns()
    for depth in range(params.max_depth):
        w = state['org'].shape[0]
        with opened(prof.BOUNCE, depth=depth, width=w) as rec:
            state = bounce(state, depth, rec)
        last = depth == params.max_depth - 1
        if last and not keep:
            break
        with span(prof.COMPACT):
            live = _live(state, params)
            with opened(prof.SYNC) as sync:
                n = int(torch.sum(live))     # the bounce's one sync
            rec.set(live=n)
            if keep:
                a = rec.attrs
                bounce_stats.append({'depth': a['depth'], 'width': a['width'],
                                     'live': a['live'],
                                     'seconds': (sync.end - t0) * 1e-9})
                t0 = sync.end
            if last or n == 0:
                break
            if n < w:
                state = _compact(state, live, n, l_out)
    l_out.index_copy_(0, state['rid'], state['L'])
    return l_out, state['num_rays']
