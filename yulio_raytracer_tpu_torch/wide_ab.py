"""The walks of one tree side by side on the card: K5/K6 over its binary
rows, K3/K4 over its BVH4 rows, the width-8 kernels over its 8-wide rows,
and K5/K6 in stages (ops/traverse.py intersect_packet_staged and
occluded_packet_staged).

    python -m yulio_raytracer_tpu_torch.wide_ab [--reps 5]

The counterpart of the reference's scripts/bench_wide_ab.py and
scripts/profile_staged.py.  The colonnade is committed on the card at
leaf 32 (its BVH4 and binary rows; the 8-wide rows are read back from the
binary ones, raysets.nodes8), with the ray sets `turns wide` and
chip_smoke.py time K3/K4 on, from seed 42: its 1024^2 camera rays, 1M
hemisphere rays from their hits, and the shadow rays from those hits to
its 4 lights.  The closest-hit forms run on the camera and hemisphere
sets, the any-hit forms on the shadow set.  Each form must be bit-equal to
its plain version, which also counts its box and pair tests (a wide row's
non-empty slots, beside the kernel's box tests of all its slots), and give
K5's t and hit mask (K6's occlusion); a triangle that differs at an equal
t is a tie, counted.  Each form is timed with CUDA events (median of
--reps runs after a warm-up) and printed with its tests per ray, its bound
(roofline.bound: the bytes it must move, tables and rays read once and
results written once, and its tests' flops, 55 a Woop test and 25 a box
test) and the share of that bound its time reaches, with the card's name
and power limit.  The last line is one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import raysets, roofline
from .ops import traverse, wide
from .turns import card_name, colonnade, median_ms, nbytes


def forms(sc, nodes8):
    """{set kind: {form: (kernel, plain, tables, extra args)}}: the
    closest-hit forms and the any-hit forms of the scene's tree."""
    box = (sc.bbox_lo, sc.bbox_hi)
    binary, four, eight = ((sc.nodes, sc.tris), (sc.nodes4, sc.tris),
                           (nodes8, sc.tris))
    return {
        'closest': {
            'K5 binary': (traverse.intersect_packet,
                          traverse.intersect_binary_plain, binary, ()),
            'K3 width 4': (wide.intersect_packet4, wide.intersect_wide_plain,
                           four, ()),
            'width 8': (wide.intersect_packet8, wide.intersect_wide_plain,
                        eight, ()),
            'K5 staged': (traverse.intersect_packet_staged,
                          traverse.intersect_staged_plain, binary, box)},
        'any': {
            'K6 binary': (traverse.occluded_packet,
                          traverse.occluded_binary_plain, binary, ()),
            'K4 width 4': (wide.occluded_packet4, wide.occluded_wide_plain,
                           four, ()),
            'width 8': (wide.occluded_packet8, wide.occluded_wide_plain,
                        eight, ()),
            'K6 staged': (traverse.occluded_packet_staged,
                          traverse.occluded_staged_plain, binary, box)}}


def _tuple(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def run_form(kernel, plain, tables, extra, rays, reps):
    """One form on one ray set: its outputs, bit-equal to its plain
    version's, with its time, tests and bound."""
    out = _tuple(kernel(*tables, *rays, *extra))
    counts = {}
    ref = _tuple(plain(*tables, *rays, *extra, counts=counts))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError(f"{kernel.__name__}: not bit-equal to its "
                             "plain version")
    ms = median_ms(lambda: kernel(*tables, *rays, *extra), reps)
    n = rays[0].shape[0]
    pair, box = int(counts['pair']), int(counts['box'])
    made = int(counts.get('slots', box))
    moved = nbytes(*tables, *rays) + nbytes(*out)
    bound, by = roofline.bound(moved, pair * roofline.WOOP_FLOPS
                               + box * roofline.SLAB_FLOPS)
    return out, {'rays': n, 'ms': ms, 'pair_tests': pair, 'box_tests': box,
                 'pair_per_ray': pair / n, 'box_per_ray': box / n,
                 'kernel_box_tests': made,
                 'bytes': moved, 'bound_ms': bound, 'bound_by': by,
                 'share': bound / ms}


def agreement(out, ref):
    """How out agrees with the binary walk's ref: closest hits must have
    its t and hit mask (ties counted), occlusion must equal it."""
    if len(out) == 1:
        if not torch.equal(out[0], ref[0]):
            raise AssertionError("occlusion differs from K6's")
        return 0, "K6's occlusion"
    t, tri = out[0], out[1]
    if not (torch.equal(t, ref[0]) and torch.equal(tri >= 0, ref[1] >= 0)):
        raise AssertionError("t or hit mask differs from K5's")
    ties = int((tri != ref[1]).sum())
    return ties, f"K5's t and hit mask, {ties} ties resolved otherwise"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=5)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    card = card_name()
    sc, cam, _, hemi, shadow = colonnade(dev)
    nodes8 = raysets.nodes8(sc)
    print(f"[ab] colonnade (leaf 32): {sc.nodes.shape[0]} binary, "
          f"{sc.nodes4.shape[0]} BVH4 and {nodes8.shape[0]} BVH8 rows",
          flush=True)
    sets = (('camera', 'closest', cam), ('hemisphere', 'closest', hemi),
            ('shadow', 'any', shadow))
    table = forms(sc, nodes8)
    summary = {}
    for name, kind, rays in sets:
        ref = None
        summary[name] = {}
        for form, (kernel, plain, tables, extra) in table[kind].items():
            out, res = run_form(kernel, plain, tables, extra, rays,
                                opts.reps)
            if ref is None:
                ref, agree = out, 'the reference of this set'
            else:
                res['ties'], agree = agreement(out, ref)
            summary[name][form] = res
            print(f"[ab] {name} {form} on {res['rays']} rays: "
                  f"{res['ms']:.4f} ms; {res['box_per_ray']:.2f} box "
                  f"(the kernel makes "
                  f"{res['kernel_box_tests'] / res['rays']:.2f}) and "
                  f"{res['pair_per_ray']:.2f} pair tests a ray; bound "
                  f"{res['bound_ms']:.4f} ms by {res['bound_by']}, "
                  f"{res['share']:.2%} of it; bit-equal to its plain "
                  f"version, {agree}; {card}", flush=True)
    print(json.dumps({'card': card, 'reps': opts.reps, 'sets': summary}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
