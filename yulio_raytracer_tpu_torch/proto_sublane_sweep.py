"""The dense-sweep layout prototype on the card: one ray per lane, or 8
lanes per ray against 8 triangles.

    python -m yulio_raytracer_tpu_torch.proto_sublane_sweep [--rows 512]
        [--reps 64] [--iters 8] [--what old,new]

Counterpart of `scripts/proto_sublane_sweep.py`, the JAX package's
experiment on how to lay out the dense closest-hit sweep (the body of the
dense kernels K1 and of the pair sweeps K8/K9): does a layout with 8
triangles across one axis and rays across the other, followed by a
lex-min over the 8, hold its own against one ray per lane testing each
triangle in turn?  `--what` takes 'old' (one ray per lane, K1's form),
'new' (8 lanes per ray, the 8 groups of a super-tile unrolled) and
'newsw' (one group read per step).  As the script, each variant times
`rows * 8 * 1024 * reps` pairs a launch: 'old' 1024 rays against `rows`
rows of 8 random triangles, 'new' 128 rays against `rows` super-tiles of
64, and prints one `which: Gpairs/s` line, here with the median time of
`iters` launches (CUDA events); it prints the card's name and power limit
first.  Needs a CUDA device.

The test is the script's own Woop test (`old_kernel`, `_sweep8`): the 12
Woop floats of a packed row (ops/wide.py `pack_tris`), no tnear, no cull,
no BARY_EPS.  On a CUDA tensor `sweep_rows` and `sweep_tiles` launch the
kernels of `csrc/sweep.cu`; on a CPU tensor they run the plain torch
versions, which the kernels are held against bit for bit on the card.  No
render path runs them.

What bounds the kernels is the SMs' instruction issue: the test is 48 f32
operations on values in shared memory and registers, and `--fmad=false`
(which keeps t bit-equal to the plain versions) issues each multiply and
add apart.  So the kernels issue as little as they can besides the test:
each lane keeps its own best (t, triangle) and the 8 lanes of a ray in
the tiles layout take their lex-min once, after the sweep, since the
least (t, triangle) does not depend on the order of the tests.  And when
the rays fill fewer blocks than `SLICE_BLOCKS_PER_SM` a multiprocessor,
the wrappers split the triangle range over blocks, which merge their
results with a 64-bit atomic minimum on the key of t's bits and the
triangle (`MISS_KEY` for a miss).
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from .ops import cuda_build as cb

INF = float('inf')
RAYS_OLD, RAYS_NEW = 1024, 128      # the script's rays per program
_CHUNK_ELEMS = 1 << 24   # (ray, triangle) pairs per step of a plain version

# each ray's result as the kernels merge it across blocks: t's bits in the
# high word, the triangle in the low one; a miss (inf, -1)
MISS_KEY = 0x7f800000ffffffff
SLICE_BLOCKS_PER_SM = 4   # the triangle range is split below this
MIN_SLICE = {'rows': 2, 'tiles': 1}   # rows of 8 / super-tiles of 64

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'yrt_sweep_rows': [_V, _I, _V, _V, _I, _I, _I, _V, _V, _V, _V],
    'yrt_sweep_tiles': [_V, _I, _V, _V, _I, _I, _I, _I, _V, _V, _V, _V],
    'yrt_sweep_block_rays': [_I],
}


# ---------------------------------------------------------------- layout

def supertiles(rows: torch.Tensor) -> torch.Tensor:
    """(8 S, 128): G rows of 8 triangles (G, 128) in the super-tile
    packing of the script's `new_kernel`, triangle 8 g + s (row g, slot s)
    at row 8 (g // 8) + s, columns 16 (g % 8) .. + 16; the rows are padded
    to a multiple of 8 with zero triangles (dwp = 0: never a hit)."""
    g = rows.shape[0]
    s = (g + 7) // 8
    padded = rows.new_zeros((8 * s, 128))
    padded[:g] = rows
    # (tile, group block jj, slot s, 16) -> (tile, s, jj, 16)
    return padded.reshape(s, 8, 8, 16).permute(0, 2, 1, 3).reshape(8 * s, 128)


def _tile_rows(tiles: torch.Tensor) -> torch.Tensor:
    """The (T, 16) triangles of super-tiles, triangle 8 g + s at row
    8 g + s: the inverse of `supertiles` before its padding."""
    s = tiles.shape[0] // 8
    return tiles.reshape(s, 8, 8, 16).permute(0, 2, 1, 3).reshape(-1, 16)


# ------------------------------------------------------- plain versions

def _proto_test(w, org, dirn, t_b):
    """The script's test of triangles w (c, 16) against rays (n, 3) with
    best t t_b (n,): (th, ok), each (n, c), in its operation order."""
    ox, oy, oz = (org[:, k:k + 1] for k in range(3))
    dx, dy, dz = (dirn[:, k:k + 1] for k in range(3))
    oup = ox * w[:, 0] + oy * w[:, 3] + oz * w[:, 6] + w[:, 9]
    ovp = ox * w[:, 1] + oy * w[:, 4] + oz * w[:, 7] + w[:, 10]
    owp = ox * w[:, 2] + oy * w[:, 5] + oz * w[:, 8] + w[:, 11]
    dup = dx * w[:, 0] + dy * w[:, 3] + dz * w[:, 6]
    dvp = dx * w[:, 1] + dy * w[:, 4] + dz * w[:, 7]
    dwp = dx * w[:, 2] + dy * w[:, 5] + dz * w[:, 8]
    nz = torch.abs(dwp) > 1e-12
    inv = torch.where(nz, 1.0 / dwp, 0.0)
    th = -owp * inv
    uh = oup + th * dup
    vh = ovp + th * dvp
    ok = (nz & (uh >= 0.0) & (vh >= 0.0) & (uh + vh <= 1.0) & (th > 0.0)
          & (th < t_b[:, None]))
    return th, ok


def _sweep_plain(tris, org, dirn, reps):
    """Each ray's least t over the triangles tris (T, 16) and the lowest
    triangle at it, swept `reps` times.  A chunk of triangles at a time:
    the least t among the chunk's hits (the first triangle among equal
    t) replaces the best when strictly nearer, which is what a loop over
    the chunk's triangles in ascending order with a strictly-nearer
    update keeps, the kernels' loops among them."""
    n = org.shape[0]
    t_b = torch.full((n,), INF, dtype=torch.float32, device=org.device)
    tri_b = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for _ in range(reps):
        for c0 in range(0, tris.shape[0], step):
            th, ok = _proto_test(tris[c0:c0 + step], org, dirn, t_b)
            tmin, j = torch.min(torch.where(ok, th, INF), dim=1)
            hit = tmin < t_b
            t_b = torch.where(hit, tmin, t_b)
            tri_b = torch.where(hit, (c0 + j).to(torch.int32), tri_b)
    return t_b, tri_b


def sweep_rows_plain(rows, org, dirn, reps=1):
    """Plain torch version of `sweep_rows`."""
    if org.is_cuda:
        sweep_rows_plain.cuda_calls += 1
    return _sweep_plain(rows.reshape(-1, 16), org, dirn, reps)


def sweep_tiles_plain(tiles, org, dirn, reps=1, switch=False):
    """Plain torch version of `sweep_tiles`; `switch` (the order in which
    the kernel reads the groups) does not change the result."""
    if org.is_cuda:
        sweep_tiles_plain.cuda_calls += 1
    return _sweep_plain(_tile_rows(tiles), org, dirn, reps)


# ------------------------------------------------------------- wrappers

def _lib():
    return cb.library('sweep', _SIGNATURES)


def _kernel_args(table, org, dirn):
    """The kernels' table and rays: checked, contiguous, on one card."""
    r = org.shape[0]
    if r >= cb.MAX_RAYS:
        raise ValueError(f"{r} rays exceed one launch ({cb.MAX_RAYS})")
    org, dirn = org.contiguous(), dirn.contiguous()
    for name, x in (('org', org), ('dirn', dirn)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (r, 3)
                or x.device != org.device or not x.is_cuda):
            raise ValueError(f"{name}: expected a float32 CUDA tensor of "
                             f"shape {(r, 3)} on {org.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    table = cb.table_arg('rows', table, 128, org.device)
    if table.shape[0] * 8 >= 1 << 31:
        raise ValueError(f"{table.shape[0]} rows exceed an int's triangles")
    return table, org, dirn


def slices(block_rays, n_rays, units, min_units, sm_count):
    """Triangle slices for a sweep of n_rays rays, block_rays a block,
    over `units` rows or super-tiles: 1 when the rays alone make
    SLICE_BLOCKS_PER_SM blocks a multiprocessor, else enough slices of
    at least min_units units to make that many blocks."""
    blocks = -(-n_rays // block_rays)
    target = SLICE_BLOCKS_PER_SM * sm_count
    if blocks == 0 or blocks >= target:
        return 1
    return max(1, min(-(-target // blocks), units // min_units))


def _sweep(kind, table, org, dirn, reps, switch=False):
    """One launch of the sweep kernel `kind` ('rows' or 'tiles') on
    checked arguments (`_kernel_args`), over the triangle slices
    `slices` chooses; returns (t, tri)."""
    r, dev = org.shape[0], org.device
    units = table.shape[0] // (8 if kind == 'tiles' else 1)
    n_slices = slices(_lib().yrt_sweep_block_rays(int(kind == 'tiles')), r,
                      units, MIN_SLICE[kind],
                      torch.cuda.get_device_properties(
                          dev).multi_processor_count)
    keys = (torch.full((r,), MISS_KEY, dtype=torch.int64, device=dev)
            if n_slices > 1 else None)
    out = (torch.empty((r,), dtype=torch.float32, device=dev),
           torch.empty((r,), dtype=torch.int32, device=dev))
    form = (int(bool(switch)),) if kind == 'tiles' else ()
    _OPS[kind](table, org, dirn, int(reps), *form, n_slices, keys, *out)
    return out


def launch(lib, entry, table, org, dirn, reps, *rest):
    """yrt_sweep_rows of lib, a build of csrc/sweep.cu, on (rows, org,
    dirn, reps, n_slices, keys, t, tri), or yrt_sweep_tiles on (tiles,
    org, dirn, reps, switch, n_slices, keys, t, tri); the C interface
    takes the table's units after it and the ray count after the rays."""
    units = table.shape[0] // (8 if entry == 'yrt_sweep_tiles' else 1)
    cb.launch(getattr(lib, entry), entry, org.device, table, units, org,
              dirn, org.shape[0], reps, *rest)


def sweep_rows(rows, org, dirn, reps=1):
    """(t, tri) of each ray (R, 3) against G rows of 8 triangles
    (G, 128), one ray per lane testing each triangle in turn (the
    script's `old_kernel`; the kernel gives a thread two rays)."""
    if org.device.type == 'cpu':
        return sweep_rows_plain(rows, org, dirn, reps)
    return _sweep('rows', *_kernel_args(rows, org, dirn), reps)


def sweep_tiles(tiles, org, dirn, reps=1, switch=False):
    """(t, tri) of each ray (R, 3) against S super-tiles (8 S, 128) of
    `supertiles`, 8 lanes per ray (the script's `new_kernel`): one group
    per step with `switch`, else each super-tile's 8 groups unrolled."""
    if org.device.type == 'cpu':
        return sweep_tiles_plain(tiles, org, dirn, reps, switch)
    tiles, org, dirn = _kernel_args(tiles, org, dirn)
    if tiles.shape[0] % 8:
        raise ValueError(f"{tiles.shape[0]} rows are not whole super-tiles "
                         "of 8 rows")
    return _sweep('tiles', tiles, org, dirn, reps, switch)


_OUT = 'Tensor(a!)? keys, Tensor(b!) t, Tensor(c!) tri) -> ()'
_OPS = {'rows': cb.operator(
            'sweep_rows', '(Tensor rows, Tensor org, Tensor dirn, int reps, '
            f'int n_slices, {_OUT}', launch, _lib, sweep_rows),
        'tiles': cb.operator(
            'sweep_tiles', '(Tensor tiles, Tensor org, Tensor dirn, int reps, '
            f'int switch, int n_slices, {_OUT}', launch, _lib, sweep_tiles)}

# launch counts: kernels launched, and plain versions run on CUDA tensors
sweep_rows.launches = 0
sweep_tiles.launches = 0
sweep_rows_plain.cuda_calls = 0
sweep_tiles_plain.cuda_calls = 0


# ---------------------------------------------------------------- script

def shape_a(which: str, rows: int, device):
    """The script's inputs for variant `which` at `rows` (its random
    numbers, RandomState(0), all in [0, 1): no ray hits): (table, org,
    dirn), 'old' `rows` rows of 8 triangles against 1024 rays, 'new' and
    'newsw' `rows` super-tiles of 64 against 128."""
    rs = np.random.RandomState(0)
    if which == 'old':
        n, tris = RAYS_OLD, rs.rand(rows, 128).astype(np.float32)
    elif which in ('new', 'newsw'):
        n, tris = RAYS_NEW, rs.rand(rows * 8, 128).astype(np.float32)
    else:
        raise ValueError(f"unknown variant {which!r} (old, new, newsw)")
    ray = [rs.rand(n).astype(np.float32) for _ in range(6)]
    return tuple(torch.as_tensor(x).to(device) for x in (
        tris, np.stack(ray[:3], 1), np.stack(ray[3:], 1)))


def run(which: str, rows: int, reps: int, iters: int):
    """The script's equal-work comparison on the card: every variant
    tests rows * 8 * 1024 pairs a rep ('old': `rows` rows of 8 triangles
    against 1024 rays; 'new', 'newsw': `rows` super-tiles of 64 against
    128), on the script's random numbers (`shape_a`).  Prints and
    returns (Gpairs/s, median ms of `iters` launches)."""
    from .turns import median_ms
    tris, org, dirn = shape_a(which, rows, torch.device('cuda'))
    pairs = rows * 8 * 1024 * reps
    if which == 'old':
        ms = median_ms(lambda: sweep_rows(tris, org, dirn, reps), iters)
    else:
        ms = median_ms(lambda: sweep_tiles(tris, org, dirn, reps,
                                           which == 'newsw'), iters)
    gp = pairs / (ms * 1e-3) / 1e9
    print("%s: %.2f Gpairs/s  (median %.3f ms of %d launches)"
          % (which, gp, ms, iters), flush=True)
    return gp, ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--rows', type=int, default=512)
    ap.add_argument('--reps', type=int, default=64)
    ap.add_argument('--iters', type=int, default=8)
    ap.add_argument('--what', default='old,new')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sweep kernels have no CPU "
                           "mode")
    from .turns import card_name
    print("card:", card_name())
    for w in args.what.split(','):
        run(w, args.rows, args.reps, args.iters)
    return 0


if __name__ == '__main__':
    sys.exit(main())
