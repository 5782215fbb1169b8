"""Pixel and triangle parallelism over several devices and processes.

Counterpart of `yulio_raytracer_tpu/parallel/sharding.py`.  A `Mesh` is
a ('px', 'tri') grid of device slots:

* every pass of a frame splits its pixel ids into contiguous shards over
  the 'px' axis (padded to a multiple of it as the reference pads them,
  `arange(npix_pad) % npix`, the padding dropped before accumulation);
  each shard renders on its slot through the renderer's own pass
  function, so a pixel's samples stay on one slot and are summed in the
  same order as on one device: the film is bit-equal to the one-device
  film;
* the scene, the camera, the backplate and the sampler's tables are
  copied once to each distinct device (`TorchScene.to`), and the
  shards' radiance is added into the film on the film's device;
* a 'tri' axis above 1 (render_frame_sharded only) splits the scene's
  triangles into contiguous shards, one per slot of a 'px' row, each
  traced by the dense kernels on its slot; the integrator takes the
  nearest shard's hit (the lowest triangle id on equal t) and the OR of
  the shards' any-hit results (integrator/pathtracer.py);
* slots on distinct devices run in host threads, each on its own
  device; slots that share a device run in turn;
* after `init_distributed` the 'px' axis of a mesh made then spans the
  processes: each renders its part of the padded pixel ids on its own
  slots and the pass's radiance is all-gathered (over the host under
  gloo), so every process holds the whole film.

The reference compiles one shard_map step over a jax mesh; here a pass
is ordinary torch code run once per slot.
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from .. import renderer as _renderer
from ..scene import to_device

# per committed scene: its replica for each row of slots
_REPLICAS = WeakIdKeyDictionary()


@dataclass(frozen=True)
class Mesh:
    """A ('px', 'tri') grid of this process's device slots: slots[i][j]
    is px row i's j-th triangle slot.  Across `world` processes (the
    one here is `rank`) the 'px' axis holds every process's rows."""
    slots: tuple
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> dict:
        return {'px': len(self.slots) * self.world,
                'tri': len(self.slots[0])}


def _slot(d) -> torch.device:
    """A named slot's device, with its card's index; raises for a card
    that does not exist."""
    d = torch.device(d)
    if d.type != 'cuda':
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for the slot {d}")
    i = torch.cuda.current_device() if d.index is None else d.index
    if i >= torch.cuda.device_count():
        raise ValueError(f"slot {d}: only {torch.cuda.device_count()} "
                         "CUDA devices are visible")
    return torch.device('cuda', i)


def make_mesh(n_devices: Optional[int] = None, tri_parallel: int = 1,
              devices=None) -> Mesh:
    """A mesh of n_devices slots, tri_parallel per 'px' row.  Without
    `devices` the slots are the first n_devices visible cards (None: all
    of them), and asking for more cards than exist, or for any without
    one, raises.  `devices` names the slots (['cpu'] * 8, or
    ['cuda:0'] * 2 for two slots on one card), the first n_devices of
    them when it is given.  After init_distributed the 'px' axis also
    spans the processes, each with these slots of its own; without
    `devices` each process's one slot is then the card init_distributed
    pinned it to."""
    world = dist.get_world_size() if _joined() else 1
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail == 0:
            raise RuntimeError("make_mesh: no CUDA device; name the slots "
                               "(devices=['cpu'] * n) to run on the CPU")
        if world > 1:
            # each process's one slot is the card init_distributed pinned
            if n_devices not in (None, world):
                raise ValueError(f"make_mesh: {n_devices} cards asked for "
                                 f"over {world} processes of one card each")
            devs = [torch.device('cuda', torch.cuda.current_device())]
        else:
            n = avail if n_devices is None else n_devices
            if n > avail:
                raise ValueError(f"make_mesh: {n} cards asked for, {avail} "
                                 "visible")
            devs = [torch.device('cuda', i) for i in range(n)]
    else:
        devs = [_slot(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"make_mesh: {n_devices} slots asked for, "
                                 f"{len(devs)} named")
            devs = devs[:n_devices]
    if not devs or tri_parallel < 1 or len(devs) % tri_parallel:
        raise ValueError(f"make_mesh: {len(devs)} slots do not split into "
                         f"rows of tri_parallel={tri_parallel}")
    slots = tuple(tuple(devs[i:i + tri_parallel])
                  for i in range(0, len(devs), tri_parallel))
    return Mesh(slots, dist.get_rank(), world) if world > 1 else Mesh(slots)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def run_slots(tasks) -> list:
    """Run tasks [(device, fn)], each fn() on its device: those of one
    device in turn on one thread, distinct devices on threads of their
    own, each thread's current CUDA device its own.  Returns the results
    in task order; the first task to raise raises here."""
    groups = {}
    for i, (d, _) in enumerate(tasks):
        groups.setdefault(d, []).append(i)
    out = [None] * len(tasks)

    def run(d, idxs):
        with (torch.cuda.device(d) if d.type == 'cuda'
              else contextlib.nullcontext()):
            for i in idxs:
                out[i] = tasks[i][1]()

    if len(groups) == 1:
        run(*next(iter(groups.items())))
        return out
    with ThreadPoolExecutor(len(groups)) as pool:
        for f in [pool.submit(run, d, idxs) for d, idxs in groups.items()]:
            f.result()
    return out


def shard_triangles(scene, devices) -> tuple:
    """The scene's packed triangles cut into len(devices) contiguous
    shards of whole 128-float rows, shard j on devices[j]: ((start,
    (g, 128) rows), ...), start its first triangle's id.  The tail is
    filled with zero triangles, which never hit."""
    if scene.motion is not None:
        raise ValueError("a motion scene cannot be triangle-sharded")
    rows = scene.tris.reshape(-1, 16)
    n = len(devices)
    per = -(-rows.shape[0] // n)
    per = -(-per // 8) * 8
    rows = torch.cat([rows, rows.new_zeros((per * n - rows.shape[0], 16))])
    return tuple((j * per, rows[j * per:(j + 1) * per].reshape(-1, 128)
                  .contiguous().to(d)) for j, d in enumerate(devices))


def _replica(scene, row):
    """The scene for a 'px' row of slots: on the row's first device, with
    its triangles sharded over the row's slots when it has several."""
    cache = _REPLICAS.setdefault(scene, {})
    if row not in cache:
        sc = scene.to(row[0])
        if len(row) > 1:
            sc = dataclasses.replace(sc,
                                     tri_shards=shard_triangles(scene, row))
        if sc is scene:
            return sc
        cache[row] = sc
    return cache[row]


def replicate(mesh: Mesh, scene, camera, backplate=None, tables=None):
    """Each of this process's 'px' rows' (scene, camera, backplate,
    tables), copied to the row's first device (the scene once per
    device, kept while the scene lives)."""
    return [(_replica(scene, row), to_device(camera, row[0]),
             None if backplate is None else backplate.to(row[0]),
             to_device(tables, row[0])) for row in mesh.slots]


def mesh_pass(mesh: Mesh, slots, pix, **kw):
    """One pass of a frame over the mesh: pix (n,) the pass's pixel ids,
    padded to a multiple of the 'px' axis and cut into contiguous shards,
    each rendered by renderer._render_pass(scene, camera, shard, tables=,
    backplate=, **kw) on its row of `slots` (replicate's); kw's
    bounce_stats list, if any, gets each row's in row order.  Returns
    ((n, 3) radiance, the ray count), on pix's device and gathered over
    the processes."""
    n, n_px = pix.shape[0], mesh.shape['px']
    per = -(-n // n_px)
    ids = pix[torch.arange(per * n_px, device=pix.device) % n]
    first = mesh.rank * len(mesh.slots)
    stats = kw.pop('bounce_stats', None)
    row_stats = [None if stats is None else [] for _ in slots]
    tasks = []
    for i, (sc, cam, bp, tabs) in enumerate(slots):
        g = first + i
        shard = ids[g * per:(g + 1) * per].to(sc.device)
        tasks.append((mesh.slots[i][0], lambda sc=sc, cam=cam, bp=bp,
                      tabs=tabs, shard=shard, st=row_stats[i]:
                      _renderer._render_pass(sc, cam, pix=shard, tables=tabs,
                                             backplate=bp, bounce_stats=st,
                                             **kw)))
    outs = run_slots(tasks)
    if stats is not None:
        for st in row_stats:
            stats.extend(st)
    rgb = torch.cat([o[0].to(pix.device) for o in outs])
    nrays = sum(o[1].to(pix.device) for o in outs)
    if mesh.world > 1:
        rgb, nrays = _gather(rgb, nrays)
    return rgb[:n], nrays


def _gather(rgb, nrays):
    """Every process's pass radiance, in rank order, and the summed ray
    count (through the host under gloo)."""
    dev = rgb.device
    host = dist.get_backend() == 'gloo'
    x = rgb.cpu() if host else rgb
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    total = nrays.reshape(1).to(torch.float64)
    total = total.cpu() if host else total
    dist.all_reduce(total)
    return torch.cat(parts).to(dev), total[0].to(dev, nrays.dtype)


def render_frame_sharded(scene, camera, params, width: int, height: int,
                         spp: int, mesh: Mesh, film=None, seed: int = 0,
                         iteration: int = 0):
    """One frame of spp samples per pixel over the mesh, pixels over its
    'px' axis and, where its 'tri' axis is above 1, triangles over that
    (the reference's sharding.py:66-130).  Adds to `film` (a new one when
    it is None) and returns it; on the 'px' axis alone the film is
    bit-equal to render_frame's."""
    film, _ = _renderer._frame(scene, camera, params, width, height, spp,
                               seed=seed, film=film, iteration=iteration,
                               mesh=mesh)
    return film


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = 'gloo'):
    """Join this process to a group of num_processes (the reference's
    jax.distributed.initialize): coordinator 'host:port' (else the
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK environment), this
    process's rank process_id.  Where there are cards, each process is
    pinned to card rank % device_count, the default slot of a mesh made
    afterwards (which spans the processes).  backend: gloo (the pass's
    radiance gathered over the host), or nccl, which needs a card for
    every process."""
    if coordinator is None:
        dist.init_process_group(backend, init_method='env://')
    else:
        if backend == 'nccl':
            cards = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            if cards < num_processes:
                raise ValueError(f"init_distributed: nccl needs a card for "
                                 f"each of {num_processes} processes, "
                                 f"{cards} visible")
        dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                                world_size=num_processes, rank=process_id)
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
