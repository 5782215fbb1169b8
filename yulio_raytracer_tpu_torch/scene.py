"""Scene assembly and commit (the analog of `rtCommit(scene)`).

Counterpart of `yulio_raytracer_tpu/scene.py`: `SceneBuilder` stages
meshes, materials and lights on the host; `commit(device=...)` packs
them into a `TorchScene` on one device, the card unless the caller asks
for another:

* the packed triangle rows `tris` ((G, 128) f32, ops/wide.py pack_tris);
* for scenes above BRUTE_FORCE_MAX_TRIS triangles, a binary SAH BVH
  (geometry/bvh.py, leaf `leaf_size`, at the reference's `quality`:
  'high' by default, 'normal' or 'high-spatial', whose duplicated
  triangles are gathered into every per-triangle table) as the binary
  rows `nodes`
  (ops/traverse.py) and, unless `accel='bvh2'` or the collapse fails its
  guards, its BVH4 collapse `nodes4` (the reference's default accel),
  with the uniform grid `grid` (ops/grid.py build_grid, GRID_RES^3
  cells) for `ray_binning='grid'`, whose fallback walks `nodes`, and the
  treelet tables `treelets` (TREELET_KEYS: the cut of `nodes` into
  MAX_TREELETS subtrees, ops/treelets.py, with each one's box and tile
  range over the scene's pair rows `planes_rows`, ops/pairs.py
  pack_planes) for `ray_binning='treelet'` and `'dense'`; smaller scenes
  run the dense kernels;
* for motion scenes, the vertex-edge arrays `motion` and, above
  BRUTE_FORCE_MAX_TRIS, binary rows over union bounds with the motion
  triangle rows `tris_mb`;
* the shading table (with authored tangents where meshes have them),
  the material table, the texture atlas and the light list (every kind;
  an HDRI light's image and distribution tables on the device), with the
  static facts the bounce reads off them: the lobe types in use and the
  material table's texture modes and bump maps (shading/materials.py
  table_gates).

The reference's TPU layout rules (SMEM leaf growth, the VMEM/HBM split,
the zero rows after the packed triangles) and the lane-major `planes`
its TPU kernels read are not part of this package.  The reference builds
the grid, and the pair rows and tile ranges of the 'dense' binning, only
where their planes fit a 15.3 MB VMEM budget; the port builds them for
every static BVH scene, so a scene above that budget takes the grid or
the dense rounds here and the sorted-BVH path (grid) or the treelet
rounds (dense) in the reference, with the same hits up to ties.  Every
other array equals the reference commit's (`from_numpy_scene` builds a
TorchScene from those arrays).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .geometry import bvh as gbvh
from .geometry import mesh as gmesh
from .geometry import primitives
from .lights import lights as glights
from .ops import grid as ggrid
from .ops import pairs, traverse, treelets, wide
from .sampling import distribution as gdist
from .shading import materials as gmat
from .shading import textures as gtex

# at most this many triangles run the dense kernels (scene.py:53)
BRUTE_FORCE_MAX_TRIS = 2048


@dataclass
class SceneBuilder:
    """Mutable host-side staging area (rtNewShape/rtNewMaterial/
    rtNewLight land here)."""
    meshes: list = field(default_factory=list)        # HostMesh
    materials: list = field(default_factory=list)     # MaterialSpec
    lights: list = field(default_factory=list)        # light dicts
    textures: gtex.TextureTableBuilder = field(
        default_factory=gtex.TextureTableBuilder)

    def add_material(self, spec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_mesh(self, m: gmesh.HostMesh) -> int:
        self.meshes.append(m)
        return len(self.meshes) - 1

    def add_light(self, light: dict) -> int:
        """Area lights also create their emissive geometry."""
        self.lights.append(light)
        lid = len(self.lights) - 1
        if light['kind'] == 'triangle':
            mat = self.add_material(gmat.make_material(
                'matte', {'reflectance': (1.0, 1.0, 1.0)}))
            # the visible shape's Ng must match the light's emission
            # normal (shapes/triangle.h:43), so the winding is swapped
            tri = primitives.single_triangle(
                np.asarray(light['v0']), np.asarray(light['v2']),
                np.asarray(light['v1']), material=mat, light=lid)
            self.add_mesh(tri)
        return lid

    def has_billboards(self) -> bool:
        return any(m.face_camera for m in self.meshes)

    def commit(self, device=None, leaf_size: int = 64,
               force_bvh: Optional[bool] = None,
               accel: str = 'default', view_pos=None,
               view_up=(0.0, 1.0, 0.0),
               quality: str = 'high') -> "TorchScene":
        """Pack the staged scene onto `device` (a torch device or its
        name; None is the card, and raises without one).  Camera-aligned
        billboards face view_pos (with view_up; the per-view
        rtUpdatePrimitive + rtCommit of renderer.cpp:550-559), or keep
        their authored placement without one.  A BVH is built
        above BRUTE_FORCE_MAX_TRIS triangles (or as force_bvh says), at
        `quality` ('high', 'normal' or 'high-spatial', geometry/bvh.py;
        a motion scene's tree is the numpy object-split build whatever
        it says, as the reference's).  accel, as in the reference:
        'default' takes the BVH4 collapse and falls back to the binary
        tables when it fails its stack or exactness guard; 'bvh2' forces
        the binary tables; 'bvh4' raises where the collapse fails;
        'bvh4mb' requires motion geometry.  A motion scene's tree is built
        over union bounds and traversed by the motion kernel whatever
        accel says.  The scene's `accel` records what runs.  Every light
        gets the packed scene's bounds (the ambient dome's bounding
        sphere).  The scene records the tree's build seconds and its
        triangle references (`bvh_seconds`, `bvh_refs`).  Raises
        ValueError for an unknown accel or quality and RuntimeError for a
        CUDA device when there is none."""
        if accel not in ('default', 'bvh2', 'bvh4', 'bvh4mb'):
            raise ValueError(
                f"unknown accel {accel!r}: expected 'default' "
                f"(auto-select), 'bvh2', 'bvh4', or 'bvh4mb' "
                f"(motion scenes)")
        if quality not in gbvh.QUALITIES:
            raise ValueError(f"unknown quality {quality!r}: expected one "
                             f"of {gbvh.QUALITIES}")
        meshes = [m if not (m.face_camera and m.orig_transform is not None)
                  else m.transformed(
                      m.orig_transform if view_pos is None else
                      gmesh.billboard_transform(m.orig_transform, view_pos,
                                                view_up))
                  for m in self.meshes]
        packed = gmesh.pack_meshes(meshes)
        n_tris = packed.num_triangles
        has_motion = packed.mv0 is not None
        if accel == 'bvh4mb' and not has_motion:
            raise ValueError("accel='bvh4mb' requires motion geometry "
                             "(meshes with motion vertex buffers)")
        device = resolve_device(device)
        use_bvh = (force_bvh if force_bvh is not None
                   else n_tris > BRUTE_FORCE_MAX_TRIS)
        host = {k: getattr(packed, k) for k in gbvh.PER_TRIANGLE_KEYS
                if getattr(packed, k) is not None}
        bvh_seconds, bvh_refs = 0.0, 0
        if use_bvh:
            t0 = time.perf_counter()
            bounds = (traverse.motion_bounds(
                packed.v0, packed.e1, packed.e2, packed.mv0, packed.me1,
                packed.me2) if has_motion else None)
            tree = gbvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                              leaf_size=leaf_size, bounds=bounds,
                              quality=quality)
            bvh_seconds = time.perf_counter() - t0
            bvh_refs = tree.num_refs
            host = gbvh.permute_geom(host, tree.order)
        if has_motion:
            # small motion scenes keep no tables: they trace every triangle
            packet = ({'nodes': traverse.pack_nodes(tree),
                       'tris_mb': traverse.pack_tris_mb(host)}
                      if use_bvh else {})
            accel_used = 'bvh4mb' if use_bvh else 'dense'
        else:
            woop = gmesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                                       host['valid'])
            packet = {'tris': wide.pack_tris(woop, host)}
            accel_used = 'dense'
            if use_bvh:
                packet.update(_static_nodes(tree, accel))
                packet.update(_treelet_tables(packet['nodes'], woop, host))
                packet['grid'] = ggrid.build_grid(woop, host)
                accel_used = 'bvh4' if 'nodes4' in packet else 'bvh2'
        lights = [glights.set_scene_bounds(l, packed.bbox_lo, packed.bbox_hi)
                  for l in self.lights]
        scene = from_numpy_scene(
            geom=gmesh.add_shade_table(host),
            packet=packet,
            materials=gmat.build_table(self.materials),
            textures=self.textures.build(),
            lights=lights,
            leaf_size=leaf_size,
            bbox_lo=tuple(float(x) for x in packed.bbox_lo),
            bbox_hi=tuple(float(x) for x in packed.bbox_hi),
            num_triangles=n_tris,
            lobe_types=tuple(sorted({lo.type for ms in self.materials
                                     for lo in ms.lobes})),
            accel=accel_used,
            device=device)
        return dataclasses.replace(scene, bvh_seconds=bvh_seconds,
                                   bvh_refs=bvh_refs)


def _static_nodes(tree, accel: str) -> dict:
    """The node tables of a static BVH scene: the binary rows 'nodes'
    (which the grid path's fallback walks) and the BVH4 rows 'nodes4',
    except for accel 'bvh2' and where the BVH4 collapse fails its guards
    (which raises for accel 'bvh4')."""
    tables = {'nodes': traverse.pack_nodes(tree)}
    if accel != 'bvh2':
        try:
            tables['nodes4'] = wide.pack_nodes4(tree)
        except ValueError:
            if accel == 'bvh4':
                raise
    return tables


def _treelet_tables(nodes, woop, host) -> dict:
    """The tables of the 'treelet' and 'dense' binnings, under the
    reference packet's keys (TREELET_KEYS)."""
    roots, boxes = treelets.treelet_cut(nodes, treelets.MAX_TREELETS)
    lo, hi = treelets.treelet_tri_tiles(nodes, roots)
    return {'treelet_roots': roots, 'treelet_boxes': boxes,
            'planes_rows': pairs.pack_planes(woop, host)[1],
            'treelet_tile_lo': lo, 'treelet_tile_hi': hi}


# the treelet cut ('treelet' binning) and, where present, the pair rows
# and tile ranges of the 'dense' binning
TREELET_KEYS = ('treelet_roots', 'treelet_boxes', 'planes_rows',
                'treelet_tile_lo', 'treelet_tile_hi')

# the vertex-edge arrays a motion scene traces at each ray's time
MOTION_KEYS = ('v0', 'e1', 'e2', 'mv0', 'me1', 'me2', 'cull', 'valid')


@dataclass(frozen=True)
class TorchScene:
    """A committed scene on one device.  `accel` says which traversal
    runs: 'bvh4mb' (the motion kernel), 'bvh4', 'bvh2' (the binary
    kernels) or 'dense' (the dense kernels; for a motion scene, every
    triangle at each ray's time in torch ops).  A static BVH scene keeps
    its binary rows, its grid and its treelet tables beside its BVH4
    rows; a motion scene keeps its vertex-edge arrays (`motion`), which
    mark it as moving."""
    device: torch.device
    tris: Optional[torch.Tensor]    # (G, 128) f32 packed triangle rows
    nodes4: Optional[torch.Tensor]  # (N4, 32) f32 BVH4 rows
    nodes: Optional[torch.Tensor]   # (N, 8) f32 binary BVH rows
    tris_mb: Optional[torch.Tensor]  # (G, 128) f32 motion triangle rows
    grid: Optional[dict]          # ops/grid.py GRID_KEYS tables
    treelets: Optional[dict]      # TREELET_KEYS tables
    motion: Optional[dict]        # MOTION_KEYS arrays of a motion scene
    geom: dict                    # {'shade_tab': (T, 28) f32}
    materials: dict               # material table (shading/materials.py)
    textures: dict                # texture atlas (shading/textures.py)
    lights: list                  # light dicts, arrays as tensors
    leaf_size: int
    bbox_lo: tuple
    bbox_hi: tuple
    num_triangles: int
    lobe_types: tuple             # static set of lobe type ids in use
    accel: str
    tex_modes: tuple              # texture modes the material table holds
    bump: bool                    # a material binds a bump map
    bvh_seconds: float = 0.0      # the commit's BVH build (0: none)
    bvh_refs: int = 0             # the tree's triangle references
    # a triangle-sharded scene's shards ((start, (g, 128) rows on the
    # shard's device), ...), traced by the dense kernels and combined by
    # the integrator (parallel/sharding.py shard_triangles); None: whole
    tri_shards: Optional[tuple] = None

    @property
    def env_lights(self):
        """The lights that shine on escaped rays (ambient, HDRI)."""
        return [l for l in self.lights if glights.is_env(l)]

    def to(self, device) -> "TorchScene":
        """This scene on `device`: every tensor copied there (self where
        it lives there already), the static fields kept.  A triangle-
        sharded scene's shards stay on their devices."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {f.name: to_device(getattr(self, f.name), device)
                 for f in dataclasses.fields(self)
                 if f.name not in ('device', 'tri_shards')}
        return dataclasses.replace(self, device=device, **moved)


def to_device(x, device):
    """A copy of x with every tensor in it on `device`: tensors, and the
    dicts, lists, tuples, named tuples and dataclasses holding them;
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None is the card.  Raises RuntimeError
    for a CUDA device when there is none: nothing falls back to the
    CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}; pass "
                           "device='cpu' to run on the CPU")
    return device


def from_numpy_scene(geom, packet, materials, textures, lights, *,
                     leaf_size, bbox_lo, bbox_hi, num_triangles,
                     lobe_types, accel, device=None) -> TorchScene:
    """A TorchScene on `device` (None: the card) from a committed scene's
    arrays, as numpy: the fields of the reference's TpuScene (`geom`,
    `packet` ({} for none; its 'grid' a dict), `materials`, `textures`,
    `lights` as merged dicts, and the static fields, `accel` among
    them).  It keeps the node, triangle and motion tables, the grid's
    GRID_KEYS and the packet's TREELET_KEYS (the reference keeps the
    dense binning's only where they fit its VMEM budget), and drops the
    lane-major planes; a scene without node tables is 'dense' whatever
    the reference's accel says.  Lights of every kind carry across: their
    arrays become float32 tensors (an HDRI's `dist` a
    Distribution2D of them), their str and int fields stay."""
    device = resolve_device(device)

    def dev(x):
        return torch.as_tensor(np.array(x)).to(device)

    def table(key):
        return dev(packet[key]) if key in packet else None

    def light_field(key, v):
        if key == 'dist':
            return gdist.Distribution2D(*(dev(x) for x in v))
        return v if isinstance(v, (str, int)) else dev(v)

    tex_modes, bump = gmat.table_gates(materials)
    return TorchScene(
        device=device,
        tris=table('tris'),
        nodes4=table('nodes4'),
        nodes=table('nodes'),
        tris_mb=table('tris_mb'),
        grid=({k: dev(packet['grid'][k]) for k in ggrid.GRID_KEYS}
              if 'grid' in packet else None),
        treelets=({k: dev(packet[k]) for k in TREELET_KEYS if k in packet}
                  if 'treelet_roots' in packet else None),
        motion=({k: dev(geom[k]) for k in MOTION_KEYS} if 'mv0' in geom
                else None),
        geom={'shade_tab': dev(geom['shade_tab'])},
        materials={k: dev(v) for k, v in materials.items()},
        textures={k: dev(v) for k, v in textures.items()},
        lights=[{k: light_field(k, v) for k, v in l.items()}
                for l in lights],
        leaf_size=int(leaf_size),
        bbox_lo=tuple(bbox_lo),
        bbox_hi=tuple(bbox_hi),
        num_triangles=int(num_triangles),
        lobe_types=tuple(lobe_types),
        accel=accel if 'nodes' in packet else 'dense',
        tex_modes=tex_modes,
        bump=bump,
    )
