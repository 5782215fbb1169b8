"""Scene assembly and commit (the analog of `rtCommit(scene)`).

Counterpart of `yulio_raytracer_tpu/scene.py`: `SceneBuilder` stages
meshes, materials and lights on the host; `commit(device=...)` packs
them into a `TorchScene` on one device:

* the packed triangle rows `tris` ((G, 128) f32, ops/wide.py pack_tris);
* for scenes above BRUTE_FORCE_MAX_TRIS triangles, a binary SAH BVH
  (geometry/bvh.py, leaf `leaf_size`) collapsed to the BVH4 rows `nodes4`
  (the reference's default accel), or kept as the binary rows `nodes`
  (ops/traverse.py, `accel='bvh2'` and the fallback); smaller scenes run
  the dense kernels;
* for motion scenes, the vertex-edge arrays `motion` and, above
  BRUTE_FORCE_MAX_TRIS, binary rows over union bounds with the motion
  triangle rows `tris_mb`;
* the shading table, material table, texture atlas and light list.

The reference's TPU layout rules (SMEM leaf growth, the VMEM/HBM split,
the zero rows after the packed triangles) and its ablation tables
(treelets, planes, grid) are not part of this package.  Every other
array equals the reference commit's (`from_numpy_scene` builds a
TorchScene from those arrays).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .geometry import bvh as gbvh
from .geometry import mesh as gmesh
from .geometry import primitives
from .lights import lights as glights
from .ops import traverse, wide
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

    def commit(self, device='cpu', leaf_size: int = 64,
               force_bvh: Optional[bool] = None,
               accel: str = 'default') -> "TorchScene":
        """Pack the staged scene onto `device` (a torch device or its
        name).  A BVH is built above BRUTE_FORCE_MAX_TRIS triangles (or
        as force_bvh says).  accel, as in the reference:
        'default' takes the BVH4 collapse and falls back to the binary
        tables when it fails its stack or exactness guard; 'bvh2' forces
        the binary tables; 'bvh4' raises where the collapse fails;
        'bvh4mb' requires motion geometry.  A motion scene's tree is built
        over union bounds and traversed by the motion kernel whatever
        accel says.  The scene's `accel` records what runs.  Raises
        ValueError for an unknown accel and NotImplementedError for
        non-triangle lights."""
        if accel not in ('default', 'bvh2', 'bvh4', 'bvh4mb'):
            raise ValueError(
                f"unknown accel {accel!r}: expected 'default' "
                f"(auto-select), 'bvh2', 'bvh4', or 'bvh4mb' "
                f"(motion scenes)")
        packed = gmesh.pack_meshes(self.meshes)
        n_tris = packed.num_triangles
        has_motion = packed.mv0 is not None
        if accel == 'bvh4mb' and not has_motion:
            raise ValueError("accel='bvh4mb' requires motion geometry "
                             "(meshes with motion vertex buffers)")
        use_bvh = (force_bvh if force_bvh is not None
                   else n_tris > BRUTE_FORCE_MAX_TRIS)
        host = {k: getattr(packed, k) for k in gbvh.PER_TRIANGLE_KEYS
                if getattr(packed, k) is not None}
        if use_bvh:
            bounds = (traverse.motion_bounds(
                packed.v0, packed.e1, packed.e2, packed.mv0, packed.me1,
                packed.me2) if has_motion else None)
            tree = gbvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                              leaf_size=leaf_size, bounds=bounds)
            host = gbvh.permute_geom(host, tree.order)
        if has_motion:
            # small motion scenes keep no tables: they trace every triangle
            packet = ({'nodes': traverse.pack_nodes(tree),
                       'tris_mb': traverse.pack_tris_mb(host)}
                      if use_bvh else {})
        else:
            woop = gmesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                                       host['valid'])
            packet = {'tris': wide.pack_tris(woop, host)}
            if use_bvh:
                packet.update(_static_nodes(tree, accel))
        lights = [glights.set_scene_bounds(l, packed.bbox_lo, packed.bbox_hi)
                  for l in self.lights]
        return from_numpy_scene(
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
            device=device)


def _static_nodes(tree, accel: str) -> dict:
    """The node table of a static BVH scene: {'nodes4': BVH4 rows}, or
    {'nodes': binary rows} for accel 'bvh2' and where the BVH4 collapse
    fails its guards (which raises for accel 'bvh4')."""
    if accel != 'bvh2':
        try:
            return {'nodes4': wide.pack_nodes4(tree)}
        except ValueError:
            if accel == 'bvh4':
                raise
    return {'nodes': traverse.pack_nodes(tree)}


# the vertex-edge arrays a motion scene traces at each ray's time
MOTION_KEYS = ('v0', 'e1', 'e2', 'mv0', 'me1', 'me2', 'cull', 'valid')


@dataclass(frozen=True)
class TorchScene:
    """A committed scene on one device.  Of the traversal tables, only
    those of the traversal that runs are present (see `accel`); a
    motion scene also keeps its vertex-edge arrays (`motion`), which
    mark it as moving."""
    device: torch.device
    tris: Optional[torch.Tensor]    # (G, 128) f32 packed triangle rows
    nodes4: Optional[torch.Tensor]  # (N4, 32) f32 BVH4 rows
    nodes: Optional[torch.Tensor]   # (N, 8) f32 binary BVH rows
    tris_mb: Optional[torch.Tensor]  # (G, 128) f32 motion triangle rows
    motion: Optional[dict]        # MOTION_KEYS arrays of a motion scene
    geom: dict                    # {'shade_tab': (T, 28) f32}
    materials: dict               # material table (shading/materials.py)
    textures: dict                # texture atlas (empty in this slice)
    lights: list                  # light dicts, arrays as tensors
    leaf_size: int
    bbox_lo: tuple
    bbox_hi: tuple
    num_triangles: int
    lobe_types: tuple             # static set of lobe type ids in use

    @property
    def accel(self) -> str:
        """Which traversal runs: 'bvh4mb' (the motion kernel), 'bvh4',
        'bvh2' (the binary kernels) or 'dense' (the dense kernels; for a
        motion scene, every triangle at each ray's time in torch ops)."""
        if self.tris_mb is not None:
            return 'bvh4mb'
        if self.nodes4 is not None:
            return 'bvh4'
        return 'dense' if self.nodes is None else 'bvh2'


def from_numpy_scene(geom, packet, materials, textures, lights, *,
                     leaf_size, bbox_lo, bbox_hi, num_triangles,
                     lobe_types, device='cpu') -> TorchScene:
    """A TorchScene from a committed scene's arrays, as numpy: the fields
    of the reference's TpuScene (`geom`, `packet` ({} for none),
    `materials`, `textures`, `lights` as merged dicts, and the static
    fields).  It keeps the tables of the traversal the reference runs on
    them (the BVH4 rows over the binary ones, the motion rows and the
    motion arrays of a motion scene) and drops the ablation tables.
    Raises NotImplementedError for what this package cannot shade (other
    lobe types, textures, non-triangle lights)."""
    device = torch.device(device)

    def dev(x):
        return torch.as_tensor(np.array(x)).to(device)

    def table(key):
        return dev(packet[key]) if key in packet else None

    gmat.check_table(materials)
    for l in lights:
        if l['kind'] != 'triangle':
            raise NotImplementedError(
                f"{l['kind']!r} lights are not ported yet ('triangle' only)")
    nodes4 = table('nodes4')
    return TorchScene(
        device=device,
        tris=table('tris'),
        nodes4=nodes4,
        nodes=table('nodes') if nodes4 is None else None,
        tris_mb=table('tris_mb'),
        motion=({k: dev(geom[k]) for k in MOTION_KEYS} if 'mv0' in geom
                else None),
        geom={'shade_tab': dev(geom['shade_tab'])},
        materials={k: dev(v) for k, v in materials.items()},
        textures={k: dev(v) for k, v in textures.items()},
        lights=[{k: (v.item() if isinstance(v, np.generic) else
                     v if isinstance(v, (str, int, float)) else dev(v))
                 for k, v in l.items()} for l in lights],
        leaf_size=int(leaf_size),
        bbox_lo=tuple(bbox_lo),
        bbox_hi=tuple(bbox_hi),
        num_triangles=int(num_triangles),
        lobe_types=tuple(lobe_types),
    )
