"""Scene assembly and commit (the analog of `rtCommit(scene)`).

Counterpart of `yulio_raytracer_tpu/scene.py`: `SceneBuilder` stages
meshes, materials and lights on the host; `commit(device=...)` packs
them into a `TorchScene` on one device:

* the packed triangle rows `tris` ((G, 128) f32, ops/wide.py pack_tris);
* for scenes above BRUTE_FORCE_MAX_TRIS triangles, a binary SAH BVH
  (geometry/bvh.py, leaf `leaf_size`) collapsed to the BVH4 rows `nodes4`
  (the reference's default accel); smaller scenes run the dense kernels;
* the shading table, material table, texture atlas and light list.

The reference's TPU layout rules (SMEM leaf growth, the VMEM/HBM split,
the zero rows after the packed triangles) and its ablation tables
(binary nodes, treelets, planes, grid) are not part of this package.
Every other array equals the reference commit's (`from_numpy_scene`
builds a TorchScene from those arrays).
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
from .ops import wide
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

    def commit(self, device='cpu', leaf_size: int = 64) -> "TorchScene":
        """Pack the staged scene onto `device` (a torch device or its
        name).  Raises NotImplementedError for non-triangle lights and
        ValueError when the BVH4 collapse exceeds the kernels' stack
        bound."""
        packed = gmesh.pack_meshes(self.meshes)
        n_tris = packed.num_triangles
        host = {k: getattr(packed, k) for k in gbvh.PER_TRIANGLE_KEYS}
        nodes4 = None
        if n_tris > BRUTE_FORCE_MAX_TRIS:
            tree = gbvh.build(packed.v0, packed.e1, packed.e2, packed.valid,
                              leaf_size=leaf_size)
            host = gbvh.permute_geom(host, tree.order)
            nodes4 = wide.pack_nodes4(tree)
        woop = gmesh.woop_matrices(host['v0'], host['e1'], host['e2'],
                                   host['valid'])
        tris = wide.pack_tris(woop, host)
        lights = [glights.set_scene_bounds(l, packed.bbox_lo, packed.bbox_hi)
                  for l in self.lights]
        return from_numpy_scene(
            geom=gmesh.add_shade_table(host),
            packet={'tris': tris} if nodes4 is None
            else {'tris': tris, 'nodes4': nodes4},
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


@dataclass(frozen=True)
class TorchScene:
    """A committed scene on one device."""
    device: torch.device
    tris: torch.Tensor            # (G, 128) f32 packed triangle rows
    nodes4: Optional[torch.Tensor]  # (N4, 32) f32 BVH4 rows, or None
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
        """'dense' or 'bvh4': which kernel pair traverses the scene."""
        return 'dense' if self.nodes4 is None else 'bvh4'


def from_numpy_scene(geom, packet, materials, textures, lights, *,
                     leaf_size, bbox_lo, bbox_hi, num_triangles,
                     lobe_types, device='cpu') -> TorchScene:
    """A TorchScene from a committed scene's arrays, as numpy: the fields
    of the reference's TpuScene (`geom`, `packet`, `materials`,
    `textures`, `lights` as merged dicts, and the static fields).  Raises
    NotImplementedError for tables this package cannot traverse or shade
    (a binary-BVH packet without 'nodes4', other lobe types, textures,
    non-triangle lights)."""
    device = torch.device(device)

    def dev(x):
        return torch.as_tensor(np.array(x)).to(device)

    if 'nodes' in packet and 'nodes4' not in packet:
        raise NotImplementedError(
            "binary BVH traversal is not ported yet (BVH4 only)")
    gmat.check_table(materials)
    for l in lights:
        if l['kind'] != 'triangle':
            raise NotImplementedError(
                f"{l['kind']!r} lights are not ported yet ('triangle' only)")
    return TorchScene(
        device=device,
        tris=dev(packet['tris']),
        nodes4=dev(packet['nodes4']) if 'nodes4' in packet else None,
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
