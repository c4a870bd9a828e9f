"""User-facing Scene: node tree + lights, flattened to device SceneData.

``flatten`` bakes transforms into world-space vertices and builds one
BVH, as the reference's default does; ``flatten(instancing=True)``
builds a TLAS over per-mesh BLASes instead (scene/instances.py).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cadrays_tpu_torch.core.bsdf import Material
from cadrays_tpu_torch.core.camera import Camera
from cadrays_tpu_torch.core.lights import (
    Lights,
    concat_lights,
    directional_light,
    empty_lights,
)
from cadrays_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from cadrays_tpu_torch.geometry.mesh import TriangleMesh
from cadrays_tpu_torch.scene.flatten import SceneData, flatten_parts
from cadrays_tpu_torch.scene.instances import build_instanced
from cadrays_tpu_torch.scene.model import DataModel, DataNode, NodeType


class Scene:
    def __init__(self):
        self.model = DataModel()
        self._lights: List[Lights] = [
            directional_light(direction=(-0.25, -1.0, -1.0), intensity=1.0,
                              smooth_angle_deg=0.0, headlight=True)
        ]
        self.camera: Camera = Camera.look_at()
        self._dirty = True
        self._cache: Optional[SceneData] = None
        self._version = 0  # bumped on every mutation

    def touch(self) -> None:
        self._dirty = True
        self._version += 1

    def add_mesh(self, name: str, mesh: TriangleMesh,
                 mat: Optional[Material] = None,
                 transform: Optional[np.ndarray] = None,
                 node_type: NodeType = NodeType.POLY_MESH) -> DataNode:
        node = DataNode(name, node_type, mesh, mat, transform)
        self.model.add(node)
        self.touch()
        return node

    def add_shape(self, name: str, mesh: TriangleMesh,
                  mat: Optional[Material] = None,
                  transform: Optional[np.ndarray] = None) -> DataNode:
        return self.add_mesh(name, mesh, mat, transform, NodeType.CAD_SHAPE)

    def add_light(self, light: Lights) -> int:
        self._lights.append(light)
        self.touch()
        return len(self._lights) - 1

    def clear_lights(self) -> None:
        self._lights = []
        self.touch()

    def flatten(self, camera: Optional[Camera] = None,
                instancing: bool = False,
                device=DEFAULT_DEVICE) -> SceneData:
        """Device snapshot of the visible scene (cached on the host, moved
        to ``device`` on return).

        instancing=False bakes transforms into world-space vertices and
        builds one BVH; instancing=True builds a TLAS over per-mesh BLASes
        (scene/instances.py). As in the reference, a cached snapshot is
        returned while the scene is unchanged, whatever ``instancing``
        asks: flatten a fresh Scene to get the other layout.
        """
        dev = resolve_device(device)
        if self._cache is None or self._dirty:
            leaves = self.model.leaves(visible_only=True)
            if not leaves:
                raise ValueError("scene has no visible geometry")
            lights = (concat_lights(self._lights) if self._lights
                      else empty_lights())
            if instancing:
                data = build_instanced(
                    [n.mesh for n in leaves],
                    [n.world_transform() for n in leaves],
                    [n.material for n in leaves],
                    list(range(len(leaves))),
                    lights=lights, device="cpu")
            else:
                meshes, mats, mat_ids = [], [], []
                for i, node in enumerate(leaves):
                    meshes.append(node.mesh.transformed(node.world_transform()))
                    mats.append(node.material)
                    mat_ids.append(i)
                data = flatten_parts(meshes, mats, mat_ids, lights=lights,
                                     device="cpu")
            self._cache = data.replace(version=self._version)
            self._dirty = False
        return self._update_headlights(self._cache, camera).to(dev)

    def _update_headlights(self, data: SceneData,
                           camera: Optional[Camera]) -> SceneData:
        """Headlight directional lights follow the camera forward axis."""
        cam = camera or self.camera
        if data.lights.count == 0:
            return data
        fwd = cam.basis()[2]
        is_head = (data.lights.headlight > 0.0)[:, None]
        vec = torch.where(is_head, fwd[None, :], data.lights.vec)
        return data.replace(lights=data.lights.replace(vec=vec))
