"""Scene flattening: host scene graph -> device tables (SceneData).

Every table is built in numpy on the host exactly as the reference
builds it (same BVH builder, same wide collapse, same packing), then
moved to the device once. ``flatten_parts`` bakes world-space meshes
into one BVH; two-level instanced scenes are built by
scene/instances.py into the same dataclasses. The environment map,
emissive and texture tables are the placeholders the bounce body reads
when those features are off.

The reference also builds, for triangle tables above 200,000 rows, a
copy padded to (T, 128) columns (``tris_hbm``, ``wtris_hbm``): a
128-column row is the TPU's DMA tiling for its streamed-triangle kernel
variant. The port never builds it: on the card the kernel reads the
(T, 12) table from device memory at any size, and the padded copy of a
611,264-row table would be 313 MB of zeros. Both fields keep their
(1, 128) placeholders.

``scene_data_from_numpy`` / ``render_params_from_dict`` rebuild the
port's dataclasses from plain numpy arrays keyed by field path
("geometry.wboxes", "materials.kd", ...), which is how scene data made
elsewhere (for instance by the JAX reference) is carried across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from cadrays_tpu_torch.core.bsdf import Material, concat_materials
from cadrays_tpu_torch.core.lights import Lights, empty_lights
from cadrays_tpu_torch.device import resolve_device
from cadrays_tpu_torch.geometry.bvh import build_bvh
from cadrays_tpu_torch.geometry.mesh import TriangleMesh
from cadrays_tpu_torch.geometry.wide_bvh import build_wide_bvh

WIDE_LEAF = 64  # the reference's leaf size for every scene
# the reference's padded (T, 128) triangle tables, which the port keeps
# as placeholders (module docstring)
_PADDED_FIELDS = ("geometry.tris_hbm", "geometry.wtris_hbm")


def _f32(*shape, fill=0.0):
    return torch.full(shape, fill, dtype=torch.float32)


def _i32(*shape, fill=0):
    return torch.full(shape, fill, dtype=torch.int32)


class _TensorTree:
    """`.to(device)` and `.replace()` for dataclasses of tensors."""

    def to(self, device):
        dev = torch.device(device)
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(dev) if hasattr(v, "to") else v
        return dataclasses.replace(self, **out)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class GeometryData(_TensorTree):
    """World-space triangle soup, threaded binary BVH and BVH8 tables.

    nodes_packed (N, 8) f32: [min xyz | max xyz | bitcast(skip) |
        bitcast(leafbits)]; tris_packed (T+128, 12) f32: [p0 | e1 | e2 |
        bitcast(mat_id) | pad | pad]; wboxes (Nw, 48) f32, wmeta/worder
        (Nw, 8) i32: the wide tree (geometry/wide_bvh.py).
    Instancing fields (scene/instances.py) keep the reference's
    identity placeholders on a baked scene; tris_hbm and wtris_hbm are
    always (1, 128) placeholders (module docstring).
    """

    vertices: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    tri_v: torch.Tensor
    tri_mat: torch.Tensor
    bvh_min: torch.Tensor
    bvh_max: torch.Tensor
    bvh_skip: torch.Tensor
    bvh_first: torch.Tensor
    bvh_count: torch.Tensor
    nodes_packed: torch.Tensor
    tris_packed: torch.Tensor
    node_inst: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1, fill=-1))
    tri_inst: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1))
    inst_inv: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.eye(3, 4)[None])
    inst_tf: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.eye(3, 4)[None])
    instanced: bool = False
    wboxes: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 6))
    wmeta: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1, 1, fill=0x7FFFFFFF))
    winst: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1, 1, fill=-1))
    worder: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1, 8))
    tris_hbm: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 128))
    wide_leaf: int = 16
    wide_depth: int = 0
    wtris_packed: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 12))
    wtris_hbm: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 128))
    wdelta: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1))
    inst_lo: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 3))
    inst_hi: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32(1, 3))
    inst_bridge: torch.Tensor = dataclasses.field(
        default_factory=lambda: _i32(1, fill=0x7FFFFFFF))

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]


@dataclasses.dataclass
class EnvMapData(_TensorTree):
    """Lat-long environment map + sampling CDFs (placeholder when off)."""

    image: torch.Tensor
    marginal_cdf: torch.Tensor
    conditional_cdf: torch.Tensor
    pdf_map: torch.Tensor
    intensity: torch.Tensor
    enabled: bool = False
    background: bool = True


@dataclasses.dataclass
class EmissiveData(_TensorTree):
    """Area-light table: triangles with Le > 0, sampled by power."""

    tri_idx: torch.Tensor
    cdf: torch.Tensor
    area: torch.Tensor
    total_power: torch.Tensor
    count: int = 0


@dataclasses.dataclass
class TextureAtlas(_TensorTree):
    image: torch.Tensor  # (A, A, 3)
    rect: torch.Tensor  # (Ntex, 4): u0, v0, du, dv (normalized)
    enabled: bool = False


@dataclasses.dataclass
class SceneData(_TensorTree):
    geometry: GeometryData
    materials: Material
    lights: Lights
    envmap: EnvMapData
    emissive: EmissiveData
    textures: TextureAtlas
    version: int = -1

    @property
    def device(self) -> torch.device:
        return self.geometry.tris_packed.device


def pack_geometry(vertices: np.ndarray, tri_v: np.ndarray,
                  tri_mat: np.ndarray, bvh) -> tuple:
    """Build the packed traversal tables (see GeometryData)."""
    N = bvh.skip.shape[0]
    T = tri_v.shape[0]
    assert T < (1 << 24), "triangle count exceeds packed-first limit"
    nodes = np.zeros((N, 8), np.float32)
    nodes[:, 0:3] = bvh.node_min
    nodes[:, 3:6] = bvh.node_max
    nodes[:, 6] = bvh.skip.astype(np.int32).view(np.float32)
    descend = np.arange(N, dtype=np.int64) + 1
    leafbits = np.where(
        bvh.count > 0,
        bvh.first.astype(np.int64) | (bvh.count.astype(np.int64) << 24),
        -descend - 2,
    ).astype(np.int32)
    nodes[:, 7] = leafbits.view(np.float32)

    # 128 spare zero rows, as the reference lays the table out
    tris = np.zeros((max(T, 1) + 128, 12), np.float32)
    if T:
        p0 = vertices[tri_v[:, 0]]
        p1 = vertices[tri_v[:, 1]]
        p2 = vertices[tri_v[:, 2]]
        tris[:T, 0:3] = p0
        tris[:T, 3:6] = p1 - p0
        tris[:T, 6:9] = p2 - p0
        tris[:T, 9] = tri_mat.astype(np.int32).view(np.float32)
    return nodes, tris


def empty_envmap() -> EnvMapData:
    return EnvMapData(
        image=_f32(1, 1, 3),
        marginal_cdf=_f32(1, fill=1.0),
        conditional_cdf=_f32(1, 1, fill=1.0),
        pdf_map=_f32(1, 1, fill=1.0 / (4.0 * np.pi)),
        intensity=torch.tensor(1.0),
        enabled=False,
        background=True,
    )


def empty_textures() -> TextureAtlas:
    return TextureAtlas(image=_f32(1, 1, 3), rect=_f32(1, 4), enabled=False)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def flatten_parts(
    meshes: Sequence[TriangleMesh],
    materials: Sequence[Material],
    mat_ids: Sequence[int],
    lights: Optional[Lights] = None,
    device="cuda",
) -> SceneData:
    """Assemble SceneData from world-space meshes; meshes[i] uses
    material index mat_ids[i] into `materials`."""
    dev = resolve_device(device)
    if not meshes:
        raise ValueError("cannot flatten an empty scene")
    vs, idx, ns, uvs, mats = [], [], [], [], []
    off = 0
    for mesh, mid in zip(meshes, mat_ids):
        m = mesh
        if m.normals is None:
            m = TriangleMesh(m.vertices, m.indices, None, m.uvs)
            m.compute_vertex_normals()
        uv = m.uvs if m.uvs is not None else np.zeros((m.num_vertices, 2),
                                                      np.float32)
        vs.append(m.vertices)
        idx.append(m.indices + off)
        ns.append(m.normals)
        uvs.append(uv)
        mats.append(np.full(m.num_triangles, mid, np.int32))
        off += m.vertices.shape[0]
    vertices = np.concatenate(vs)
    indices = np.concatenate(idx)
    normals = np.concatenate(ns)
    uv_all = np.concatenate(uvs)
    tri_mat = np.concatenate(mats)

    bvh = build_bvh(vertices, indices)
    tri_v = indices[bvh.order]
    tri_mat = tri_mat[bvh.order]
    nodes_packed, tris_packed = pack_geometry(vertices, tri_v, tri_mat, bvh)
    wide = build_wide_bvh(bvh.node_min, bvh.node_max, bvh.skip,
                          bvh.first, bvh.count, wide_leaf=WIDE_LEAF)

    geom = GeometryData(
        vertices=_t(vertices), normals=_t(normals), uvs=_t(uv_all),
        tri_v=_t(tri_v), tri_mat=_t(tri_mat),
        bvh_min=_t(bvh.node_min), bvh_max=_t(bvh.node_max),
        bvh_skip=_t(bvh.skip), bvh_first=_t(bvh.first),
        bvh_count=_t(bvh.count),
        nodes_packed=_t(nodes_packed), tris_packed=_t(tris_packed),
        wboxes=_t(wide.wboxes), wmeta=_t(wide.wmeta),
        winst=_t(wide.winst), worder=_t(wide.worder),
        wide_leaf=wide.max_leaf, wide_depth=wide.max_depth,
        # single-level scenes: the wide tables' triangles ARE the fused ones
        wtris_packed=_t(tris_packed),
    )
    mat_table = concat_materials(list(materials))
    emissive = _build_emissive(vertices, tri_v, tri_mat, mat_table)
    data = SceneData(
        geometry=geom,
        materials=mat_table,
        lights=lights if lights is not None else empty_lights(),
        envmap=empty_envmap(),
        emissive=emissive,
        textures=empty_textures(),
    )
    return data.to(dev)


def _build_emissive(vertices: np.ndarray, tri_v: np.ndarray,
                    tri_mat: np.ndarray, mats: Material) -> EmissiveData:
    le = mats.le.numpy()
    lum = le @ np.float32([0.2126, 0.7152, 0.0722])
    tri_lum = lum[np.asarray(tri_mat)]
    p0 = vertices[tri_v[:, 0]]
    p1 = vertices[tri_v[:, 1]]
    p2 = vertices[tri_v[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    power = tri_lum * area
    sel = np.nonzero(power > 0.0)[0]
    if sel.size == 0:
        return EmissiveData(tri_idx=_i32(1), cdf=_f32(1, fill=1.0),
                            area=_f32(1, fill=1.0),
                            total_power=torch.tensor(0.0), count=0)
    p = power[sel]
    cdf = np.cumsum(p)
    total = cdf[-1]
    return EmissiveData(
        tri_idx=_t(sel.astype(np.int32)),
        cdf=_t((cdf / total).astype(np.float32)),
        area=_t(area[sel].astype(np.float32)),
        total_power=torch.tensor(float(total), dtype=torch.float32),
        count=int(sel.size),
    )


# ---------------------------------------------------------------------------
# Carrying state across: numpy arrays keyed by field path
# ---------------------------------------------------------------------------

def _from_arrays(cls, arrays: dict, prefix: str):
    kw = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        sub = _NESTED.get((cls, f.name))
        if sub is not None:
            kw[f.name] = _from_arrays(sub, arrays, key + ".")
        elif key in arrays:
            v = np.asarray(arrays[key])
            if f.type in ("bool", "int"):
                kw[f.name] = (bool if f.type == "bool" else int)(v)
            else:
                kw[f.name] = torch.from_numpy(np.array(v))
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise KeyError(f"scene_data_from_numpy: missing {key!r}")
    return cls(**kw)


_NESTED = {
    (SceneData, "geometry"): GeometryData,
    (SceneData, "materials"): Material,
    (SceneData, "lights"): Lights,
    (SceneData, "envmap"): EnvMapData,
    (SceneData, "emissive"): EmissiveData,
    (SceneData, "textures"): TextureAtlas,
}


def scene_data_from_numpy(arrays: dict, device="cuda") -> SceneData:
    """Build SceneData from numpy arrays keyed by field path.

    Keys follow the reference's SceneData field paths, e.g.
    "geometry.wboxes", "materials.kd", "lights.vec"; static fields
    ("geometry.wide_depth", "emissive.count", ...) may be given as
    scalars and otherwise take their defaults. The reference's padded
    triangle tables are dropped for the placeholders.
    """
    dev = resolve_device(device)
    arrays = {k: v for k, v in arrays.items() if k not in _PADDED_FIELDS}
    return _from_arrays(SceneData, arrays, "").to(dev)
