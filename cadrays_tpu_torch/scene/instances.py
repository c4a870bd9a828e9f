"""Two-level BVH: per-mesh BLAS + TLAS over instances.

A copy of the reference's host-side build (same algorithm, same tables,
bit for bit). Each unique mesh gets one BLAS in *object* space (cached
on the mesh); the TLAS is built over world-space instance AABBs (one
instance per leaf). The two levels are fused into one threaded node
array: every TLAS leaf becomes a "bridge" node whose descend pointer
jumps to its instance's BLAS root, and the BLAS exit-skips are rewired
to the bridge's skip. ``node_inst`` tags each node with its instance
(-1 for the TLAS), and the walkers move rays into object space with
``inst_inv`` (direction left unnormalised, so t stays in world units).

The wide (BVH8) tree is built over a second, shared-BLAS layout: the
instances of one (mesh, material) group share one BLAS subtree and one
range of the compact triangle table ``wtris_packed``; the bridge slot
of the wide tree carries the instance id (``winst``), and
``wdelta[inst]`` maps a compact triangle id back to the fused
per-instance id. Kernel K1 variant (b) (ops/wide.py) walks it, at any
size of the compact table: the reference's streamed-triangle variant
(c) for tables above 200,000 rows is the same kernel on the card, and
its padded (T, 128) copy ``wtris_hbm`` is not built (scene/flatten.py).
The only limit is the packing: a leaf holds ``first | count << 24`` and
a hit id is ``first + k + wdelta`` in int32, so the compact table must
stay below 2^24 rows (``_check_compact_rows``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cadrays_tpu_torch.core.bsdf import Material, concat_materials
from cadrays_tpu_torch.core.lights import Lights, empty_lights
from cadrays_tpu_torch.device import resolve_device
from cadrays_tpu_torch.geometry.bvh import ThreadedBVH, build_bvh
from cadrays_tpu_torch.geometry.mesh import TriangleMesh
from cadrays_tpu_torch.geometry.wide_bvh import build_wide_bvh
from cadrays_tpu_torch.scene.flatten import (
    WIDE_LEAF,
    EmissiveData,
    GeometryData,
    SceneData,
    _f32,
    _i32,
    _t,
    empty_envmap,
    empty_textures,
)


def _mesh_blas(mesh: TriangleMesh):
    """BLAS + reordered object-space arrays, cached ON the mesh object
    (an id()-keyed global cache would go stale when a freed mesh's id is
    recycled)."""
    key = (id(mesh.vertices), id(mesh.indices))
    cached = getattr(mesh, "_blas_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    m = mesh
    if m.normals is None:
        m.compute_vertex_normals()
    uv = m.uvs if m.uvs is not None else np.zeros((m.num_vertices, 2),
                                                  np.float32)
    bvh = build_bvh(m.vertices, m.indices)
    out = (bvh, m.vertices, m.normals, uv, m.indices[bvh.order])
    mesh._blas_cache = (key, out)
    return out


def _transform_aabb(lo, hi, m):
    """Exact AABB of a transformed AABB (per-axis corner extremes)."""
    lin = m[:3, :3]
    t = m[:3, 3]
    c = (lo + hi) * 0.5
    e = (hi - lo) * 0.5
    center = lin @ c + t
    extent = np.abs(lin) @ e
    return center - extent, center + extent


def build_instanced(
    meshes: Sequence[TriangleMesh],
    transforms: Sequence[np.ndarray],
    materials: Sequence[Material],
    mat_ids: Sequence[int],
    lights: Optional[Lights] = None,
    device="cuda",
) -> SceneData:
    """Assemble a two-level SceneData on ``device``; meshes[i] is
    instanced with transforms[i] (4x4 world matrix) and material
    mat_ids[i]."""
    dev = resolve_device(device)
    n_inst = len(meshes)
    if n_inst == 0:
        raise ValueError("cannot flatten an empty scene")

    # one BLAS per unique mesh object (assemblies repeat parts)
    _blas_cache: dict = {}

    def _blas_of(m):
        k = id(m)
        if k not in _blas_cache:
            _blas_cache[k] = _mesh_blas(m)
        return _blas_cache[k]

    blases = [_blas_of(m) for m in meshes]

    # ---- instance world AABBs + TLAS (leaf = 1 instance) ---------------
    inst_lo = np.zeros((n_inst, 3), np.float32)
    inst_hi = np.zeros((n_inst, 3), np.float32)
    for i, (bvh, *_rest) in enumerate(blases):
        inst_lo[i], inst_hi[i] = _transform_aabb(
            bvh.node_min[0], bvh.node_max[0],
            np.asarray(transforms[i], np.float32))
    tlas = _build_tlas(inst_lo, inst_hi)

    # ---- fuse node arrays ----------------------------------------------
    Nt = tlas.skip.shape[0]
    blas_sizes = [b[0].skip.shape[0] for b in blases]
    tri_counts = [b[4].shape[0] for b in blases]
    # BLAS copies in TLAS leaf order (= tlas.order)
    inst_order = tlas.order
    blas_offset = {}
    off = Nt
    tri_off = {}
    toff = 0
    voff = {}
    vo = 0
    for inst in inst_order:
        blas_offset[int(inst)] = off
        off += blas_sizes[int(inst)]
        tri_off[int(inst)] = toff
        toff += tri_counts[int(inst)]
        voff[int(inst)] = vo
        vo += blases[int(inst)][1].shape[0]
    N = off
    T = toff
    V = vo

    node_min = np.zeros((N, 3), np.float32)
    node_max = np.zeros((N, 3), np.float32)
    skip = np.full(N, -1, np.int32)
    descend = np.zeros(N, np.int64)
    first = np.full(N, -1, np.int32)
    count = np.zeros(N, np.int32)
    node_inst = np.full(N, -1, np.int32)

    # TLAS portion; its leaves become bridges (count 0, first -1)
    node_min[:Nt] = tlas.node_min
    node_max[:Nt] = tlas.node_max
    skip[:Nt] = tlas.skip
    descend[:Nt] = np.arange(Nt) + 1
    leaf_ids = np.nonzero(tlas.count > 0)[0]
    for ln in leaf_ids:
        inst = int(tlas.order[tlas.first[ln]])  # leaf holds one instance
        descend[ln] = blas_offset[inst]

    vertices = np.zeros((V, 3), np.float32)
    normals = np.zeros((V, 3), np.float32)
    uvs = np.zeros((V, 2), np.float32)
    tri_v = np.zeros((T, 3), np.int32)
    tri_mat = np.zeros(T, np.int32)
    tri_inst = np.zeros(T, np.int32)

    for inst in inst_order:
        inst = int(inst)
        bvh, v, nrm, uv, tv = blases[inst]
        o = blas_offset[inst]
        n = blas_sizes[inst]
        to = tri_off[inst]
        tc = tri_counts[inst]
        vo2 = voff[inst]
        node_min[o:o + n] = bvh.node_min
        node_max[o:o + n] = bvh.node_max
        # the bridge node that jumps here:
        bridge = [ln for ln in leaf_ids
                  if int(tlas.order[tlas.first[ln]]) == inst][0]
        exit_skip = tlas.skip[bridge]
        skip[o:o + n] = np.where(bvh.skip >= 0, bvh.skip + o, exit_skip)
        descend[o:o + n] = np.arange(o, o + n) + 1
        leaf = bvh.count > 0
        first[o:o + n] = np.where(leaf, bvh.first + to, -1)
        count[o:o + n] = bvh.count
        node_inst[o:o + n] = inst
        vertices[vo2:vo2 + v.shape[0]] = v
        normals[vo2:vo2 + v.shape[0]] = nrm
        uvs[vo2:vo2 + v.shape[0]] = uv
        tri_v[to:to + tc] = tv + vo2
        tri_mat[to:to + tc] = mat_ids[inst]
        tri_inst[to:to + tc] = inst

    # ---- packed tables --------------------------------------------------
    # hit ids are exact in float32 (the reference's kernel) below 2^24
    assert T < (1 << 24)
    nodes_packed = np.zeros((N, 8), np.float32)
    nodes_packed[:, 0:3] = node_min
    nodes_packed[:, 3:6] = node_max
    nodes_packed[:, 6] = skip.view(np.float32)
    leafbits = np.where(count > 0,
                        first.astype(np.int64)
                        | (count.astype(np.int64) << 24),
                        -descend - 2).astype(np.int32)
    nodes_packed[:, 7] = leafbits.view(np.float32)

    # 128 spare zero rows, as the reference lays the table out
    tris_packed = np.zeros((max(T, 1) + 128, 12), np.float32)
    p0 = vertices[tri_v[:, 0]]
    p1 = vertices[tri_v[:, 1]]
    p2 = vertices[tri_v[:, 2]]
    tris_packed[:T, 0:3] = p0
    tris_packed[:T, 3:6] = p1 - p0
    tris_packed[:T, 6:9] = p2 - p0
    tris_packed[:T, 9] = tri_mat.view(np.float32)

    inst_inv = np.zeros((n_inst, 3, 4), np.float32)
    inst_tf = np.zeros((n_inst, 3, 4), np.float32)
    for i, tf in enumerate(transforms):
        m = np.asarray(tf, np.float64)
        inst_inv[i] = np.linalg.inv(m)[:3, :4].astype(np.float32)
        inst_tf[i] = m[:3, :4].astype(np.float32)

    # ---- shared-BLAS wide structure ------------------------------------
    # Instances grouped by (mesh identity, material): each group's BLAS
    # appears ONCE in the wide tree (build_wide_bvh memoizes the shared
    # subtree; the bridge slot carries the instance id). Leaf triangle
    # ranges index the COMPACT per-group table, and the kernel adds
    # wdelta[inst] to a hit to recover the fused per-instance id.
    group_key = [(id(meshes[i]), int(mat_ids[i])) for i in range(n_inst)]
    group_of: dict = {}
    group_rep: list = []
    for i in range(n_inst):
        if group_key[i] not in group_of:
            group_of[group_key[i]] = len(group_rep)
            group_rep.append(i)
    group_idx = [group_of[group_key[i]] for i in range(n_inst)]
    G = len(group_rep)

    g_nodes = [blas_sizes[group_rep[g]] for g in range(G)]
    g_tris = [tri_counts[group_rep[g]] for g in range(G)]
    g_node_off = np.concatenate([[Nt], Nt + np.cumsum(g_nodes)])[:G]
    g_tri_off = np.concatenate([[0], np.cumsum(g_tris)])[:G]
    Tw = int(sum(g_tris))
    Nw = Nt + int(sum(g_nodes))
    _check_compact_rows(Tw + 128)

    w_min = np.zeros((Nw, 3), np.float32)
    w_max = np.zeros((Nw, 3), np.float32)
    w_skip = np.full(Nw, -1, np.int32)
    w_desc = np.arange(1, Nw + 1, dtype=np.int64)
    w_first = np.full(Nw, -1, np.int32)
    w_count = np.zeros(Nw, np.int32)
    w_inst = np.full(Nw, -1, np.int32)

    w_min[:Nt] = tlas.node_min
    w_max[:Nt] = tlas.node_max
    w_skip[:Nt] = tlas.skip
    for ln in leaf_ids:
        inst = int(tlas.order[tlas.first[ln]])
        w_desc[ln] = g_node_off[group_idx[inst]]
        w_inst[ln] = inst  # the bridge carries the instance id
    for g in range(G):
        bvh = blases[group_rep[g]][0]
        o = int(g_node_off[g])
        n = g_nodes[g]
        w_min[o:o + n] = bvh.node_min
        w_max[o:o + n] = bvh.node_max
        w_skip[o:o + n] = np.where(bvh.skip >= 0, bvh.skip + o, -1)
        leaf = bvh.count > 0
        w_first[o:o + n] = np.where(leaf, bvh.first + g_tri_off[g], -1)
        w_count[o:o + n] = bvh.count

    bridge_mask = np.zeros(Nw, bool)
    bridge_mask[leaf_ids] = True  # TLAS leaves became bridges
    wide = build_wide_bvh(w_min, w_max, w_skip, w_first, w_count,
                          descend=w_desc, node_inst=w_inst,
                          bridge=bridge_mask, wide_leaf=WIDE_LEAF)

    wtris_packed = np.zeros((Tw + 128, 12), np.float32)
    for g in range(G):
        rep = group_rep[g]
        src = tri_off[rep]
        wtris_packed[g_tri_off[g]:g_tri_off[g] + g_tris[g]] = \
            tris_packed[src:src + g_tris[g]]
    wdelta = np.asarray(
        [tri_off[i] - g_tri_off[group_idx[i]] for i in range(n_inst)],
        np.int32)

    geom = GeometryData(
        vertices=_t(vertices), normals=_t(normals), uvs=_t(uvs),
        tri_v=_t(tri_v), tri_mat=_t(tri_mat),
        bvh_min=_t(node_min), bvh_max=_t(node_max), bvh_skip=_t(skip),
        bvh_first=_t(first), bvh_count=_t(count),
        nodes_packed=_t(nodes_packed), tris_packed=_t(tris_packed),
        node_inst=_t(node_inst), tri_inst=_t(tri_inst),
        inst_inv=_t(inst_inv), inst_tf=_t(inst_tf),
        instanced=True,
        wboxes=_t(wide.wboxes), wmeta=_t(wide.wmeta),
        winst=_t(wide.winst), worder=_t(wide.worder),
        wide_leaf=wide.max_leaf, wide_depth=wide.max_depth,
        wtris_packed=_t(wtris_packed),
        wtris_hbm=_f32(1, 128),  # placeholder: never built on the card
        wdelta=_t(wdelta),
        inst_lo=_t(inst_lo), inst_hi=_t(inst_hi),
        inst_bridge=_t(_bridge_metas(wide, n_inst)),
    )

    mat_table = concat_materials(list(materials))
    emissive = _build_emissive_instanced(vertices, tri_v, tri_mat, tri_inst,
                                         transforms, mat_table)
    data = SceneData(
        geometry=geom,
        materials=mat_table,
        lights=lights if lights is not None else empty_lights(),
        envmap=empty_envmap(),
        emissive=emissive,
        textures=empty_textures(),
    )
    return data.to(dev)


def _check_compact_rows(rows: int) -> None:
    """A leaf packs its first row in 24 bits, and hit ids are summed in
    int32 (the reference's float32 ids round above 2^24)."""
    if rows >= 1 << 24:
        raise ValueError(
            f"compact triangle table of {rows} rows: leaves pack their "
            "first row in 24 bits, so it must stay below 2^24 rows")


def _bridge_metas(wide, n_inst: int) -> np.ndarray:
    """Per-instance wide-tree entry: the meta a TLAS pop pushes when a
    ray enters instance i. Every instance sits in exactly one (node,
    slot) of `winst`; shared-BLAS groups repeat the same meta. Read by
    the reference's per-instance rebinned walk (K1 variant d)."""
    out = np.full(n_inst, 0x7FFFFFFF, np.int32)
    wi = np.asarray(wide.winst)
    wm = np.asarray(wide.wmeta)
    sel = wi >= 0
    out[wi[sel]] = wm[sel]
    return out


def _build_tlas(lo: np.ndarray, hi: np.ndarray) -> ThreadedBVH:
    """SAH build over instance boxes using degenerate triangles whose
    AABBs equal the instance boxes (diagonal corner triple)."""
    n = lo.shape[0]
    verts = np.zeros((2 * n, 3), np.float32)
    verts[0::2] = lo
    verts[1::2] = hi
    tris = np.stack([np.arange(n) * 2, np.arange(n) * 2 + 1,
                     np.arange(n) * 2], axis=1).astype(np.int32)
    return build_bvh(verts, tris, max_leaf=1, backend="python")


def _build_emissive_instanced(vertices, tri_v, tri_mat, tri_inst,
                              transforms, mats: Material) -> EmissiveData:
    le = mats.le.numpy()
    lum = le @ np.float32([0.2126, 0.7152, 0.0722])
    tri_lum = lum[np.asarray(tri_mat)]
    if not np.any(tri_lum > 0):
        return EmissiveData(tri_idx=_i32(1), cdf=_f32(1, fill=1.0),
                            area=_f32(1, fill=1.0),
                            total_power=torch.tensor(0.0), count=0)
    # world-space areas: transform the emissive triangles
    tfs = np.stack([np.asarray(t, np.float32) for t in transforms])
    lin = tfs[tri_inst][:, :3, :3]  # (T, 3, 3)
    p0 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 0]])
    p1 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 1]])
    p2 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 2]])
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    power = tri_lum * area
    sel = np.nonzero(power > 0.0)[0]
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
