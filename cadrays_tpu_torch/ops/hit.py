"""Hit attributes recomputed from the traversal's triangle ids.

The wavefront builds one per-triangle shading table (geometry + full
material row) per sample; shading then needs one row gather per bounce.
Forward only: ``gather_rows``'s segment-sum backward comes with the
training slice.

On a two-level instanced scene the triangle data is in object space:
the table carries each triangle's instance id as its last column, the
ray moves into the instance's space by ``inst_inv`` (t is shared
between the two spaces, since the direction is not renormalised), and
normals come back to world space by the inverse transpose.
"""
from __future__ import annotations

import torch

from cadrays_tpu_torch.core import vecmath as vm
from cadrays_tpu_torch.core.bsdf import Material


def build_shade_table(geom, materials: Material):
    """(T, C) per-triangle shading rows: p0 e1 e2 | n0 n1 n2 | uv0 uv1 uv2
    | material row | [instance id]."""
    tv = geom.tri_v.long()
    p0 = geom.vertices[tv[:, 0]]
    p1 = geom.vertices[tv[:, 1]]
    p2 = geom.vertices[tv[:, 2]]
    n0 = geom.normals[tv[:, 0]]
    n1 = geom.normals[tv[:, 1]]
    n2 = geom.normals[tv[:, 2]]
    uv0 = geom.uvs[tv[:, 0]]
    uv1 = geom.uvs[tv[:, 1]]
    uv2 = geom.uvs[tv[:, 2]]
    m = materials.gather(geom.tri_mat.long())
    f = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    cols = [
        p0, p1 - p0, p2 - p0, n0, n1, n2, uv0, uv1, uv2,
        m.kc, m.kd, m.ks, m.kt, m.le,
        m.base_rough[:, None], m.coat_rough[:, None],
        m.absorp_color, m.absorp_coeff[:, None],
        f(m.base_ftype), m.base_fparams,
        f(m.coat_ftype), m.coat_fparams,
        f(m.tex_id), f(m.ks_tex_id), m.uv_scale[:, None],
    ]
    if geom.instanced:
        cols.append(f(geom.tri_inst))
    return torch.cat(cols, dim=1)


def gather_rows(table, tid):
    """`table[tid]`: one row gather per ray (forward only)."""
    return table.index_select(0, tid.long())


_MAT0 = 24  # material block offset in the packed row


def _unpack_material(rows) -> Material:
    b = _MAT0

    def seg(k):
        nonlocal b
        out = rows[:, b:b + k]
        b += k
        return out

    i32 = lambda x: x[:, 0].to(torch.int32)  # noqa: E731
    return Material(
        kc=seg(3), kd=seg(3), ks=seg(3), kt=seg(3), le=seg(3),
        base_rough=seg(1)[:, 0], coat_rough=seg(1)[:, 0],
        absorp_color=seg(3), absorp_coeff=seg(1)[:, 0],
        base_ftype=i32(seg(1)), base_fparams=seg(4),
        coat_ftype=i32(seg(1)), coat_fparams=seg(4),
        tex_id=i32(seg(1)), ks_tex_id=i32(seg(1)), uv_scale=seg(1)[:, 0],
    )


def hit_attributes_packed(geom, table, origin, direction, tri):
    """Shading data for rays whose traversal chose triangle `tri` (-1 =
    miss; lanes still computed, mask with `hit`), plus the gathered
    per-ray Material — all from one row gather of `table`."""
    hit = tri >= 0
    tid = torch.clamp(tri, min=0)
    rows = gather_rows(table, tid)
    p0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    n0 = rows[:, 9:12]
    n1 = rows[:, 12:15]
    n2 = rows[:, 15:18]
    uv0 = rows[:, 18:20]
    uv1 = rows[:, 20:22]
    uv2 = rows[:, 22:24]
    mat = _unpack_material(rows)

    if geom.instanced:
        inv = geom.inst_inv[rows[:, -1].long()]  # (R, 3, 4)
        lin = inv[..., :3]
        o_l = (lin * origin[:, None, :]).sum(-1) + inv[..., 3]
        d_l = (lin * direction[:, None, :]).sum(-1)
    else:
        o_l, d_l = origin, direction
    pvec = vm.cross(d_l, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tvec = o_l - p0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d_l, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    w = torch.clamp(1.0 - u - v, 0.0, 1.0)

    position = origin + direction * t[..., None]

    n_geom_l = vm.cross(e1, e2)
    n_shade_l = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2
    if geom.instanced:
        # n_world = n_obj @ M^-1 (row-vector inverse transpose)
        n_geom = vm.normalize((n_geom_l[:, :, None] * lin).sum(1))
        n_shade = vm.normalize((n_shade_l[:, :, None] * lin).sum(1))
    else:
        n_geom = vm.normalize(n_geom_l)
        n_shade = vm.normalize(n_shade_l)
    n_shade = torch.where(vm.dot(n_shade, n_geom, keepdims=True) < 0.0,
                          -n_shade, n_shade)
    uv = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2

    front = vm.dot(direction, n_geom) < 0.0
    flip = torch.where(front, 1.0, -1.0)[..., None]
    return {
        "hit": hit,
        "t": t,
        "position": position,
        "n_geom": n_geom * flip,
        "n_shade": n_shade * flip,
        "uv": uv,
        "front": front,
    }, mat
