"""Ray helpers shared by traversal and shading."""
from __future__ import annotations

import torch

from cadrays_tpu_torch.core import vecmath as vm

INF = 1e30
EPS = 1e-7


def safe_inv_dir(direction):
    """1/d with huge-but-finite values (+-1e12) for near-zero components,
    rounded as kernels/wide_trace.cu rounds it."""
    tiny = torch.where(direction >= 0, 1e-12, -1e-12)
    return torch.reciprocal(
        torch.where(torch.abs(direction) < 1e-12, tiny, direction))


def tri_intersect_packed(origin, direction, trow):
    """Moller-Trumbore of each (n, 3) ray against its own packed triangle
    row [p0 | e1 | e2 | ...] (n, 12).

    Written out by component, sums left to right, with an IEEE
    reciprocal of det, as kernels/wide_trace.cu and binary_trace.cu
    compute it. Leading dimensions broadcast. Returns t, u, v and the
    hit mask (|det| > 1e-12, eps 1e-7 on u, v, u + v and t).
    """
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    r0, r1, r2, r3, r4, r5, r6, r7, r8 = trow[..., :9].unbind(-1)
    pvx = dy * r8 - dz * r7
    pvy = dz * r6 - dx * r8
    pvz = dx * r7 - dy * r6
    det = (r3 * pvx + r4 * pvy) + r5 * pvz
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, torch.reciprocal(det), 0.0)
    tvx = ox - r0
    tvy = oy - r1
    tvz = oz - r2
    u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
    qvx = tvy * r5 - tvz * r4
    qvy = tvz * r3 - tvx * r5
    qvz = tvx * r4 - tvy * r3
    v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det
    t = ((r6 * qvx + r7 * qvy) + r8 * qvz) * inv_det
    hit = (det_ok & (u >= -EPS) & (v >= -EPS) & (u + v <= 1.0 + EPS)
           & (t > EPS))
    return t, u, v, hit


def offset_ray_origin(p, n_geom, direction):
    """Offset a secondary-ray origin off the surface to dodge self-hits."""
    side = torch.where(vm.dot(n_geom, direction, keepdims=True) >= 0.0,
                       1.0, -1.0)
    return p + n_geom * side * 1e-4
