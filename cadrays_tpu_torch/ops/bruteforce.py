"""Brute-force ray-triangle intersection: the CUDA kernel K3 and its
plain version.

Counterpart of cadrays_tpu/ops/mxu_intersect.py (``trace_bruteforce``,
the reference's ``"bruteforce"`` backend). Every ray is tested against
every triangle, with no tree. ``trace_bruteforce`` is the kernel's
wrapper: a CUDA tensor launches ``kernels/bruteforce.cu``; a CPU tensor
runs ``trace_bruteforce_ref``. There is no other branch and no fallback.

Moller-Trumbore is four triple products per (ray, triangle) pair, each
linear in the ray's features X = [o, d, m = o x d, 1]. With the
per-triangle constants n = e1 x e2, k = p0 . n, c2 = e2 x p0 and
c3 = p0 x e1 (``tri_tables``):

    det   = -d . n            t.det = o . n - k
    u.det = -d . c2 + m . e2  v.det = -d . c3 - m . e1

The reference takes these as one matmul X @ W on the TPU's matrix unit.
Here both versions sum only the nonzero terms of each product, in
feature order, in fp32 on CUDA cores (no TF32, no BLAS). Then the
sign-folded hit test, t = c * (1 / |det|) and a strict-< running
argmin in triangle order: among equal t the smallest index wins.
Any-hit runs the same reduction. t, u and v are then recomputed
exactly on the winning triangle, outside the kernel, as the reference
does.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from cadrays_tpu_torch.ops.intersect import EPS, INF, tri_intersect_packed

TRI_TILE = 512  # triangles per tile (the table is padded to a multiple)
MAX_TRIS = 24576
_RAY_CHUNK_ELEMS = 1 << 24  # rays x triangles per step of the plain version

_tables = WeakIdKeyDictionary()  # tris_packed -> (version, table)


def fits_bruteforce(geom) -> bool:
    return (not geom.instanced) and geom.tris_packed.shape[0] <= MAX_TRIS


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def tri_tables(geom):
    """(Tpad, 16) f32 per-triangle constants [n | k | c2 | c3 | e1 | e2],
    Tpad the triangle count rounded up to TRI_TILE. Padding rows are
    zero, so det = 0 and they never hit. Built once per tris_packed
    tensor (and again if it is changed in place)."""
    tp = geom.tris_packed
    cached = _tables.get(tp)
    if cached is not None and cached[0] == tp._version:
        return cached[1]
    p0, e1, e2 = tp[:, 0:3], tp[:, 3:6], tp[:, 6:9]
    n = _cross(e1, e2)
    k = (p0[:, 0] * n[:, 0] + p0[:, 1] * n[:, 1]) + p0[:, 2] * n[:, 2]
    c2 = _cross(e2, p0)
    c3 = _cross(p0, e1)
    T = tp.shape[0]
    t_pad = -(-T // TRI_TILE) * TRI_TILE
    table = torch.zeros((t_pad, 16), dtype=torch.float32, device=tp.device)
    table[:T] = torch.cat([n, k[:, None], c2, c3, e1, e2], dim=1)
    _tables[tp] = (tp._version, table)
    return table


def _check_geometry(geom) -> None:
    if geom.instanced:
        # object-space triangles: only the walkers that transform rays
        # per instance can trace them (ops/traverse.trace sends such
        # scenes to K1 variant b, as the reference does)
        raise ValueError(
            "trace_bruteforce: K3 does not trace instanced (two-level) "
            "scenes; trace() sends them to trace_wide")
    if not fits_bruteforce(geom):
        raise ValueError(
            f"trace_bruteforce: {geom.tris_packed.shape[0]} triangle rows, "
            f"more than MAX_TRIS={MAX_TRIS}")


def trace_bruteforce(geom, origin, direction, t_max, any_hit: bool = False):
    """Closest-hit query of (R, 3) rays up to t_max (R,) against every
    triangle. Returns dict t, u, v (R,) float32 and tri (R,) int32
    (-1 = miss). any_hit runs the same reduction (callers read only
    ``tri >= 0``)."""
    _check_geometry(geom)
    if origin.device.type == "cpu":
        return trace_bruteforce_ref(geom, origin, direction, t_max,
                                    any_hit=any_hit)
    if origin.device.type != "cuda":
        raise RuntimeError(
            f"trace_bruteforce: unsupported device {origin.device}")
    return _launch(geom, origin, direction, t_max, any_hit)


trace_bruteforce.launches = 0


def _launch(geom, origin, direction, t_max, any_hit):
    from cadrays_tpu_torch.kernels.build import load

    dev = origin.device
    R = origin.shape[0]
    if origin.shape != (R, 3) or direction.shape != (R, 3):
        raise ValueError(
            "trace_bruteforce: origin and direction must be (R, 3)")
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    tm = tm.expand(R).contiguous()
    table = tri_tables(geom)
    args = [origin, direction, tm, table]
    for a in args:
        if (a.device != dev or a.dtype != torch.float32
                or not a.is_contiguous()):
            raise ValueError(
                f"trace_bruteforce: expected a contiguous float32 tensor on "
                f"{dev}, got {a.dtype} on {a.device} "
                f"(contiguous={a.is_contiguous()})")
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        fn = load("bruteforce")[0].crt_bruteforce
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
        err = fn(*[ptr(a) for a in args], ctypes.c_int(table.shape[0]),
                 ctypes.c_int(R), ptr(tri), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"trace_bruteforce: kernel launch failed, cudaError {err}")
        trace_bruteforce.launches += 1
    return _exact_hits(geom, origin, direction, tm, tri)


def _exact_hits(geom, origin, direction, tm, tri):
    """t, u, v recomputed by Moller-Trumbore on each ray's winning
    triangle; a miss keeps t = min(t_max, 1e30) and u = v = 0."""
    trow = geom.tris_packed[tri.clamp(min=0).long()]
    t, u, v, _ = tri_intersect_packed(origin, direction, trow)
    miss = tri < 0
    return {"t": torch.where(miss, torch.clamp(tm, max=INF), t), "tri": tri,
            "u": torch.where(miss, 0.0, u), "v": torch.where(miss, 0.0, v)}


def trace_bruteforce_ref(geom, origin, direction, t_max,
                         any_hit: bool = False):
    """Plain PyTorch version of the kernel: the same terms summed in the
    same order, elementwise over (ray chunk, triangle tile) blocks, and
    the same argmin (smallest index among equal t)."""
    _check_geometry(geom)
    dev = origin.device
    R = origin.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    table = tri_tables(geom)
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    chunk = max(_RAY_CHUNK_ELEMS // TRI_TILE, 1)
    for r0 in range(0, R, chunk):
        sl = slice(r0, min(r0 + chunk, R))
        tri[sl] = _closest_ref(table, origin[sl], direction[sl], tm[sl])
    return _exact_hits(geom, origin, direction, tm, tri)


def _closest_ref(table, origin, direction, tm):
    ox, oy, oz = (c[:, None] for c in origin.unbind(1))
    dx, dy, dz = (c[:, None] for c in direction.unbind(1))
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    cap = torch.clamp(tm, max=INF)
    tmc = tm[:, None]
    best_t = cap.clone()
    best_i = torch.full_like(tm, -1, dtype=torch.int64)
    ids = torch.arange(TRI_TILE, device=tm.device)
    for j in range(0, table.shape[0], TRI_TILE):
        (nx, ny, nz, k, c2x, c2y, c2z, c3x, c3y, c3z,
         e1x, e1y, e1z, e2x, e2y, e2z) = table[j:j + TRI_TILE].T[:, None, :]
        det = (-(dx * nx) - dy * ny) - dz * nz
        tdet = ((ox * nx + oy * ny) + oz * nz) - k
        udet = (((((-(dx * c2x) - dy * c2y) - dz * c2z) + mx * e2x)
                 + my * e2y) + mz * e2z)
        vdet = (((((-(dx * c3x) - dy * c3y) - dz * c3z) - mx * e1x)
                 - my * e1y) - mz * e1z)
        s = torch.where(det >= 0.0, 1.0, -1.0)
        dabs = torch.abs(det)
        a = udet * s
        b = vdet * s
        c = tdet * s
        tol = EPS * dabs
        hit = ((dabs > 1e-12) & (a >= -tol) & (b >= -tol)
               & (a + b <= dabs * (1.0 + EPS)) & (c > EPS * dabs)
               & (c < tmc * dabs))
        tval = torch.where(
            hit, c * torch.reciprocal(torch.clamp(dabs, min=1e-30)), INF)
        tile_t = tval.amin(dim=1)
        tile_arg = torch.where(tval <= tile_t[:, None], ids, TRI_TILE)
        tile_arg = tile_arg.amin(dim=1)
        better = tile_t < best_t
        best_t = torch.where(better, tile_t, best_t)
        best_i = torch.where(better, tile_arg + j, best_i)
    return torch.where(best_t < cap, best_i, -1).to(torch.int32)
