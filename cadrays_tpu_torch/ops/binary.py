"""Binary threaded-BVH traversal: the CUDA kernel K2 and its plain version.

Counterpart of cadrays_tpu/ops/pallas_traverse.py (``trace_pallas``, the
reference's ``"pallas"`` backend). ``trace_binary`` is the kernel's
wrapper: a CUDA tensor launches ``kernels/binary_trace.cu``; a CPU
tensor runs ``trace_binary_ref``, the same walk written as vectorised
PyTorch. There is no other branch and no fallback.

Both walk each ray on its own over ``nodes_packed`` (N, 8): [min xyz |
max xyz | bitcast(skip) | bitcast(leafbits)]. A node whose widened slab
test passes against the ray's best t descends (an inner node to
``-leafbits - 2``) or, at a leaf (``first | count << 24``, at most 4
triangles), runs Moller-Trumbore on its triangles and moves on to its
skip link; a missed node moves on to its skip link. The walk ends at
node -1. Any-hit rays stop after their first hitting leaf.
``trace_binary_ref`` keeps the kernel's operation order, so on the card
the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from cadrays_tpu_torch.ops.intersect import safe_inv_dir, tri_intersect_packed

MAX_LEAF = 4  # triangles per leaf of the binary tree (geometry/bvh.py)
_LEAF_MASK = (1 << 24) - 1


def _check_geometry(geom) -> None:
    if geom.nodes_packed.ndim != 2 or geom.nodes_packed.shape[1] != 8:
        raise ValueError("trace_binary: nodes_packed must be (N, 8)")
    if geom.tris_packed.ndim != 2 or geom.tris_packed.shape[1] != 12:
        raise ValueError("trace_binary: tris_packed must be (T, 12)")


def trace_binary(geom, origin, direction, t_max, any_hit: bool = False):
    """Closest-hit (or any-hit) query of (R, 3) rays up to t_max (R,).

    Returns dict t, u, v (R,) float32 and tri (R,) int32 (-1 = miss).
    With any_hit, a ray stops at its first hitting leaf and only
    ``tri >= 0`` is meaningful.
    """
    _check_geometry(geom)
    if geom.instanced:
        # the reference's K2 refuses two-level scenes too
        # (pallas_traverse.py:50-51); ops/traverse.trace sends them to
        # trace_wide
        raise ValueError(
            "trace_binary: K2 does not trace instanced (two-level) "
            "scenes; trace() sends them to trace_wide")
    if origin.device.type == "cpu":
        return trace_binary_ref(geom, origin, direction, t_max,
                                any_hit=any_hit)
    if origin.device.type != "cuda":
        raise RuntimeError(
            f"trace_binary: unsupported device {origin.device}")
    return _launch(geom, origin, direction, t_max, any_hit)


trace_binary.launches = 0


def _launch(geom, origin, direction, t_max, any_hit):
    from cadrays_tpu_torch.kernels.build import load

    dev = origin.device
    R = origin.shape[0]
    if origin.shape != (R, 3) or direction.shape != (R, 3):
        raise ValueError("trace_binary: origin and direction must be (R, 3)")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(R).contiguous()
    args = [origin, direction, t_max, geom.nodes_packed, geom.tris_packed]
    for a in args:
        if (a.device != dev or a.dtype != torch.float32
                or not a.is_contiguous()):
            raise ValueError(
                f"trace_binary: expected a contiguous float32 tensor on "
                f"{dev}, got {a.dtype} on {a.device} "
                f"(contiguous={a.is_contiguous()})")
    if geom.nodes_packed.data_ptr() % 16:
        raise ValueError("trace_binary: nodes_packed must be 16-byte "
                         "aligned (the kernel reads each row as 2 float4)")

    out_t = torch.empty(R, dtype=torch.float32, device=dev)
    out_tri = torch.empty(R, dtype=torch.int32, device=dev)
    out_u = torch.empty(R, dtype=torch.float32, device=dev)
    out_v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}
    fn = load("binary_trace")[0].crt_binary_trace
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = fn(*[ptr(a) for a in args], ctypes.c_int(R),
             ctypes.c_int(1 if any_hit else 0),
             ptr(out_t), ptr(out_tri), ptr(out_u), ptr(out_v),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"trace_binary: kernel launch failed, cudaError {err}")
    trace_binary.launches += 1
    return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}


def trace_binary_ref(geom, origin, direction, t_max, any_hit: bool = False,
                     stats: dict | None = None):
    """Plain PyTorch version of the kernel (same tables, same per-ray
    rules, same operation order): each iteration visits one node for
    every ray whose walk has not ended.

    On an instanced (two-level) scene, which K2 refuses, it is the
    reference's gather walk (traverse.py:233-240): a ray visits each
    node in that node's space, moved there by ``inst_inv[node_inst]``
    (world space where node_inst is -1), and leaves index the fused
    object-space triangle table.

    stats: optional dict; accumulates "box_tests" (nodes visited) and
    "tri_tests" (triangles tested), the work these rays need, for
    bounds on the card.
    """
    _check_geometry(geom)
    dev = origin.device
    R = origin.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    nodes = geom.nodes_packed
    nodei = nodes[:, 6:8].contiguous().view(torch.int32)  # skip, leafbits
    tris = geom.tris_packed
    inv = safe_inv_dir(direction)

    t = torch.clamp(tm, max=1e30).clone()
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    # t_max <= 0 marks a dead lane: it reports a miss
    node = torch.where(tm > 0.0, 0, -1).to(torch.int64)
    act = torch.nonzero(node >= 0).squeeze(1)
    n_box = n_tri = 0

    while act.numel():
        n = node[act]
        row = nodes[n]
        o, ia = origin[act], inv[act]
        d = direction[act]
        if geom.instanced:
            ins = geom.node_inst[n]
            world = (ins < 0)[:, None]
            m = geom.inst_inv[ins.clamp(min=0).long()]  # (n, 3, 4)
            o = torch.where(world, o, (m[..., :3] * o[:, None, :]).sum(-1)
                            + m[..., 3])
            d = torch.where(world, d, (m[..., :3] * d[:, None, :]).sum(-1))
            ia = safe_inv_dir(d)
        t0 = (row[:, 0:3] - o) * ia
        t1 = (row[:, 3:6] - o) * ia
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        t_far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        hit = (torch.clamp(t_near * 0.9999996, min=0.0)
               <= torch.minimum(t_far * 1.0000004, t[act]))
        skip = nodei[n, 0].long()
        leafbits = nodei[n, 1].long()
        is_leaf = leafbits >= 0
        nxt = torch.where(hit & ~is_leaf, -leafbits - 2, skip)
        if stats is not None:
            n_box += int(act.numel())

        at_leaf = hit & is_leaf
        la = act[at_leaf]
        if la.numel():
            first = leafbits[at_leaf] & _LEAF_MASK
            count = leafbits[at_leaf] >> 24
            if stats is not None:
                n_tri += int(count.clamp(max=MAX_LEAF).sum())
            lo_, ld_ = o[at_leaf], d[at_leaf]
            for k in range(MAX_LEAF):
                live = k < count
                tid = torch.where(live, first + k, 0)
                tt, uu, vv, ok = tri_intersect_packed(lo_, ld_, tris[tid])
                # strict <: the lower k wins a tie, as in the kernel
                better = live & ok & (tt < t[la])
                lb = la[better]
                t[lb] = tt[better]
                tri[lb] = tid[better].to(torch.int32)
                u[lb] = uu[better]
                v[lb] = vv[better]
            if any_hit:
                leaf_nxt = nxt[at_leaf]
                nxt[at_leaf] = torch.where(tri[la] >= 0, -1, leaf_nxt)
        node[act] = nxt
        act = act[nxt >= 0]

    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + n_box
        stats["tri_tests"] = stats.get("tri_tests", 0) + n_tri
    return {"t": t, "tri": tri, "u": u, "v": v}
