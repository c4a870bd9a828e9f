"""BVH8 wide-tree traversal: the CUDA kernel K1 and its plain version.

Counterpart of cadrays_tpu/ops/pallas_wide.py (variant a: non-instanced,
tables resident). ``trace_wide`` is the kernel's wrapper: a CUDA tensor
launches ``kernels/wide_trace.cu``; a CPU tensor runs
``trace_wide_ref``, the same walk written as vectorised PyTorch. There
is no other branch and no fallback: a scene whose wide tree is missing
or too deep for the kernel's stack raises ``ValueError``.

Both walk each ray on its own: pop an entry; a wide node slab-tests its
8 children and pushes the hit ones far-to-near by the ray's direction
octant, each with its entry distance; a merged leaf runs Moller-Trumbore
on its triangles. ``trace_wide_ref`` keeps the kernel's operation order,
so on the card the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from cadrays_tpu_torch.ops.intersect import safe_inv_dir, tri_intersect_packed

STACK_CAP = 192
WIDTH = 8
_COUNT_SHIFT = 24
_LEAF_MASK = (1 << _COUNT_SHIFT) - 1
_EMPTY = 0x7FFFFFFF
_INF = 3e30


def _stack_fits(geom) -> bool:
    """Worst-case stack bound: each wide-node pop nets +(width-1)
    entries, so a depth-D tree needs at most 1 + (width-1)*D slots."""
    width = geom.wmeta.shape[1]
    return 1 + (width - 1) * max(int(geom.wide_depth), 1) <= STACK_CAP


def fits_wide(geom) -> bool:
    """True when a BVH8 tree was built and the kernel's stack holds it."""
    if geom.wmeta.shape[0] <= 1 and geom.wmeta.shape[1] == 1:
        return False  # placeholder: no wide tree built
    if geom.wmeta.shape[1] != WIDTH or geom.worder.shape != (
            geom.wmeta.shape[0], 8):
        return False
    return _stack_fits(geom)


def _check_geometry(geom) -> None:
    if geom.instanced:
        raise NotImplementedError(
            "instanced wide traversal (K1 variant b) is not ported yet: "
            "ROADMAP queue B, item 13")
    if not fits_wide(geom):
        raise ValueError(
            "trace_wide: the scene has no BVH8 tree or it is deeper than "
            f"the kernel stack holds (STACK_CAP={STACK_CAP}, "
            f"wide_depth={geom.wide_depth})")


def trace_wide(geom, origin, direction, t_max, any_hit: bool = False):
    """Closest-hit (or any-hit) query of (R, 3) rays up to t_max (R,).

    Returns dict t, u, v (R,) float32 and tri (R,) int32 (-1 = miss).
    With any_hit, a ray stops at its first hitting leaf and only
    ``tri >= 0`` is meaningful.
    """
    _check_geometry(geom)
    if origin.device.type == "cpu":
        return trace_wide_ref(geom, origin, direction, t_max,
                              any_hit=any_hit)
    if origin.device.type != "cuda":
        raise RuntimeError(f"trace_wide: unsupported device {origin.device}")
    return _launch(geom, origin, direction, t_max, any_hit)


trace_wide.launches = 0


def _launch(geom, origin, direction, t_max, any_hit):
    from cadrays_tpu_torch.kernels.build import load

    dev = origin.device
    R = origin.shape[0]
    if origin.shape != (R, 3) or direction.shape != (R, 3):
        raise ValueError("trace_wide: origin and direction must be (R, 3)")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(R).contiguous()
    tris = geom.tris_packed
    args = [origin, direction, t_max, geom.wboxes, geom.wmeta, geom.worder,
            tris]
    want = [torch.float32] * 4 + [torch.int32, torch.int32, torch.float32]
    for a, dt in zip(args, want):
        if a.device != dev or a.dtype != dt or not a.is_contiguous():
            raise ValueError(
                f"trace_wide: expected a contiguous {dt} tensor on {dev}, "
                f"got {a.dtype} on {a.device} "
                f"(contiguous={a.is_contiguous()})")
    if tris.shape[1] != 12 or geom.wboxes.shape[1] != 6 * WIDTH:
        raise ValueError("trace_wide: unexpected table widths")

    out_t = torch.empty(R, dtype=torch.float32, device=dev)
    out_tri = torch.empty(R, dtype=torch.int32, device=dev)
    out_u = torch.empty(R, dtype=torch.float32, device=dev)
    out_v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}
    fn = load("wide_trace")[0].crt_wide_trace
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = fn(*[ptr(a) for a in args], ctypes.c_int(R),
             ctypes.c_int(1 if any_hit else 0),
             ptr(out_t), ptr(out_tri), ptr(out_u), ptr(out_v),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"trace_wide: kernel launch failed, cudaError {err}")
    trace_wide.launches += 1
    return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}


def trace_wide_ref(geom, origin, direction, t_max, any_hit: bool = False,
                   stats: dict | None = None):
    """Plain PyTorch version of the kernel (same tables, same per-ray
    rules, same operation order): every ray keeps an (R, STACK_CAP)
    stack row, and each iteration pops one entry per non-empty stack.

    stats: optional dict; accumulates "pops", "box_tests" and
    "tri_tests" (the work these rays need), for bounds on the card.
    """
    _check_geometry(geom)
    dev = origin.device
    R = origin.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    wboxes = geom.wboxes.reshape(-1, WIDTH, 6)
    wmeta = geom.wmeta
    worder = geom.worder
    tris = geom.tris_packed
    K = int(geom.wide_leaf)

    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    ix, iy, iz = safe_inv_dir(direction).unbind(1)
    octant = ((dx >= 0).long() | ((dy >= 0).long() << 1)
              | ((dz >= 0).long() << 2))

    t = torch.clamp(tm, max=1e30).clone()
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)

    # column STACK_CAP is a write-only sink for children that are not pushed
    stack = torch.zeros((R, STACK_CAP + 1), dtype=torch.int32, device=dev)
    tstk = torch.zeros((R, STACK_CAP + 1), dtype=torch.float32, device=dev)
    stack[:, 0] = -2
    sp = (tm > 0.0).long()  # dead lanes (t_max <= 0) start empty
    kk = torch.arange(K, device=dev)
    slots = torch.arange(WIDTH, device=dev)
    n_pops = n_box = n_tri = 0

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        e = stack[act, top]
        worth = tstk[act, top] <= t[act]
        act, e = act[worth], e[worth]
        if stats is not None:
            n_pops += int(act.numel())

        leaf = e >= 0
        la, le = act[leaf], e[leaf]
        if la.numel():
            first = (le & _LEAF_MASK).long()
            count = (le >> _COUNT_SHIFT).long()
            if stats is not None:
                n_tri += int(count.sum())
            live_k = kk[None, :] < count[:, None]
            tid = torch.where(live_k, first[:, None] + kk[None, :], 0)
            tt, uu, vv, hit = tri_intersect_packed(
                origin[la, None], direction[la, None], tris[tid])  # (n, K)
            hit = hit & live_k
            tt = torch.where(hit, tt, _INF)
            bt = tt.amin(dim=1)
            # lowest k among the minima: the kernel's strict-< scan order
            bk = torch.where(tt == bt[:, None], kk[None, :], K).amin(dim=1)
            bk_c = bk.clamp(max=K - 1)[:, None]
            better = bt < t[la]
            lb = la[better]
            t[lb] = bt[better]
            tri[lb] = (first + bk)[better].to(torch.int32)
            u[lb] = uu.gather(1, bk_c)[:, 0][better]
            v[lb] = vv.gather(1, bk_c)[:, 0][better]
            if any_hit:
                sp[lb] = 0

        na, ne = act[~leaf], e[~leaf]
        if na.numel():
            if stats is not None:
                n_box += WIDTH * int(na.numel())
            w = (-ne - 2).long()
            b = wboxes[w]  # (n, 8, 6)
            nox, noy, noz = ox[na, None], oy[na, None], oz[na, None]
            nix, niy, niz = ix[na, None], iy[na, None], iz[na, None]
            tx0 = (b[..., 0] - nox) * nix
            ty0 = (b[..., 1] - noy) * niy
            tz0 = (b[..., 2] - noz) * niz
            tx1 = (b[..., 3] - nox) * nix
            ty1 = (b[..., 4] - noy) * niy
            tz1 = (b[..., 5] - noz) * niz
            t_near = torch.maximum(
                torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                torch.minimum(tz0, tz1))
            t_far = torch.minimum(
                torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                torch.maximum(tz0, tz1))
            t_near = torch.clamp(t_near * 0.9999996, min=0.0)
            t_far = t_far * 1.0000004
            meta = wmeta[w]  # (n, 8)
            push = ((t_near <= torch.minimum(t_far, t[na, None]))
                    & (meta != _EMPTY))
            rword = worder[w, octant[na]].long()
            rank = (rword[:, None] >> (4 * slots[None, :])) & 0xF
            # stack slot of child k: sp + #pushed children ranked farther
            farther = rank[:, None, :] < rank[:, :, None]  # [n, k, k2]
            pos = sp[na, None] + (push[:, None, :] & farther).sum(-1)
            pos = torch.where(push, pos, STACK_CAP)
            rows = na[:, None].expand(-1, WIDTH)
            stack[rows, pos] = meta
            tstk[rows, pos] = t_near
            sp[na] += push.sum(-1)

    if stats is not None:
        stats["pops"] = stats.get("pops", 0) + n_pops
        stats["box_tests"] = stats.get("box_tests", 0) + n_box
        stats["tri_tests"] = stats.get("tri_tests", 0) + n_tri
    return {"t": t, "tri": tri, "u": u, "v": v}
