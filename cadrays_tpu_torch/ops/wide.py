"""BVH8 wide-tree traversal: the CUDA kernel K1, its plain version, and
the instance-rebinned driver that seeds it.

Counterpart of cadrays_tpu/ops/pallas_wide.py. ``trace_wide`` is the
kernel's wrapper: a CUDA tensor launches ``kernels/wide_trace.cu``; a
CPU tensor runs ``trace_wide_ref``, the same walk written as vectorised
PyTorch. There is no other branch and no fallback: a scene whose wide
tree is missing or too deep for the kernel's stack raises
``ValueError``. The kernel's variants:

- (a) non-instanced and (b) instanced (two-level TLAS/BLAS), tables
  resident in device memory;
- (c) the reference's ``hbm_tris``, for triangle tables above its VMEM:
  on the card that is (a) or (b) over a table of any row count, since
  the kernel reads device memory through L1 and L2 (no padded (T, 128)
  copy is built, and ``trace_wide`` takes no ``hbm_tris`` argument);
- (d) seeded stacks: an int32 ``start`` table of (nb, 4) rows
  ``[meta0, inst0, meta1, inst1]`` and a ``block`` size B; ray r starts
  from row r // B instead of the root, as
  cadrays_tpu/ops/pallas_wide.py:221-241 seeds a block.

Both versions walk each ray on its own: pop an entry; a wide node
slab-tests its 8 children and pushes the hit ones far-to-near by the
octant of the ray's world direction, each with its entry distance; a
merged leaf runs Moller-Trumbore on its triangles. On an instanced scene
each entry also carries an instance id (-1 at the root; a child takes
``winst`` where that is >= 0), every pop moves the ray into that
instance's space by the 3x4 row ``inst_inv[inst]`` (an identity row for
-1; the direction is not renormalised, so t stays in world units),
leaves index the compact shared-BLAS table ``wtris_packed``, and a hit
adds ``wdelta[inst]``. The child order uses the world octant in both
variants (the reference takes its block's summed world direction); it
changes only which of two triangles at equal t wins. ``trace_wide_ref``
keeps the kernel's operation order, so on the card the two agree bit
for bit.

``trace_wide_rebinned`` ports the reference's per-ray candidate pass
over the instances' world boxes and its rounds of rebinned walks
(pallas_wide.py:686-804); each round launches K1 (d) through
``trace_wide``.
"""
from __future__ import annotations

import ctypes

import torch

from cadrays_tpu_torch.ops.intersect import safe_inv_dir, tri_intersect_packed

# rays per seed row of a seeded launch. The reference's 2048 took 4x the
# wall and K1 time of 32 in trace_wide_rebinned on the distinct-parts
# bounce rays (163 rounds against 32; NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6)
BLOCK = 32
STACK_CAP = 192
WIDTH = 8
_COUNT_SHIFT = 24
_LEAF_MASK = (1 << _COUNT_SHIFT) - 1
_EMPTY = 0x7FFFFFFF
_INF = 3e30
_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _eff_tris(geom):
    """The kernel's triangle table: the compact shared-BLAS table when
    one was built (instanced scenes), else the fused table."""
    return (geom.wtris_packed if geom.wtris_packed.shape[0] > 1
            else geom.tris_packed)


def _instance_tables(geom):
    """(n_inst + 1, 12) world-to-object rows and (n_inst + 1,) hit-id
    offsets, each with the slot of instance -1 appended last (identity,
    0), as the reference's trace_wide appends them."""
    n_inst = geom.inst_inv.shape[0]
    dev = geom.inst_inv.device
    instinv = torch.cat([
        geom.inst_inv.reshape(n_inst, 12),
        torch.tensor([_IDENTITY], dtype=torch.float32, device=dev)])
    wdelta = (geom.wdelta if geom.wdelta.shape[0] == n_inst
              else torch.zeros(n_inst, dtype=torch.int32, device=dev))
    wdelta = torch.cat([wdelta, torch.zeros(1, dtype=torch.int32,
                                            device=dev)])
    return instinv.contiguous(), wdelta.contiguous()


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
    if not fits_wide(geom):
        raise ValueError(
            "trace_wide: the scene has no BVH8 tree or it is deeper than "
            f"the kernel stack holds (STACK_CAP={STACK_CAP}, "
            f"wide_depth={geom.wide_depth})")


def _check_start(start, block: int, R: int) -> None:
    """Variant (d)'s seed table: (nb, 4) int32 with nb * block >= R."""
    if block < 1:
        raise ValueError(f"trace_wide: block must be >= 1, got {block}")
    if start.dtype != torch.int32 or start.dim() != 2 or \
            start.shape[1] != 4:
        raise ValueError("trace_wide: start must be an (nb, 4) int32 table, "
                         f"got {tuple(start.shape)} {start.dtype}")
    if start.shape[0] * block < R:
        raise ValueError(f"trace_wide: {start.shape[0]} seed rows of block "
                         f"{block} cover fewer than {R} rays")


def trace_wide(geom, origin, direction, t_max, any_hit: bool = False,
               start=None, block: int | None = None):
    """Closest-hit (or any-hit) query of (R, 3) rays up to t_max (R,).

    Returns dict t, u, v (R,) float32 and tri (R,) int32 (-1 = miss).
    With any_hit, a ray stops at its first hitting leaf and only
    ``tri >= 0`` is meaningful. ``start`` (variant d): an (nb, 4) int32
    table of per-block stack seeds, ray r taking row r // block
    (block defaults to BLOCK).
    """
    _check_geometry(geom)
    if origin.device.type == "cpu":
        return trace_wide_ref(geom, origin, direction, t_max,
                              any_hit=any_hit, start=start, block=block)
    if origin.device.type != "cuda":
        raise RuntimeError(f"trace_wide: unsupported device {origin.device}")
    return _launch(geom, origin, direction, t_max, any_hit, start=start,
                   block=block)


trace_wide.launches = 0


def _launch(geom, origin, direction, t_max, any_hit, start=None, block=None):
    from cadrays_tpu_torch.kernels.build import load

    dev = origin.device
    R = origin.shape[0]
    if origin.shape != (R, 3) or direction.shape != (R, 3):
        raise ValueError("trace_wide: origin and direction must be (R, 3)")
    block = BLOCK if block is None else int(block)
    if start is not None:
        _check_start(start, block, R)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(R).contiguous()
    tris = _eff_tris(geom)
    args = [origin, direction, t_max, geom.wboxes, geom.wmeta, geom.worder,
            tris]
    want = [torch.float32] * 4 + [torch.int32, torch.int32, torch.float32]
    n_inst = 0
    if geom.instanced:
        instinv, wdelta = _instance_tables(geom)
        n_inst = instinv.shape[0] - 1
        args += [geom.winst, instinv, wdelta]
        want += [torch.int32, torch.float32, torch.int32]
        if geom.winst.shape != geom.wmeta.shape:
            raise ValueError("trace_wide: winst must have wmeta's shape")
    for a, dt in zip(args, want):
        if a.device != dev or a.dtype != dt or not a.is_contiguous():
            raise ValueError(
                f"trace_wide: expected a contiguous {dt} tensor on {dev}, "
                f"got {a.dtype} on {a.device} "
                f"(contiguous={a.is_contiguous()})")
    if tris.shape[1] != 12 or geom.wboxes.shape[1] != 6 * WIDTH:
        raise ValueError("trace_wide: unexpected table widths")
    if not geom.instanced:
        args += [None] * 3  # variant (a) reads no instance tables
    if start is not None:
        if start.device != dev or not start.is_contiguous():
            raise ValueError(f"trace_wide: start must be contiguous on {dev}")
    args.append(start)

    out_t = torch.empty(R, dtype=torch.float32, device=dev)
    out_tri = torch.empty(R, dtype=torch.int32, device=dev)
    out_u = torch.empty(R, dtype=torch.float32, device=dev)
    out_v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}
    fn = load("wide_trace")[0].crt_wide_trace
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = fn(*[None if a is None else ptr(a) for a in args],
             ctypes.c_int(block), ctypes.c_int(n_inst), ctypes.c_int(R),
             ctypes.c_int(1 if any_hit else 0),
             ctypes.c_int(1 if geom.instanced else 0),
             ptr(out_t), ptr(out_tri), ptr(out_u), ptr(out_v),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"trace_wide: kernel launch failed, cudaError {err}")
    trace_wide.launches += 1
    return {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v}


def trace_wide_ref(geom, origin, direction, t_max, any_hit: bool = False,
                   stats: dict | None = None, start=None,
                   block: int | None = None):
    """Plain PyTorch version of the kernel (same tables, same per-ray
    rules, same operation order): every ray keeps an (R, STACK_CAP)
    stack row (and, on an instanced scene, an instance-id row), and each
    iteration pops one entry per non-empty stack. ``start`` and
    ``block`` seed the stacks as ``trace_wide`` does.

    stats: optional dict; accumulates "pops" (entries past the t cull,
    each of which moves its ray into the entry's space on an instanced
    scene), "box_tests" and "tri_tests" (the work these rays need), and
    "nodes_touched" and "rows_touched" (the distinct wide nodes and
    triangle rows they read), for bounds on the card.
    """
    _check_geometry(geom)
    dev = origin.device
    R = origin.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    wboxes = geom.wboxes.reshape(-1, WIDTH, 6)
    wmeta = geom.wmeta
    worder = geom.worder
    tris = _eff_tris(geom)
    K = int(geom.wide_leaf)
    instanced = geom.instanced

    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    inv_dir = safe_inv_dir(direction)
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
    if instanced:
        instinv, wdelta = _instance_tables(geom)
        n_inst = instinv.shape[0] - 1
        istk = torch.full((R, STACK_CAP + 1), -1, dtype=torch.int32,
                          device=dev)
    sp = (tm > 0.0).long()  # dead lanes (t_max <= 0) start empty
    if start is not None:
        # variant (d): meta1 (when not empty) sits above meta0, so it
        # pops first; an empty meta0 leaves the stack empty
        block = BLOCK if block is None else int(block)
        _check_start(start, block, R)
        seed = start[torch.arange(R, device=dev) // block]  # (R, 4)
        two = seed[:, 2] != _EMPTY
        stack[:, 0] = seed[:, 0]
        stack[:, 1] = torch.where(two, seed[:, 2], 0)
        if instanced:
            istk[:, 0] = seed[:, 1]
            istk[:, 1] = torch.where(two, seed[:, 3], -1)
        sp = torch.where(seed[:, 0] == _EMPTY, 0, 1 + two.long()) * sp
    kk = torch.arange(K, device=dev)
    slots = torch.arange(WIDTH, device=dev)
    n_pops = n_box = n_tri = 0
    if stats is not None:
        rows_seen = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
        nodes_seen = torch.zeros(wmeta.shape[0], dtype=torch.bool, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        e = stack[act, top]
        worth = tstk[act, top] <= t[act]
        act, e, top = act[worth], e[worth], top[worth]
        if stats is not None:
            n_pops += int(act.numel())

        # the popped rays in their entries' spaces
        o, d = origin[act], direction[act]
        if instanced:
            inst = istk[act, top]
            slot = torch.where(inst < 0, n_inst, inst).long()
            m = instinv[slot]  # (n, 12) row-major 3x4
            o = torch.stack([
                m[:, 0] * o[:, 0] + m[:, 1] * o[:, 1] + m[:, 2] * o[:, 2]
                + m[:, 3],
                m[:, 4] * o[:, 0] + m[:, 5] * o[:, 1] + m[:, 6] * o[:, 2]
                + m[:, 7],
                m[:, 8] * o[:, 0] + m[:, 9] * o[:, 1] + m[:, 10] * o[:, 2]
                + m[:, 11]], dim=1)
            d = torch.stack([
                m[:, 0] * d[:, 0] + m[:, 1] * d[:, 1] + m[:, 2] * d[:, 2],
                m[:, 4] * d[:, 0] + m[:, 5] * d[:, 1] + m[:, 6] * d[:, 2],
                m[:, 8] * d[:, 0] + m[:, 9] * d[:, 1] + m[:, 10] * d[:, 2]],
                dim=1)
            inv = safe_inv_dir(d)
        else:
            inv = inv_dir[act]

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
                o[leaf, None], d[leaf, None], tris[tid])  # (n, K)
            hit = hit & live_k
            if stats is not None:
                rows_seen[tid[live_k]] = True
            tt = torch.where(hit, tt, _INF)
            bt = tt.amin(dim=1)
            # lowest k among the minima: the kernel's strict-< scan order
            bk = torch.where(tt == bt[:, None], kk[None, :], K).amin(dim=1)
            bk_c = bk.clamp(max=K - 1)[:, None]
            hit_id = first + bk
            if instanced:
                # compact shared-BLAS id -> fused per-instance id
                hit_id = hit_id + wdelta[slot[leaf]]
            better = bt < t[la]
            lb = la[better]
            t[lb] = bt[better]
            tri[lb] = hit_id[better].to(torch.int32)
            u[lb] = uu.gather(1, bk_c)[:, 0][better]
            v[lb] = vv.gather(1, bk_c)[:, 0][better]
            if any_hit:
                sp[lb] = 0

        node = ~leaf
        na, ne = act[node], e[node]
        if na.numel():
            if stats is not None:
                n_box += WIDTH * int(na.numel())
            w = (-ne - 2).long()
            if stats is not None:
                nodes_seen[w] = True
            b = wboxes[w]  # (n, 8, 6)
            no, ni = o[node], inv[node]
            nox, noy, noz = no[:, 0, None], no[:, 1, None], no[:, 2, None]
            nix, niy, niz = ni[:, 0, None], ni[:, 1, None], ni[:, 2, None]
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
            if instanced:
                # a bridge child switches to its instance; others inherit
                wi = geom.winst[w]
                istk[rows, pos] = torch.where(wi >= 0, wi, inst[node, None])
            sp[na] += push.sum(-1)

    if stats is not None:
        stats["pops"] = stats.get("pops", 0) + n_pops
        stats["box_tests"] = stats.get("box_tests", 0) + n_box
        stats["tri_tests"] = stats.get("tri_tests", 0) + n_tri
        stats["nodes_touched"] = (stats.get("nodes_touched", 0)
                                  + int(nodes_seen.sum()))
        stats["rows_touched"] = (stats.get("rows_touched", 0)
                                 + int(rows_seen.sum()))
    return {"t": t, "tri": tri, "u": u, "v": v}


def trace_wide_rebinned(geom, origin, direction, t_max, any_hit: bool = False,
                        block: int | None = None, max_rounds: int = 0,
                        stats: dict | None = None):
    """Per-ray instance candidates with rebinned BLAS walks
    (cadrays_tpu/ops/pallas_wide.py:686-804); contract of ``trace_wide``.

    1. Candidate pass: every ray slab-tests every instance's world box
       (``inst_lo``, ``inst_hi``), an (R, I) test with no tree.
    2. Rounds: each ray picks its nearest untested candidate whose entry
       distance beats its best t; the rays are sorted by (choice,
       coherence key), and each block of ``block`` sorted rays (default
       BLOCK; the reference's is 2048) is seeded
       with the BLAS entries (``inst_bridge``) of its smallest and
       largest choice, so K1 (d) walks those instances' subtrees
       directly, without the TLAS. Every lane of a block walks both
       seeds (the reference's over-approximation: any hit it reports is
       real); a lane's choice is marked tested only when a seed covered
       it, so the middle lanes of a block that spans three or more
       instances stay pending for the next round.
    3. Repeat while any ray has a candidate pending (at most
       ``max_rounds`` rounds when it is > 0). A round's hit replaces a
       ray's state only at a strictly smaller t.

    The driver is plain PyTorch on the rays' device, with one host sync
    per round (on "any pending"); each round launches ``trace_wide``
    with ``start``, which is K1 (d) on a CUDA tensor and its plain
    version on a CPU one. stats: optional dict; accumulates "rounds".
    """
    from cadrays_tpu_torch.ops.traverse import _coherence_key

    assert geom.instanced and (
        int(geom.inst_bridge.shape[0]) > 1
        or int(geom.inst_bridge[0]) != _EMPTY), \
        "rebinned traversal needs instance candidate tables"
    dev = origin.device
    R = origin.shape[0]
    B = BLOCK if block is None else int(block)
    nb = -(-R // B)
    Rp = nb * B
    I = geom.inst_lo.shape[0]
    tm0 = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32,
                                      device=dev).expand(R), max=1e30)

    # ---- candidate pass: (R, I) slab tests ------------------------------
    inv_d = safe_inv_dir(direction)
    t0 = (geom.inst_lo[None] - origin[:, None]) * inv_d[:, None]
    t1 = (geom.inst_hi[None] - origin[:, None]) * inv_d[:, None]
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    t_near = torch.clamp(t_near, min=0.0)
    cand = t_near <= torch.minimum(t_far, tm0[:, None])  # (R, I)
    t_near = torch.where(cand, t_near, _INF)
    key_coh = _coherence_key(geom, origin, direction)

    t = tm0.clone()
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(R, dtype=torch.float32, device=dev)
    tested = ~cand
    inst_ids = torch.arange(I, device=dev)
    blk = torch.arange(Rp, device=dev) // B
    rounds = 0
    while not max_rounds or rounds < max_rounds:
        live = t > 0.0
        if any_hit:
            live = live & (tri < 0)
        pend = ~tested & (t_near < t[:, None]) & live[:, None]
        if not bool(pend.any()):  # the round's one host sync
            break
        have = pend.any(1)
        choice = torch.where(pend, t_near, _INF).argmin(1)
        # dead rays (no candidate) sink to the tail blocks with t_max 0
        key = torch.where(have, choice, I) * (1 << 15) + (key_coh & 0x7FFF)
        perm = torch.argsort(key, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(R, device=dev)
        tm_s = torch.where(have[perm], t[perm], 0.0)
        c_s = torch.full((Rp,), -1, dtype=torch.long, device=dev)
        c_s[:R] = torch.where(have, choice, -1)[perm]
        cb = c_s.reshape(nb, B)
        # per-block seeds: the largest and smallest live choice
        i0 = cb.amax(1)
        i1 = torch.where(cb >= 0, cb, I + 1).amin(1)
        m0 = torch.where(i0 >= 0, geom.inst_bridge[i0.clamp(min=0)], _EMPTY)
        m1 = torch.where((i1 <= I) & (i1 != i0),
                         geom.inst_bridge[i1.clamp(0, I - 1)], _EMPTY)
        start = torch.stack([m0, i0.clamp(min=0), m1, i1.clamp(0, I - 1)],
                            1).to(torch.int32).contiguous()
        res = trace_wide(geom, origin[perm].contiguous(),
                         direction[perm].contiguous(), tm_s.contiguous(),
                         any_hit=any_hit, start=start, block=B)
        rt, rtri = res["t"][inv], res["tri"][inv]
        better = (rtri >= 0) & (rt < t)
        t = torch.where(better, rt, t)
        tri = torch.where(better, rtri, tri)
        u = torch.where(better, res["u"][inv], u)
        v = torch.where(better, res["v"][inv], v)
        # seed-gated tested mark, back in the caller's ray order
        covered = ((c_s == i0[blk]) | (c_s == i1[blk]))[:R][inv]
        tested = tested | ((have & covered)[:, None]
                           & (inst_ids[None] == choice[:, None]))
        rounds += 1
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
    return {"t": t, "tri": tri, "u": u, "v": v}
