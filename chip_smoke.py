"""Chip smoke test of the PyTorch / CUDA port (cadrays_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
It builds the three hand-written kernels from this checkout in parallel
(K1 wide_trace, in its variants (a), (b) instanced, (c) over a CAD-scale
table and (d) seeded, K2 binary_trace, K3 bruteforce), holds each
against its plain PyTorch version on the card, and drives the port's
main paths:
- the persistent-wavefront forward render of the full Cornell box
  (262,144 lanes, spp 32, depth 5, 96 steps, then a full 1024x1024
  frame through Renderer.render) once under each traversal backend that
  selects a kernel: "wide" (K1 (a), the default), "pallas" (K2) and
  "bruteforce" (K3). Each backend's render must launch its own kernel
  192 times; the K2 render must match the "wide" render, and K3's hits
  must match K1's up to ties and to lanes within rounding of a
  triangle's edge or the ray's end (K3 rounds otherwise than K1, as the
  reference's brute-force walk does against its BVH walks);
- the instanced CAD assembly of the reference's bench/cad_scale.py (100
  instances of one torus, 518,400 triangles) rendered at 1024x1024 in
  four chunks of 262,144 lanes, depth 5, spp 8, 26 steps, lit (208
  launches of K1 (b)) and unlit as the reference renders it (104);
- the assembly of distinct parts of the reference's
  bench/cad_distinct.py (54 unique parts, 611,136 triangles, a compact
  table of 611,264 rows: the reference's streamed-triangle variant (c))
  rendered the same way (208 launches of K1 (c)), with 8 profiled
  steps; and trace_wide_rebinned on its bounce rays at blocks 2048 and
  32, each round a launch of K1 (d), held to trace's hits up to ties.
Each kernel is held against its plain version again on every launch of
a short render on the rays the main path hands it; the card's render
is checked against the CPU's; the instanced full Cornell box is held
against the baked one; and each kernel is timed against its bound on a
main path's sorted first-bounce rays. Each phase prints one JSON line;
then the card's name and power limit, the kernels line, and last the
result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM published peaks (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# operations of one box slab test (a K1 child box or a K2 node) and one
# Moller-Trumbore test as written in kernels/wide_trace.cu and
# kernels/binary_trace.cu (adds, multiplies, min/max, compares), and of
# one ray-triangle test of kernels/bruteforce.cu (33 for the four
# products, 16 for the sign-folded test, 1 for the argmin compare)
OPS_PER_BOX_TEST = 27
OPS_PER_TRI_TEST = 53
OPS_PER_BRUTE_TEST = 50


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Median of `reps` CUDA-event timings of fn() after 3 warm-ups."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def mt64(g, o, d, tri):
    """Float64 Moller-Trumbore of each ray against its triangle (in the
    triangle's instance's space on an instanced scene): the signed
    distance to the triangle's nearest edge (min of u, v and
    1 - u - v), t, and the cosine of incidence, which scales how far
    fp32 rounding can move a ray across an edge or along itself."""
    import torch

    rows = g.tris_packed[tri.long()].double()
    o, d = o.double(), d.double()
    if g.instanced:  # into the triangle's instance's space
        m = g.inst_inv[g.tri_inst[tri.long()].long()].double()
        o = (m[:, :, :3] @ o[:, :, None])[..., 0] + m[:, :, 3]
        d = (m[:, :, :3] @ d[:, :, None])[..., 0]
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pv = torch.linalg.cross(d, e2)
    det = (e1 * pv).sum(-1)
    tv = o - p0
    qv = torch.linalg.cross(tv, e1)
    u = (tv * pv).sum(-1) / det
    v = (d * qv).sum(-1) / det
    t = (e2 * qv).sum(-1) / det
    n = torch.linalg.cross(e1, e2)
    cos = (d * n).sum(-1).abs() / (n.norm(dim=-1) * d.norm(dim=-1))
    return torch.stack([u, v, 1 - u - v]).amin(0), t, cos


# a lane within this much of a decision boundary, in mt64's scaled
# units (about 8 fp32 ulp at the box's unit scale), may go either way
ROUNDING = 2.0 ** -20


def k3_vs_k1(g, o, d, tm, any_hit, got, t_rtol=1e-4, t_atol=1e-8,
             tie_rtol=1e-6):
    """K3's hits against K1's plain version on the same rays, under
    the reference's contract between its bruteforce and gather walks
    (tests/test_geometry.py:276-284): equal hit masks, t within
    rtol 1e-4, tri equal on more than 99% of hit lanes. (t_rtol, t_atol
    and tie_rtol hold another walker or another build of the same scene
    to another contract.) The two
    walkers round differently, and so do the reference's:
    - a lane where only one of them hits must lie within ROUNDING of
      a decision boundary of the triangle it hit (an edge, or t_max);
    - a lane where they hit different triangles must be a tie: t
      equal within rtol 1e-6 (a few ulp), and the float64 hit point
      on both triangles, within ROUNDING. Ties are counted as
      coplanar faces of opposite orientation (the full box's glass
      bottom on the glossy top), coplanar of the same orientation,
      and crossing (two faces meeting at an edge)."""
    import torch

    from cadrays_tpu_torch.ops import wide

    ref = wide.trace_wide_ref(g, o, d, tm, any_hit=any_hit)
    tm = tm.expand(o.shape[0])
    k3_hit = got["tri"] >= 0
    hit = ref["tri"] >= 0
    mdiff = k3_hit != hit
    out = {"mask_differs": int(mdiff.sum()), "max_boundary_dist": 0.0}
    if out["mask_differs"]:
        inside, t, cos = mt64(g, o[mdiff], d[mdiff], torch.where(
            k3_hit, got["tri"], ref["tri"])[mdiff])
        tmd = tm[mdiff].double()
        dist = torch.minimum(inside.abs(), (t - tmd).abs() / tmd) * cos
        out["max_boundary_dist"] = float(dist.max())
        assert bool((dist <= ROUNDING).all()), (any_hit, out)
    if any_hit:
        return out
    hit = hit & k3_hit
    dt = (got["t"][hit] - ref["t"][hit]).abs()
    out["t_max_abs_diff"] = float(dt.max()) if dt.numel() else 0.0
    assert bool((dt <= t_atol + t_rtol * ref["t"][hit].abs()).all()), out
    diff = hit & (got["tri"] != ref["tri"])
    n_diff = int(diff.sum())
    assert n_diff <= 0.01 * int(hit.sum()), (n_diff, out)
    assert torch.allclose(got["t"][diff], ref["t"][diff], rtol=tie_rtol,
                          atol=0.0), ("the walkers differ off a tie", out)
    normals = []
    for tri in (got["tri"][diff], ref["tri"][diff]):
        inside, _, cos = mt64(g, o[diff], d[diff], tri)
        assert bool((inside * cos >= -ROUNDING).all()), \
            "a tie off one of its triangles"
        rows = g.tris_packed[tri.long()]
        n = torch.linalg.cross(rows[:, 3:6], rows[:, 6:9])
        if g.instanced:  # world normals: the inverse transpose
            m = g.inst_inv[g.tri_inst[tri.long()].long()][:, :, :3]
            n = (m.transpose(1, 2) @ n[:, :, None])[..., 0]
        normals.append(n / n.norm(dim=-1, keepdim=True))
    cos = (normals[0] * normals[1]).sum(-1)
    out.update({"tri_differs": n_diff,
                "coplanar_opposite": int((cos < -0.999).sum()),
                "coplanar_same": int((cos > 0.999).sum()),
                "crossing": int((cos.abs() <= 0.999).sum())})
    return out


# per pop of an instanced walk (kernels/wide_trace.cu, variant b): the
# 3x4 transform of origin and direction (18 multiplies, 15 adds) and the
# 3 reciprocals of the safe inverse direction
OPS_PER_POP_TRANSFORM = 36


def _bit_equal(got, ref, what):
    """K1 (b) against its plain version: every output equal bit for bit
    on every lane, no tie allowed; returns the hit count."""
    import torch

    torch.cuda.synchronize()
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k], ref[k]), (what, k)
    return int((ref["tri"] >= 0).sum())


def _tri_map(inst_geom, baked_geom):
    """Fused triangle id of an instanced build -> id of the same world
    triangle in a baked build of the same scene (nearest world centroid;
    the two builds order triangles differently)."""
    import torch

    def centroids(g, tf=None):
        v = g.vertices[g.tri_v.long()].double().mean(1)  # (T, 3)
        if tf is not None:
            m = tf[g.tri_inst.long()].double()
            v = (m[..., :3] * v[:, None, :]).sum(-1) + m[..., 3]
        return v

    ci = centroids(inst_geom, inst_geom.inst_tf)
    cb = centroids(baked_geom)
    dist = torch.cdist(ci, cb)
    near, idx = dist.min(1)
    assert float(near.max()) < 1e-5, float(near.max())
    assert idx.unique().numel() == idx.numel()
    return idx.to(torch.int32)


def run_instanced(dev, reset_counts, read_counts, *, grid=10, segments=72, rings=36,
                  width=1024, spp=8, n_steps=26, n_syn=65_536, cpu_size=32,
                  cornell_lanes=262_144, cornell_spp=32, cornell_steps=96,
                  reps=20):
    """The instanced slice on the card: K1 variant (b) against its plain
    version (synthetic rays, every launch of one chunk of the main
    path), the reference's CAD-scale render (bench/cad_scale.py:160-200:
    the 100-torus grid, four chunks of a 1024x1024 frame, depth 5, spp
    8, 26 steps) lit and unlit, the card against the CPU, the instanced
    full Cornell box against the baked one, and K1 (b)'s time against
    its bound. reset_counts() zeroes every kernel wrapper's launch count
    and read_counts() reads them by backend. Returns K1 (b)'s row of the
    kernels line."""
    import numpy as np
    import torch

    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.persistent import render_persistent
    from cadrays_tpu_torch.integrator.renderer import render_persistent_image
    from cadrays_tpu_torch.integrator.wavefront import build_wavefront
    from cadrays_tpu_torch.ops import traverse, wide
    from cadrays_tpu_torch.scene.scene import Scene
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.core.camera import Camera
    from cadrays_tpu_torch.core.lights import directional_light
    from cadrays_tpu_torch.geometry import primitives
    from cadrays_tpu_torch.testing.regression import compare
    from cadrays_tpu_torch.testing.scenes import (cornell_box, cornell_camera,
                                                  torus_grid)

    traverse.set_backend("wide")
    params = RenderParams(ray_depth=5)
    t_build = time.perf_counter()
    scenes = {lit: torus_grid(grid, segments, rings, lit=lit, device=dev)
              for lit in (True, False)}
    t_build = time.perf_counter() - t_build
    data, cam = scenes[True]
    geom = data.geometry
    assert geom.instanced and wide.fits_wide(geom)
    emit({"phase": "torus_grid", "grid": grid, "instances":
          int(geom.inst_inv.shape[0]), "triangles": int(geom.tri_v.shape[0]),
          "compact_rows": int(geom.wtris_packed.shape[0]),
          "wide_nodes": int(geom.wmeta.shape[0]),
          "wide_depth": int(geom.wide_depth),
          "wide_leaf": int(geom.wide_leaf),
          "binary_nodes": int(geom.nodes_packed.shape[0]),
          "build_seconds_both": t_build})
    rng = np.random.default_rng(4)
    side = grid * 2.6

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1 (b) against its plain version, synthetic rays --------------
    n = n_syn
    px_side = int(round(n ** 0.5))
    pix = np.arange(n)
    px = cuda((pix % px_side + rng.uniform(size=n)).astype(np.float32))
    py = cuda((pix // px_side + rng.uniform(size=n)).astype(np.float32))
    zeros = torch.zeros(n, device=dev)
    cam_o, cam_d = cam.to(dev).generate_rays(px, py, zeros, zeros,
                                             px_side, px_side)
    b_o = rng.uniform([0, 0, -1], [side, side, 2], (n, 3)).astype(np.float32)
    b_d = rng.normal(size=(n, 3)).astype(np.float32)
    b_d /= np.linalg.norm(b_d, axis=-1, keepdims=True)
    # a non-uniformly scaled instance (tests/test_instances.py:59), with
    # every other hit lane capped at half its hit distance and every 7th
    # lane dead
    sq = Scene()
    sq.clear_lights()
    sq.add_light(directional_light(direction=(0, 0, -1), intensity=2.0))
    sq.add_mesh("squashed", primitives.sphere(1.0, 24, 12),
                material(kd=(0.7, 0.7, 0.7)),
                np.diag([3.0, 1.0, 0.5, 1.0]).astype(np.float32))
    sq_cam = Camera.look_at(eye=(0, 0, 6), at=(0, 0, 0), up=(0, 1, 0),
                            fovy_deg=45.0)
    sq_geom = sq.flatten(sq_cam, instancing=True, device=dev).geometry
    s_o = rng.uniform([-4, -2, -1], [4, 2, 1], (n, 3)).astype(np.float32)
    s_d = rng.normal(size=(n, 3)).astype(np.float32)
    s_d /= np.linalg.norm(s_d, axis=-1, keepdims=True)
    s_o, s_d = cuda(s_o), cuda(s_d)
    full = wide.trace_wide_ref(sq_geom, s_o, s_d,
                               torch.full((n,), 1e30, device=dev))
    capped = (full["tri"] >= 0) & (torch.arange(n, device=dev) % 2 == 0)
    s_tm = torch.where(capped, full["t"] * 0.5, 1e30)
    s_tm[::7] = 0.0
    inf = torch.full((n,), 1e30, device=dev)
    cases = [("torus_camera", geom, cam_o.contiguous(), cam_d.contiguous(),
              inf), ("torus_bounce", geom, cuda(b_o), cuda(b_d), inf),
             ("squashed_capped", sq_geom, s_o, s_d, s_tm.contiguous())]
    for name, g, o, d, tm in cases:
        for any_hit in (False, True):
            got = wide.trace_wide(g, o, d, tm, any_hit=any_hit)
            ref = wide.trace_wide_ref(g, o, d, tm, any_hit=any_hit)
            hits = _bit_equal(got, ref, (name, any_hit))
            if name == "squashed_capped":
                assert bool((got["tri"][::7] == -1).all())
                assert not bool((got["tri"][capped] >= 0).any())
            emit({"phase": "k1b_check", "case": name, "any_hit": any_hit,
                  "rays": n, "hits": hits, "tie_lanes": 0,
                  "max_abs_err": 0.0})

    # ---- the reference's CAD-scale render, lit and unlit ---------------
    R = width * width // 4
    chunks = [torch.arange(c * R, (c + 1) * R, device=dev) for c in range(4)]
    launches = {}
    for lit in (True, False):
        data_l, cam_l = scenes[lit]
        render_persistent(data_l, cam_l, params, width, width, 1, 2,
                          pixel_ids=chunks[1][:4096])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        done, imgs = 0, []
        for pids in chunks:
            img, cnt = render_persistent(data_l, cam_l, params, width, width,
                                         spp, n_steps, pixel_ids=pids)
            done += int(cnt.sum())
            imgs.append(img / cnt[:, None].clamp(min=1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        per_step = 2 if lit else 1  # no light: no shadow trace
        assert counts == {"wide": 4 * n_steps * per_step, "pallas": 0,
                          "bruteforce": 0}, counts
        launches[lit] = counts["wide"]
        frame = torch.cat(imgs)
        mean = float(frame.mean())
        assert bool(torch.isfinite(frame).all())
        if lit:
            assert mean > 0.01, mean  # the light reaches the tori
        emit({"phase": "torus_main_path", "lit": lit,
              "call": "render_persistent x 4 chunks", "width": width,
              "height": width, "lanes": R, "spp": spp, "n_steps": n_steps,
              "depth": params.ray_depth, "seconds": dt,
              "samples_per_s": done / dt,
              "quota_completion": done / (4 * R * spp),
              "k1b_launches": counts["wide"], "hdr_mean": mean})

    # ---- K1 (b) on every launch of chunks 0 and 2 of the lit render ----
    # chunk 0 (the frame's top rows) looks over the assembly at the sky,
    # so its rays all miss; chunk 2 looks down at the tori
    launch = wide._launch
    for c in (0, 2):
        seen = {}

        def checked_launch(g, o, d, tm, any_hit, _seen=seen, **kw):
            assert kw.get("start") is None
            got = launch(g, o, d, tm, any_hit, **kw)
            ref = wide.trace_wide_ref(g, o, d, tm, any_hit=any_hit)
            s = _seen.setdefault(any_hit, {"launches": 0, "hits": 0})
            s["launches"] += 1
            s["hits"] += _bit_equal(got, ref, ("main path", c, any_hit))
            return got

        wide._launch = checked_launch
        try:
            render_persistent(data, cam, params, width, width, spp, n_steps,
                              pixel_ids=chunks[c])
        finally:
            wide._launch = launch
        assert sum(s["launches"] for s in seen.values()) == 2 * n_steps, seen
        for any_hit, s in sorted(seen.items()):
            emit({"phase": "k1b_main_path_check", "chunk": c, "lanes": R,
                  "any_hit": any_hit, **s, "tie_lanes": 0,
                  "max_abs_err": 0.0})

    # ---- the card against the CPU, 32x32 torus grid --------------------
    small = {}
    for d_ in (dev.type, "cpu"):
        sd, sc = torus_grid(grid, segments, rings, lit=True, device=d_)
        small[d_] = render_persistent_image(sd, sc, params, cpu_size,
                                            cpu_size, spp=4).cpu().numpy()
    res = compare(small[dev.type], small["cpu"], pix_tol=0.02)
    assert res["match"], res
    emit({"phase": "card_vs_cpu_torus", "size": cpu_size, "spp": 4, **res})

    # ---- instanced against baked: the full Cornell box ----------------
    # two fresh scenes: a Scene returns its cached snapshot whatever
    # `instancing` asks
    ccam = cornell_camera()
    baked = cornell_box(full=True).flatten(ccam, device=dev)
    inst = cornell_box(full=True).flatten(ccam, instancing=True, device=dev)
    assert inst.geometry.instanced and not baked.geometry.instanced
    pids = torch.arange(cornell_lanes, device=dev)
    cimg = {}
    for name, sd in (("baked", baked), ("instanced", inst)):
        reset_counts()
        t0 = time.perf_counter()
        img, cnt = render_persistent(sd, ccam, params, 1024, 1024,
                                     cornell_spp, cornell_steps,
                                     pixel_ids=pids)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert read_counts() == {"wide": 2 * cornell_steps, "pallas": 0,
                                 "bruteforce": 0}
        cimg[name] = (img / cnt[:, None].clamp(min=1)).reshape(
            -1, 1024, 3).cpu().numpy()
        emit({"phase": "cornell_instanced_vs_baked", "scene": name,
              "lanes": cornell_lanes, "spp": cornell_spp,
              "n_steps": cornell_steps, "seconds": dt,
              "samples_per_s": int(cnt.sum()) / dt,
              "quota_completion": int(cnt.sum()) / (cornell_lanes
                                                    * cornell_spp)})
    # the images may differ where the two builds break a coplanar tie
    # apart (the glass box's bottom on the glossy box's top, met from
    # inside the glass: ROADMAP C2); the compare result is printed, and
    # every hit the two builds disagree on must be a tie or within
    # rounding of an edge or t_max (k3_vs_k1's contract between two
    # walkers that round differently), on the camera rays and the
    # sorted rays of every later bounce of the baked path
    res = compare(cimg["instanced"], cimg["baked"], pix_tol=0.02)
    tmap = _tri_map(inst.geometry, baked.geometry)
    state, bounce = build_wavefront(baked, ccam, params, 1024, 1024, 0, pids)
    ray_sets = [("camera", state["origin"], state["direction"],
                 torch.full((cornell_lanes,), 1e30, device=dev))]
    with torch.no_grad():
        for b in range(params.ray_depth - 1):
            state, _ = bounce(state, b)
            ray_sets.append((f"bounce_{b + 1}", state["origin"],
                             state["direction"],
                             torch.where(state["alive"], 1e30, 0.0)))
    gap = {}
    for rname, o, d, tm in ray_sets:
        o, d, tm = o.contiguous(), d.contiguous(), tm.contiguous()
        for any_hit in (False, True):
            got = dict(wide.trace_wide(inst.geometry, o, d, tm,
                                       any_hit=any_hit))
            got["tri"] = torch.where(got["tri"] >= 0,
                                     tmap[got["tri"].clamp(min=0).long()],
                                     -1)
            # t: the reference's contract between a baked and an
            # instanced build (tests/test_instances.py:43-45); the
            # builds round the geometry apart by an ulp of its
            # coordinates, which shows on short bounce segments (t ~ 1e-4
            # off a surface) and on ties (the two coplanar faces' t up to
            # 4.0e-6 apart, where one walker on one build gives 1e-7)
            gap[f"{rname}_{'any' if any_hit else 'closest'}"] = k3_vs_k1(
                baked.geometry, o, d, tm, any_hit, got, t_rtol=2e-4,
                t_atol=2e-4, tie_rtol=1e-5)
    emit({"phase": "cornell_instanced_vs_baked", "compare": res,
          "hit_differences": gap})

    # ---- K1 (b) timing on the torus grid's sorted first-bounce rays ----
    # pixel ids strided over the whole frame (cad_scale.py:113-117): a
    # contiguous quarter would see mostly sky above the assembly
    spids = torch.arange(R, device=dev) * 4
    state, bounce = build_wavefront(data, cam, params, width, width, 0, spids)
    with torch.no_grad():
        state, _ = bounce(state, 0)
    o = state["origin"].contiguous()
    d = state["direction"].contiguous()
    tm = torch.where(state["alive"], 1e30, 0.0)
    live = int((tm > 0).sum())
    instinv, wdelta = wide._instance_tables(geom)
    tables = sum(t.numel() * t.element_size() for t in (
        geom.wboxes, geom.wmeta, geom.worder, geom.winst,
        geom.wtris_packed, instinv, wdelta))
    ray_bytes = R * (4 + 4 * 4) + live * 6 * 4
    timing = {}
    for any_hit in (False, True):
        stats = {}
        got = wide.trace_wide(geom, o, d, tm, any_hit=any_hit)
        hits = _bit_equal(got, wide.trace_wide_ref(geom, o, d, tm,
                                                   any_hit=any_hit,
                                                   stats=stats),
                          ("timing rays", any_hit))
        ms = time_ms(lambda: wide.trace_wide(geom, o, d, tm,
                                             any_hit=any_hit), reps)
        plain_ms = time_ms(lambda: wide.trace_wide_ref(
            geom, o, d, tm, any_hit=any_hit), 3)
        ops = (stats["box_tests"] * OPS_PER_BOX_TEST
               + stats["tri_tests"] * OPS_PER_TRI_TEST
               + stats["pops"] * OPS_PER_POP_TRANSFORM)
        t_bytes = (ray_bytes + tables) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS_PER_S * 1e3
        timing[any_hit] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=ray_bytes + tables, ops=ops, **stats)
        emit({"phase": "k1b_timing", "any_hit": any_hit, "rays": R,
              "live_rays": live, "hits": hits, "tie_lanes": 0,
              "max_abs_err": 0.0, **timing[any_hit], "library_ms": None,
              "library_note": "no single PyTorch call traces a BVH"})
    close, anyh = timing[False], timing[True]
    return {"launches": launches[True], "max_abs_err": 0.0,
            "ms": close["ms"], "plain_ms": close["plain_ms"],
            "bound_ms": close["bound_ms"], "bound_by": close["bound_by"],
            "library_ms": None, "any_hit_ms": anyh["ms"],
            "any_hit_plain_ms": anyh["plain_ms"],
            "any_hit_bound_ms": anyh["bound_ms"],
            "unlit_launches": launches[False]}


def _profile_steps(render, n_steps, wall_ms_per_step, kernel, key):
    """Device kernel time and launches per step of `render(n_steps)`
    under torch.profiler, against an unprofiled wall time per step, and
    the time of the kernels whose name holds `kernel` (keys `key`_...)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(n_steps)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert events, "torch.profiler recorded no device kernels"
    per_name = {}
    for e in events:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + e.time_range.elapsed_us())
    dev_ms = sum(per_name.values()) / n_steps / 1e3
    k_ms = sum(v for k, v in per_name.items() if kernel in k) / n_steps / 1e3
    return {"steps": n_steps, "wall_ms_per_step": wall_ms_per_step,
            "device_ms_per_step": dev_ms,
            "device_busy_share": dev_ms / wall_ms_per_step,
            "kernels_per_step": len(events) / n_steps,
            f"{key}_device_ms_per_step": k_ms,
            f"{key}_share_of_device": k_ms / dev_ms,
            "top_kernels_ms_per_step": [
                [k[:80], v / n_steps / 1e3] for k, v in
                sorted(per_name.items(), key=lambda kv: -kv[1])[:5]]}


# bytes of one wide node (its 8 child boxes and its wmeta, worder and
# winst rows) and of one compact triangle row
WIDE_NODE_BYTES = 8 * 6 * 4 + 3 * 8 * 4
TRI_ROW_BYTES = 12 * 4


def _k1_bound(stats, ray_bytes, other_bytes=0):
    """Least time of a K1 launch (or of a sum of them): the larger of its
    bytes (the rays' `ray_bytes`, the wide nodes and triangle rows these
    rays read, each once, and `other_bytes`) over the memory rate, and of
    its operations (slab tests, triangle tests, per-pop transforms) over
    the fp32 rate; work and reads counted by trace_wide_ref on the same
    rays."""
    ops = (stats["box_tests"] * OPS_PER_BOX_TEST
           + stats["tri_tests"] * OPS_PER_TRI_TEST
           + stats["pops"] * OPS_PER_POP_TRANSFORM)
    nbytes = (ray_bytes + stats["nodes_touched"] * WIDE_NODE_BYTES
              + stats["rows_touched"] * TRI_ROW_BYTES + other_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, **stats)


def run_distinct(dev, reset_counts, read_counts, *, width=1024, spp=8,
                 n_steps=26, n_syn=65_536, cpu_size=768, check_chunk=2,
                 prof_steps=8, blocks=(32, 2048), reps=20):
    """The distinct-parts slice on the card: the reference's
    bench/cad_distinct.py assembly (54 distinct parts, 611,136
    triangles, a compact table of 611,264 rows: the reference's
    streamed-triangle variant (c)) and its K1 (d) rebinned walk.
    - K1 on the 611k table against its plain version, bit for bit, on
      the strided camera rays, distinct_bounce_rays and random rays;
    - the reference's end-to-end render (cad_distinct.py:264-300: four
      chunks of a 1024x1024 frame, depth 5, spp 8, 26 steps; 208 K1
      launches), every launch of one chunk held against the plain
      version, the card against the CPU, and 8 profiled steps;
    - K1 (c)'s time on the bounce and camera rays against its bound;
    - trace_wide_rebinned: every K1 (d) launch bit-equal to its plain
      version with the same seeds, the result equal to trace's up to
      ties, and its time at each block size (the port's default 32 and
      the reference's 2048).
    The CPU render is the largest square whose plain-version render
    stays under about a minute on the card machine's host (PERF.md).
    Returns the kernels line's rows for (c) and (d)."""
    import numpy as np
    import torch

    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.persistent import render_persistent
    from cadrays_tpu_torch.integrator.renderer import render_persistent_image
    from cadrays_tpu_torch.ops import traverse, wide
    from cadrays_tpu_torch.testing.regression import compare
    from cadrays_tpu_torch.testing.scenes import (distinct_bounce_rays,
                                                  distinct_parts)

    traverse.set_backend("wide")
    params = RenderParams(ray_depth=5)
    t0 = time.perf_counter()
    data, cam = distinct_parts(device=dev)
    t_build = time.perf_counter() - t0
    geom = data.geometry
    instinv, wdelta = wide._instance_tables(geom)
    inst_bytes = sum(t.numel() * t.element_size() for t in (instinv, wdelta))
    tables = inst_bytes + sum(t.numel() * t.element_size() for t in (
        geom.wboxes, geom.wmeta, geom.worder, geom.winst, geom.wtris_packed))
    sizes = {"instances": int(geom.inst_inv.shape[0]),
             "triangles": int(geom.tri_v.shape[0]),
             "compact_rows": int(geom.wtris_packed.shape[0]),
             "wide_nodes": int(geom.wmeta.shape[0]),
             "wide_depth": int(geom.wide_depth),
             "wide_leaf": int(geom.wide_leaf),
             "binary_nodes": int(geom.nodes_packed.shape[0])}
    # the reference's scene (bench/cad_distinct.py, measured on its build)
    assert sizes == {"instances": 54, "triangles": 611_136,
                     "compact_rows": 611_264, "wide_nodes": 3_483,
                     "wide_depth": 7, "wide_leaf": 64,
                     "binary_nodes": 371_483}, sizes
    assert geom.instanced and wide.fits_wide(geom)
    assert tuple(geom.wtris_hbm.shape) == (1, 128)  # no padded table
    emit({"phase": "distinct_parts", **sizes, "k1_table_bytes": tables,
          "build_seconds": t_build})

    # ---- the three ray sets ---------------------------------------------
    R = width * width // 4
    inf = torch.full((R,), 1e30, device=dev)
    spids = torch.arange(R, device=dev) * 4  # strided over the frame
    zeros = torch.zeros(R, device=dev)
    c_o, c_d = cam.to(dev).generate_rays((spids % width).float(),
                                         (spids // width).float(), zeros,
                                         zeros, width, width)
    c_o, c_d = c_o.contiguous(), c_d.contiguous()
    t0 = time.perf_counter()
    b_o, b_d = distinct_bounce_rays(geom, cam, width, width)
    t_bounce = time.perf_counter() - t0
    rng = np.random.default_rng(9)
    lo = geom.inst_lo.amin(0).cpu().numpy()
    hi = geom.inst_hi.amax(0).cpu().numpy()
    pad = 0.1 * (hi - lo)
    r_o = rng.uniform(lo - pad, hi + pad, (n_syn, 3)).astype(np.float32)
    r_d = rng.normal(size=(n_syn, 3)).astype(np.float32)
    r_d /= np.linalg.norm(r_d, axis=-1, keepdims=True)
    r_o = torch.from_numpy(r_o).to(dev)
    r_d = torch.from_numpy(r_d).to(dev)
    r_full = wide.trace_wide_ref(geom, r_o, r_d,
                                 torch.full((n_syn,), 1e30, device=dev))
    # every other hit lane capped at half its hit distance (must miss),
    # every 7th lane dead
    capped = (r_full["tri"] >= 0) & (torch.arange(n_syn, device=dev) % 2 == 0)
    r_tm = torch.where(capped, r_full["t"] * 0.5, 1e30)
    r_tm[::7] = 0.0
    sets = [("camera_strided", c_o, c_d, inf), ("bounce", b_o, b_d, inf),
            ("random_capped", r_o, r_d, r_tm.contiguous())]
    for name, o, d, tm in sets:
        for any_hit in (False, True):
            got = wide.trace_wide(geom, o, d, tm, any_hit=any_hit)
            hits = _bit_equal(got, wide.trace_wide_ref(
                geom, o, d, tm, any_hit=any_hit), ("k1c", name, any_hit))
            if name == "random_capped":
                assert bool((got["tri"][::7] == -1).all())
                assert not bool((got["tri"][capped] >= 0).any())
            assert hits > 0, name
            emit({"phase": "k1c_check", "case": name, "any_hit": any_hit,
                  "rays": o.shape[0], "hits": hits, "tie_lanes": 0,
                  "max_abs_err": 0.0})

    # ---- the reference's end-to-end render ------------------------------
    chunks = [torch.arange(c * R, (c + 1) * R, device=dev) for c in range(4)]
    render_persistent(data, cam, params, width, width, 1, 2,
                      pixel_ids=chunks[1][:4096])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done, imgs = 0, []
    for pids in chunks:
        img, cnt = render_persistent(data, cam, params, width, width, spp,
                                     n_steps, pixel_ids=pids)
        done += int(cnt.sum())
        imgs.append(img / cnt[:, None].clamp(min=1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {"wide": 4 * n_steps * 2, "pallas": 0,
                      "bruteforce": 0}, counts
    launches_c = counts["wide"]
    frame = torch.cat(imgs)
    mean = float(frame.mean())
    assert bool(torch.isfinite(frame).all()) and mean > 0.005, mean
    emit({"phase": "distinct_main_path", "call": "render_persistent x 4 chunks",
          "width": width, "height": width, "lanes": R, "spp": spp,
          "n_steps": n_steps, "depth": params.ray_depth, "seconds": dt,
          "samples_per_s": done / dt, "quota_completion": done / (4 * R * spp),
          "k1c_launches": launches_c, "hdr_mean": mean})
    wall_ms_per_step = dt / (4 * n_steps) * 1e3

    # ---- K1 on every launch of one chunk that sees the assembly --------
    launch = wide._launch
    seen = {}

    def checked_launch(g, o, d, tm, any_hit, start=None, block=None):
        assert start is None
        got = launch(g, o, d, tm, any_hit)
        ref = wide.trace_wide_ref(g, o, d, tm, any_hit=any_hit)
        s_ = seen.setdefault(any_hit, {"launches": 0, "hits": 0})
        s_["launches"] += 1
        s_["hits"] += _bit_equal(got, ref, ("distinct main path", any_hit))
        return got

    wide._launch = checked_launch
    try:
        render_persistent(data, cam, params, width, width, spp, n_steps,
                          pixel_ids=chunks[check_chunk])
    finally:
        wide._launch = launch
    assert sum(s_["launches"] for s_ in seen.values()) == 2 * n_steps, seen
    assert seen[False]["hits"] > 0, seen
    for any_hit, s_ in sorted(seen.items()):
        emit({"phase": "k1c_main_path_check", "chunk": check_chunk,
              "lanes": R, "any_hit": any_hit, **s_, "tie_lanes": 0,
              "max_abs_err": 0.0})

    # ---- the card against the CPU ---------------------------------------
    small = {}
    secs = {}
    for d_ in (dev.type, "cpu"):
        sd, sc = (data, cam) if d_ == dev.type else distinct_parts(device="cpu")
        t0 = time.perf_counter()
        small[d_] = render_persistent_image(sd, sc, params, cpu_size,
                                            cpu_size, spp=4).cpu().numpy()
        secs[d_] = time.perf_counter() - t0
    res = compare(small[dev.type], small["cpu"], pix_tol=0.02)
    assert res["match"], res
    emit({"phase": "card_vs_cpu_distinct", "size": cpu_size, "spp": 4,
          "card_seconds": secs[dev.type], "cpu_seconds": secs["cpu"], **res})

    # ---- where a step's time goes ----------------------------------------
    prof = _profile_steps(
        lambda k: render_persistent(data, cam, params, width, width, spp, k,
                                    pixel_ids=chunks[check_chunk]),
        prof_steps, wall_ms_per_step, "wide_trace_kernel", "k1")
    emit({"phase": "step_profile", "scene": "distinct_parts",
          "chunk": check_chunk, **prof})

    # ---- K1 (c): time against the bound ---------------------------------
    timing = {}
    for case, o, d, any_hit in (("hbm_bounce", b_o, b_d, False),
                                ("hbm_bounce_anyhit", b_o, b_d, True),
                                ("hbm_coherent", c_o, c_d, False)):
        stats = {}
        got = wide.trace_wide(geom, o, d, inf, any_hit=any_hit)
        hits = _bit_equal(got, wide.trace_wide_ref(
            geom, o, d, inf, any_hit=any_hit, stats=stats), ("k1c", case))
        ms = time_ms(lambda: wide.trace_wide(geom, o, d, inf,
                                             any_hit=any_hit), reps)
        plain_ms = time_ms(lambda: wide.trace_wide_ref(
            geom, o, d, inf, any_hit=any_hit), 3)
        # t_max in and t, tri, u, v out on every lane, o and d in
        timing[case] = dict(ms=ms, plain_ms=plain_ms, **_k1_bound(
            stats, R * (4 + 4 * 4 + 6 * 4), inst_bytes))
        emit({"phase": "k1c_timing", "case": case, "any_hit": any_hit,
              "rays": R, "live_rays": R, "hits": hits, "tie_lanes": 0,
              "max_abs_err": 0.0, **timing[case], "library_ms": None,
              "library_note": "no single PyTorch call traces a BVH"})

    # ---- K1 (d): trace_wide_rebinned on the bounce rays -----------------
    ref_root = {ah: wide.trace_wide(geom, b_o, b_d, inf, any_hit=ah)
                for ah in (False, True)}
    d_stats = {}
    launches_d = {}
    for block in blocks:
        for any_hit in (False, True):
            reset_counts()
            st = {}
            res = wide.trace_wide_rebinned(geom, b_o, b_d, inf,
                                           any_hit=any_hit, block=block,
                                           stats=st)
            torch.cuda.synchronize()
            n_launch = read_counts()["wide"]
            assert n_launch == st["rounds"] > 0, (n_launch, st)
            launches_d[(block, any_hit)] = n_launch
            # every K1 (d) launch of the same call against its plain
            # version with the same seeds and block
            per = {"launches": 0, "hits": 0, "lanes": 0, "pops": 0,
                   "box_tests": 0, "tri_tests": 0, "nodes_touched": 0,
                   "rows_touched": 0, "ray_bytes": 0, "plain_ms": 0.0}

            def seeded_launch(g, o, d, tm, any_hit_, start=None, block=None,
                              _per=per):
                assert start is not None
                got = launch(g, o, d, tm, any_hit_, start=start, block=block)
                lstats = {}
                torch.cuda.synchronize()
                t_ref = time.perf_counter()
                ref = wide.trace_wide_ref(g, o, d, tm, any_hit=any_hit_,
                                          start=start, block=block,
                                          stats=lstats)
                torch.cuda.synchronize()
                _per["plain_ms"] += (time.perf_counter() - t_ref) * 1e3
                _per["launches"] += 1
                _per["hits"] += _bit_equal(got, ref, ("k1d", block, any_hit_))
                live = int((tm > 0).sum())
                _per["lanes"] += live
                for k, v in lstats.items():
                    _per[k] += v
                # t_max and the outputs on every lane, o and d on live
                # lanes, the seeds and instance tables once per launch
                _per["ray_bytes"] += (o.shape[0] * (4 + 4 * 4) + live * 6 * 4
                                      + start.numel() * 4 + inst_bytes)
                return got

            wide._launch = seeded_launch
            try:
                again = wide.trace_wide_rebinned(geom, b_o, b_d, inf,
                                                 any_hit=any_hit, block=block)
            finally:
                wide._launch = launch
            for k in res:
                assert torch.equal(res[k], again[k]), ("rebinned rerun", k)
            assert per["launches"] == n_launch, (per, n_launch)
            # against the walk from the root: t, u, v bit-equal where tri
            # is; every other lane a tie or within rounding of an edge or
            # of t_max (k3_vs_k1's contract)
            root = ref_root[any_hit]
            gap = k3_vs_k1(geom, b_o, b_d, inf, any_hit, res)
            if not any_hit:
                same = (res["tri"] == root["tri"]) & (root["tri"] >= 0)
                for k in ("t", "u", "v"):
                    assert torch.equal(res[k][same], root[k][same]), k
                gap["tri_equal"] = int(same.sum())
            d_stats[(block, any_hit)] = per
            emit({"phase": "k1d_check", "block": block, "any_hit": any_hit,
                  "rays": R, "rounds": st["rounds"], "k1d_launches": n_launch,
                  **per, "tie_lanes": 0, "max_abs_err": 0.0,
                  "vs_trace": gap})

    d_timing = {}
    for block in blocks:
        for any_hit in (False, True):
            def call(_b=block, _a=any_hit):
                return wide.trace_wide_rebinned(geom, b_o, b_d, inf,
                                                any_hit=_a, block=_b)

            for _ in range(3):
                call()
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            dev_ms = []

            def timed_launch(*a, _acc=dev_ms, **kw):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = launch(*a, **kw)
                ev[1].record()
                _acc[-1].append(ev)
                return out

            wide._launch = timed_launch
            try:
                for _ in range(reps):
                    dev_ms.append([])
                    call()
            finally:
                wide._launch = launch
            torch.cuda.synchronize()
            sums = [sum(a.elapsed_time(b) for a, b in evs) for evs in dev_ms]
            per = d_stats[(block, any_hit)]
            d_timing[(block, any_hit)] = dict(
                wall_ms=statistics.median(walls), rounds=len(dev_ms[0]),
                ms=statistics.median(sums),
                **_k1_bound(per, per["ray_bytes"]))
            emit({"phase": "k1d_timing", "case": "rebin_bounce" + (
                "_anyhit" if any_hit else ""), "block": block,
                "any_hit": any_hit, "rays": R, **d_timing[(block, any_hit)],
                "library_ms": None,
                "library_note": "no single PyTorch call traces a BVH"})

    kernel = {"route": "cuda", "source": "cadrays_tpu_torch/kernels/"
              "wide_trace.cu", "max_abs_err": 0.0, "library_ms": None,
              "check": "passed"}
    close, anyh = timing["hbm_bounce"], timing["hbm_bounce_anyhit"]
    row_c = {"name": "wide_trace (c) CAD scale", **kernel,
             "replaces": "cadrays_tpu/ops/pallas_wide.py:279",
             "launches": launches_c, "ms": close["ms"],
             "plain_ms": close["plain_ms"], "bound_ms": close["bound_ms"],
             "bound_by": close["bound_by"], "any_hit_ms": anyh["ms"],
             "any_hit_plain_ms": anyh["plain_ms"],
             "any_hit_bound_ms": anyh["bound_ms"],
             "coherent_ms": timing["hbm_coherent"]["ms"],
             "coherent_bound_ms": timing["hbm_coherent"]["bound_ms"],
             "note": "the kernel of (a) and (b) over a 611,264-row table: "
                     "the card reads device memory at any table size"}
    row_d = {"name": "wide_trace (d) seeded", **kernel,
             "replaces": "cadrays_tpu/ops/pallas_wide.py:221",
             "note": "trace_wide_rebinned on 262,144 bounce rays: ms, "
                     "plain_ms and bound summed over its rounds; launches "
                     "are its rounds"}
    for block in blocks:
        pre = "" if block == blocks[0] else f"block_{block}_"
        close, anyh = d_timing[(block, False)], d_timing[(block, True)]
        row_d.update({
            f"{pre}block": block,
            f"{pre}launches": launches_d[(block, False)],
            f"{pre}ms": close["ms"],
            f"{pre}plain_ms": d_stats[(block, False)]["plain_ms"],
            f"{pre}bound_ms": close["bound_ms"],
            f"{pre}bound_by": close["bound_by"],
            f"{pre}wall_ms": close["wall_ms"],
            f"{pre}any_hit_ms": anyh["ms"],
            f"{pre}any_hit_plain_ms": d_stats[(block, True)]["plain_ms"],
            f"{pre}any_hit_bound_ms": anyh["bound_ms"],
            f"{pre}any_hit_wall_ms": anyh["wall_ms"]})
    return row_c, row_d

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)\n")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.persistent import render_persistent
    from cadrays_tpu_torch.integrator.renderer import (
        Renderer, render_persistent_image)
    from cadrays_tpu_torch.integrator.wavefront import build_wavefront
    from cadrays_tpu_torch.kernels import build as kbuild
    from cadrays_tpu_torch.ops import binary, bruteforce, traverse, wide
    from cadrays_tpu_torch.scene.flatten import flatten_parts
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.mesh import TriangleMesh
    from cadrays_tpu_torch.testing.regression import compare
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # backend -> its kernel: wrapper module, wrapper, plain version
    kern = {
        "wide": dict(k="k1", name="wide_trace", mod=wide,
                     wrapper=wide.trace_wide, plain=wide.trace_wide_ref,
                     replaces="cadrays_tpu/ops/pallas_wide.py:163",
                     profile="wide_trace_kernel"),
        "pallas": dict(k="k2", name="binary_trace", mod=binary,
                       wrapper=binary.trace_binary,
                       plain=binary.trace_binary_ref,
                       replaces="cadrays_tpu/ops/pallas_traverse.py:60",
                       profile="binary_trace_kernel"),
        "bruteforce": dict(k="k3", name="bruteforce", mod=bruteforce,
                           wrapper=bruteforce.trace_bruteforce,
                           plain=bruteforce.trace_bruteforce_ref,
                           replaces="cadrays_tpu/ops/mxu_intersect.py:89",
                           profile="bruteforce_kernel"),
    }

    def reset_counts():
        for kn in kern.values():
            kn["wrapper"].launches = 0

    def read_counts():
        return {b: kn["wrapper"].launches for b, kn in kern.items()}

    # ---- 1. environment ------------------------------------------------
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind,
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

    # ---- 2. build the kernels from this checkout, one nvcc each --------
    def timed_build(name):
        t0 = time.perf_counter()
        _, ptxas = kbuild.load(name, force=True)
        return time.perf_counter() - t0, ptxas

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kern)) as ex:
        builds = {kn["name"]: ex.submit(timed_build, kn["name"])
                  for kn in kern.values()}
        builds = {name: f.result() for name, f in builds.items()}
    for name, (secs, ptxas) in builds.items():
        emit({"phase": "build", "kernel": name, "seconds": secs,
              "ptxas": [ln.strip() for ln in ptxas.splitlines()
                        if "registers" in ln or "spill" in ln]})
    emit({"phase": "build_all", "seconds": time.perf_counter() - t0})

    def check(backend, g, o, d, tm, any_hit, got=None, stats=None):
        """Kernel against its plain version on the same inputs: equal hit
        masks and t, tri equal except on tie lanes (equal t), u and v
        equal where tri is; returns (hits, tie lanes, max |err| of t/u/v
        on lanes with equal tri)."""
        kn = kern[backend]
        if got is None:
            got = kn["wrapper"](g, o, d, tm, any_hit=any_hit)
        extra = {} if stats is None else {"stats": stats}
        ref = kn["plain"](g, o, d, tm, any_hit=any_hit, **extra)
        torch.cuda.synchronize()
        hit = ref["tri"] >= 0
        assert torch.equal(got["tri"] >= 0, hit), (backend, any_hit)
        assert torch.equal(got["t"], ref["t"]), (backend, any_hit)
        ties = (got["tri"] != ref["tri"]) & hit
        same = (got["tri"] == ref["tri"]) & hit
        for k in ("u", "v"):
            assert torch.equal(got[k][same], ref[k][same]), (backend, k)
        err = max(float((got[k][same] - ref[k][same]).abs().max())
                  if bool(same.any()) else 0.0 for k in ("t", "u", "v"))
        return int(hit.sum()), int(ties.sum()), err

    # ---- 3. each kernel against its plain version, synthetic rays ------
    scene = cornell_box(full=True, sphere_res=24)
    cam = cornell_camera()
    data = scene.flatten(cam, device=dev)
    geom = data.geometry
    rng = np.random.default_rng(0)
    n = 65_536

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    side = 256
    pix = np.arange(side * side)
    px = cuda((pix % side + rng.uniform(size=n)).astype(np.float32))
    py = cuda((pix // side + rng.uniform(size=n)).astype(np.float32))
    zeros = torch.zeros(n, device=dev)
    cam_o, cam_d = cam.to(dev).generate_rays(px, py, zeros, zeros, side, side)
    b_o = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    b_d = rng.normal(size=(n, 3)).astype(np.float32)
    b_d /= np.linalg.norm(b_d, axis=-1, keepdims=True)

    verts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.1, (400, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1, (400, 3)).astype(np.float32)
    mesh = TriangleMesh(np.concatenate([verts, verts + e1, verts + e2]),
                        np.arange(1200).reshape(3, 400).T.copy())
    mgeom = flatten_parts([mesh], [material()], [0], device=dev).geometry
    m_o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    m_d = rng.normal(size=(n, 3)).astype(np.float32)
    m_d /= np.linalg.norm(m_d, axis=-1, keepdims=True)
    m_full = wide.trace_wide_ref(mgeom, cuda(m_o), cuda(m_d),
                                 torch.full((n,), 1e30, device=dev))
    # every other hit lane capped at half its hit distance (must miss),
    # every 7th lane dead (t_max = 0, must miss)
    capped = (m_full["tri"] >= 0) & (torch.arange(n, device=dev) % 2 == 0)
    m_tm = torch.where(capped, m_full["t"] * 0.5, 1e30)
    m_tm[::7] = 0.0

    cases = [("cornell_camera", geom, cam_o.contiguous(), cam_d.contiguous(),
              torch.full((n,), 1e30, device=dev)),
             ("cornell_bounce", geom, cuda(b_o), cuda(b_d),
              torch.full((n,), 1e30, device=dev)),
             ("random_mesh_capped", mgeom, cuda(m_o), cuda(m_d),
              m_tm.contiguous())]
    max_err = {b: 0.0 for b in kern}
    for backend, kn in kern.items():
        for name, g, o, d, tm in cases:
            for any_hit in (False, True):
                got = kn["wrapper"](g, o, d, tm, any_hit=any_hit)
                hits, ties, err = check(backend, g, o, d, tm, any_hit,
                                        got=got)
                max_err[backend] = max(max_err[backend], err)
                if name == "random_mesh_capped":
                    assert bool((got["tri"][::7] == -1).all())
                    assert not bool((got["tri"][capped] >= 0).any())
                emit({"phase": f"{kn['k']}_check", "case": name,
                      "any_hit": any_hit, "rays": n, "hits": hits,
                      "tie_lanes": ties, "max_abs_err": err})

    # ---- 4. the main path, under each backend --------------------------
    params = RenderParams(ray_depth=5)
    W = H = 1024
    R = (W * H) // 4
    spp, n_steps = 32, 96
    pids = torch.arange(R, device=dev)

    launches, images = {}, {}
    for backend, kn in kern.items():
        traverse.set_backend(backend)
        # warm-up at a small size: loads PyTorch's CUDA modules
        render_persistent(data, cam, params, W, H, 1, 2,
                          pixel_ids=pids[:4096])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        img, cnt, n_alive = render_persistent(data, cam, params, W, H, spp,
                                              n_steps, pixel_ids=pids,
                                              return_stats=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        launches[backend] = counts[backend]
        done = int(cnt.sum())
        pix_img = img / cnt[:, None].clamp(min=1)
        mean = float(pix_img.mean())
        assert counts[backend] == 2 * n_steps, counts
        assert all(c == 0 for b, c in counts.items() if b != backend), counts
        assert bool(torch.isfinite(img).all())
        assert 0.05 < mean < 1.0, mean  # Cornell HDR mean (tests: 0.2-0.4)
        images[backend] = pix_img.reshape(H // 4, W, 3).cpu().numpy()
        line = {"phase": "main_path", "backend": backend,
                "call": "render_persistent", "lanes": R, "spp": spp,
                "n_steps": n_steps, "depth": params.ray_depth,
                "seconds": dt, "samples_per_s": done / dt,
                "quota_completion": done / (R * spp),
                "active_lane_steps": int(n_alive.sum()),
                f"{kn['k']}_launches": counts[backend], "launches": counts,
                "hdr_mean": mean}
        if backend != "wide":
            # K2 walks with K1's arithmetic, so its render must match
            # K1's. K3 finds the same hits up to ties, but breaks the
            # 1-ulp ties between the coplanar back-to-back faces of the
            # full box (glossy box top, glass box bottom) by its own
            # rounding, as the reference's bruteforce does against its
            # gather walk; its hits are held to K1's in phase
            # k3_main_path_check instead
            res = compare(images[backend], images["wide"], pix_tol=0.02)
            assert res["match"] or backend == "bruteforce", res
            line["vs_wide"] = res
        emit(line)

        # where a step's time goes: device kernel time and launches per
        # step (torch.profiler over 8 steps of the same call) against the
        # unprofiled wall time per step above
        emit({"phase": "step_profile", "backend": backend,
              **_profile_steps(
                  lambda k: render_persistent(data, cam, params, W, H, spp,
                                              k, pixel_ids=pids),
                  8, dt / n_steps * 1e3, kn["profile"], kn["k"])})

        reset_counts()
        t0 = time.perf_counter()
        frame = Renderer(params, device=dev).render(scene, cam, W, H, spp=4)
        torch.cuda.synchronize()
        dt_frame = time.perf_counter() - t0
        counts = read_counts()
        fmean = float(frame.mean())
        assert frame.shape == (H, W, 3) and bool(torch.isfinite(frame).all())
        assert 0.05 < fmean < 1.0, fmean
        assert counts[backend] > 0, counts
        assert all(c == 0 for b, c in counts.items() if b != backend), counts
        emit({"phase": "main_path", "backend": backend,
              "call": "Renderer.render", "width": W, "height": H, "spp": 4,
              "seconds": dt_frame, "samples_per_s": W * H * 4 / dt_frame,
              f"{kn['k']}_launches": counts[backend], "hdr_mean": fmean})
    traverse.set_backend("wide")

    # ---- 4b. each kernel against its plain version on the main path's
    # own rays: every launch of a 4-step render_persistent at the main
    # path's 262,144 lanes and of a 1024x1024 spp-1 Renderer.render
    # (1,048,576 lanes), on the very inputs the integrator gave it
    for backend, kn in kern.items():
        mod = kn["mod"]
        launch = mod._launch
        seen = {}

        def checked_launch(g, o, d, tm, any_hit, _b=backend, _l=launch,
                           _seen=seen, **kw):
            assert kw.get("start") is None
            got = _l(g, o, d, tm, any_hit, **kw)
            hits, ties, err = check(_b, g, o, d, tm, any_hit, got=got)
            s = _seen.setdefault((o.shape[0], any_hit), {
                "launches": 0, "hits": 0, "tie_lanes": 0,
                "max_abs_err": 0.0})
            s["launches"] += 1
            s["hits"] += hits
            s["tie_lanes"] += ties
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if _b == "bruteforce":
                vs = s.setdefault("vs_k1", {})
                for k, v in k3_vs_k1(g, o, d, tm, any_hit, got).items():
                    vs[k] = (max(vs.get(k, v), v) if k == "max_boundary_dist"
                             else vs.get(k, 0) + v)
            return got

        traverse.set_backend(backend)
        mod._launch = checked_launch
        try:
            render_persistent(data, cam, params, W, H, spp, 4,
                              pixel_ids=pids)
            Renderer(params, device=dev).render(scene, cam, W, H, spp=1)
        finally:
            mod._launch = launch
            traverse.set_backend("wide")
        assert {k[0] for k in seen} == {R, W * H}, sorted(seen)
        assert sum(s["launches"] for s in seen.values()) >= 8, seen
        for (lanes, any_hit), s in sorted(seen.items()):
            max_err[backend] = max(max_err[backend], s["max_abs_err"])
            emit({"phase": f"{kn['k']}_main_path_check", "backend": backend,
                  "lanes": lanes, "any_hit": any_hit, **s})

    # ---- 5. the card against the CPU, under each backend --------------
    for backend in kern:
        traverse.set_backend(backend)
        small = {}
        for d in ("cuda", "cpu"):
            sd = scene.flatten(cam, device=d)
            small[d] = render_persistent_image(sd, cam, params, 32, 32,
                                               spp=4).cpu().numpy()
        traverse.set_backend("wide")
        res = compare(small["cuda"], small["cpu"], pix_tol=0.02)
        assert res["match"], res
        emit({"phase": "card_vs_cpu", "backend": backend, "size": 32,
              "spp": 4, **res})

    # ---- 6. kernel timing at the main path's shape ---------------------
    state, bounce = build_wavefront(data, cam, params, W, H, 0, pids)
    with torch.no_grad():
        state, _ = bounce(state, 0)  # first bounce, sorted wavefront
    o = state["origin"].contiguous()
    d = state["direction"].contiguous()
    tm = torch.where(state["alive"], 1e30, 0.0)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # t_max in and t, tri, u, v out on every lane; o and d only on live
    # lanes (t_max > 0): a dead lane's answer needs nothing else
    live = int((tm > 0).sum())
    ray_bytes = R * (4 + 4 * 4) + live * 6 * 4
    tables = {
        "wide": nbytes(geom.wboxes, geom.wmeta, geom.worder,
                       geom.tris_packed),
        "pallas": nbytes(geom.nodes_packed, geom.tris_packed),
        "bruteforce": nbytes(bruteforce.tri_tables(geom), geom.tris_packed),
    }
    t_pad = bruteforce.tri_tables(geom).shape[0]
    timing = {b: {} for b in kern}
    for backend, kn in kern.items():
        for any_hit in (False, True):
            stats = {} if backend != "bruteforce" else None
            hits, ties, err = check(backend, geom, o, d, tm, any_hit,
                                    stats=stats)
            max_err[backend] = max(max_err[backend], err)
            ms = time_ms(lambda: kn["wrapper"](geom, o, d, tm,
                                               any_hit=any_hit), 20)
            plain_ms = time_ms(lambda: kn["plain"](geom, o, d, tm,
                                                   any_hit=any_hit), 3)
            if backend == "bruteforce":
                # every live lane against every padded triangle row
                stats = {"ray_tri_tests": live * t_pad}
                ops = live * t_pad * OPS_PER_BRUTE_TEST
            else:
                ops = (stats["box_tests"] * OPS_PER_BOX_TEST
                       + stats["tri_tests"] * OPS_PER_TRI_TEST)
            b_bytes = ray_bytes + tables[backend]
            t_bytes = b_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_FLOPS_PER_S * 1e3
            timing[backend][any_hit] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=b_bytes, ops=ops, **stats)
            emit({"phase": f"{kn['k']}_timing", "backend": backend,
                  "any_hit": any_hit, "rays": R,
                  "live_rays": live, "hits": hits,
                  "tie_lanes": ties, "max_abs_err": err,
                  **timing[backend][any_hit], "library_ms": None,
                  "library_note": "no single PyTorch call computes a BVH "
                                  "traversal or a brute-force closest hit"})

    # ---- 7. the instanced slice: K1 variant (b) ------------------------
    k1b = run_instanced(dev, reset_counts, read_counts)

    # ---- 8. the distinct-parts slice: K1 variants (c) and (d) ----------
    k1c, k1d = run_distinct(dev, reset_counts, read_counts)

    # ---- 9. kernels ----------------------------------------------------
    print(smi, flush=True)
    rows = []
    for backend, kn in kern.items():
        close, anyh = timing[backend][False], timing[backend][True]
        rows.append({
            "name": kn["name"], "route": "cuda",
            "source": f"cadrays_tpu_torch/kernels/{kn['name']}.cu",
            "replaces": kn["replaces"], "launches": launches[backend],
            "max_abs_err": max_err[backend],
            "ms": close["ms"], "plain_ms": close["plain_ms"],
            "bound_ms": close["bound_ms"], "bound_by": close["bound_by"],
            "library_ms": None,
            "any_hit_ms": anyh["ms"], "any_hit_plain_ms": anyh["plain_ms"],
            "any_hit_bound_ms": anyh["bound_ms"], "check": "passed"})
        if backend == "wide":
            rows[-1]["name"] = "wide_trace (a)"
            rows.append({
                "name": "wide_trace (b) instanced", "route": "cuda",
                "source": "cadrays_tpu_torch/kernels/wide_trace.cu",
                "replaces": "cadrays_tpu/ops/pallas_wide.py:163",
                **k1b, "check": "passed"})
            rows += [k1c, k1d]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
