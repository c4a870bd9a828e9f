"""Canonical scenes.

``cornell_box``: the Cornell box of the reference's CornellBox fixture.
Unit open box (interior [0,1]^3, +Y side open toward the camera, z up),
coloured side walls, positional sphere light at (0.5, 0.5, 0.85) with
radius 0.06 and intensity 25; the full variant adds the glass sphere,
glossy and glass boxes and the mirror ball.

``torus_grid``: the reference's CAD-scale instanced assembly
(bench/cad_scale.py:53-79), a grid of one shared torus mesh.

``distinct_parts``: the reference's assembly of distinct parts
(bench/cad_distinct.py:61-151), 54 unique deformed meshes and 611,136
triangles, whose compact triangle table cannot dedup;
``distinct_bounce_rays`` makes its bounce rays (:154-200).
"""
from __future__ import annotations

import numpy as np
import torch

from cadrays_tpu_torch.core.bsdf import material
from cadrays_tpu_torch.core.camera import Camera
from cadrays_tpu_torch.core.fresnel import (
    FRESNEL_CONSTANT,
    FRESNEL_DIELECTRIC,
    fresnel,
)
from cadrays_tpu_torch.core.lights import positional_light
from cadrays_tpu_torch.geometry import primitives
from cadrays_tpu_torch.geometry.mesh import TriangleMesh
from cadrays_tpu_torch.scene.flatten import SceneData
from cadrays_tpu_torch.scene.instances import build_instanced
from cadrays_tpu_torch.scene.scene import Scene


def _translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def _rot_z(deg):
    a = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = np.cos(a)
    m[0, 1] = -np.sin(a)
    m[1, 0] = np.sin(a)
    m[1, 1] = np.cos(a)
    return m


def cornell_box(full: bool = False, sphere_res: int = 24) -> Scene:
    scene = Scene()
    scene.clear_lights()
    scene.add_light(positional_light(position=(0.5, 0.5, 0.85),
                                     intensity=25.0, smooth_radius=0.06))

    white = material(kd=(1.0, 1.0, 1.0))
    red = material(kd=(1.0, 0.3, 0.3))
    blue = material(kd=(0.3, 0.5, 1.0))

    walls = [
        ("b_1", 1, _translate((1, 0, 0)), red),  # right wall at x=1
        ("b_2", 2, _translate((-1, 0, 0)), blue),  # left wall at x=0
        ("b_3", 3, _translate((0, 1, 0)), white),  # back wall at y=1
        ("b_5", 5, _translate((0, 0, 1)), white),  # ceiling at z=1
        ("b_6", 6, _translate((0, 0, -1)), white),  # floor at z=0
    ]
    for name, face, tf, mat in walls:
        mesh = primitives.box_face(1.0, 1.0, 1.0, face)
        scene.add_shape(name, mesh, mat, tf)

    if not full:
        scene.add_shape(
            "c", primitives.box(0.3, 0.3, 0.2),
            material(kd=(1.0, 0.8, 0.2)),
            _translate((0.55, 0.3, 0.0)) @ _rot_z(-30),
        )
        return scene

    glass_blue = material(
        kd=(0, 0, 0), kt=(1.0, 1.0, 1.0),
        absorp_color=(0.8, 0.8, 1.0), absorp_coeff=6.0,
        base_fresnel=fresnel(FRESNEL_DIELECTRIC, 1.5),
    )
    glass_green = material(
        kd=(0, 0, 0), kt=(1.0, 1.0, 1.0),
        absorp_color=(0.8, 1.0, 0.8), absorp_coeff=6.0,
        base_fresnel=fresnel(FRESNEL_DIELECTRIC, 1.5),
    )
    glossy = material(kd=(1.0, 0.8, 0.2), ks=(0.3, 0.3, 0.3),
                      base_rough=0.2)
    mirror_ball = material(kd=(0.5, 0.9, 0.3), ks=(0.3, 0.3, 0.3),
                           base_rough=0.0,
                           base_fresnel=fresnel(FRESNEL_CONSTANT, 1.0))

    scene.add_shape("s", primitives.sphere(0.2, sphere_res * 2, sphere_res),
                    glass_blue, _translate((0.21, 0.3, 0.2)))
    scene.add_shape("c", primitives.box(0.3, 0.3, 0.2), glossy,
                    _translate((0.55, 0.3, 0.0)) @ _rot_z(-30))
    scene.add_shape("g", primitives.box(0.15, 0.15, 0.3), glass_green,
                    _translate((0.7, 0.25, 0.2)) @ _rot_z(10))
    scene.add_shape("r", primitives.sphere(0.1, sphere_res * 2, sphere_res),
                    mirror_ball, _translate((0.5, 0.65, 0.1)))
    return scene


def cornell_camera(aperture: float = 0.0) -> Camera:
    """Front view of the open box."""
    return Camera.look_at(
        eye=(0.5, -1.6, 0.5),
        at=(0.5, 0.5, 0.5),
        up=(0.0, 0.0, 1.0),
        fovy_deg=40.0,
        aperture=aperture,
        focal_dist=2.1,
    )


def torus_grid(grid: int = 10, segments: int = 72, rings: int = 36,
               lit: bool = True, device="cuda") -> tuple[SceneData, Camera]:
    """Instanced assembly of grid x grid copies of one torus (major 1,
    minor 0.35), each turned about z then x by one random angle and
    lifted by up to 1.5, on a 2.6 pitch: the reference's CAD-scale scene
    (bench/cad_scale.py:53-79, seed 7; at grid 10, 72 x 36: 100
    instances, 518,400 triangles) with its camera. All instances share
    one material, so the wide tree holds ONE torus BLAS.

    lit=True adds a positional light of intensity 900 above the grid,
    placed as bench/cad_distinct.py:145-146 places its light, with
    extent grid * 2.6 (at grid 10: (13, -7.8, 31.2)); lit=False has no
    light, as the reference's benchmark render has none.
    """
    mesh = primitives.torus(1.0, 0.35, segments, rings)
    meshes, tfs = [], []
    rng = np.random.default_rng(7)
    for i in range(grid):
        for j in range(grid):
            m = np.eye(4, dtype=np.float32)
            ang = rng.uniform(0, np.pi)
            c, s = np.cos(ang), np.sin(ang)
            m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                 np.float32) @ np.array(
                [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
            m[:3, 3] = (i * 2.6, j * 2.6, rng.uniform(0, 1.5))
            meshes.append(mesh)
            tfs.append(m)
    side = grid * 2.6
    lights = (positional_light(position=(side / 2, -side * 0.3, side * 1.2),
                               intensity=900.0) if lit else None)
    data = build_instanced(meshes, tfs, [material(kd=(0.8, 0.8, 0.8))],
                           [0] * len(meshes), lights=lights, device=device)
    cam = Camera.look_at(eye=(side / 2, -side * 0.8, side * 0.55),
                         at=(side / 2, side / 2, 0.5), up=(0, 0, 1),
                         fovy_deg=45.0)
    return data, cam


def _deform(mesh: TriangleMesh, seed: int, amp: float = 0.08) -> TriangleMesh:
    """Displace the vertices along their normals by a per-part harmonic
    field (bench/cad_distinct.py:61-80), so no two parts share data."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(1.5, 6.0, size=3)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    v = np.asarray(mesh.vertices, np.float32)
    n = np.asarray(mesh.normals, np.float32)
    h = (np.sin(f[0] * v[:, 0] + ph[0])
         * np.sin(f[1] * v[:, 1] + ph[1])
         * np.sin(f[2] * v[:, 2] + ph[2])).astype(np.float32)
    v2 = v + n * (amp * h)[:, None]
    return TriangleMesh(vertices=v2, indices=np.asarray(mesh.indices),
                        normals=n, uvs=np.asarray(mesh.uvs))


def _distinct_meshes(n_parts: int, min_tris: int) -> list:
    """n_parts unique meshes from five families (seeds 1000 + i), then
    unique tori (seeds 5000 + k) until the total clears min_tris
    (bench/cad_distinct.py:83-119)."""
    parts = []
    i = 0
    while len(parts) < n_parts:
        fam = i % 5
        if fam == 0:
            m = primitives.torus(1.0 + 0.2 * (i % 3), 0.25 + 0.02 * (i % 5),
                                 96 + 8 * (i % 4), 64 + 8 * (i % 3))
        elif fam == 1:
            m = primitives.sphere(0.9 + 0.1 * (i % 4), 96 + 16 * (i % 3),
                                  64 + 8 * (i % 4))
        elif fam == 2:
            m = primitives.cylinder(0.5 + 0.1 * (i % 3), 1.6 + 0.2 * (i % 4),
                                    384 + 64 * (i % 3))
        elif fam == 3:
            m = primitives.cone(0.8 + 0.1 * (i % 3), 0.15 + 0.05 * (i % 4),
                                1.7, 512 + 64 * (i % 3))
        else:
            m = primitives.torus(1.3, 0.5 - 0.04 * (i % 5), 80 + 16 * (i % 3),
                                 56 + 8 * (i % 4))
        parts.append(_deform(m, seed=1000 + i))
        i += 1
    total = sum(p.indices.shape[0] for p in parts)
    k = 0
    while total < min_tris:
        extra = primitives.torus(1.0 + 0.07 * (k % 7), 0.28 + 0.015 * (k % 5),
                                 128, 96)
        parts.append(_deform(extra, seed=5000 + k))
        total += extra.indices.shape[0]
        k += 1
    return parts


def distinct_parts(n_parts: int = 48, min_tris: int = 600_000,
                   device="cuda") -> tuple[SceneData, Camera]:
    """The reference's CAD assembly of distinct parts
    (bench/cad_distinct.py:83-151): n_parts deformed meshes of five
    families plus unique tori up to min_tris triangles (the defaults
    give 54 parts and 611,136 triangles, so the compact table holds
    611,264 rows), on a 3.4 grid, each turned about z then x by one
    angle from default_rng(11) and lifted by up to 1.2; materials
    alternate between a matte and a glossy one; a positional light of
    intensity 900 and the reference's camera. No two parts share a
    mesh, so nothing dedups. ``min_tris=0`` builds a small assembly
    with the same code.
    """
    parts = _distinct_meshes(n_parts, min_tris)
    n = len(parts)
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(11)
    tfs = []
    for k in range(n):
        i, j = divmod(k, side)
        m = np.eye(4, dtype=np.float32)
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             np.float32) @ np.array(
            [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m[:3, 3] = (i * 3.4, j * 3.4, rng.uniform(0.0, 1.2))
        tfs.append(m)
    mats = [material(kd=(0.75, 0.72, 0.68)),
            material(kd=(0.35, 0.45, 0.75), ks=(0.2, 0.2, 0.2),
                     base_rough=0.3)]
    mat_ids = [k % 2 for k in range(n)]
    ext = side * 3.4
    lights = positional_light(position=(ext / 2, -ext * 0.3, ext * 1.2),
                              intensity=900.0)
    data = build_instanced(parts, tfs, mats, mat_ids, lights=lights,
                           device=device)
    cam = Camera.look_at(eye=(ext / 2, -ext * 0.75, ext * 0.6),
                         at=(ext / 2, ext / 2, 0.4), up=(0, 0, 1),
                         fovy_deg=45.0)
    return data, cam


def distinct_bounce_rays(geom, cam: Camera, W: int = 1024, H: int = 1024,
                         quarter: int = 4, seed: int = 5):
    """Bounce rays as the renderer issues them at depth >= 2
    (bench/cad_distinct.py:154-200): W * H / quarter camera rays through
    pixel ids strided by ``quarter`` over the frame, traced; origins at
    hit points drawn with default_rng(seed), offset 1e-3 along the
    triangle's normal turned to face the ray (the normal of its packed
    row, object space on an instanced scene, as the reference takes
    it), cosine-hemisphere directions about it, sorted by the coherence
    key. Returns (origin, direction), each (R, 3) float32 on the
    geometry's device.
    """
    from cadrays_tpu_torch.ops.traverse import _coherence_key, trace

    dev = geom.tris_packed.device
    R = W * H // quarter
    pids = torch.arange(R, dtype=torch.int32, device=dev) * quarter
    px = (pids % W).to(torch.float32)
    py = (pids // W).to(torch.float32)
    zeros = torch.zeros(R, device=dev)
    o, d = cam.to(dev).generate_rays(px, py, zeros, zeros, W, H)
    o, d = o.contiguous(), d.contiguous()
    res = trace(geom, o, d, torch.full((R,), 1e30, device=dev))
    res = {k: v.cpu().numpy() for k, v in res.items()}
    o, d = o.cpu().numpy(), d.cpu().numpy()

    hit_idx = np.nonzero(res["tri"] >= 0)[0]
    assert hit_idx.size > R // 8, "camera must see the assembly"
    rng = np.random.default_rng(seed)
    src = hit_idx[rng.integers(0, hit_idx.size, R)]

    p = o[src] + res["t"][src, None] * d[src]
    rows = geom.tris_packed.cpu().numpy()[res["tri"][src]]
    n = np.cross(rows[:, 3:6], rows[:, 6:9])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n = np.where(np.sum(n * d[src], axis=-1, keepdims=True) > 0, -n, n)

    u1 = rng.uniform(0, 1, R).astype(np.float32)
    u2 = rng.uniform(0, 1, R).astype(np.float32)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    t_ax = np.cross(n, np.where(np.abs(n[:, 2:3]) < 0.9,
                                [0, 0, 1.0], [1.0, 0, 0]))
    t_ax /= np.maximum(np.linalg.norm(t_ax, axis=-1, keepdims=True), 1e-12)
    b_ax = np.cross(n, t_ax)
    local = np.stack([r * np.cos(phi), r * np.sin(phi),
                      np.sqrt(np.maximum(1 - u1, 0))], -1)
    d_b = (local[:, 0:1] * t_ax + local[:, 1:2] * b_ax
           + local[:, 2:3] * n).astype(np.float32)
    o_b = (p + n * 1e-3).astype(np.float32)

    o_b, d_b = torch.from_numpy(o_b).to(dev), torch.from_numpy(d_b).to(dev)
    perm = torch.argsort(_coherence_key(geom, o_b, d_b), stable=True)
    return o_b[perm].contiguous(), d_b[perm].contiguous()
