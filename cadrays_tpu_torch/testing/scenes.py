"""Canonical scenes.

``cornell_box``: the Cornell box of the reference's CornellBox fixture.
Unit open box (interior [0,1]^3, +Y side open toward the camera, z up),
coloured side walls, positional sphere light at (0.5, 0.5, 0.85) with
radius 0.06 and intensity 25; the full variant adds the glass sphere,
glossy and glass boxes and the mirror ball.

``torus_grid``: the reference's CAD-scale instanced assembly
(bench/cad_scale.py:53-79), a grid of one shared torus mesh.
"""
from __future__ import annotations

import numpy as np

from cadrays_tpu_torch.core.bsdf import material
from cadrays_tpu_torch.core.camera import Camera
from cadrays_tpu_torch.core.fresnel import (
    FRESNEL_CONSTANT,
    FRESNEL_DIELECTRIC,
    fresnel,
)
from cadrays_tpu_torch.core.lights import positional_light
from cadrays_tpu_torch.geometry import primitives
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
