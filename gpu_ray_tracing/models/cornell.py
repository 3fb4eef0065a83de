"""The Cornell box: the canonical triangle-light test scene.

The round-4 triangle-light extension (Scene.tri_lights, docs/
ARCHITECTURE.md "Light sampling") exists precisely so scenes like this
render efficiently: an enclosed box lit by ONE small ceiling quad, where
pure BSDF sampling (the reference's only strategy, compute_shader.wgsl:
236-291) almost never finds the light and NEE/MIS samples it directly at
every diffuse vertex.

This is the classic two-sphere variant (mirror + glass) rather than the
two-rotated-boxes one: the framework's sphere BSDFs showcase caustics and
reflections of the quad light, and the Scene needs at least one sphere by
design (models/spheres.py:98-103).  Dimensions follow the traditional
555-unit box.
"""

from __future__ import annotations

import numpy as np

from gpu_ray_tracing.models.camera import CameraSettings
from gpu_ray_tracing.models.mesh import make_mesh, merge_meshes
from gpu_ray_tracing.models.scene import Scene, make_scene
from gpu_ray_tracing.models.spheres import (
    DIELECTRIC,
    EMISSIVE,
    LAMBERTIAN,
    METAL,
    make_spheres,
)

import jax.numpy as jnp

#: Traditional wall albedos (Cornell's measured spectra, RGB-projected).
WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)


def _quad(a, b, c, d, **mat_kw):
    """Two-triangle quad through the corners a-b-c-d (in winding order).

    Winding is cosmetic: closest-hit orients normals by the front-face
    test and triangle lights are two-sided, so either order renders
    identically.
    """
    verts = np.asarray([a, b, c, d], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return make_mesh(verts, faces, **mat_kw)


def cornell_box_scene(
    light_intensity: float = 15.0,
    light_half: float = 65.0,
) -> Scene:
    """The 555-unit Cornell box with a ceiling quad light and two spheres.

    `light_half` is the half-side of the square ceiling light (the
    traditional lamp is ~130x105).  Returns a Scene whose tri_lights carry
    the two light triangles; render with nee=True (mis=True recommended)
    and sky_intensity=0 — the box is closed, so every photon comes from
    the lamp.
    """
    s = 555.0
    lh, ly = float(light_half), s - 1.0
    walls = merge_meshes(
        _quad((0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s), albedo=WHITE),  # floor
        _quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), albedo=WHITE),  # ceiling
        _quad((0, 0, s), (s, 0, s), (s, s, s), (0, s, s), albedo=WHITE),  # back
        _quad((s, 0, 0), (s, s, 0), (s, s, s), (s, 0, s), albedo=GREEN),  # right
        _quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), albedo=RED),    # left
        _quad(  # the lamp, just below the ceiling
            (s / 2 - lh, ly, s / 2 - lh), (s / 2 + lh, ly, s / 2 - lh),
            (s / 2 + lh, ly, s / 2 + lh), (s / 2 - lh, ly, s / 2 + lh),
            albedo=(1.0, 1.0, 1.0), mat_kind=EMISSIVE,
            mat_param=float(light_intensity),
        ),
    )
    spheres = make_spheres(
        [
            ((185.0, 90.0, 170.0), 90.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
            ((370.0, 90.0, 350.0), 90.0, METAL, (0.8, 0.85, 0.88), 0.0),
        ]
    )
    return make_scene(spheres, walls)


def cornell_camera() -> CameraSettings:
    """The traditional Cornell viewpoint: centered, outside the open face."""
    return CameraSettings(
        look_from=jnp.asarray([278.0, 278.0, -800.0]),
        look_at=jnp.asarray([278.0, 278.0, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(40.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(10.0),
    )
