"""gpu_ray_tracing — a JAX path tracer for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas/pjit rebuild of the capabilities of the
reference project Sur091/GPU-Ray-Tracing (Rust/Bevy/WGSL "Ray Tracing in One
Weekend" progressive path tracer).  The public surface is a pure, jittable,
vmappable, differentiable rendering API instead of the reference's windowed
app (`gpu_ray_tracing::run()`, lib.rs:28).

Quick start:

    import jax
    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, one_weekend_scene, render
    )

    scene = one_weekend_scene(jax.random.key(0))
    cfg = RenderConfig(width=1280, height=720, spp=16, max_depth=30)
    img = render(scene, CameraSettings.default(), cfg, key=jax.random.key(1))

Multi-chip rendering lives under `gpu_ray_tracing.parallel`
(`parallel.mesh.make_mesh` builds the ('x', 's') device mesh — distinct
from the top-level `make_mesh`, which builds triangle geometry —
`parallel.sharding.render_sharded` / `progressive_step_sharded` /
`accum_image` shard rows and samples over it).  Interactive-style camera
motion ops (dolly/strafe/yaw/zoom, the reference's keyboard controls) are
pure functions in `gpu_ray_tracing.models.camera`.
"""

from gpu_ray_tracing.api import (
    adaptive_progressive_step,
    count_traced_rays,
    progressive_step,
    render,
    render_animation,
    render_denoised,
    render_progressive,
    stack_camera_track,
)
from gpu_ray_tracing.ops.denoise import atrous_denoise
from gpu_ray_tracing.models.camera import Camera, CameraSettings, derive_camera
from gpu_ray_tracing.models.mesh import (
    TriangleMesh,
    box,
    icosphere,
    load_obj,
    make_mesh,
    merge_meshes,
    torus,
    transform_mesh,
)
from gpu_ray_tracing.models.cornell import cornell_box_scene, cornell_camera
from gpu_ray_tracing.models.scene import Scene, make_scene
from gpu_ray_tracing.models.spheres import (
    DIELECTRIC,
    EMISSIVE,
    LAMBERTIAN,
    METAL,
    Spheres,
    base_scene,
    make_spheres,
    one_weekend_scene,
)
from gpu_ray_tracing.ops.accumulate import (
    AccumState,
    AdaptiveAccumState,
    init_accum,
    init_adaptive_accum,
)
from gpu_ray_tracing.utils.config import REFERENCE_CONFIG, RenderConfig

__version__ = "0.3.0"

__all__ = [
    "AccumState",
    "AdaptiveAccumState",
    "adaptive_progressive_step",
    "Camera",
    "CameraSettings",
    "DIELECTRIC",
    "EMISSIVE",
    "LAMBERTIAN",
    "METAL",
    "REFERENCE_CONFIG",
    "RenderConfig",
    "Scene",
    "Spheres",
    "TriangleMesh",
    "base_scene",
    "box",
    "cornell_box_scene",
    "cornell_camera",
    "icosphere",
    "load_obj",
    "make_mesh",
    "make_scene",
    "merge_meshes",
    "torus",
    "transform_mesh",
    "count_traced_rays",
    "derive_camera",
    "init_accum",
    "init_adaptive_accum",
    "make_spheres",
    "one_weekend_scene",
    "progressive_step",
    "render",
    "render_animation",
    "render_denoised",
    "render_progressive",
    "atrous_denoise",
    "stack_camera_track",
]
