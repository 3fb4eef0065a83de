"""Ray generation: jittered anti-aliasing + defocus blur (thin lens).

Reference mapping (compute_shader.wgsl):
  - `generate_rays_*`     <- get_ray (wgsl:305-325)
  - jitter                <- sample_square (wgsl:299-303); the reference's
                             y draw uses seed*seed — reproduced only in
                             parity mode
  - defocus origin        <- defocus_disk_sample (wgsl:327-331); the reference
                             normalizes the 2D point so it samples the disk
                             RIM (ring bokeh) — reproduced only in parity
                             mode; the default samples the disk uniformly
                             (r = sqrt(u)).

Ray directions are intentionally NOT normalized (wgsl:322); the intersection
math handles non-unit directions via a = dot(d, d).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_ray_tracing.models.camera import Camera
from gpu_ray_tracing.ops import rng as rng_ops

Array = jax.Array

_TWO_PI = 6.283185307179586


def _pixel_centers(
    camera: Camera,
    width: int,
    height: int,
    jitter_x: Array,
    jitter_y: Array,
    y_offset: Array | int = 0,
) -> Array:
    """upper_left + du*(x + 0.5 + jx) + dv*(y + 0.5 + jy)   (wgsl:314-317).

    `y_offset` shifts the global row index so a row shard of a taller frame
    generates exactly the rays the full frame would.
    """
    x = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0) + jnp.asarray(
        y_offset, jnp.float32
    )
    fx = (x + 0.5 + jitter_x)[..., None]
    fy = (y + 0.5 + jitter_y)[..., None]
    return (
        camera.viewport_upper_left
        + camera.pixel_delta_u * fx
        + camera.pixel_delta_v * fy
    )


def _defocus_origin(camera: Camera, px: Array, py: Array) -> Array:
    """Thin-lens origin from a 2D point (px, py) in the defocus disk basis
    (wgsl:330); falls back to the pinhole center when defocus_angle <= 0
    (wgsl:319)."""
    origin = (
        camera.center
        + px[..., None] * camera.defocus_disk_u
        + py[..., None] * camera.defocus_disk_v
    )
    use_defocus = camera.defocus_angle > 0.0
    return jnp.where(use_defocus, origin, camera.center)


def generate_rays_threefry(
    camera: Camera, width: int, height: int, key: Array
) -> tuple[Array, Array]:
    """Default ray generation: independent jitter draws, uniform-disk defocus.

    Returns (origins, dirs), each (height, width, 3) f32.
    """
    kj, kd = jax.random.split(key)
    jit = jax.random.uniform(kj, (2, height, width), jnp.float32) - 0.5
    centers = _pixel_centers(camera, width, height, jit[0], jit[1])

    u = jax.random.uniform(kd, (2, height, width), jnp.float32)
    radius = jnp.sqrt(u[0])  # uniform over the disk area
    angle = u[1] * _TWO_PI
    origins = _defocus_origin(camera, radius * jnp.cos(angle), radius * jnp.sin(angle))
    dirs = centers - origins
    return origins, dirs


def generate_rays_hash(
    camera: Camera,
    width: int,
    height: int,
    sample_index: Array,
    frame_seed_u32: Array,
    *,
    y_offset: Array | int = 0,
    total_width: int | None = None,
    row_stride: Array | int = 1,
    sampler_spec: tuple | None = None,
) -> tuple[Array, Array, Array]:
    """Counter-based ray generation (the default).

    All draws derive from the GLOBAL pixel id, so the result is independent of
    sharding/tiling: rendering rows [y0, y0+height) of a total_width-wide
    frame yields exactly those rows of the full-frame render.  Local row r
    maps to global row `y_offset + r * row_stride` — stride 1 is a
    contiguous band, stride n with y_offset xi is the load-balanced
    interleaved partition (shard xi owns every n-th row).

    Returns (origins, dirs, pixel_seeds); pixel_seeds feeds the integrator's
    per-bounce draws.
    """
    tw = width if total_width is None else total_width
    pixel_ids = hash_pixel_ids(
        width, height, y_offset=y_offset, total_width=tw, row_stride=row_stride
    )
    # One sampling-arithmetic implementation for the full-frame grid and
    # arbitrary id sets: pid % tw / pid // tw reproduce the x / y iotas
    # exactly (both integers are f32-exact), so this stays bit-identical to
    # the historical inline grid path.
    return generate_rays_for_ids(
        camera, pixel_ids, sample_index, frame_seed_u32, total_width=tw,
        sampler_spec=sampler_spec,
    )


def hash_pixel_ids(
    width: int,
    height: int,
    *,
    y_offset: Array | int = 0,
    total_width: int | None = None,
    row_stride: Array | int = 1,
) -> Array:
    """GLOBAL (height, width) uint32 pixel-id grid of a (possibly sharded)
    frame: local row r maps to global row `y_offset + r * row_stride` of a
    total_width-wide frame — the id space every counter-based draw keys on.
    """
    tw = width if total_width is None else total_width
    x = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 1)
    y = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 0) * jnp.uint32(
        row_stride
    ) + jnp.uint32(y_offset)
    return y * jnp.uint32(tw) + x


def generate_rays_for_ids(
    camera: Camera,
    pixel_ids: Array,
    sample_index: Array,
    frame_seed_u32: Array,
    *,
    total_width: int,
    sampler_spec: tuple | None = None,
) -> tuple[Array, Array, Array]:
    """Counter-based ray generation for an arbitrary array of GLOBAL pixel ids.

    Same draws and same arithmetic as `generate_rays_hash` — for any pixel id
    the returned ray is bit-identical to the full-frame generator's — but the
    pixels need not form a frame and `sample_index` may vary PER ELEMENT.
    This is what lets the wavefront engine's ray regeneration refill dead ray
    rows mid-trace with primary rays of a later sample (ops/pallas/wavefront).

    Returns (origins, dirs, seeds): origins/dirs are pixel_ids.shape + (3,).
    """
    pid = jnp.asarray(pixel_ids, jnp.uint32)
    seeds = rng_ops.hash_pixel_seeds(pid, sample_index, frame_seed_u32)

    u1 = rng_ops.uniform_hash(seeds, 1)
    u2 = rng_ops.uniform_hash(seeds, 2)
    # AA jitter pair under the configured sampler (salt-5 pair id):
    # independent draws pass through, 'stratified' remaps them into sample
    # s's stratum, 'sobol' replaces them with the Owen-scrambled (0,2) point.
    jx, jy = rng_ops.sampler_jitter(
        u1, u2, pid, sample_index, frame_seed_u32, sampler_spec
    )
    tw = jnp.uint32(total_width)
    # Global x/y from the flat id.  Both fit f32 exactly (ids < 2^24 for any
    # frame this renderer addresses; the pad-id range stays below that too).
    fx = ((pid % tw).astype(jnp.float32) + 0.5 + jx)[..., None]
    fy = ((pid // tw).astype(jnp.float32) + 0.5 + jy)[..., None]
    centers = (
        camera.viewport_upper_left
        + camera.pixel_delta_u * fx
        + camera.pixel_delta_v * fy
    )
    u3 = rng_ops.uniform_hash(seeds, 3)
    u4 = rng_ops.uniform_hash(seeds, 4)
    # Thin-lens point (third dimension pair, salt-7 pair id): sampler
    # points in (u3, u4) = (r^2, theta) are equal-AREA strata of the defocus
    # disk.  A no-op for pinhole cameras (the draws are unused).
    u3, u4 = rng_ops.sampler_uniforms(
        u3, u4, pid, sample_index, frame_seed_u32, sampler_spec,
        rot_salt=rng_ops._LENS_ROT_SALT,
    )
    radius = jnp.sqrt(u3)
    angle = _TWO_PI * u4
    origins = _defocus_origin(camera, radius * jnp.cos(angle), radius * jnp.sin(angle))
    dirs = centers - origins
    return origins, dirs, seeds


def generate_rays_wgsl(
    camera: Camera,
    width: int,
    height: int,
    sample_seed_u32: Array,
    frame_seed_u32: Array,
    parity: bool,
    *,
    y_offset: Array | int = 0,
) -> tuple[Array, Array]:
    """WGSL-seeded ray generation for golden parity tests.

    `sample_seed_u32` is the scalar the reference calls `seed` in update()
    (1 + samples_until_now + frame_seed, wgsl:353); the per-pixel seed is
    derived exactly as in get_ray (wgsl:309-311).

    parity=True keeps the reference sampler quirks (seed*seed jitter-y, rim
    defocus); parity=False uses independent jitter and uniform-disk defocus
    while still drawing from the WGSL hash stream.
    """
    seeds = rng_ops.pixel_seeds(width, height, sample_seed_u32, frame_seed_u32, y_offset)

    jx = rng_ops.wgsl_random_float(seeds) - 0.5  # (wgsl:300)
    if parity:
        jy = rng_ops.wgsl_random_float(seeds * seeds) - 0.5  # quirk (wgsl:301)
    else:
        jy = rng_ops.wgsl_random_float(seeds + jnp.uint32(7919)) - 0.5
    centers = _pixel_centers(camera, width, height, jx, jy, y_offset)

    if parity:
        # Rim sampling: angle only, radius 1 (wgsl:327-331).
        angle = _TWO_PI * rng_ops.wgsl_random_float(seeds + jnp.uint32(1))
        px, py = jnp.cos(angle), jnp.sin(angle)
    else:
        u1 = rng_ops.wgsl_random_float(seeds + jnp.uint32(1))
        u2 = rng_ops.wgsl_random_float(seeds + jnp.uint32(2))
        radius = jnp.sqrt(u1)
        angle = _TWO_PI * u2
        px, py = radius * jnp.cos(angle), radius * jnp.sin(angle)
    origins = _defocus_origin(camera, px, py)
    dirs = centers - origins
    return origins, dirs
