"""Camera model: user-facing settings, derived GPU camera, and motion ops.

Reference mapping:
  - `CameraSettings`  <- camera.rs:10-46  (the user-facing resource)
  - `Camera`          <- camera.rs:256-291 `SceneCamera` (the derived uniform),
                         minus the nine fields the shader never reads
                         (wgsl:9,10,18,23,29,32,35,38,39 are marked "No uses";
                         the reference uniform carries ~40% dead payload which
                         we simply don't build)
  - `derive_camera`   <- camera.rs:293-350 `From<&CameraSettings>`
  - motion ops        <- camera.rs:125-253 keyboard controls, re-expressed as
                         pure functions (no input system in a batch renderer; camera paths
                         are data — see `gpu_ray_tracing.api.animate`)

Everything here is a pytree of f32 arrays, so camera derivation can be traced,
vmapped over camera tracks, and differentiated (d image / d look_from works).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


def _v3(x) -> jax.Array:
    return jnp.asarray(x, dtype=jnp.float32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "look_from",
        "look_at",
        "vup",
        "field_of_view",
        "defocus_angle",
        "focus_distance",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class CameraSettings:
    """User-facing camera parameters (camera.rs:10-28).

    The reference also stores samples_per_pixel / max_depth / camera_has_moved
    here (camera.rs:12-14); in this framework those are render-loop concerns
    and live in `RenderConfig` / the accumulation API instead.
    """

    look_from: Array  # (3,)
    look_at: Array  # (3,)
    vup: Array  # (3,)
    field_of_view: Array  # scalar, degrees
    defocus_angle: Array  # scalar, degrees
    focus_distance: Array  # scalar

    @staticmethod
    def default() -> "CameraSettings":
        """Reference defaults (camera.rs:30-46)."""
        return CameraSettings(
            look_from=_v3([13.0, 2.0, 3.0]),
            look_at=_v3([0.0, 0.0, 0.0]),
            vup=_v3([0.0, 1.0, 0.0]),
            field_of_view=jnp.float32(20.0),
            defocus_angle=jnp.float32(0.6),
            focus_distance=jnp.float32(10.0),
        )

    def replace(self, **kw) -> "CameraSettings":
        return dataclasses.replace(self, **kw)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "center",
        "viewport_upper_left",
        "pixel_delta_u",
        "pixel_delta_v",
        "defocus_disk_u",
        "defocus_disk_v",
        "defocus_angle",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    """Derived per-render camera (the live fields of camera.rs:256-291).

    Only the fields the kernel actually reads (wgsl:8-39 minus dead ones):
    ray origin center, viewport upper-left corner, per-pixel deltas, the two
    defocus-disk axes, and the defocus angle used as an on/off + size gate.
    """

    center: Array  # (3,)
    viewport_upper_left: Array  # (3,)
    pixel_delta_u: Array  # (3,)
    pixel_delta_v: Array  # (3,)
    defocus_disk_u: Array  # (3,)
    defocus_disk_v: Array  # (3,)
    defocus_angle: Array  # scalar, degrees


def _normalize(v: Array) -> Array:
    return v / jnp.linalg.norm(v)


def validate_camera(settings: CameraSettings) -> None:
    """Reject degenerate poses that would normalize a zero vector and
    render silent NaNs: look_from == look_at, or vup parallel to the view
    axis.  Only effective when the settings are CONCRETE — the public
    render path derives the camera under jit, where values are traced and
    the check skips (gradients through a degenerate pose are the caller's
    problem to regularize) — so eager entry points (the CLI, direct
    derive_camera calls) are where it bites."""
    s = settings
    if isinstance(s.look_from, jax.core.Tracer) or isinstance(
        s.look_at, jax.core.Tracer
    ):
        return
    import numpy as _np

    gaze = _np.asarray(s.look_from, _np.float64) - _np.asarray(s.look_at, _np.float64)
    if float(_np.dot(gaze, gaze)) == 0.0:
        raise ValueError(
            "degenerate camera: look_from == look_at (the view basis "
            "would normalize a zero vector and render NaNs)"
        )
    if not isinstance(s.vup, jax.core.Tracer):
        cr = _np.cross(_np.asarray(s.vup, _np.float64), gaze)
        if float(_np.dot(cr, cr)) == 0.0:
            raise ValueError(
                "degenerate camera: vup is parallel to the view axis "
                "(u = vup x w would normalize a zero vector)"
            )


def derive_camera(settings: CameraSettings, width: int, height: int) -> Camera:
    """CameraSettings -> Camera, the closed-form math of camera.rs:293-350.

    viewport_height = 2 * tan(fov/2) * focus_dist            (camera.rs:300-303)
    basis: w = norm(from-at), u = norm(vup x w), v = w x u   (camera.rs:307-309)
    viewport_v is negated to flip the y axis                 (camera.rs:312)
    pixel deltas = viewport / resolution                     (camera.rs:315-316)
    upper_left = center - focus*w - vu/2 - vv/2              (camera.rs:319-320)
    defocus_radius = focus * tan(defocus_angle/2)            (camera.rs:322-325)
    """
    s = settings
    validate_camera(s)
    aspect_ratio = jnp.float32(width) / jnp.float32(height)

    theta = jnp.deg2rad(s.field_of_view)
    h = jnp.tan(theta / 2.0)
    viewport_height = 2.0 * h * s.focus_distance
    viewport_width = viewport_height * aspect_ratio

    w = _normalize(s.look_from - s.look_at)
    u = _normalize(jnp.cross(s.vup, w))
    v = jnp.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = -viewport_height * v  # negative: image y grows downward

    pixel_delta_u = viewport_u / jnp.float32(width)
    pixel_delta_v = viewport_v / jnp.float32(height)

    viewport_upper_left = (
        s.look_from - s.focus_distance * w - viewport_u / 2.0 - viewport_v / 2.0
    )

    defocus_radius = s.focus_distance * jnp.tan(jnp.deg2rad(s.defocus_angle / 2.0))

    return Camera(
        center=s.look_from,
        viewport_upper_left=viewport_upper_left,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=jnp.asarray(s.defocus_angle, jnp.float32),
    )


# ---------------------------------------------------------------------------
# Camera motion — pure-functional equivalents of camera.rs:125-253.
#
# The reference mutates CameraSettings from a keyboard system; a batch renderer
# has no event loop, so motion is a set of pure (settings, amount) -> settings
# functions you can scan over to build camera tracks.  Speeds are the caller's
# business (the reference's 2.0 units/s etc., camera.rs:116-118, become the
# `amount` argument).  The reference's accidental double-application of yaw
# (the duplicated ArrowLeft/ArrowRight blocks at camera.rs:170-206) is a bug we
# do not reproduce.
# ---------------------------------------------------------------------------


def _forward(settings: CameraSettings) -> Array:
    # Note: the reference's "forward" points from look_at TOWARD look_from
    # (camera.rs:134), so W moves the camera AWAY from the target.  We keep
    # that convention for behavioral parity.
    return _normalize(settings.look_from - settings.look_at)


def _right(settings: CameraSettings) -> Array:
    return _normalize(jnp.cross(_forward(settings), jnp.asarray([0.0, 1.0, 0.0], jnp.float32)))


def dolly(settings: CameraSettings, amount) -> CameraSettings:
    """W/S: move along the view axis (camera.rs:140-147)."""
    return settings.replace(look_from=settings.look_from + _forward(settings) * amount)


def strafe(settings: CameraSettings, amount) -> CameraSettings:
    """A/D: move along the right axis (camera.rs:150-157)."""
    return settings.replace(look_from=settings.look_from + _right(settings) * amount)


def elevate(settings: CameraSettings, amount) -> CameraSettings:
    """Up/Down arrows: move along world +Y (camera.rs:160-166)."""
    up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    return settings.replace(look_from=settings.look_from + up * amount)


def _rotate_y(v: Array, angle) -> Array:
    c, s = jnp.cos(angle), jnp.sin(angle)
    x, y, z = v[0], v[1], v[2]
    return jnp.stack([c * x + s * z, y, -s * x + c * z])


def orbit_yaw(settings: CameraSettings, angle) -> CameraSettings:
    """Left/Right arrows: rotate look_from about look_at around world Y
    (camera.rs:170-187; applied ONCE, unlike the reference's duplicated
    blocks at camera.rs:188-206 which double the speed)."""
    view = settings.look_from - settings.look_at
    length = jnp.linalg.norm(view)
    direction = _normalize(_rotate_y(view, angle))
    return settings.replace(look_from=settings.look_at + direction * length)


def orbit_pitch(settings: CameraSettings, angle) -> CameraSettings:
    """Keys 1/2: pitch look_from about look_at around the right axis, with the
    flip guard |dot(dir, Y)| < 0.95 (camera.rs:209-242)."""
    view = settings.look_from - settings.look_at
    length = jnp.linalg.norm(view)
    fwd = _normalize(view)
    right = _normalize(jnp.cross(fwd, jnp.asarray([0.0, 1.0, 0.0], jnp.float32)))
    # Rodrigues rotation of fwd around `right`.
    c, s = jnp.cos(angle), jnp.sin(angle)
    rotated = fwd * c + jnp.cross(right, fwd) * s + right * jnp.dot(right, fwd) * (1.0 - c)
    rotated = _normalize(rotated)
    ok = jnp.abs(rotated[1]) < 0.95
    new_from = jnp.where(ok, settings.look_at + rotated * length, settings.look_from)
    return settings.replace(look_from=new_from)


def zoom(settings: CameraSettings, fov_delta, fov_min=10.0, fov_max=120.0) -> CameraSettings:
    """Mouse-wheel FOV zoom with the 10..120 degree clamp (camera.rs:57-68,
    consts at camera.rs:121-122). The reference wrote but never registered this
    system (camera.rs:48, underscore-prefixed); here it is a live API."""
    fov = jnp.clip(settings.field_of_view + fov_delta, fov_min, fov_max)
    return settings.replace(field_of_view=fov)
